// Weighted intra-part distance sums for Hopper (sm_90a), plain C interface.
//
// Replaces the three TPU kernels of
// semantichuman_tpu/ops/pallas/part_dist_pallas.py, which share one tile
// computation (_weights_de_mask):
//   mode 0  _fwd_call      (_fwd_kernel):      term sum and mask count
//   mode 1  _fwd_grad_call (_fwd_grad_kernel): the sums and the unscaled
//           gradient g0 = d(term sum)/d(rp), the one-pass VJP
//   mode 2  _vjp_bwd       (_bwd_kernel):      drp = g0 * ct, recomputed
//
// One tile is one (part, batch element): vp, rp [n_pad, 3] (GT and
// reconstructed vertices of the part, rows >= n_real are padding), the
// part's bone vector, the edit factor a and the part's uniform-weight flag.
// For every ordered pair j != k of real rows:
//   de0 = sqrt(relu((|v_j|^2 - 2 v_j.v_k) + |v_k|^2))      (Gram form)
//   cos = |(v_j - v_k).bone| / (de0 |bone|), 1 where de0 |bone| = 0
//   w   = 1 (all_one or a uniform part), acos(cos) 2/pi (linear),
//         that or 0 below w_threshold (threshold), sqrt(1 - cos^2) (sin)
//   de  = de0 a;  the pair counts iff w de != 0
//   de_r = the same Gram-form distance of rp
//   q = w de_r / de - w (relat) or w de_r - w de;  term = |q|
//   g = sign(q) w / de (relat) or sign(q) w;  coef = g / de_r, 0 where
//       de_r = 0 (the Pallas kernel's guard, PARITY #19)
//   g0[j] = 2 (rp_j sum_k coef[j,k] - sum_k coef[j,k] rp_k)
//
// Rounding: every per-pair value is computed with the plain version's
// operations in its order, and multiplies and adds are never contracted
// into FMAs (__fmul_rn, __fadd_rn, __fsub_rn; sqrtf and divides correctly
// rounded, acosf the same libdevice routine as torch's).  The Gram form
// loses ~11 of f32's 24 bits for a mesh's nearest pairs and the loss is
// discontinuous (the mask, the threshold, the sign of q), so rounding that
// differed would send a few pairs to the other side.  The plain version
// (part_dist_plain) stays the reference for every decision; the kernel
// differs from it only in the order of the sums.
//
// acos only where it can matter (threshold mode).  The weight is zeroed
// when w = fl(fl(acosf(c)) fl(2/pi)) < t.  acosf's maximum error is 2 ulp
// (CUDA C++ Programming Guide, single-precision mathematical functions);
// with the two roundings of the product, the computed w is within
// 4.2e-7 w (relative) of (2/pi) acos(c).  The host passes c_skip, cos of
// (pi/2) t (1 - 1e-4) computed in double and rounded up to float
// (`_acos_skip_cos` in ops/part_dist.py): for c > c_skip, acos(c) <
// (pi/2) t (1 - 1e-4), so the computed w < t (1 - 1e-4)(1 + 4.2e-7) < t and
// the plain version zeroes it too.  The band is ~240 times wider than the
// error needs.  Pairs at or below c_skip call acosf as the plain version
// calls acos.
//
// Bound on an H100 SXM: operations (f32 issue on the CUDA cores, and the
// SFU for square roots, reciprocals and acos).  Only O(G n) bytes are read
// and written while every tile does n (n - 1) pair evaluations.
//
// Design: no n x n matrix is stored anywhere.  One block (4 or 8 warps,
// the host's choice) takes 32 rows of one tile and stages the tile's real
// rows of vp and rp, their squared norms and bone projections in shared
// memory (36 bytes a vertex: 14.7 KB at n_pad = 408).  A warp owns one
// row j at a time and its lanes take 32 columns k a step, so the lanes
// share row j and nearby columns: their decisions (the acos band, the
// mask) mostly agree, and a step whose lanes all fall past the band or
// outside the mask skips that work.  A
// fixed xor-shuffle tree reduces the row's sums, so the row's owner writes
// g0[j] with no atomics; per-block (term, count) partials go to scratch
// and a second kernel adds them per tile in row-block order, so every
// result is the same from run to run.
//
// What was measured and left out (PERF.md, section 6): evaluating each
// unordered pair once, where both Gram orders round alike and the rest
// apart, built three ways (rows on a circulant schedule, 32 x 32 block
// pairs with column sums passed lane to lane, a warp a row with per-warp
// column sums), and queueing the pairs in the mask so that the
// reconstruction's half runs on full warps.  On the training step's data
// every one was slower than this layout: there ~11 % of the pairs' two
// Gram orders round otherwise, and the second orders, evaluated apart, run
// on warps whose lanes disagree.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxWarps = 8;
constexpr int kRowsPerBlock = 32;
constexpr float kTwoOverPi = 0.636619772367581343f;
constexpr unsigned kFull = 0xffffffffu;

enum WMode { W_ALL_ONE = 0, W_LINEAR = 1, W_SIN = 2, W_THRESHOLD = 3 };
enum Mode { MODE_FWD = 0, MODE_FWD_GRAD = 1, MODE_BWD = 2 };

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(kFull, v, off);
  return v;
}

__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}

// (a0 b0 + a1 b1) + a2 b2, rounded after every operation
__device__ __forceinline__ float dot3(float a0, float a1, float a2, float b0,
                                      float b1, float b2) {
  return add(add(mul(a0, b0), mul(a1, b1)), mul(a2, b2));
}

// relu((r_j - 2 <x_j, x_k>) + r_k), then sqrt
__device__ __forceinline__ float gram_dist(float rj, float inner, float rk) {
  return sqrtf(fmaxf(add(sub(rj, mul(2.f, inner)), rk), 0.f));
}

__device__ __forceinline__ float sign_of(float v) {
  return v > 0.f ? 1.f : (v < 0.f ? -1.f : 0.f);
}

template <int MODE>
__global__ void __launch_bounds__(32 * kMaxWarps)
part_dist_rows_kernel(const float* __restrict__ vp,
                      const float* __restrict__ rp,
                      const float* __restrict__ bone,
                      const float* __restrict__ a,
                      const int* __restrict__ n_real,
                      const int* __restrict__ allone,
                      const float* __restrict__ ct,
                      float* __restrict__ partial, float* __restrict__ grad,
                      int B, int n_pad, int w_mode, float w_threshold,
                      float c_skip, int relat) {
  extern __shared__ float smem[];
  const int tile = blockIdx.y;
  const int rb = blockIdx.x;
  const int n_rb = gridDim.x;
  const int part = tile / B;
  // rows past n_pad do not exist, whatever n_real says
  const int n = min(max(n_real[part], 0), n_pad);
  const bool uniform = (w_mode == W_ALL_ONE) || allone[part] != 0;
  float* sv = smem;              // [n][3] GT vertices (n <= n_pad)
  float* sr = sv + 3 * n;        // [n][3] reconstructed vertices
  float* nv = sr + 3 * n;        // [n] |v|^2
  float* nr = nv + n;            // [n] |r|^2
  float* sp = nr + n;            // [n] v . bone
  const float* vt = vp + (size_t)tile * n_pad * 3;
  const float* rt = rp + (size_t)tile * n_pad * 3;
  const float bx = bone[tile * 3 + 0];
  const float by = bone[tile * 3 + 1];
  const float bz = bone[tile * 3 + 2];
  const float bn = sqrtf(dot3(bx, by, bz, bx, by, bz));
  const float at = a[tile];
  const float ctt = (MODE == MODE_BWD) ? ct[tile] : 0.f;

  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    const float x = vt[3 * k], y = vt[3 * k + 1], z = vt[3 * k + 2];
    const float u = rt[3 * k], v = rt[3 * k + 1], w = rt[3 * k + 2];
    sv[3 * k] = x; sv[3 * k + 1] = y; sv[3 * k + 2] = z;
    sr[3 * k] = u; sr[3 * k + 1] = v; sr[3 * k + 2] = w;
    nv[k] = dot3(x, y, z, x, y, z);
    nr[k] = dot3(u, v, w, u, v, w);
    sp[k] = dot3(x, y, z, bx, by, bz);
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  float term_w = 0.f, count_w = 0.f;      // this warp's sums (all lanes)
  const int j_end = min((rb + 1) * kRowsPerBlock, n_pad);
  for (int j = rb * kRowsPerBlock + warp; j < j_end; j += warps) {
    if (j >= n) {                          // padding row: zero gradient
      if (MODE != MODE_FWD && lane < 3)
        grad[((size_t)tile * n_pad + j) * 3 + lane] = 0.f;
      continue;
    }
    const float vjx = sv[3 * j], vjy = sv[3 * j + 1], vjz = sv[3 * j + 2];
    const float rjx = sr[3 * j], rjy = sr[3 * j + 1], rjz = sr[3 * j + 2];
    const float nvj = nv[j], nrj = nr[j], spj = sp[j];
    float term = 0.f, count = 0.f, rowsum = 0.f;
    float mx = 0.f, my = 0.f, mz = 0.f;
    for (int k = lane; k < n; k += 32) {
      if (k == j) continue;
      const float de0 = gram_dist(
          nvj, dot3(vjx, vjy, vjz, sv[3 * k], sv[3 * k + 1], sv[3 * k + 2]),
          nv[k]);
      float w = 1.f;
      if (!uniform) {
        const float denom = mul(de0, bn);
        float c = denom > 0.f ? fabsf(sub(spj, sp[k])) / denom : 1.f;
        c = fminf(c, 1.f);
        if (w_mode == W_SIN) {
          w = sqrtf(fmaxf(sub(1.f, mul(c, c)), 0.f));
        } else if (w_mode == W_THRESHOLD && c > c_skip) {
          w = 0.f;                 // below the threshold, past the band
        } else {
          w = mul(acosf(c), kTwoOverPi);
          if (w_mode == W_THRESHOLD && w < w_threshold) w = 0.f;
        }
      }
      const float de = mul(de0, at);
      if (mul(w, de) == 0.f) continue;     // outside the mask
      const float rkx = sr[3 * k], rky = sr[3 * k + 1], rkz = sr[3 * k + 2];
      const float der = gram_dist(nrj, dot3(rjx, rjy, rjz, rkx, rky, rkz),
                                  nr[k]);
      float q, g;
      if (relat) {
        q = sub(mul(w, der / de), w);
        g = mul(w / de, sign_of(q));
      } else {
        q = sub(mul(w, der), mul(w, de));
        g = mul(w, sign_of(q));
      }
      term += fabsf(q);
      count += 1.f;
      if (MODE != MODE_FWD) {
        if (MODE == MODE_BWD) g = mul(g, ctt);
        const float coef = der > 0.f ? g / der : 0.f;
        rowsum += coef;
        mx += coef * rkx;
        my += coef * rky;
        mz += coef * rkz;
      }
    }
    if (MODE != MODE_BWD) {
      term_w += term;
      count_w += count;
    }
    if (MODE != MODE_FWD) {
      rowsum = warp_sum(rowsum);
      mx = warp_sum(mx);
      my = warp_sum(my);
      mz = warp_sum(mz);
      if (lane == 0) {
        float* gj = grad + ((size_t)tile * n_pad + j) * 3;
        gj[0] = 2.f * (rjx * rowsum - mx);
        gj[1] = 2.f * (rjy * rowsum - my);
        gj[2] = 2.f * (rjz * rowsum - mz);
      }
    }
  }
  if (MODE == MODE_BWD) return;

  __shared__ float red[2][kMaxWarps];
  term_w = warp_sum(term_w);
  count_w = warp_sum(count_w);
  if (lane == 0) {
    red[0][warp] = term_w;
    red[1][warp] = count_w;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = 0.f, c = 0.f;
    for (int i = 0; i < warps; ++i) {
      t += red[0][i];
      c += red[1][i];
    }
    partial[((size_t)tile * n_rb + rb) * 2 + 0] = t;
    partial[((size_t)tile * n_rb + rb) * 2 + 1] = c;
  }
}

// sums[tile] = the tile's row-block partials (term, count) in order
__global__ void part_dist_rows_finish_kernel(const float* __restrict__ partial,
                                             float* __restrict__ sums, int G,
                                             int n_rb) {
  const int tile = blockIdx.x * blockDim.x + threadIdx.x;
  if (tile >= G) return;
  float t = 0.f, c = 0.f;
  for (int rb = 0; rb < n_rb; ++rb) {
    t += partial[((size_t)tile * n_rb + rb) * 2 + 0];
    c += partial[((size_t)tile * n_rb + rb) * 2 + 1];
  }
  sums[tile * 2 + 0] = t;
  sums[tile * 2 + 1] = c;
}

template <int MODE>
int launch(const void* vp, const void* rp, const void* bone, const void* a,
           const void* n_real, const void* allone, const void* ct,
           void* partial, void* sums, void* grad, int G, int B, int n_pad,
           int w_mode, float w_threshold, float c_skip, int relat, int warps,
           cudaStream_t st) {
  const size_t smem = (size_t)n_pad * 9 * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      part_dist_rows_kernel<MODE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_rb = (n_pad + kRowsPerBlock - 1) / kRowsPerBlock;
  part_dist_rows_kernel<MODE><<<dim3(n_rb, G), 32 * warps, smem, st>>>(
      static_cast<const float*>(vp), static_cast<const float*>(rp),
      static_cast<const float*>(bone), static_cast<const float*>(a),
      static_cast<const int*>(n_real), static_cast<const int*>(allone),
      static_cast<const float*>(ct), static_cast<float*>(partial),
      static_cast<float*>(grad), B, n_pad, w_mode, w_threshold, c_skip,
      relat);
  if (MODE != MODE_BWD)
    part_dist_rows_finish_kernel<<<(G + 127) / 128, 128, 0, st>>>(
        static_cast<const float*>(partial), static_cast<float*>(sums), G,
        n_rb);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches on `stream` and returns a CUDA error code (0 on success).  The
// caller has checked shapes, types and contiguity, G <= 65535, and that
// the tile's n_pad * 36 bytes fit a block's shared memory.  vp, rp [G,
// n_pad, 3], bone [G, 3], a [G] float32 with tile g = part * B + b;
// n_real, allone [G / B] int32; ct [G] (mode 2); partial [G, ceil(n_pad /
// 32), 2] scratch; sums [G, 2] (modes 0, 1); grad [G, n_pad, 3] (modes 1,
// 2).  c_skip: threshold mode's acos band (`_acos_skip_cos`); warps: a
// block's, 1 .. 8 (`_rows_warps`).
int sh_part_dist(const void* vp, const void* rp, const void* bone,
                 const void* a, const void* n_real, const void* allone,
                 const void* ct, void* partial, void* sums, void* grad, int G,
                 int B, int n_pad, int w_mode, float w_threshold,
                 float c_skip, int relat, int mode, int warps,
                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (warps < 1 || warps > kMaxWarps)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (mode) {
    case MODE_FWD:
      return launch<MODE_FWD>(vp, rp, bone, a, n_real, allone, ct, partial,
                              sums, grad, G, B, n_pad, w_mode, w_threshold,
                              c_skip, relat, warps, st);
    case MODE_FWD_GRAD:
      return launch<MODE_FWD_GRAD>(vp, rp, bone, a, n_real, allone, ct,
                                   partial, sums, grad, G, B, n_pad, w_mode,
                                   w_threshold, c_skip, relat, warps, st);
    case MODE_BWD:
      return launch<MODE_BWD>(vp, rp, bone, a, n_real, allone, ct, partial,
                              sums, grad, G, B, n_pad, w_mode, w_threshold,
                              c_skip, relat, warps, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* sh_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
