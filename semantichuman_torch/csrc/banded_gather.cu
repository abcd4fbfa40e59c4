// Block-diagonal banded gather for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernels semantichuman_tpu/ops/pallas/
// banded_gather_pallas.py: _fwd_call (kernel _fwd_kernel) and _bwd_call
// (kernel _bwd_kernel), the custom VJP pair of diag_banded_gather.
//
// Forward.  xp [n_src, M] (M = B*C, any element type unweighted, float32
// weighted), the DiagBandSpec arrays base [nblk] and rel [nblk*R*S] int32
// (ops/banding.py), optional per-output-row weights w [n_rows] float32:
//
//   out[p, m] = w[p] * xp[base[p / (R*S)]*R + rel[p] - K*R, m]
//               (0 where rel[p] = -1)
//
// for the n_rows = N*S flat output rows.  The TPU kernel built one-hot
// selection tiles in VMEM and contracted them on the MXU, over a source
// padded by K zero blocks in front and lanes padded to 128.  None of that
// is needed here: a thread copies (or scales) one 2-16 byte unit of an
// output row, its source row read straight from xp; the wrapper checked
// once on the host that every in-band source row lies in [0, n_src).
// Unweighted, the kernel is a byte copy and takes any element type.
//
// Backward (the transpose, weights folded in):
//
//   dx[u, m] = sum_{j in [offs[u], offs[u+1])} wts[j] * ct[cols[j], m]
//
// over a CSR table the wrapper builds once per spec on the host: row u
// lists, in ascending order, the flat output rows p whose in-band source
// is u.  Every sum runs in that fixed order (no atomics), so results repeat
// bit for bit.  Rows are short (a real vertex is read by at most ~40 spiral
// entries) except the zero dummy row, which collects the in-band dummy
// pads of the last blocks; as in csr_reduce.cu, rows longer than a
// threshold are cut into chunks, each reduced by one block (8 warps over
// entries, lanes over channels) into a partial, and the partials of a row
// are then added in chunk order.
//
// Bound on an H100 SXM: bytes.  Each element of xp (ct) is read once and
// each output (dx) element written once, with at most one multiply per 4
// bytes moved; the index tables add 4-12 bytes per output (CSR) row.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = 8;
constexpr int kPerLane = 4;                 // channels per lane in a slice
constexpr int kSlice = 32 * kPerLane;       // channels per grid.z slice

int grid_for(long long total) {
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > (1 << 20)) blocks = 1 << 20;   // grid-stride beyond this
  return static_cast<int>(blocks < 1 ? 1 : blocks);
}

// ---- forward, unweighted: copy units of type U ---------------------------
template <typename U>
__global__ void __launch_bounds__(kThreads)
banded_copy_kernel(const U* __restrict__ xp, const int* __restrict__ base,
                   const int* __restrict__ rel, U* __restrict__ out,
                   int n_rows, int mu, int rs, int R, int KR) {
  const long long total = static_cast<long long>(n_rows) * mu;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x)
                     + threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int p = static_cast<int>(i / mu);
    const int m = static_cast<int>(i - static_cast<long long>(p) * mu);
    const int r = __ldg(rel + p);
    U v = U();
    if (r >= 0) {
      const int src = __ldg(base + p / rs) * R + r - KR;
      v = xp[static_cast<long long>(src) * mu + m];
    }
    out[i] = v;
  }
}

// ---- forward, weighted (float32, V floats a thread) ----------------------
template <int V> struct FVec;
template <> struct FVec<1> { using T = float; };
template <> struct FVec<4> { using T = float4; };

__device__ __forceinline__ float scale(float w, float v) {
  return __fmul_rn(w, v);
}
__device__ __forceinline__ float4 scale(float w, float4 v) {
  return make_float4(__fmul_rn(w, v.x), __fmul_rn(w, v.y),
                     __fmul_rn(w, v.z), __fmul_rn(w, v.w));
}

template <int V>
__global__ void __launch_bounds__(kThreads)
banded_weighted_kernel(const float* __restrict__ xp,
                       const int* __restrict__ base,
                       const int* __restrict__ rel,
                       const float* __restrict__ w, float* __restrict__ out,
                       int n_rows, int mv, int rs, int R, int KR) {
  using T = typename FVec<V>::T;
  const T* x = reinterpret_cast<const T*>(xp);
  T* o = reinterpret_cast<T*>(out);
  const long long total = static_cast<long long>(n_rows) * mv;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x)
                     + threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int p = static_cast<int>(i / mv);
    const int m = static_cast<int>(i - static_cast<long long>(p) * mv);
    const int r = __ldg(rel + p);
    T v = T();
    if (r >= 0) {
      const int src = __ldg(base + p / rs) * R + r - KR;
      v = scale(__ldg(w + p), x[static_cast<long long>(src) * mv + m]);
    }
    o[i] = v;
  }
}

// ---- backward: CSR reduce with optional weights ---------------------------
__device__ __forceinline__ void accum(float& acc, float w, float v) {
  acc = __fadd_rn(acc, __fmul_rn(w, v));
}
__device__ __forceinline__ void accum(float4& acc, float w, float4 v) {
  accum(acc.x, w, v.x);
  accum(acc.y, w, v.y);
  accum(acc.z, w, v.z);
  accum(acc.w, w, v.w);
}

template <int V>
__global__ void __launch_bounds__(kThreads)
bwd_short_kernel(const float* __restrict__ ct, const int* __restrict__ offs,
                 const int* __restrict__ cols, const float* __restrict__ wts,
                 float* __restrict__ dx, int n_src, int mv,
                 int long_thresh) {
  using T = typename FVec<V>::T;
  const T* g = reinterpret_cast<const T*>(ct);
  T* o = reinterpret_cast<T*>(dx);
  const long long total = static_cast<long long>(n_src) * mv;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x)
                     + threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int u = static_cast<int>(i / mv);
    const int m = static_cast<int>(i - static_cast<long long>(u) * mv);
    const int lo = __ldg(offs + u);
    const int hi = __ldg(offs + u + 1);
    if (hi - lo > long_thresh) continue;    // written by the long-row path
    T acc = T();
    for (int j = lo; j < hi; ++j) {
      const float wj = wts == nullptr ? 1.f : __ldg(wts + j);
      accum(acc, wj, g[static_cast<long long>(__ldg(cols + j)) * mv + m]);
    }
    o[i] = acc;
  }
}

__global__ void __launch_bounds__(32 * kWarps)
bwd_long_partial_kernel(const float* __restrict__ ct,
                        const int* __restrict__ cols,
                        const float* __restrict__ wts,
                        const int* __restrict__ chunk_lo,
                        const int* __restrict__ chunk_hi,
                        float* __restrict__ partial, int M) {
  __shared__ float red[kWarps][kSlice];
  const int k = blockIdx.x;
  const int c0 = blockIdx.y * kSlice;
  const int lane = threadIdx.x;
  const int warp = threadIdx.y;
  float acc[kPerLane];
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) acc[i] = 0.f;
  const int hi = chunk_hi[k];
  for (int j = chunk_lo[k] + warp; j < hi; j += kWarps) {
    const float* row = ct + static_cast<long long>(cols[j]) * M;
    const float wj = wts == nullptr ? 1.f : wts[j];
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      const int c = c0 + lane + 32 * i;
      if (c < M) accum(acc[i], wj, row[c]);
    }
  }
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) red[warp][lane + 32 * i] = acc[i];
  __syncthreads();
  if (warp != 0) return;
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const int c = c0 + lane + 32 * i;
    if (c >= M) continue;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s = __fadd_rn(s, red[w][lane + 32 * i]);
    partial[static_cast<long long>(k) * M + c] = s;
  }
}

__global__ void bwd_long_finish_kernel(const float* __restrict__ partial,
                                       const int* __restrict__ long_rows,
                                       const int* __restrict__ chunk_offs,
                                       float* __restrict__ dx, int M) {
  const int i = blockIdx.x;
  const int u = long_rows[i];
  for (int c = blockIdx.y * blockDim.x + threadIdx.x; c < M;
       c += gridDim.y * blockDim.x) {
    float s = 0.f;
    for (int k = chunk_offs[i]; k < chunk_offs[i + 1]; ++k)
      s = __fadd_rn(s, partial[static_cast<long long>(k) * M + c]);
    dx[static_cast<long long>(u) * M + c] = s;
  }
}

template <typename U>
void launch_copy(const void* xp, const void* base, const void* rel,
                 void* out, int n_rows, int row_bytes, int rs, int R, int KR,
                 cudaStream_t st) {
  const int mu = row_bytes / static_cast<int>(sizeof(U));
  banded_copy_kernel<U><<<grid_for(static_cast<long long>(n_rows) * mu),
                          kThreads, 0, st>>>(
      static_cast<const U*>(xp), static_cast<const int*>(base),
      static_cast<const int*>(rel), static_cast<U*>(out), n_rows, mu, rs, R,
      KR);
}

}  // namespace

extern "C" {

// Forward on `stream`; returns cudaGetLastError() (0 on success).  `w` is
// NULL for the unweighted gather, which copies `unit`-byte pieces (16, 8, 4
// or 2; a divisor of row_bytes and of both pointers' alignment).  With `w`,
// xp and out are float32 and unit is 16 (float4) or 4.  The caller has
// checked shapes, types, contiguity and that every in-band source row
// base[p / rs]*R + rel[p] - KR lies in [0, n_src).
int sh_banded_gather_fwd(const void* xp, const void* base, const void* rel,
                         const void* w, void* out, int n_rows, int row_bytes,
                         int unit, int rs, int R, int KR, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_rows <= 0 || row_bytes <= 0) return 0;
  if (w != nullptr) {
    const int m = row_bytes / 4;
    const int* b = static_cast<const int*>(base);
    const int* r = static_cast<const int*>(rel);
    const float* x = static_cast<const float*>(xp);
    const float* wf = static_cast<const float*>(w);
    float* o = static_cast<float*>(out);
    if (unit == 16) {
      banded_weighted_kernel<4><<<grid_for(static_cast<long long>(n_rows)
                                           * (m / 4)),
                                  kThreads, 0, st>>>(x, b, r, wf, o, n_rows,
                                                     m / 4, rs, R, KR);
    } else if (unit == 4) {
      banded_weighted_kernel<1><<<grid_for(static_cast<long long>(n_rows)
                                           * m),
                                  kThreads, 0, st>>>(x, b, r, wf, o, n_rows,
                                                     m, rs, R, KR);
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(cudaGetLastError());
  }
  switch (unit) {
    case 16: launch_copy<uint4>(xp, base, rel, out, n_rows, row_bytes, rs, R,
                                KR, st); break;
    case 8: launch_copy<uint2>(xp, base, rel, out, n_rows, row_bytes, rs, R,
                               KR, st); break;
    case 4: launch_copy<unsigned int>(xp, base, rel, out, n_rows, row_bytes,
                                      rs, R, KR, st); break;
    case 2: launch_copy<unsigned short>(xp, base, rel, out, n_rows,
                                        row_bytes, rs, R, KR, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Backward on `stream`: float32 ct [n_out, M] -> dx [n_src, M]; `wts` NULL
// or float32 [nnz] in CSR order; vec 4 (M % 4 == 0, 16-byte aligned
// pointers) or 1.  Rows longer than long_thresh are exactly the n_long
// rows of long_rows, cut into the n_chunks chunks [chunk_lo[k],
// chunk_hi[k]), chunks chunk_offs[i]..chunk_offs[i+1] of long row i; the
// caller allocates `partial` [n_chunks, M].
int sh_banded_gather_bwd(const void* ct, const void* offs, const void* cols,
                         const void* wts, const void* chunk_lo,
                         const void* chunk_hi, const void* long_rows,
                         const void* chunk_offs, void* partial, void* dx,
                         int n_src, int M, int vec, int long_thresh,
                         int n_long, int n_chunks, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_src <= 0 || M <= 0) return 0;
  const float* g = static_cast<const float*>(ct);
  const int* of = static_cast<const int*>(offs);
  const int* cl = static_cast<const int*>(cols);
  const float* wf = static_cast<const float*>(wts);
  float* o = static_cast<float*>(dx);
  if (vec == 4) {
    bwd_short_kernel<4><<<grid_for(static_cast<long long>(n_src) * (M / 4)),
                          kThreads, 0, st>>>(g, of, cl, wf, o, n_src, M / 4,
                                             long_thresh);
  } else if (vec == 1) {
    bwd_short_kernel<1><<<grid_for(static_cast<long long>(n_src) * M),
                          kThreads, 0, st>>>(g, of, cl, wf, o, n_src, M,
                                             long_thresh);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_long > 0) {
    const dim3 grid_part(n_chunks, (M + kSlice - 1) / kSlice);
    bwd_long_partial_kernel<<<grid_part, dim3(32, kWarps), 0, st>>>(
        g, cl, wf, static_cast<const int*>(chunk_lo),
        static_cast<const int*>(chunk_hi), static_cast<float*>(partial), M);
    const int slices = (M + 255) / 256;
    const dim3 grid_fin(n_long, slices > 65535 ? 65535 : slices);
    bwd_long_finish_kernel<<<grid_fin, 256, 0, st>>>(
        static_cast<const float*>(partial),
        static_cast<const int*>(long_rows),
        static_cast<const int*>(chunk_offs), o, M);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* sh_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
