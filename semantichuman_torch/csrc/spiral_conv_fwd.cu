// Spiral convolution forward for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel semantichuman_tpu/ops/pallas/spiral_conv_pallas.py:
// spiral_conv_fused (kernel _kernel), whose XLA form is
// semantichuman_tpu/ops/spiral_conv.py:spiral_conv_take, and the port's
// first kernel for it (csrc/spiral_conv.cu, kept as the yardstick).  It
// computes
//
//   y[b, v, n] = act(sum_{s, c} x[b, spiral[v, s], c] * W[s*C + c, n] + bias[n])
//   y[b, V1-1, :] = 0                                   (the dummy row)
//
// x [B, V1, C] in float32 or bfloat16, spiral [V1, S] int32, W [S*C, Co] in
// x's type, bias [Co] float32, y [B, V1, Co] float32.  Products and sums are
// float32 on the CUDA cores (a bf16 x bf16 product is exact in f32); every
// sum runs in a fixed order and nothing is added atomically, so two runs
// give the same bits.
//
// Bound on an H100 SXM: operations.  The nine convs of the default model at
// trunk batch 384 do 2*B*V1*S*C*Co = 224 GFLOP, 3.34 ms at the 67 TFLOP/s
// f32 peak; the bytes they must move (x, W, spiral, bias once, y once) take
// 0.75 ms at 3.35 TB/s.  The first kernel reached 16 % of that bound:
// it tiled one batch element per block, divided per gathered element, read
// 4-byte scalars, had one shared buffer (load, barrier, multiply, barrier)
// and 4 x 4 register tiles fed by 8 shared loads per 16 FMAs.
//
// Design.  The GEMM's rows are the B*V1 (b, v) pairs in order, so a tile
// holds neighbouring vertices of one batch element (their spiral rows share
// most sources, which then come from L1) and the weight tile is loaded once
// per BM rows whatever B is; the last ragged tile exists once, not once per
// batch element.  The wrapper picks the tile from the shape, smaller where
// the grid would leave the card half empty (B = 1 serving).  Per block:
//
// - the tile's source offsets (b*V1 + spiral[v, s]) * C are computed once
//   into shared memory, [S][BM];
// - K = S*C is walked in chunks of BK = 32: several whole spiral positions
//   when C <= 32, else a 32-channel slice of one position.  A thread always
//   loads the same slot of a chunk, so its (position, channel) within the
//   chunk is found once: no divide per gathered element;
// - a chunk's x rows and W rows land in a two-stage shared-memory ring
//   through 16-byte cp.async (f32 with C % 4 == 0, bf16 with C % 8 == 0; W
//   likewise by Co), issued a chunk ahead of the multiply, one barrier per
//   chunk; other rows are staged element by element through registers.
//   The copies go through L1 (.ca): a vertex's S sources are mostly its
//   neighbours' too;
// - each thread keeps a TM x TN tile (8 x 8 for Co = 128 and Co = 64 from
//   wide inputs, 8 x 4 at Co = 32, 4 x 4 for Co = 16 or small grids) and
//   reads x four k at a time (two at 8 x 8) and W four outputs at a time:
//   at 8 x 8, 12 shared loads per 128 FMAs; __launch_bounds__ holds each
//   tile to 128 registers (170 for the 8 x 8 tile of 128 threads), two to
//   eight blocks an SM;
// - the epilogue adds bias, applies the activation, writes the dummy row as
//   exactly 0 and stores four outputs at once where Co % 4 == 0.
//
// Outputs of at most four channels (the last conv, 16 -> 3) would leave most
// of a tile's columns empty, and rows of 3 channels (the first conv) cannot
// go in 16-byte pieces.  There one thread computes one output row from W
// held in shared memory (float4s per k): bound by the bytes of x it gathers,
// not by FMAs.
//
// What the card showed (PERF.md has the numbers): the convs with Co >= 32 run
// at 36-53 % of the f32 peak; the level-0 convs wait on their gathers (each
// x row is asked for S times, and a tile of 128 vertices reaches a few
// hundred rows beyond itself), which staging a block's window of source rows
// in shared memory once would cut.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBK = 32;       // k per chunk
constexpr int kStages = 2;    // shared-memory ring
constexpr int kMaxSmem = 232448;
constexpr int kNarrowThreads = 128;

enum Activation {
  ACT_IDENTITY = 0,
  ACT_ELU = 1,
  ACT_RELU = 2,
  ACT_LEAKY_RELU = 3,
  ACT_SIGMOID = 4,
  ACT_TANH = 5,
};

__device__ __forceinline__ float apply_act(float v, int act) {
  switch (act) {
    case ACT_ELU: return v > 0.f ? v : expm1f(v);
    case ACT_RELU: return fmaxf(v, 0.f);
    case ACT_LEAKY_RELU: return v >= 0.f ? v : 0.02f * v;
    case ACT_SIGMOID: return 1.f / (1.f + expf(-v));
    case ACT_TANH: return tanhf(v);
    default: return v;
  }
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// four consecutive elements as f32 (p aligned to four elements)
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  float4 r;
  r.x = __uint_as_float(raw.x << 16);
  r.y = __uint_as_float(raw.x & 0xffff0000u);
  r.z = __uint_as_float(raw.y << 16);
  r.w = __uint_as_float(raw.y & 0xffff0000u);
  return r;
}

// two consecutive elements as f32 in .x, .y (p aligned to two elements)
__device__ __forceinline__ float4 load2(const float* p) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  return make_float4(v.x, v.y, 0.f, 0.f);
}
__device__ __forceinline__ float4 load2(const __nv_bfloat16* p) {
  const unsigned raw = *reinterpret_cast<const unsigned*>(p);
  return make_float4(__uint_as_float(raw << 16),
                     __uint_as_float(raw & 0xffff0000u), 0.f, 0.f);
}

__device__ __forceinline__ float lane(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* g) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(g));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// MB: blocks an SM the register budget is set for (__launch_bounds__)
template <typename T, int BM, int BN, int TM, int TN, int MB>
struct Tile {
  static constexpr int NTX = BN / TN;             // threads along outputs
  static constexpr int NTY = BM / TM;             // threads along rows
  static constexpr int NT = NTX * NTY;
  static constexpr int NH = TN / 4;               // float4 groups along n
  // k per shared read of x: two for the 8 x 8 tile, whose 64 sums and
  // 8 x 4 x values would not leave room under 128 registers
  static constexpr int KA = TM * TN >= 64 ? 2 : 4;
  static constexpr int EPU = 16 / sizeof(T);      // elements per 16 bytes
  static constexpr int LDA = kBK + EPU;           // padded x row in smem
  static constexpr int A_ELEMS = BM * LDA;
  static constexpr int W_ELEMS = kBK * BN;
  static constexpr int STAGE_BYTES = (A_ELEMS + W_ELEMS) * sizeof(T);
  static int smem(int S) { return kStages * STAGE_BYTES + BM * S * 4; }
};

template <typename T, int BM, int BN, int TM, int TN, int MB>
__global__ void __launch_bounds__(Tile<T, BM, BN, TM, TN, MB>::NT, MB)
sc_fwd_tile_kernel(const T* __restrict__ x, const int* __restrict__ spiral,
                   const T* __restrict__ w, const float* __restrict__ bias,
                   float* __restrict__ y, int M, int V1, int C, int S, int Co,
                   int act, int vecx, int vecw) {
  using Sh = Tile<T, BM, BN, TM, TN, MB>;
  constexpr int NT = Sh::NT;
  constexpr int NTX = Sh::NTX;
  constexpr int NTY = Sh::NTY;
  constexpr int NH = Sh::NH;
  constexpr int EPU = Sh::EPU;
  constexpr int LDA = Sh::LDA;
  static_assert(NT % kBK == 0 && BM % (NT / kBK) == 0, "x element slots");
  static_assert(NT % (kBK / EPU) == 0 && BM % (NT / (kBK / EPU)) == 0,
                "x 16-byte slots");
  static_assert(TN % 4 == 0 && NTX * 4 * NH == BN, "output tile");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);
  int* tab = reinterpret_cast<int*>(smem_raw + kStages * Sh::STAGE_BYTES);

  const int tid = threadIdx.x;
  const int tx = tid % NTX;
  const int ty = tid / NTX;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  // source offsets of the tile's rows, [S][BM]; rows past M read row 0
  for (int e = tid; e < BM * S; e += NT) {
    const int m = e % BM;
    const int s = e / BM;
    const int r = m0 + m;
    int off = 0;
    if (r < M) {
      const int b = r / V1;
      const int v = r - b * V1;
      off = (b * V1 + __ldg(spiral + (size_t)v * S + s)) * C;
    }
    tab[e] = off;
  }

  // the chunk layout: C <= kBK takes `spc` whole positions a chunk, else
  // one position's 32-channel slices
  const bool whole = C <= kBK;
  const int spc = whole ? kBK / C : 1;
  const int kch = whole ? spc * C : kBK;
  const int cps = whole ? 1 : (C + kBK - 1) / kBK;  // chunks a position
  const int n_chunks = whole ? (S + spc - 1) / spc : S * cps;

  // the fixed slot this thread loads in every chunk: 16-byte units when
  // vecx, else single elements; (ds, cc) = its position and channel
  // relative to the chunk's start
  const int slot = vecx ? (tid % (kBK / EPU)) * EPU : tid % kBK;
  const int ds = whole ? slot / C : 0;
  const int cc = whole ? slot - ds * C : slot;

  // chunk t starts at position ls, channel lc0
  auto load = [&](int t, int buf) {
    const int ls = whole ? t * spc : t / cps;
    const int lc0 = whole ? 0 : (t - ls * cps) * kBK;
    T* As = ring + buf * (Sh::A_ELEMS + Sh::W_ELEMS);
    T* Ws = As + Sh::A_ELEMS;
    const int k0 = ls * C + lc0;
    const int kc = whole ? min(kch, S * C - k0) : min(kBK, C - lc0);
    const int s_slot = ls + ds;
    const int c_slot = lc0 + cc;
    const bool live = slot < kc;
    const int* trow = tab + (live ? s_slot : 0) * BM;
    if (vecx) {
      constexpr int UPR = kBK / EPU;
      constexpr int RS = NT / UPR;
      const int mr = tid / UPR;
#pragma unroll
      for (int j = 0; j < BM / RS; ++j) {
        const int m = mr + j * RS;
        T* dst = As + m * LDA + slot;
        if (live)
          cp_async16(dst, x + trow[m] + c_slot);
        else
          *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
      }
    } else {
      constexpr int RS = NT / kBK;
      const int mr = tid / kBK;
#pragma unroll 4
      for (int j = 0; j < BM / RS; ++j) {
        const int m = mr + j * RS;
        As[m * LDA + slot] = live ? x[trow[m] + c_slot] : T(0.f);
      }
    }
    if (vecw) {
      constexpr int WU = BN / EPU;
#pragma unroll 1
      for (int u = tid; u < kBK * WU; u += NT) {
        const int kk = u / WU;
        const int n = (u - kk * WU) * EPU;
        T* dst = Ws + kk * BN + n;
        if (kk < kc && n0 + n < Co)
          cp_async16(dst, w + (size_t)(k0 + kk) * Co + n0 + n);
        else
          *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
      }
    } else {
      for (int e = tid; e < kBK * BN; e += NT) {
        const int kk = e / BN;
        const int n = e - kk * BN;
        Ws[e] = (kk < kc && n0 + n < Co) ? w[(size_t)(k0 + kk) * Co + n0 + n]
                                         : T(0.f);
      }
    }
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  __syncthreads();  // the offset table
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_chunks) load(st, st);
    cp_async_commit();
  }
  for (int t = 0; t < n_chunks; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int tl = t + kStages - 1;
    if (tl < n_chunks) load(tl, tl % kStages);
    cp_async_commit();

    const T* As = ring + (t % kStages) * (Sh::A_ELEMS + Sh::W_ELEMS);
    const T* Ws = As + Sh::A_ELEMS;
    constexpr int KA = Sh::KA;
#pragma unroll
    for (int ka = 0; ka < kBK; ka += KA) {
      float4 a[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const T* p = As + (ty + i * NTY) * LDA + ka;
        a[i] = KA == 4 ? load4(p) : load2(p);
      }
#pragma unroll
      for (int kk = 0; kk < KA; ++kk) {
        float4 bv[NH];
#pragma unroll
        for (int h = 0; h < NH; ++h)
          bv[h] = load4(Ws + (ka + kk) * BN + h * (BN / NH) + tx * 4);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float av = lane(a[i], kk);
#pragma unroll
          for (int h = 0; h < NH; ++h) {
            acc[i][h * 4 + 0] = fmaf(av, bv[h].x, acc[i][h * 4 + 0]);
            acc[i][h * 4 + 1] = fmaf(av, bv[h].y, acc[i][h * 4 + 1]);
            acc[i][h * 4 + 2] = fmaf(av, bv[h].z, acc[i][h * 4 + 2]);
            acc[i][h * 4 + 3] = fmaf(av, bv[h].w, acc[i][h * 4 + 3]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  // epilogue: bias, activation, the dummy row as exactly 0
  float bias_v[TN];
#pragma unroll
  for (int h = 0; h < NH; ++h)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + h * (BN / NH) + tx * 4 + j;
      bias_v[h * 4 + j] = n < Co ? bias[n] : 0.f;
    }
  const bool vecy = (Co % 4) == 0;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = m0 + ty + i * NTY;
    if (r >= M) continue;
    const int v = r - (r / V1) * V1;
    const bool dummy = v == V1 - 1;
    float* yr = y + (size_t)r * Co;
#pragma unroll
    for (int h = 0; h < NH; ++h) {
      const int n = n0 + h * (BN / NH) + tx * 4;
      if (n >= Co) continue;
      float o[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        o[j] = dummy ? 0.f : apply_act(acc[i][h * 4 + j] + bias_v[h * 4 + j], act);
      if (vecy) {
        *reinterpret_cast<float4*>(yr + n) = make_float4(o[0], o[1], o[2], o[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (n + j < Co) yr[n + j] = o[j];
      }
    }
  }
}

// One thread per output row (b, v) for narrow outputs (Co <= 4 * NQ): W as
// NQ float4 per k in shared memory (outputs past Co zero), the row's S
// source rows read through L1, four channels at a time where C allows.
// Co <= 4 (the last conv, 16 -> 3) takes NQ = 1; rows of fewer than 16
// bytes (the first conv's C = 3) with Co <= 16 take NQ = 4, where the tile
// kernel would stage them element by element.
template <typename T, int NQ>
__global__ void __launch_bounds__(kNarrowThreads)
sc_fwd_narrow_kernel(const T* __restrict__ x, const int* __restrict__ spiral,
                     const T* __restrict__ w, const float* __restrict__ bias,
                     float* __restrict__ y, int M, int V1, int C, int S,
                     int Co, int act, int vecx) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float4* ws = reinterpret_cast<float4*>(smem_raw);  // [S*C][NQ]
  const int K = S * C;
  for (int e = threadIdx.x; e < K * NQ; e += kNarrowThreads) {
    const int k = e / NQ;
    const int n0 = (e - k * NQ) * 4;
    const T* wr = w + (size_t)k * Co;
    float4 r = make_float4(0.f, 0.f, 0.f, 0.f);
    if (n0 < Co) r.x = to_f32(wr[n0]);
    if (n0 + 1 < Co) r.y = to_f32(wr[n0 + 1]);
    if (n0 + 2 < Co) r.z = to_f32(wr[n0 + 2]);
    if (n0 + 3 < Co) r.w = to_f32(wr[n0 + 3]);
    ws[e] = r;
  }
  __syncthreads();
  const int r = blockIdx.x * kNarrowThreads + threadIdx.x;
  if (r >= M) return;
  const int b = r / V1;
  const int v = r - b * V1;
  float* yr = y + (size_t)r * Co;
  if (v == V1 - 1) {
    for (int n = 0; n < Co; ++n) yr[n] = 0.f;
    return;
  }
  const int* sp = spiral + (size_t)v * S;
  const T* xb = x + (size_t)b * V1 * C;
  float4 acc[NQ];
#pragma unroll
  for (int q = 0; q < NQ; ++q) acc[q] = make_float4(0.f, 0.f, 0.f, 0.f);
  auto fma_k = [&](float e, const float4* wk) {
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const float4 wv = wk[q];
      acc[q].x = fmaf(e, wv.x, acc[q].x);
      acc[q].y = fmaf(e, wv.y, acc[q].y);
      acc[q].z = fmaf(e, wv.z, acc[q].z);
      acc[q].w = fmaf(e, wv.w, acc[q].w);
    }
  };
  for (int s = 0; s < S; ++s) {
    const T* row = xb + (size_t)__ldg(sp + s) * C;
    const float4* wk = ws + (size_t)s * C * NQ;
    if (vecx) {
      for (int c = 0; c < C; c += 4) {
        const float4 xv = load4(row + c);
        fma_k(xv.x, wk + (c + 0) * NQ);
        fma_k(xv.y, wk + (c + 1) * NQ);
        fma_k(xv.z, wk + (c + 2) * NQ);
        fma_k(xv.w, wk + (c + 3) * NQ);
      }
    } else {
      for (int c = 0; c < C; ++c) fma_k(to_f32(row[c]), wk + c * NQ);
    }
  }
#pragma unroll
  for (int q = 0; q < NQ; ++q)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = 4 * q + j;
      if (n < Co) yr[n] = apply_act(lane(acc[q], j) + bias[n], act);
    }
}

template <typename K>
cudaError_t allow_smem(K kernel) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
}

template <typename T, int BM, int BN, int TM, int TN, int MB>
cudaError_t tile_launch(const void* x, const int* spiral, const void* w,
                        const float* bias, float* y, int M, int V1, int C,
                        int S, int Co, int act, int bm, int bn, int smem,
                        int nt, int mb, int vecx, int vecw, cudaStream_t st) {
  using Sh = Tile<T, BM, BN, TM, TN, MB>;
  // the caller's plan (and the tile table it picks from) must be this
  // instance's
  if (bm != BM || bn != BN || nt != Sh::NT || mb != MB ||
      smem != Sh::smem(S) || smem > kMaxSmem)
    return cudaErrorInvalidValue;
  auto kernel = sc_fwd_tile_kernel<T, BM, BN, TM, TN, MB>;
  static bool ready = false;
  if (!ready) {
    const cudaError_t err = allow_smem(kernel);
    if (err != cudaSuccess) return err;
    ready = true;
  }
  const dim3 grid((M + BM - 1) / BM, (Co + BN - 1) / BN);
  kernel<<<grid, Sh::NT, smem, st>>>(
      static_cast<const T*>(x), spiral, static_cast<const T*>(w), bias, y, M,
      V1, C, S, Co, act, vecx, vecw);
  return cudaGetLastError();
}

template <typename T, int NQ>
cudaError_t narrow_launch(const void* x, const int* spiral, const void* w,
                          const float* bias, float* y, int M, int V1, int C,
                          int S, int Co, int act, int bm, int bn, int smem,
                          int nt, int mb, int vecx, cudaStream_t st) {
  // mb 0: __launch_bounds__ sets no blocks an SM
  if (bm != kNarrowThreads || nt != kNarrowThreads || mb != 0 ||
      bn != 4 * NQ || Co > 4 * NQ || smem != S * C * 16 * NQ ||
      smem > kMaxSmem)
    return cudaErrorInvalidValue;
  auto kernel = sc_fwd_narrow_kernel<T, NQ>;
  static bool ready = false;
  if (!ready) {
    const cudaError_t err = allow_smem(kernel);
    if (err != cudaSuccess) return err;
    ready = true;
  }
  kernel<<<(M + kNarrowThreads - 1) / kNarrowThreads, kNarrowThreads, smem,
           st>>>(static_cast<const T*>(x), spiral, static_cast<const T*>(w),
                 bias, y, M, V1, C, S, Co, act, vecx);
  return cudaGetLastError();
}

// The tile ids of ops/spiral_conv.py's _FWD_TILES.
template <typename T>
cudaError_t dispatch(int tile, const void* x, const int* spiral,
                     const void* w, const float* bias, float* y, int M,
                     int V1, int C, int S, int Co, int act, int bm, int bn,
                     int smem, int nt, int mb, int vecx, int vecw,
                     cudaStream_t st) {
#define SH_TILE(BM, BN, TM, TN, MB)                                          \
  return tile_launch<T, BM, BN, TM, TN, MB>(x, spiral, w, bias, y, M, V1, C, \
                                            S, Co, act, bm, bn, smem, nt,    \
                                            mb, vecx, vecw, st)
  // MB gives 128 registers a thread, except 170 for the 8 x 8 tile of 128
  // threads, which spills at 128
  switch (tile) {
    case 0: SH_TILE(128, 128, 8, 8, 2);
    case 1: SH_TILE(128, 64, 8, 8, 3);
    case 2: SH_TILE(64, 64, 4, 4, 2);
    case 3: SH_TILE(128, 32, 8, 4, 4);
    case 4: SH_TILE(64, 32, 4, 4, 4);
    case 5: SH_TILE(128, 16, 4, 4, 4);
    case 6: SH_TILE(64, 16, 4, 4, 8);
    case 7:
      return narrow_launch<T, 1>(x, spiral, w, bias, y, M, V1, C, S, Co, act,
                                 bm, bn, smem, nt, mb, vecx, st);
    case 8:
      return narrow_launch<T, 4>(x, spiral, w, bias, y, M, V1, C, S, Co, act,
                                 bm, bn, smem, nt, mb, vecx, st);
    default: return cudaErrorInvalidValue;
  }
#undef SH_TILE
}

}  // namespace

extern "C" {

// Launches the tile (or narrow) kernel `tile` on `stream` and returns a
// CUDA error code (0 on success).  The caller has checked shapes, types,
// contiguity, 16-byte alignment where vecx/vecw ask for it, and that x
// holds fewer than 2^31 elements; bm, bn, smem, the threads nt and the
// blocks an SM mb are its plan, which must match the instance.
int sh_spiral_conv_fwd_tiled(const void* x, const void* spiral, const void* w,
                             const void* bias, void* y, int B, int V1, int C,
                             int S, int Co, int act, int x_is_bf16, int tile,
                             int bm, int bn, int smem, int nt, int mb,
                             int vecx, int vecw, void* stream) {
  const int* sp = static_cast<const int*>(spiral);
  const float* bi = static_cast<const float*>(bias);
  float* out = static_cast<float*>(y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = B * V1;
  cudaError_t err;
  if (x_is_bf16)
    err = dispatch<__nv_bfloat16>(tile, x, sp, w, bi, out, M, V1, C, S, Co,
                                  act, bm, bn, smem, nt, mb, vecx, vecw, st);
  else
    err = dispatch<float>(tile, x, sp, w, bi, out, M, V1, C, S, Co, act, bm,
                          bn, smem, nt, mb, vecx, vecw, st);
  return static_cast<int>(err);
}

const char* sh_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
