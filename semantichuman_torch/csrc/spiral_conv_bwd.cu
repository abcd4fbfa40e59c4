// Spiral convolution backward for Hopper (sm_90a), plain C interface.
//
// Replaces the backward of the TPU kernel semantichuman_tpu/ops/pallas/
// spiral_conv_pallas.py:spiral_conv_fused, which the JAX package takes as
// XLA's autodiff of semantichuman_tpu/ops/spiral_conv.py:spiral_conv_take,
// and the port's earlier route for it: torch matmuls around two buffers of
// shape [B, V1, S*C] (the gathered x for dW, dy' W^T for dx) plus the
// csr_reduce kernel.  With dy' = dy * act'(y), dummy row zero, it computes
//
//   dW[s*C + c, n] = sum_{b, v} x[b, spiral[v, s], c] * dy'[b, v, n]
//   dx[b, u, c]    = sum_{j in row u of the inverse table}
//                      sum_n dy'[b, v_j, n] * W[s_j*C + c, n],  j = v_j*S + s_j
//
// x [B, V1, C] and W [S*C, Co] in float32 or bfloat16 (converted to f32 on
// load), dy' [B, V1, Co] float32, dW and dx float32.  Products and sums are
// f32 on the CUDA cores, every sum runs in a fixed order and nothing is
// added atomically, so two runs give the same bits.
//
// Bound on an H100 SXM: operations.  The nine convs of one training step at
// trunk batch 384 do 4*B*V1*S*C*Co = 446 GFLOP in the two products, 6.7 ms at
// the 67 TFLOP/s f32 peak, against 5 GB (1.5 ms at 3.35 TB/s) for x, dy', dx,
// W and the tables.  The earlier route wrote and read back 15 GB of
// [B, V1, S*C] buffers twice, 59 GB a step, and so ran as if bound by bytes
// that need not exist.  Neither kernel here writes anything of width S*C to
// device memory.
//
// dW is a gathered SGEMM whose output stays on chip.  The B*V1 rows are cut
// into chunks; a block takes one chunk and one [BKT x BN] tile of dW, walks
// its rows 16 at a time, gathers their x rows (whole 16-byte pieces where
// C*4 is a multiple of 16, single elements for C = 3) and stages the dy' rows
// beside them in shared memory, and every thread accumulates an 8 x TN tile in
// registers.  The next stage's loads are issued before the current stage is
// multiplied: float32 rows go straight into the second buffer with cp.async,
// everything else into registers that are stored there after the multiply.
// Narrow outputs (Co <= 32) leave few threads per tile, so RG groups of
// threads take alternate rows and are added in group order at the end.  Each
// block writes its partial [K, Co] tile into scratch that the caller
// allocated; a second kernel adds the partials in chunk order.
//
// dx is a product per output row u with the batch as the tile's rows: all
// batch elements share row u's entry list, so dx[:, u, :] = sum_j
// dy'[:, v_j, :] [B x Co] . W_{s_j}^T [Co x C].  One warp takes one (u, batch
// tile) and accumulates an 8 x 8 tile per lane; per entry and 16 output
// channels it copies the dy' rows (contiguous pieces of Co floats) and the
// weight slab into its own shared memory with cp.async, double-buffered, and
// multiplies four channels at a time from rows padded against bank conflicts.
// Warps never wait for each other.  dy' rows are read by the S neighbouring
// rows u that gather them; the launch orders the batch tiles of one u next to
// each other, so that the warps of a block ask for the same weight slabs at
// about the same time (L1) and the card works on a few hundred neighbouring u
// at once, whose dy' rows the 50 MB L2 holds.  Rows longer than the caller's
// threshold (the dummy row, which every spiral pad points at: 34,041 of
// level 0's 103,395 entries) would serialise one warp, so they take
//   sum_j dy'[v_j] W_{s_j}^T = sum_s (sum_{j: s_j = s} dy'[v_j]) W_s^T :
// per chunk of the row S segmented sums of dy' rows in entry order, the chunk
// sums added in chunk order, then one small product.
//
// What the card showed: both kernels run at the rate the L2 delivers gathered
// rows to the SMs (about 2 TB/s: every x row and every dy' row is asked for S
// times), not at the rate of the FMAs; PERF.md has the numbers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSMs = 132;

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

__device__ __forceinline__ void fma4(float& acc, const float4& a,
                                     const float4& b) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  acc = fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ void cp_async16_cg(void* smem, const void* g) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(g));
}
__device__ __forceinline__ void cp_async16_ca(void* smem, const void* g) {
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

// ---------------------------------------------------------------- dW -------

constexpr int kBR = 16;  // rows per stage

template <int BKT, int BN, int TN, int RG>
struct DwShape {
  static constexpr int NTY = BKT / 8;
  static constexpr int NTX = BN / TN;
  static constexpr int NT = NTY * NTX * RG;
  static constexpr int QPR = BKT / 4;     // x units per row
  static constexpr int RSTEP = NT / QPR;  // rows between a thread's units
  static constexpr int GU = (kBR + RSTEP - 1) / RSTEP;      // x units/thread
  static constexpr int DU = (kBR * BN / 4 + NT - 1) / NT;   // dy units/thread
  static constexpr int STAGE = kBR * (BKT + BN);
  static constexpr int SMEM =
      (RG > 1 && BKT * BN > 2 * STAGE) ? BKT * BN : 2 * STAGE;
};

// A thread gathers the same four k of every row it loads: their spiral
// slot s and channel c, found once (slot -1: k outside K).  With whole
// 16-byte pieces (vec) only the first pair is used.
struct KInfo {
  int s[4];
  int c[4];
};

__device__ __forceinline__ KInfo k_info(int k, int K, int C) {
  KInfo r;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kk = k + i;
    r.s[i] = kk < K ? kk / C : -1;
    r.c[i] = kk < K ? kk - r.s[i] * C : 0;
  }
  return r;
}

// Four consecutive k of vertex v's gathered x in batch element b.
template <typename T>
__device__ __forceinline__ float4 gather_unit(
    const T* __restrict__ x, const int* __restrict__ spiral, int b, int v,
    int V1, int C, int S, const KInfo& ki, bool vec) {
  const int* sp = spiral + (size_t)v * S;
  const T* xb = x + (size_t)b * V1 * C;
  if (vec) return load4(xb + (size_t)__ldg(sp + ki.s[0]) * C + ki.c[0]);
  float e[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    e[i] = ki.s[i] >= 0
               ? to_f32(xb[(size_t)__ldg(sp + ki.s[i]) * C + ki.c[i]])
               : 0.f;
  return make_float4(e[0], e[1], e[2], e[3]);
}

__device__ __forceinline__ float4 dy_unit(const float* __restrict__ dy, int m,
                                          int m_end, int n, int Co, bool vec) {
  float4 r = make_float4(0.f, 0.f, 0.f, 0.f);
  if (m >= m_end || n >= Co) return r;
  const float* p = dy + (size_t)m * Co + n;
  if (vec) return load4(p);
  r.x = p[0];
  if (n + 1 < Co) r.y = p[1];
  if (n + 2 < Co) r.z = p[2];
  if (n + 3 < Co) r.w = p[3];
  return r;
}

template <typename T, int BKT, int BN, int TN, int RG>
__global__ void __launch_bounds__(DwShape<BKT, BN, TN, RG>::NT)
dw_partial_kernel(const T* __restrict__ x, const int* __restrict__ spiral,
                  const float* __restrict__ dy, float* __restrict__ partial,
                  int M, int V1, int C, int S, int Co, int rows_per_chunk,
                  int vecx, int vecd) {
  using Sh = DwShape<BKT, BN, TN, RG>;
  constexpr int NT = Sh::NT;
  static_assert(NT % Sh::QPR == 0, "a thread's x units share their k");
  constexpr int TNH = TN / 4;  // float4 halves along n
  extern __shared__ __align__(16) float dw_smem[];
  float* smem = dw_smem;

  const int K = S * C;
  const int tid = threadIdx.x;
  const int tx = tid % Sh::NTX;
  const int ty = (tid / Sh::NTX) % Sh::NTY;
  const int rg = tid / (Sh::NTX * Sh::NTY);
  const int chunk = blockIdx.x;
  const int k0 = blockIdx.y * BKT;
  const int n0 = blockIdx.z * BN;
  const int m0 = chunk * rows_per_chunk;
  const int m_end = min(M, m0 + rows_per_chunk);

  float acc[8][TN];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  float4 gq[Sh::GU];
  float4 dq[Sh::DU];
  const int gq_row = tid / Sh::QPR;  // the first row of a stage it gathers
  const KInfo ki = k_info(k0 + 4 * (tid % Sh::QPR), K, C);

  // float32 rows in whole 16-byte pieces go from device memory straight
  // into the next stage's buffer (cp.async); everything else is loaded
  // into registers here and stored by stash() after the multiply
  const bool direct = sizeof(T) == 4 && vecx != 0;
  auto fetch = [&](int r0, int buf) {
    const int b0 = r0 / V1;
    const int v0 = r0 - b0 * V1;
    float4* gs4 = reinterpret_cast<float4*>(smem + buf * Sh::STAGE);
#pragma unroll
    for (int i = 0; i < Sh::GU; ++i) {
      const int r = gq_row + i * Sh::RSTEP;
      const bool live = r < kBR && r0 + r < m_end && ki.s[0] >= 0;
      gq[i] = make_float4(0.f, 0.f, 0.f, 0.f);
      int b = b0;
      int v = v0 + r;
      while (live && v >= V1) {
        v -= V1;
        ++b;
      }
      if (direct) {
        if (r >= kBR) continue;
        float4* dst = gs4 + tid + i * NT;
        if (live)
          cp_async16_cg(dst, x + ((size_t)b * V1 +
                                  __ldg(spiral + (size_t)v * S + ki.s[0])) *
                                     C + ki.c[0]);
        else
          *dst = gq[i];
      } else if (live) {
        gq[i] = gather_unit<T>(x, spiral, b, v, V1, C, S, ki, vecx != 0);
      }
    }
#pragma unroll
    for (int i = 0; i < Sh::DU; ++i) {
      const int e = tid + i * NT;
      const int r = e / (BN / 4);
      const int q = e - r * (BN / 4);
      dq[i] = (e < kBR * BN / 4)
                  ? dy_unit(dy, r0 + r, m_end, n0 + 4 * q, Co, vecd != 0)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  auto stash = [&](int buf) {
    float* gs = smem + buf * Sh::STAGE;
    float* ds = gs + kBR * BKT;
#pragma unroll
    for (int i = 0; i < Sh::GU; ++i) {
      const int e = tid + i * NT;  // row gq_row + i * RSTEP, the thread's k
      if (!direct && e < kBR * BKT / 4)
        reinterpret_cast<float4*>(gs)[e] = gq[i];
    }
#pragma unroll
    for (int i = 0; i < Sh::DU; ++i) {
      const int e = tid + i * NT;
      if (e < kBR * BN / 4) reinterpret_cast<float4*>(ds)[e] = dq[i];
    }
  };

  fetch(m0, 0);
  stash(0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  int buf = 0;
  for (int r0 = m0; r0 < m_end; r0 += kBR) {
    const bool more = r0 + kBR < m_end;
    if (more) {
      fetch(r0 + kBR, buf ^ 1);
      cp_async_commit();
    }
    const float* gs = smem + buf * Sh::STAGE;
    const float* ds = gs + kBR * BKT;
#pragma unroll
    for (int r = rg; r < kBR; r += RG) {
      float4 a[2];
      float4 b[TNH];
      a[0] = *reinterpret_cast<const float4*>(gs + r * BKT + ty * 4);
      a[1] = *reinterpret_cast<const float4*>(gs + r * BKT + BKT / 2 + ty * 4);
#pragma unroll
      for (int h = 0; h < TNH; ++h)
        b[h] = *reinterpret_cast<const float4*>(ds + r * BN + h * (BN / TNH) +
                                                tx * 4);
#pragma unroll
      for (int ha = 0; ha < 2; ++ha) {
        const float av[4] = {a[ha].x, a[ha].y, a[ha].z, a[ha].w};
#pragma unroll
        for (int hb = 0; hb < TNH; ++hb) {
          const float bv[4] = {b[hb].x, b[hb].y, b[hb].z, b[hb].w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              acc[ha * 4 + i][hb * 4 + j] =
                  fmaf(av[i], bv[j], acc[ha * 4 + i][hb * 4 + j]);
        }
      }
    }
    if (more) stash(buf ^ 1);
    cp_async_wait<0>();
    __syncthreads();
    buf ^= 1;
  }

  // the row groups' tiles, added in group order into group 0's
  if (RG > 1) {
    float* red = smem;
    for (int g = 1; g < RG; ++g) {
      __syncthreads();
      if (rg == g) {
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j)
            red[((i / 4) * (BKT / 2) + ty * 4 + (i % 4)) * BN +
                (j / 4) * (BN / TNH) + tx * 4 + (j % 4)] = acc[i][j];
      }
      __syncthreads();
      if (rg == 0) {
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j)
            acc[i][j] += red[((i / 4) * (BKT / 2) + ty * 4 + (i % 4)) * BN +
                             (j / 4) * (BN / TNH) + tx * 4 + (j % 4)];
      }
    }
  }
  if (rg != 0) return;
  float* out = partial + (size_t)chunk * K * Co;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int k = k0 + (i / 4) * (BKT / 2) + ty * 4 + (i % 4);
    if (k >= K) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + (j / 4) * (BN / TNH) + tx * 4 + (j % 4);
      if (n < Co) out[(size_t)k * Co + n] = acc[i][j];
    }
  }
}

__global__ void dw_finish_kernel(const float* __restrict__ partial,
                                 float* __restrict__ dw, int KCo,
                                 int n_chunks) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= KCo) return;
  float s = 0.f;
  for (int k = 0; k < n_chunks; ++k) s += partial[(size_t)k * KCo + e];
  dw[e] = s;
}

// The tile shape follows Co and K.  Wide outputs take square tiles; narrow
// ones (Co <= 32) take one tile over the whole of K where it fits, so that
// the block that gathers a vertex's S neighbours finds the rows its
// neighbouring vertices just gathered in L1.
struct DwPlan {
  int shape;  // index into the launch switch
  int bkt, bn;
};

DwPlan dw_plan(int K, int Co) {
  if (Co > 64) return {0, 128, 128};
  if (Co > 32) return {1, 128, 64};
  if (Co > 16) {
    if (K <= 192) return {7, 192, 32};
    if (K <= 256) return {2, 256, 32};
    if (K <= 384) return {8, 384, 32};
    return {2, 256, 32};  // measured faster than one 512-row tile at K = 512
  }
  if (K <= 64) return {Co > 4 ? 5 : 6, 64, Co > 4 ? 16 : 4};
  if (Co > 4) return K <= 256 ? DwPlan{3, 256, 16} : DwPlan{10, 512, 16};
  return {4, 256, 4};
}

// Chunks of rows: enough blocks for four per SM, rows a multiple of kBR.
void dw_chunking(int M, int K, int Co, int* rows_per_chunk, int* n_chunks) {
  const DwPlan p = dw_plan(K, Co);
  const int tiles = ((K + p.bkt - 1) / p.bkt) * ((Co + p.bn - 1) / p.bn);
  int want = (4 * kSMs + tiles - 1) / tiles;
  const int most = (M + kBR - 1) / kBR;
  if (want > most) want = most;
  if (want < 1) want = 1;
  int rows = (M + want - 1) / want;
  rows = (rows + kBR - 1) / kBR * kBR;
  *rows_per_chunk = rows;
  *n_chunks = (M + rows - 1) / rows;
}

template <typename T, int BKT, int BN, int TN, int RG>
void dw_launch(const void* x, const int* spiral, const float* dy,
               float* partial, int M, int V1, int C, int S, int Co, int rows,
               int n_chunks, int vecx, int vecd, cudaStream_t st) {
  const int K = S * C;
  const dim3 grid(n_chunks, (K + BKT - 1) / BKT, (Co + BN - 1) / BN);
  using Sh = DwShape<BKT, BN, TN, RG>;
  constexpr int smem_bytes = Sh::SMEM * (int)sizeof(float);
  cudaFuncSetAttribute(dw_partial_kernel<T, BKT, BN, TN, RG>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem_bytes);
  dw_partial_kernel<T, BKT, BN, TN, RG><<<grid, Sh::NT, smem_bytes, st>>>(
          static_cast<const T*>(x), spiral, dy, partial, M, V1, C, S, Co, rows,
          vecx, vecd);
}

template <typename T>
void dw_dispatch(int shape, const void* x, const int* spiral, const float* dy,
                 float* partial, int M, int V1, int C, int S, int Co, int rows,
                 int n_chunks, int vecx, int vecd, cudaStream_t st) {
#define SH_DW(BKT, BN, TN, RG)                                              \
  dw_launch<T, BKT, BN, TN, RG>(x, spiral, dy, partial, M, V1, C, S, Co,    \
                                rows, n_chunks, vecx, vecd, st)
  switch (shape) {
    case 0: SH_DW(128, 128, 8, 1); break;
    case 1: SH_DW(128, 64, 8, 2); break;
    case 2: SH_DW(256, 32, 8, 2); break;
    case 3: SH_DW(256, 16, 4, 2); break;
    case 4: SH_DW(256, 4, 4, 8); break;
    case 5: SH_DW(64, 16, 4, 8); break;
    case 6: SH_DW(64, 4, 4, 16); break;
    case 7: SH_DW(192, 32, 8, 2); break;
    case 8: SH_DW(384, 32, 8, 1); break;
    default: SH_DW(512, 16, 4, 1); break;
  }
#undef SH_DW
}

// ---------------------------------------------------------------- dx -------

// A table entry col = v*S + s is split with one multiply: `s_inv` is
// ceil(2^32 / S), exact for col < 2^32 / S (the C entry point checks
// V1*S*S < 2^32).
__device__ __forceinline__ int entry_vertex(int col, unsigned s_inv) {
  return (int)__umulhi((unsigned)col, s_inv);
}

constexpr int kDxWarps = 4;
constexpr int kNB = 16;   // output channels n per stage
constexpr int kAST = 20;  // floats per staged dy' row: 16 + 4 against conflicts

template <typename T>
struct WRow {  // elements per staged weight row, and per 16-byte unit
  static constexpr int ST = sizeof(T) == 4 ? 20 : 24;
  static constexpr int EPU = 16 / sizeof(T);
};

template <typename T, int NTC>
struct DxShape {
  static constexpr int NTB = 32 / NTC;
  static constexpr int BT = 8 * NTB;   // batch elements per warp tile
  static constexpr int CP = 8 * NTC;   // input channels c per warp tile
  static constexpr int A_BYTES = BT * kAST * 4;
  static constexpr int W_BYTES = CP * WRow<T>::ST * sizeof(T);
  static constexpr int WARP_BYTES = 2 * (A_BYTES + W_BYTES);
  static constexpr int SMEM = kDxWarps * WARP_BYTES;
};

template <typename T, int NTC>
__global__ void __launch_bounds__(32 * kDxWarps)
dx_short_kernel(const float* __restrict__ dy, const T* __restrict__ w,
                const int* __restrict__ offs, const int* __restrict__ cols,
                float* __restrict__ dx, int B, int V1, int C, int S, int Co,
                unsigned s_inv, int long_thresh, int n_btiles, int veca,
                int vecw) {
  using Sh = DxShape<T, NTC>;
  constexpr int NTB = Sh::NTB;
  constexpr int BT = Sh::BT;
  constexpr int CP = Sh::CP;
  constexpr int WST = WRow<T>::ST;
  constexpr int EPU = WRow<T>::EPU;
  constexpr int UPR = kNB / EPU;  // 16-byte units per staged weight row
  extern __shared__ __align__(16) unsigned char dx_smem[];

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long unit = (long long)blockIdx.x * kDxWarps + warp;
  if (unit >= (long long)V1 * n_btiles) return;
  const int u = (int)(unit / n_btiles);
  const int bt = (int)(unit - (long long)u * n_btiles);
  const int b0 = bt * BT;
  const int c0 = blockIdx.y * CP;
  const int lo = offs[u];
  const int hi = offs[u + 1];
  if (hi - lo > long_thresh) return;  // written by the long-row kernels

  unsigned char* mine = dx_smem + warp * Sh::WARP_BYTES;
  // two stage buffers each of dy' rows and of weight rows
  auto a_buf = [&](int buf) {
    return reinterpret_cast<float*>(mine + buf * Sh::A_BYTES);
  };
  auto w_buf = [&](int buf) {
    return reinterpret_cast<T*>(mine + 2 * Sh::A_BYTES + buf * Sh::W_BYTES);
  };
  const int tc = lane % NTC;
  const int tb = lane / NTC;
  const int nch = (Co + kNB - 1) / kNB;
  const int n_stages = (hi - lo) * nch;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  // stage t's entry is read from the table a stage before its loads are
  // issued, so that the loads never wait for it
  auto entry = [&](int t) {
    return t < n_stages ? __ldg(cols + lo + t / nch) : 0;
  };
  auto load_stage = [&](int t, int buf, int col) {
    const int n0 = (t % nch) * kNB;
    const int v = entry_vertex(col, s_inv);
    const int s = col - v * S;
    float* as = a_buf(buf);
#pragma unroll
    for (int i = 0; i < BT * 4 / 32; ++i) {
      const int e = lane + 32 * i;
      const int row = e / 4;
      const int q = e % 4;
      const int b = b0 + row;
      const int n = n0 + 4 * q;
      float* dst = as + row * kAST + 4 * q;
      const float* src = dy + ((size_t)b * V1 + v) * Co + n;
      if (veca && b < B && n < Co) {
        cp_async16_cg(dst, src);
      } else {
#pragma unroll
        for (int d = 0; d < 4; ++d)
          dst[d] = (b < B && n + d < Co) ? src[d] : 0.f;
      }
    }
    T* ws = w_buf(buf);
#pragma unroll
    for (int i = 0; i < (CP * UPR + 31) / 32; ++i) {
      const int e = lane + 32 * i;
      if (e >= CP * UPR) break;
      const int row = e / UPR;
      const int q = e % UPR;
      const int c = c0 + row;
      const int n = n0 + q * EPU;
      T* dst = ws + row * WST + q * EPU;
      const T* src = w + ((size_t)s * C + c) * Co + n;
      if (vecw && c < C && n < Co) {
        cp_async16_ca(dst, src);
      } else {
#pragma unroll
        for (int d = 0; d < EPU; ++d)
          dst[d] = (c < C && n + d < Co) ? src[d] : T(0.f);
      }
    }
  };

  int col_next = entry(1);
  if (n_stages > 0) {
    load_stage(0, 0, entry(0));
    cp_async_commit();
  }
  for (int t = 0; t < n_stages; ++t) {
    const int buf = t & 1;
    if (t + 1 < n_stages) {
      const int col = col_next;
      col_next = entry(t + 2);
      load_stage(t + 1, buf ^ 1, col);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();
    const float* as = a_buf(buf);
    const T* ws = w_buf(buf);
#pragma unroll
    for (int q = 0; q < kNB / 4; ++q) {
      float4 wv[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        wv[j] = load4(ws + (tc + j * NTC) * WST + 4 * q);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 av = *reinterpret_cast<const float4*>(
            as + (tb + i * NTB) * kAST + 4 * q);
#pragma unroll
        for (int j = 0; j < 8; ++j) fma4(acc[i][j], av, wv[j]);
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int b = b0 + tb + i * NTB;
    if (b >= B) continue;
    float* row = dx + ((size_t)b * V1 + u) * C;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = c0 + tc + j * NTC;
      if (c < C) row[c] = acc[i][j];
    }
  }
}

// Outputs of at most four channels (the last conv's Co = 3) leave the warp
// tile above 13 of 16 columns empty; there one thread takes one (b, u) and
// 16 input channels: per entry Co loads of dy' and 16 weight rows (n padded
// to a float4) from a copy of W in shared memory, its slabs one row apart
// in the banks.
constexpr int kNarrowThreads = 128;
constexpr int kNarrowC = 16;

template <typename T>
__global__ void __launch_bounds__(kNarrowThreads)
dx_narrow_kernel(const float* __restrict__ dy, const T* __restrict__ w,
                 const int* __restrict__ offs, const int* __restrict__ cols,
                 float* __restrict__ dx, int V1, int C, int S, int Co,
                 unsigned s_inv, int long_thresh) {
  extern __shared__ __align__(16) unsigned char dx_smem[];
  float4* ws = reinterpret_cast<float4*>(dx_smem);  // [S][C + 1]
  for (int e = threadIdx.x; e < S * C; e += kNarrowThreads) {
    const T* wr = w + (size_t)e * Co;
    float4 r = make_float4(0.f, 0.f, 0.f, 0.f);
    r.x = to_f32(wr[0]);
    if (Co > 1) r.y = to_f32(wr[1]);
    if (Co > 2) r.z = to_f32(wr[2]);
    if (Co > 3) r.w = to_f32(wr[3]);
    ws[(e / C) * (C + 1) + e % C] = r;
  }
  __syncthreads();
  const int u = blockIdx.x * kNarrowThreads + threadIdx.x;
  if (u >= V1) return;
  const int b = blockIdx.y;
  const int c0 = blockIdx.z * kNarrowC;
  const int lo = offs[u];
  const int hi = offs[u + 1];
  if (hi - lo > long_thresh) return;  // written by the long-row kernels
  const float* dyb = dy + (size_t)b * V1 * Co;
  float acc[kNarrowC];
#pragma unroll
  for (int i = 0; i < kNarrowC; ++i) acc[i] = 0.f;
  for (int j = lo; j < hi; ++j) {
    const int col = __ldg(cols + j);
    const int v = entry_vertex(col, s_inv);
    const int s = col - v * S;
    const float* row = dyb + (size_t)v * Co;
    const float a0 = __ldg(row);
    const float a1 = Co > 1 ? __ldg(row + 1) : 0.f;
    const float a2 = Co > 2 ? __ldg(row + 2) : 0.f;
    const float a3 = Co > 3 ? __ldg(row + 3) : 0.f;
    const float4* slab = ws + s * (C + 1) + c0;
#pragma unroll
    for (int i = 0; i < kNarrowC; ++i) {
      if (c0 + i < C) {
        const float4 wv = slab[i];
        acc[i] = fmaf(a0, wv.x, acc[i]);
        acc[i] = fmaf(a1, wv.y, acc[i]);
        acc[i] = fmaf(a2, wv.z, acc[i]);
        acc[i] = fmaf(a3, wv.w, acc[i]);
      }
    }
  }
  float* out = dx + ((size_t)b * V1 + u) * C + c0;
#pragma unroll
  for (int i = 0; i < kNarrowC; ++i)
    if (c0 + i < C) out[i] = acc[i];
}

// One block per (chunk of a long row, tile of batch elements, slice of n):
// a thread owns one (b, n) and walks the chunk's entries in order, eight
// loads in flight at a time, adding dy'[b, v_j, n] into its own sum for the
// entry's s (a column of shared memory: no two threads share a word).
constexpr int kLongThreads = 256;

__global__ void __launch_bounds__(kLongThreads)
dx_long_partial_kernel(const float* __restrict__ dy,
                       const int* __restrict__ cols,
                       const int* __restrict__ chunk_lo,
                       const int* __restrict__ chunk_hi,
                       float* __restrict__ partial, int B, int V1, int S,
                       int Co, unsigned s_inv, int width) {
  extern __shared__ __align__(16) unsigned char dx_smem[];
  float* sums = reinterpret_cast<float*>(dx_smem);  // [S][kLongThreads]
  const int k = blockIdx.x;
  const int b = blockIdx.y * (kLongThreads / width) + threadIdx.x / width;
  const int n = blockIdx.z * width + threadIdx.x % width;
  const bool active = b < B && n < Co;
  float* my = sums + threadIdx.x;
  for (int s = 0; s < S; ++s) my[s * kLongThreads] = 0.f;
  const float* src = dy + (size_t)(active ? b : 0) * V1 * Co + (active ? n : 0);
  const int hi = chunk_hi[k];
  constexpr int U = 8;
  for (int j0 = chunk_lo[k]; j0 < hi; j0 += U) {
    int slot[U];
    float val[U];
#pragma unroll
    for (int i = 0; i < U; ++i) {
      const int col = j0 + i < hi ? __ldg(cols + j0 + i) : -1;
      const int v = col < 0 ? 0 : entry_vertex(col, s_inv);
      slot[i] = col < 0 ? -1 : col - v * S;
      val[i] = (col >= 0 && active) ? __ldg(src + (size_t)v * Co) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < U; ++i)
      if (slot[i] >= 0) my[slot[i] * kLongThreads] += val[i];
  }
  if (!active) return;
  float* out = partial + ((size_t)k * B + b) * S * Co + n;
  for (int s = 0; s < S; ++s) out[s * Co] = my[s * kLongThreads];
}

// One block per (long row, b): the chunk sums in chunk order, then the
// [S*Co] x [S*Co -> C] product with W.
template <typename T>
__global__ void dx_long_finish_kernel(const float* __restrict__ partial,
                                      const T* __restrict__ w,
                                      const int* __restrict__ long_rows,
                                      const int* __restrict__ chunk_offs,
                                      float* __restrict__ dx, int B, int V1,
                                      int C, int S, int Co) {
  extern __shared__ __align__(16) unsigned char dx_smem[];
  float* seg = reinterpret_cast<float*>(dx_smem);  // [S*Co]
  const int i = blockIdx.x;
  const int b = blockIdx.y;
  const int u = long_rows[i];
  const int SCo = S * Co;
  for (int e = threadIdx.x; e < SCo; e += blockDim.x) {
    float t = 0.f;
    for (int k = chunk_offs[i]; k < chunk_offs[i + 1]; ++k)
      t += partial[((size_t)k * B + b) * SCo + e];
    seg[e] = t;
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float t = 0.f;
    for (int s = 0; s < S; ++s) {
      const T* wr = w + ((size_t)s * C + c) * Co;
      const float* sr = seg + s * Co;
      for (int n = 0; n < Co; ++n) t = fmaf(sr[n], to_f32(wr[n]), t);
    }
    dx[((size_t)b * V1 + u) * C + c] = t;
  }
}

template <typename T, int NTC>
cudaError_t dx_short_launch(const float* dy, const void* w, const int* offs,
                            const int* cols, float* dx, int B, int V1, int C,
                            int S, int Co, unsigned s_inv, int long_thresh,
                            int veca, int vecw, cudaStream_t st) {
  using Sh = DxShape<T, NTC>;
  auto kernel = dx_short_kernel<T, NTC>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Sh::SMEM);
  if (err != cudaSuccess) return err;
  const int n_btiles = (B + Sh::BT - 1) / Sh::BT;
  const long long units = (long long)V1 * n_btiles;
  const dim3 grid((unsigned)((units + kDxWarps - 1) / kDxWarps),
                  (C + Sh::CP - 1) / Sh::CP);
  kernel<<<grid, 32 * kDxWarps, Sh::SMEM, st>>>(
      dy, static_cast<const T*>(w), offs, cols, dx, B, V1, C, S, Co, s_inv,
      long_thresh, n_btiles, veca, vecw);
  return cudaSuccess;
}

template <typename T>
cudaError_t dx_dispatch(const float* dy, const void* w, const int* offs,
                        const int* cols, const int* chunk_lo,
                        const int* chunk_hi, const int* long_rows,
                        const int* chunk_offs, float* partial, float* dx,
                        int B, int V1, int C, int S, int Co, int long_thresh,
                        int n_long, int n_chunks, cudaStream_t st) {
  const int veca = (Co % 4 == 0) && (reinterpret_cast<uintptr_t>(dy) % 16 == 0);
  const int vecw = (Co % WRow<T>::EPU == 0) &&
                   (reinterpret_cast<uintptr_t>(w) % 16 == 0);
  if ((long long)V1 * S * S >= (1LL << 32)) return cudaErrorInvalidValue;
  const unsigned s_inv = (unsigned)(((1ULL << 32) + S - 1) / S);
  cudaError_t err = cudaSuccess;
#define SH_DX(NTC)                                                          \
  err = dx_short_launch<T, NTC>(dy, w, offs, cols, dx, B, V1, C, S, Co,     \
                                s_inv, long_thresh, veca, vecw, st)
  // the warp's tile is 2048 outputs: wide in c for wide convs, else in b
  if (Co <= 4) {
    const int narrow_smem = S * (C + 1) * (int)sizeof(float4);
    err = cudaFuncSetAttribute(dx_narrow_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               narrow_smem > 48 * 1024 ? narrow_smem
                                                       : 48 * 1024);
    if (err != cudaSuccess) return err;
    dx_narrow_kernel<T>
        <<<dim3((V1 + kNarrowThreads - 1) / kNarrowThreads, B,
                (C + kNarrowC - 1) / kNarrowC),
           kNarrowThreads, narrow_smem, st>>>(
            dy, static_cast<const T*>(w), offs, cols, dx, V1, C, S, Co, s_inv,
            long_thresh);
  }
  else if (C > 64) SH_DX(16);
  else if (C > 32) SH_DX(8);
  else if (C > 16) SH_DX(4);
  else if (C > 8) SH_DX(2);
  else SH_DX(1);
#undef SH_DX
  if (err != cudaSuccess) return err;
  if (n_long > 0) {
    const int SCo = S * Co;
    int width = 1;
    while (width < Co && width < 32) width *= 2;
    const int part_smem = S * kLongThreads * (int)sizeof(float);
    err = cudaFuncSetAttribute(dx_long_partial_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               part_smem > 48 * 1024 ? part_smem : 48 * 1024);
    if (err != cudaSuccess) return err;
    const int bb = kLongThreads / width;  // batch elements per block
    dx_long_partial_kernel<<<dim3(n_chunks, (B + bb - 1) / bb,
                                  (Co + width - 1) / width),
                             kLongThreads, part_smem, st>>>(
        dy, cols, chunk_lo, chunk_hi, partial, B, V1, S, Co, s_inv, width);
    dx_long_finish_kernel<T>
        <<<dim3(n_long, B), 128, SCo * (int)sizeof(float), st>>>(
            partial, static_cast<const T*>(w), long_rows, chunk_offs, dx, B,
            V1, C, S, Co);
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// The number of row chunks sh_spiral_conv_bwd_dw cuts B*V1 rows into: the
// caller allocates `partial` as [chunks, S*C, Co] float32.
int sh_spiral_conv_bwd_dw_chunks(int B, int V1, int C, int S, int Co) {
  int rows, chunks;
  dw_chunking(B * V1, S * C, Co, &rows, &chunks);
  return chunks;
}

// Launches the partial and the finishing kernel on `stream` and returns a
// CUDA error code (0 on success).  The caller has checked shapes, types and
// contiguity and passes the chunk count it sized `partial` for.
int sh_spiral_conv_bwd_dw(const void* x, const void* spiral, const void* dy,
                          void* partial, void* dw, int B, int V1, int C, int S,
                          int Co, int x_is_bf16, int n_chunks, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = B * V1;
  const int K = S * C;
  int rows, chunks;
  dw_chunking(M, K, Co, &rows, &chunks);
  if (chunks != n_chunks) return static_cast<int>(cudaErrorInvalidValue);
  const int es = x_is_bf16 ? 2 : 4;
  const int vecx =
      (C % 4 == 0) && (reinterpret_cast<uintptr_t>(x) % (4 * es) == 0);
  const int vecd = (Co % 4 == 0) && (reinterpret_cast<uintptr_t>(dy) % 16 == 0);
  const int* sp = static_cast<const int*>(spiral);
  const float* dyf = static_cast<const float*>(dy);
  float* pf = static_cast<float*>(partial);
  const int shape = dw_plan(K, Co).shape;
  if (x_is_bf16)
    dw_dispatch<__nv_bfloat16>(shape, x, sp, dyf, pf, M, V1, C, S, Co, rows,
                               chunks, vecx, vecd, st);
  else
    dw_dispatch<float>(shape, x, sp, dyf, pf, M, V1, C, S, Co, rows, chunks,
                       vecx, vecd, st);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int KCo = K * Co;
  dw_finish_kernel<<<(KCo + 255) / 256, 256, 0, st>>>(
      pf, static_cast<float*>(dw), KCo, chunks);
  return static_cast<int>(cudaGetLastError());
}

// Launches the short-row kernel and, for the n_long rows longer than
// long_thresh (cut into n_chunks chunks [chunk_lo[k], chunk_hi[k]), chunks
// chunk_offs[i]..chunk_offs[i+1] of long row i), the two long-row kernels;
// `partial` is [max(n_chunks, 1), B, S*Co] float32.  Returns a CUDA error
// code (0 on success).
int sh_spiral_conv_bwd_dx(const void* dy, const void* w, const void* offs,
                          const void* cols, const void* chunk_lo,
                          const void* chunk_hi, const void* long_rows,
                          const void* chunk_offs, void* partial, void* dx,
                          int B, int V1, int C, int S, int Co, int long_thresh,
                          int n_long, int n_chunks, int w_is_bf16,
                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* dyf = static_cast<const float*>(dy);
  const int* of = static_cast<const int*>(offs);
  const int* cl = static_cast<const int*>(cols);
  const int* clo = static_cast<const int*>(chunk_lo);
  const int* chi = static_cast<const int*>(chunk_hi);
  const int* lr = static_cast<const int*>(long_rows);
  const int* co = static_cast<const int*>(chunk_offs);
  float* pf = static_cast<float*>(partial);
  float* dxf = static_cast<float*>(dx);
  cudaError_t err;
  if (w_is_bf16)
    err = dx_dispatch<__nv_bfloat16>(dyf, w, of, cl, clo, chi, lr, co, pf, dxf,
                                     B, V1, C, S, Co, long_thresh, n_long,
                                     n_chunks, st);
  else
    err = dx_dispatch<float>(dyf, w, of, cl, clo, chi, lr, co, pf, dxf, B, V1,
                             C, S, Co, long_thresh, n_long, n_chunks, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

const char* sh_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
