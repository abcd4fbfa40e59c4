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
// dW is a gathered SGEMM whose output stays on chip, fed from a window of
// source rows.  Neighbouring vertices name many of the same x rows (at the
// bundled topology's level 0 a tile of 256 consecutive vertices names each
// of its distinct rows 4.7 times), so the plan of ops/dw_window.py, built
// once a spiral table, lists each tile's distinct rows and gives every
// entry (v, s) its index in its tile's list.  A block takes a run of (batch
// element, vertex tile) items and one [BKT x BN] tile of dW.  Per item it
// copies into shared memory, once, the tile's rows that its k-tile's slots
// name (cp.async; the row numbers of eight pieces are loaded before any
// copy, so that their loads are in flight together), then walks the tile's
// vertices a stage at a time: each stage's dy' rows and local indices come
// through a ring of NST stages (cp.async, issued NST - 1 stages ahead), and
// every thread accumulates an 8 x TN tile in registers, reading x through
// the indices (bf16 converted on load; single elements where C % 4 != 0).
// The tile size T and the launch follow what a call shows (B, V1, S, C, Co,
// the dtype): the largest T whose window fits the blocks an SM the kernel
// is set for and still gives four blocks an SM.  Narrow outputs leave few
// threads per tile, so RG groups of threads take alternate rows and are
// added in group order at the end.  Each block writes its partial [K, Co]
// tile into scratch that the caller allocated; a second kernel adds the
// partials in a fixed order.

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
// What the card showed (PERF.md has the numbers): the first dW kernel did
// not wait on the L2, though every x row was asked for S times: a table
// whose every slot names the vertex itself ran no faster.  Its rows' loop
// had a start known only at run time, so it was never unrolled, and each
// 16-row stage waited on a chain of two dependent loads (the spiral index,
// then the row).  Here the loop is unrolled, the index chains are gone from
// the stages, and an 8 x 8 thread tile reads 16 floats from shared memory
// for its 64 FMAs: shared-memory delivery and the FMAs now take about equal
// time.  The dx kernels were read as waiting on the L2's gathered rows;
// no such control has tested that yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

constexpr int kSmemOne = 232448;  // the most a block may take

template <int BKT, int BN, int TN, int RG>
struct DwShape {
  static constexpr int KT = 8;          // k a thread
  static constexpr int NTY = BKT / KT;  // threads along k
  static constexpr int NTX = BN / TN;   // threads along n
  static constexpr int NT = NTY * NTX * RG;
  // blocks an SM the registers are set for: sixteen warps where the
  // threads allow, at least two blocks
  static constexpr int MINB = 512 / NT > 2 ? 512 / NT : 2;
  // vertices a stage: 16 rows for each thread between two barriers, 8
  // where more than two row groups share a stage
  static constexpr int BR = RG > 2 ? 8 * RG : 16 * RG;
  // stages of dy' rows and local indices in the ring: narrow tiles do
  // little work a stage, so more of their loads are kept in flight
  static constexpr int NST = BN >= 64 ? 2 : 3;
};

__device__ __forceinline__ void cp_async4_ca(void* smem, const void* g) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(g));
}

__host__ __device__ __forceinline__ int slots_padded(int S) {
  return (S + 7) / 8 * 8;
}

// The window plan's arrays (ops/dw_window.py) and the launch's numbers.
struct DwArgs {
  const void* x;
  const int* rows;        // each tile's distinct source rows, ascending
  const int* offs;        // [n_vt + 1]
  const unsigned* masks;  // slots that name each row, bit min(s, 31)
  const short* lidx;      // [V1 padded, SP] index in the tile's list
  const float* dy;
  float* partial;
  int B, V1, C, S, Co, TV, n_vt, items, per_chunk, n_chunks, smem,
      win_bytes, xmode, vecd;
};

// One stage's rows into the thread's KT x TN tile: row r's KT x values from
// the window through the row's local indices (one a group of four k, each
// read once where neighbouring groups share a slot), its dy' row from the
// ring.  FULL stages (every row live) run without a test in the loop.
template <typename T, int BN, int TN, int RG, int KT, int BR, bool VEC,
          bool FULL>
__device__ __forceinline__ void dw_stage(float (&acc)[KT][TN], const T* win,
                                         const short* lb, const float* db,
                                         int SP, int C, int live,
                                         const int (&gs)[KT],
                                         const int (&gc)[KT],
                                         const bool (&same)[KT], int rg,
                                         int tx) {
  constexpr int TNH = TN / 4;
  constexpr int NG = VEC ? KT / 4 : KT;
  // a trip count known to the compiler, so that it unrolls the rows and
  // issues one row's loads under the previous row's products
#pragma unroll
  for (int q = 0; q < BR / RG; ++q) {
    const int r = rg + q * RG;
    if (!FULL && r >= live) break;
    const short* li = lb + r * SP;
    float av[KT];
    int l = 0;
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      if (!same[g]) l = li[max(gs[g], 0)];
      if (VEC) {
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (gs[g] >= 0) v = load4(win + l * C + gc[g]);
        av[4 * g] = v.x;
        av[4 * g + 1] = v.y;
        av[4 * g + 2] = v.z;
        av[4 * g + 3] = v.w;
      } else {
        av[g] = gs[g] >= 0 ? to_f32(win[l * C + gc[g]]) : 0.f;
      }
    }
#pragma unroll
    for (int h = 0; h < TNH; ++h) {
      const float4 bq = *reinterpret_cast<const float4*>(
          db + r * BN + h * (BN / TNH) + tx * 4);
      const float bv[4] = {bq.x, bq.y, bq.z, bq.w};
#pragma unroll
      for (int i = 0; i < KT; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[i][h * 4 + j] = fmaf(av[i], bv[j], acc[i][h * 4 + j]);
    }
  }
}

template <typename T, int BKT, int BN, int TN, int RG, bool VEC>
__global__ void __launch_bounds__(DwShape<BKT, BN, TN, RG>::NT,
                                  DwShape<BKT, BN, TN, RG>::MINB)
dw_partial_kernel(const DwArgs a) {
  using Sh = DwShape<BKT, BN, TN, RG>;
  constexpr int KT = Sh::KT;
  constexpr int NT = Sh::NT;
  constexpr int NST = Sh::NST;
  constexpr int BR = Sh::BR;
  constexpr int TNH = TN / 4;
  extern __shared__ __align__(16) unsigned char dw_smem[];
  const int C = a.C, S = a.S, Co = a.Co, V1 = a.V1;
  const int SP = slots_padded(S);
  T* win = reinterpret_cast<T*>(dw_smem);
  float* dys = reinterpret_cast<float*>(dw_smem + a.win_bytes);
  short* lis = reinterpret_cast<short*>(dys + NST * BR * BN);
  const T* x = static_cast<const T*>(a.x);

  const int K = S * C;
  const int tid = threadIdx.x;
  const int tx = tid % Sh::NTX;
  const int ty = (tid / Sh::NTX) % Sh::NTY;
  const int rg = tid / (Sh::NTX * Sh::NTY);
  const int k0 = blockIdx.y * BKT;
  const int n0 = blockIdx.z * BN;
  // the slots this k-tile reads: a window holds only the rows they name
  const int s_lo = k0 / C;
  const int s_hi = (min(K, k0 + BKT) - 1) / C;
  unsigned rmask = 0;
  for (int s = s_lo; s <= s_hi; ++s) rmask |= 1u << min(s, 31);
  const bool every_row = s_lo == 0 && s_hi == S - 1;

  // a thread's k are k0 + ty*KT + i: with C % 4 == 0 groups of four
  // channels of one slot each, else single elements (slot -1: outside K);
  // `same`: the group's slot is the previous group's
  constexpr int NG = VEC ? KT / 4 : KT;
  int gs[KT], gc[KT];
  bool same[KT];
#pragma unroll
  for (int g = 0; g < KT; ++g) {
    const int k = k0 + ty * KT + (VEC ? 4 * g : g);
    gs[g] = g < NG && k < K ? k / C : -1;
    gc[g] = gs[g] >= 0 ? k - gs[g] * C : 0;
    same[g] = g > 0 && gs[g] == gs[g - 1];
  }

  float acc[KT][TN];
#pragma unroll
  for (int i = 0; i < KT; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  const int w0 = blockIdx.x * a.per_chunk;
  const int w1 = min(a.items, w0 + a.per_chunk);
  for (int w = w0; w < w1; ++w) {
    const int b = w / a.n_vt;
    const int vt = w - b * a.n_vt;
    const int v_start = vt * a.TV;
    const int v_end = min(V1, v_start + a.TV);
    const int n_st = (v_end - v_start + BR - 1) / BR;
    const float* dyb = a.dy + (size_t)b * V1 * Co;

    // stage j's local indices and dy' rows into ring buffer sb
    auto load_stage = [&](int j, int sb) {
      const int v0 = v_start + j * BR;
      const int qi = SP / 8;
      for (int u = tid; u < BR * qi; u += NT) {
        const int r = u / qi;
        cp_async16_ca(lis + (sb * BR + r) * SP + (u - r * qi) * 8,
                      a.lidx + (size_t)(v0 + r) * SP + (u - r * qi) * 8);
      }
      float* ds = dys + sb * BR * BN;
      if (a.vecd) {
        for (int u = tid; u < BR * BN / 4; u += NT) {
          const int r = u / (BN / 4);
          const int n = n0 + 4 * (u - r * (BN / 4));
          float* dst = ds + 4 * u;
          if (v0 + r < v_end && n < Co)
            cp_async16_cg(dst, dyb + (size_t)(v0 + r) * Co + n);
          else
            *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
        }
      } else {
        for (int u = tid; u < BR * BN; u += NT) {
          const int r = u / BN;
          const int n = n0 + u - r * BN;
          if (v0 + r < v_end && n < Co)
            cp_async4_ca(ds + u, dyb + (size_t)(v0 + r) * Co + n);
          else
            ds[u] = 0.f;
        }
      }
    };

    __syncthreads();  // the last item's reads of the window and the ring
    // the window: the rows of the tile's list that this k-tile reads, in
    // pieces of 16 or 4 bytes (cp.async) or single elements; a thread
    // reads the row numbers of kU pieces before it copies any, so that
    // their loads are in flight together
    {
      const int lo = __ldg(a.offs + vt);
      const int n = __ldg(a.offs + vt + 1) - lo;
      const T* xb = x + (size_t)b * V1 * C;
      const int psz = a.xmode ? a.xmode : (int)sizeof(T);
      const int qr = C * (int)sizeof(T) / psz;  // pieces a row
      const int total = n * qr;
      constexpr int kU = 8;
      for (int base = tid; base < total; base += kU * NT) {
        int ii[kU], rid[kU];
        unsigned mk[kU];
#pragma unroll
        for (int q = 0; q < kU; ++q) {
          ii[q] = min(base + q * NT, total - 1) / qr;
          rid[q] = __ldg(a.rows + lo + ii[q]);
          mk[q] = every_row ? 1u : __ldg(a.masks + lo + ii[q]);
        }
#pragma unroll
        for (int q = 0; q < kU; ++q) {
          const int u = base + q * NT;
          if (u >= total || !(every_row || (mk[q] & rmask))) continue;
          const int piece = u - ii[q] * qr;
          if (a.xmode == 0) {
            win[u] = __ldg(xb + (size_t)rid[q] * C + piece);
            continue;
          }
          unsigned char* dst = dw_smem + (size_t)u * psz;
          const unsigned char* src =
              reinterpret_cast<const unsigned char*>(xb + (size_t)rid[q] * C) +
              piece * psz;
          if (psz == 16)
            cp_async16_cg(dst, src);
          else
            cp_async4_ca(dst, src);
        }
      }
    }
    cp_async_commit();
#pragma unroll
    for (int j = 0; j < NST - 1; ++j) {
      if (j < n_st) load_stage(j, j);
      cp_async_commit();
    }

    for (int j = 0; j < n_st; ++j) {
      cp_async_wait<NST - 2>();
      __syncthreads();
      const int jn = j + NST - 1;
      if (jn < n_st) load_stage(jn, jn % NST);
      cp_async_commit();
      const int live = v_end - v_start - j * BR;
      const short* lb = lis + (j % NST) * BR * SP;
      const float* db = dys + (j % NST) * BR * BN;
      if (live >= BR)
        dw_stage<T, BN, TN, RG, KT, BR, VEC, true>(
            acc, win, lb, db, SP, C, live, gs, gc, same, rg, tx);
      else
        dw_stage<T, BN, TN, RG, KT, BR, VEC, false>(
            acc, win, lb, db, SP, C, live, gs, gc, same, rg, tx);
    }
  }

  // the row groups' tiles, added in group order into group 0's
  auto n_of = [&](int j) { return (j / 4) * (BN / TNH) + tx * 4 + (j % 4); };
  if (RG > 1) {
    float* red = reinterpret_cast<float*>(dw_smem);
    for (int g = 1; g < RG; ++g) {
      __syncthreads();
      if (rg == g) {
#pragma unroll
        for (int i = 0; i < KT; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j)
            red[(ty * KT + i) * BN + n_of(j)] = acc[i][j];
      }
      __syncthreads();
      if (rg == 0) {
#pragma unroll
        for (int i = 0; i < KT; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j)
            acc[i][j] += red[(ty * KT + i) * BN + n_of(j)];
      }
    }
  }
  if (rg != 0) return;
  float* out = a.partial + (size_t)blockIdx.x * K * Co;
#pragma unroll
  for (int i = 0; i < KT; ++i) {
    const int k = k0 + ty * KT + i;
    if (k >= K) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + n_of(j);
      if (n < Co) out[(size_t)k * Co + n] = acc[i][j];
    }
  }
}

// The chunks' partial tiles added in a fixed order: a block takes 32
// entries of dW, each of its kFinishGroups warps sums every kFinishGroups-th
// chunk from its own in chunk order, and the group sums are added in group
// order.
constexpr int kFinishGroups = 8;

__global__ void __launch_bounds__(32 * kFinishGroups)
dw_finish_kernel(const float* __restrict__ partial, float* __restrict__ dw,
                 int KCo, int n_chunks) {
  __shared__ float sums[kFinishGroups][32];
  const int e = blockIdx.x * 32 + threadIdx.x;
  const int g = threadIdx.y;
  float s = 0.f;
  if (e < KCo)
    for (int k = g; k < n_chunks; k += kFinishGroups)
      s += partial[(size_t)k * KCo + e];
  sums[g][threadIdx.x] = s;
  __syncthreads();
  if (g != 0 || e >= KCo) return;
  float t = 0.f;
#pragma unroll
  for (int i = 0; i < kFinishGroups; ++i) t += sums[i][threadIdx.x];
  dw[e] = t;
}

// A launch at tile shape <BKT, BN, TN, RG> (ops/dw_window.py:tile_shape
// picks it from K and Co, TILES lists the switch below).  The dynamic
// shared memory must hold the window, then the ring of dy' rows and local
// indices, and the row groups' sums, which reuse it at the end.
template <typename T, int BKT, int BN, int TN, int RG>
cudaError_t dw_launch(const DwArgs& a, cudaStream_t st) {
  using Sh = DwShape<BKT, BN, TN, RG>;
  const long long ring = (long long)Sh::NST * Sh::BR *
                         (BN * 4 + slots_padded(a.S) * 2);
  if (a.smem < a.win_bytes + ring ||
      (RG > 1 && a.smem < (long long)BKT * BN * 4))
    return cudaErrorInvalidValue;
  auto kernel = (a.C % 4 == 0) ? dw_partial_kernel<T, BKT, BN, TN, RG, true>
                               : dw_partial_kernel<T, BKT, BN, TN, RG, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const int K = a.S * a.C;
  const dim3 grid(a.n_chunks, (K + BKT - 1) / BKT, (a.Co + BN - 1) / BN);
  kernel<<<grid, Sh::NT, a.smem, st>>>(a);
  return cudaSuccess;
}

template <typename T>
cudaError_t dw_dispatch(int shape, const DwArgs& a, cudaStream_t st) {
  switch (shape) {
    case 0: return dw_launch<T, 128, 128, 8, 1>(a, st);
    case 1: return dw_launch<T, 256, 64, 8, 1>(a, st);
    case 2: return dw_launch<T, 256, 32, 8, 2>(a, st);
    case 3: return dw_launch<T, 256, 16, 8, 2>(a, st);
    case 4: return dw_launch<T, 256, 4, 4, 8>(a, st);
    case 5: return dw_launch<T, 64, 16, 8, 8>(a, st);
    case 6: return dw_launch<T, 64, 4, 4, 16>(a, st);
    case 7: return dw_launch<T, 192, 32, 8, 2>(a, st);
    case 8: return dw_launch<T, 384, 32, 8, 1>(a, st);
    case 9: return dw_launch<T, 512, 16, 8, 2>(a, st);
    case 10: return dw_launch<T, 512, 32, 8, 1>(a, st);
    default: return cudaErrorInvalidValue;
  }
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

// Launches the partial kernel and the finishing kernel on `stream` and
// returns a CUDA error code (0 on success).  The caller has checked shapes,
// types and contiguity and passes the window plan of its tile size TV (the
// longest list max_rows) and the launch it planned (ops/dw_window.py:
// launch_plan: tile shape, chunks of per_chunk items, shared memory); a
// launch whose chunks miss an item or whose shared memory cannot hold the
// window and its ring is refused.  `partial` is [n_chunks, S*C, Co].
int sh_spiral_conv_bwd_dw(const void* x, const void* rows, const void* offs,
                          const void* masks, const void* lidx, const void* dy,
                          void* partial, void* dw, int B, int V1, int C,
                          int S, int Co, int TV, int max_rows, int shape,
                          int n_chunks, int per_chunk, int smem, int x_is_bf16,
                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int K = S * C;
  const int es = x_is_bf16 ? 2 : 4;
  const int n_vt = (V1 + TV - 1) / TV;
  const long long items = (long long)n_vt * B;
  if (TV <= 0 || TV % 16 != 0 || per_chunk <= 0 || items >= (1LL << 31) ||
      n_chunks != (int)((items + per_chunk - 1) / per_chunk) ||
      max_rows < 0 || smem > kSmemOne)
    return static_cast<int>(cudaErrorInvalidValue);
  DwArgs a;
  a.x = x;
  a.rows = static_cast<const int*>(rows);
  a.offs = static_cast<const int*>(offs);
  a.masks = static_cast<const unsigned*>(masks);
  a.lidx = static_cast<const short*>(lidx);
  a.dy = static_cast<const float*>(dy);
  a.partial = static_cast<float*>(partial);
  a.B = B;
  a.V1 = V1;
  a.C = C;
  a.S = S;
  a.Co = Co;
  a.TV = TV;
  a.n_vt = n_vt;
  a.items = (int)items;
  a.per_chunk = per_chunk;
  a.n_chunks = n_chunks;
  a.smem = smem;
  a.win_bytes = (int)(((long long)max_rows * C * es + 15) / 16 * 16);
  const int row_bytes = C * es;
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  a.xmode = (row_bytes % 16 == 0 && xa % 16 == 0)  ? 16
            : (row_bytes % 4 == 0 && xa % 4 == 0) ? 4
                                                   : 0;
  a.vecd = (Co % 4 == 0) && (reinterpret_cast<uintptr_t>(dy) % 16 == 0);
  cudaError_t err = x_is_bf16 ? dw_dispatch<__nv_bfloat16>(shape, a, st)
                              : dw_dispatch<float>(shape, a, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int KCo = K * Co;
  dw_finish_kernel<<<(KCo + 31) / 32, dim3(32, kFinishGroups), 0, st>>>(
      a.partial, static_cast<float*>(dw), KCo, n_chunks);
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
