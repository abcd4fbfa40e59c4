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
// dy'[:, v_j, :] [B x Co] . W_{s_j}^T [Co x C].  A block owns a slice of CP
// input channels and keeps that slice of W, for every slot and every output
// channel, in shared memory for its life (one block an SM, eight warps).
// The short rows' plan of ops/dx_plan.py, built once an inverse table,
// lists each short row's entries as packed (v, s); a unit is one row at one
// batch tile, and each warp streams the units that start in its equal share
// of the call's entries, so no warp waits for another and no row's first
// stage is exposed.  Per entry and 16 output channels a warp's lane 0 asks
// for its tile's dy' rows (64-byte pieces of a row of Co floats) with one
// tensor copy into the warp's ring, double-buffered on barriers in shared
// memory, and every lane accumulates an 8 x 8 tile from the rows, whose
// pieces the copy swizzles against bank conflicts.  Rows longer than the
// caller's threshold (the dummy row, which every spiral pad points at:
// 34,041 of level 0's 103,395 entries) would serialise one warp, so they
// take
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
// time.  The earlier dx kernel, one warp per (row, batch tile) copying a
// weight slab beside the dy' rows for every entry, did not wait on the L2
// either: tables whose entries all name their row's own vertex, or all
// slot 0, ran within 1.5 % of the real one.  What paced it was the SM:
// with the weight slice resident but the rows still copied by every lane
// (cp.async, 16 bytes each), the kernel took 75-80 % of its time on the
// C = 32 convs with the copies left out and 45-60 % with the products
// left out, the two sharing the SM's load/store path.  One tensor copy a
// stage takes the copies off that path: a fifth less time again, a third
// on the 16 -> 32 conv, whose dy' bytes a FMA are the most.  A
// window of dy' rows shared by the rows of a tile was not built: 16
// consecutive rows of level 0 name 89 distinct vertices (1.8 entries a
// staged row), 4 KB each for 64 batch elements and 16 channels.  Three
// stages, weight fragments loaded a step ahead, L1-allocating copies and
// twelve warps an SM each moved the time by less than 5 %; 16 batch rows
// a lane ran half again slower.

#include <cuda.h>
#include <cudaTypedefs.h>
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

constexpr int kDxStages = 2;     // stages of dy' rows in a warp's ring
constexpr int kDxMaxWarps = 8;   // warps a block, at most: one block an SM
constexpr int kNB = 16;          // output channels n per stage: 64-byte rows

// A warp's tile is BT batch elements x CP input channels, 8 x 8 a lane; a
// block's c-slice is CP channels wide.  A stage holds BT dy' rows of kNB
// floats, 64 bytes each, their four 16-byte pieces swizzled as the tensor
// copy's 64-byte mode lays them: piece q of row r at q ^ ((r >> 1) & 3).
template <int NTC>
struct DxShape {
  static constexpr int NTB = 32 / NTC;
  static constexpr int BT = 8 * NTB;  // batch elements per warp tile
  static constexpr int CP = 8 * NTC;  // input channels c per tile
  static constexpr int A_FLOATS = BT * kNB;
};

__device__ __forceinline__ int dx_piece(int row, int q) {
  return row * kNB + ((q ^ ((row >> 1) & 3)) << 2);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(bar));
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(s)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(bar));
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(s),
      "r"(parity)
      : "memory");
}
// One tensor copy of a box of dy' (16 channels x 1 vertex x BT batch
// elements) into shared memory, reported to `bar` with its bytes.
__device__ __forceinline__ void tma_dy_rows(float* dst, const CUtensorMap* tm,
                                            uint64_t* bar, int n0, int v,
                                            int b0, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const unsigned m = static_cast<unsigned>(__cvta_generic_to_shared(bar));
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(m), "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(d),
      "l"(reinterpret_cast<uint64_t>(tm)), "r"(m), "r"(n0), "r"(v), "r"(b0)
      : "memory");
}

// The short rows' plan (ops/dx_plan.py) and the launch's numbers.  A unit
// is one short row r (u = rows[r], entries ents[roffs[r]:roffs[r+1]], each
// (v << 8) | s in the inverse table's order) at one batch tile bt; units
// run batch-tile-major, unit (bt, r) starting at position bt*(E + R) +
// keys[r] with keys[r] = roffs[r] + r (each unit weighs its entries plus
// one for its output rows).
struct DxArgs {
  const float* dy;
  const void* w;
  const int* rows;
  const int* keys;
  const int* roffs;
  const int* ents;
  float* dx;
  int B, V1, C, S, Co, R, E, n_bt, wst, veca, vecw;
};

// Shared memory past the weight slice: the rings start at the next 1024
// bytes (the swizzle's repeat), then each warp's slots, then its barriers.
constexpr int kDxAlign = 1024;

// The weight slice of the block's CP channels, for every slot and every
// output channel, as f32 in shared memory: ws[(s*CP + c)*wst + n], zero
// past C and Co (n runs to Co rounded up to kNB).
template <typename T, int CP>
__device__ __forceinline__ void dx_stage_weights(float* ws, const DxArgs& a,
                                                 int c0) {
  const int np = (a.Co + kNB - 1) / kNB * kNB;
  const T* w = static_cast<const T*>(a.w);
  if (a.vecw) {  // Co % 4 == 0: four n at a time
    const int q = np / 4;
    for (int e = threadIdx.x; e < a.S * CP * q; e += blockDim.x) {
      const int row = e / q;
      const int n = 4 * (e - row * q);
      const int s = row / CP;
      const int c = c0 + row - s * CP;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (c < a.C && n < a.Co) v = load4(w + ((size_t)s * a.C + c) * a.Co + n);
      *reinterpret_cast<float4*>(ws + row * a.wst + n) = v;
    }
  } else {
    for (int e = threadIdx.x; e < a.S * CP * np; e += blockDim.x) {
      const int row = e / np;
      const int n = e - row * np;
      const int s = row / CP;
      const int c = c0 + row - s * CP;
      ws[row * a.wst + n] = (c < a.C && n < a.Co)
                                ? to_f32(w[((size_t)s * a.C + c) * a.Co + n])
                                : 0.f;
    }
  }
}

// The first unit whose start position is at least p: (batch tile, row).
__device__ __forceinline__ void dx_unit_at(const DxArgs& a, long long p,
                                           int& bt, int& r) {
  const long long per = (long long)a.E + a.R;
  bt = (int)(p / per);
  const int rem = (int)(p - (long long)bt * per);
  int lo = 0, hi = a.R;  // keys[R] = E + R > rem
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    if (__ldg(a.keys + mid) >= rem) hi = mid;
    else lo = mid + 1;
  }
  r = lo;
  if (r == a.R) {
    ++bt;
    r = 0;
  }
}

// Short rows.  A block owns one c-slice of CP channels and keeps that
// slice of W resident in shared memory for its life; its warps each take
// a run of units whose entries (plus one per unit) split the call's evenly,
// and stream them as one pipeline of stages (one entry's dy' rows for the
// warp's batch tile and 16 output channels, through a ring of kDxStages
// buffers filled by tensor copies, or by loads where dy's rows do not go
// in 16-byte pieces), rows following each other with no stage exposed.  A row's entries are added in the table's order, each entry's
// channels in order, so the sums are those of the earlier kernel bit for
// bit.
template <typename T, int NTC>
__global__ void __launch_bounds__(32 * kDxMaxWarps, 1)
dx_short_kernel(const DxArgs a, const __grid_constant__ CUtensorMap tm) {
  using Sh = DxShape<NTC>;
  constexpr int NTB = Sh::NTB;
  constexpr int BT = Sh::BT;
  constexpr int CP = Sh::CP;
  constexpr int NST = kDxStages;
  extern __shared__ __align__(16) unsigned char dx_smem[];
  const int nw = blockDim.x / 32;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int c0 = blockIdx.y * CP;
  const int wst = a.wst;
  float* ws = reinterpret_cast<float*>(dx_smem);
  const unsigned end_w = static_cast<unsigned>(
      __cvta_generic_to_shared(ws + a.S * CP * wst));
  float* ring0 = reinterpret_cast<float*>(
      reinterpret_cast<unsigned char*>(ws + a.S * CP * wst) +
      ((kDxAlign - end_w % kDxAlign) % kDxAlign));
  float* as = ring0 + warp * NST * Sh::A_FLOATS;
  int* sring = reinterpret_cast<int*>(ring0 + nw * NST * Sh::A_FLOATS) +
               warp * NST;
  uint64_t* bars = reinterpret_cast<uint64_t*>(
                       reinterpret_cast<int*>(ring0 + nw * NST * Sh::A_FLOATS) +
                       (nw * NST + 1) / 2 * 2) +
                   warp * NST;

  dx_stage_weights<T, CP>(ws, a, c0);
  if (a.veca && lane == 0) {
#pragma unroll
    for (int j = 0; j < NST; ++j) mbar_init(bars + j);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the warp's units: those starting in [p_lo, p_hi)
  const long long total = (long long)a.n_bt * (a.E + a.R);
  const long long g = (long long)blockIdx.x * nw + warp;
  const long long gs = (long long)gridDim.x * nw;
  int bt, r, bt_end, r_end;
  dx_unit_at(a, total * g / gs, bt, r);
  dx_unit_at(a, total * (g + 1) / gs, bt_end, r_end);
  if (bt >= a.n_bt) return;
  // its entries, batch-tile-major: positions pe .. pe_end of n_bt x E
  const long long pe = (long long)bt * a.E + __ldg(a.roffs + r);
  const long long pe_end =
      (long long)bt_end * a.E + (bt_end < a.n_bt ? __ldg(a.roffs + r_end) : 0);
  const int nch = (a.Co + kNB - 1) / kNB;
  const int n_stages = (int)((pe_end - pe) * nch);

  const int tc = lane % NTC;
  const int tb = lane / NTC;

  // the loader: the next stage's entry (batch tile lbt, entry lj), its
  // chunk lk, and the packed entry after it, read a stage ahead
  int lbt = bt;
  int lj = (int)(pe - (long long)bt * a.E);
  if (lj == a.E) {  // the rest of batch tile bt is empty rows
    lj = 0;
    ++lbt;
  }
  int lk = 0;
  auto next_j = [&](int j) { return j + 1 < a.E ? j + 1 : 0; };
  int pk = 0, pk_next = 0;
  if (n_stages > 0) {
    pk = __ldg(a.ents + lj);
    pk_next = __ldg(a.ents + next_j(lj));
  }
  // a stage's rows: one tensor copy by lane 0 where dy's rows go in
  // 16-byte pieces (the copy fills zeros past B and Co), else loads
  auto load_stage = [&](int buf) {
    const int v = pk >> 8;
    const int n0 = lk * kNB;
    float* dst0 = as + buf * Sh::A_FLOATS;
    if (a.veca) {
      if (lane == 0)
        tma_dy_rows(dst0, &tm, bars + buf, n0, v, lbt * BT,
                    Sh::A_FLOATS * 4);
    } else {
#pragma unroll
      for (int i = 0; i < BT * 4 / 32; ++i) {
        const int e = lane + 32 * i;
        const int row = e / 4;
        const int q = e % 4;
        const int b = lbt * BT + row;
        const int n = n0 + 4 * q;
        float* dst = dst0 + dx_piece(row, q);
        const float* src = a.dy + ((size_t)b * a.V1 + v) * a.Co + n;
#pragma unroll
        for (int d = 0; d < 4; ++d)
          dst[d] = (b < a.B && n + d < a.Co) ? src[d] : 0.f;
      }
    }
    if (lane == 0) sring[buf] = pk & 0xff;
    if (++lk == nch) {  // the next entry
      lk = 0;
      pk = pk_next;
      lj = next_j(lj);
      if (lj == 0) ++lbt;
      pk_next = __ldg(a.ents + next_j(lj));
    }
  };

#pragma unroll
  for (int j = 0; j < NST - 1; ++j)
    if (j < n_stages) load_stage(j);

  float acc[8][8];
  int t = 0;  // the next stage to compute
  while (bt < bt_end || (bt == bt_end && r < r_end)) {
    const int len = __ldg(a.roffs + r + 1) - __ldg(a.roffs + r);
    const int u = __ldg(a.rows + r);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    for (int e = 0; e < len; ++e) {
      for (int k = 0; k < nch; ++k, ++t) {
        const int buf = t % NST;
        if (t + NST - 1 < n_stages) load_stage((t + NST - 1) % NST);
        if (a.veca) mbar_wait(bars + buf, (t / NST) & 1);
        __syncwarp();
        const float* ab = as + buf * Sh::A_FLOATS;
        const float* wb = ws + sring[buf] * CP * wst + k * kNB;
#pragma unroll
        for (int q = 0; q < kNB / 4; ++q) {
          float4 wv[8];
#pragma unroll
          for (int j = 0; j < 8; ++j)
            wv[j] = *reinterpret_cast<const float4*>(
                wb + (tc + j * NTC) * wst + 4 * q);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float4 av = *reinterpret_cast<const float4*>(
                ab + dx_piece(tb + i * NTB, q));
#pragma unroll
            for (int j = 0; j < 8; ++j) fma4(acc[i][j], av, wv[j]);
          }
        }
        __syncwarp();
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int b = bt * BT + tb + i * NTB;
      if (b >= a.B) continue;
      float* row = a.dx + ((size_t)b * a.V1 + u) * a.C;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = c0 + tc + j * NTC;
        if (c < a.C) row[c] = acc[i][j];
      }
    }
    if (++r == a.R) {
      r = 0;
      ++bt;
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

// The driver's tensor-map encoder, looked up once through the runtime (no
// link to the driver library).
PFN_cuTensorMapEncodeTiled_v12000 dx_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

// The short-row launch that ops/dx_plan.py:launch_plan chose: NTC, nw
// warps a block, nbx blocks a c-slice, shared memory (the weight slice,
// then each warp's ring of dy' rows, its slots and its barriers); a plan
// whose shared memory cannot hold them is refused.  dy' [B, V1, Co] is
// described to the tensor copies as a 3-d tensor, a box 16 channels x 1
// vertex x BT batch elements.
template <typename T, int NTC>
cudaError_t dx_short_launch(DxArgs a, int nw, int nbx, int smem,
                            cudaStream_t st) {
  using Sh = DxShape<NTC>;
  const long long slots = (long long)nw * kDxStages;
  const long long need = 4LL * a.S * Sh::CP * a.wst + kDxAlign +
                         slots * Sh::A_FLOATS * 4 + (slots + 1) / 2 * 8 +
                         slots * 8;
  if (nw < 1 || nw > kDxMaxWarps || nbx < 1 || smem < need ||
      smem > kSmemOne)
    return cudaErrorInvalidValue;
  CUtensorMap tm = {};
  if (a.veca) {
    PFN_cuTensorMapEncodeTiled_v12000 enc = dx_encoder();
    const cuuint64_t dims[3] = {(cuuint64_t)a.Co, (cuuint64_t)a.V1,
                                (cuuint64_t)a.B};
    const cuuint64_t strides[2] = {(cuuint64_t)a.Co * 4,
                                   (cuuint64_t)a.V1 * a.Co * 4};
    const cuuint32_t box[3] = {kNB, 1, Sh::BT};
    const cuuint32_t unit[3] = {1, 1, 1};
    if (enc == nullptr ||
        enc(&tm, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
            const_cast<float*>(a.dy), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      a.veca = 0;  // the rows by loads
  }
  auto kernel = dx_short_kernel<T, NTC>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const dim3 grid(nbx, (a.C + Sh::CP - 1) / Sh::CP);
  kernel<<<grid, 32 * nw, smem, st>>>(a, tm);
  return cudaSuccess;
}

template <typename T>
cudaError_t dx_dispatch(const float* dy, const void* w, const int* offs,
                        const int* cols, const int* chunk_lo,
                        const int* chunk_hi, const int* long_rows,
                        const int* chunk_offs, float* partial, float* dx,
                        const DxArgs& sa, int ntc, int nw, int nbx,
                        int smem, int B, int V1, int C, int S, int Co,
                        int long_thresh, int n_long, int n_chunks,
                        cudaStream_t st) {
  if ((long long)V1 * S * S >= (1LL << 32)) return cudaErrorInvalidValue;
  const unsigned s_inv = (unsigned)(((1ULL << 32) + S - 1) / S);
  cudaError_t err = cudaSuccess;
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
  } else if (sa.R > 0) {
    switch (ntc) {
      case 8: err = dx_short_launch<T, 8>(sa, nw, nbx, smem, st); break;
      case 4: err = dx_short_launch<T, 4>(sa, nw, nbx, smem, st); break;
      case 2: err = dx_short_launch<T, 2>(sa, nw, nbx, smem, st); break;
      case 1: err = dx_short_launch<T, 1>(sa, nw, nbx, smem, st); break;
      default: return cudaErrorInvalidValue;
    }
  }
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

// Launches the short-row kernel (or, for Co <= 4, the narrow kernel) and,
// for the n_long rows longer than long_thresh (cut into n_chunks chunks
// [chunk_lo[k], chunk_hi[k]), chunks chunk_offs[i]..chunk_offs[i+1] of long
// row i), the two long-row kernels; `partial` is [max(n_chunks, 1), B,
// S*Co] float32.  The short rows come from the plan of ops/dx_plan.py (its
// R rows, keys, offsets and E packed entries) with the launch its
// launch_plan chose (ntc, nw, nbx, smem).  Returns a CUDA error code
// (0 on success).
int sh_spiral_conv_bwd_dx(const void* dy, const void* w, const void* offs,
                          const void* cols, const void* chunk_lo,
                          const void* chunk_hi, const void* long_rows,
                          const void* chunk_offs, void* partial, void* dx,
                          const void* rows, const void* keys,
                          const void* roffs, const void* ents, int B, int V1,
                          int C, int S, int Co, int long_thresh, int n_long,
                          int n_chunks, int w_is_bf16, int R, int E, int ntc,
                          int nw, int nbx, int smem, void* stream) {
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
  if (R < 0 || E < 0 || (long long)E + R >= (1LL << 31) || S > 255 ||
      V1 >= (1 << 23))
    return static_cast<int>(cudaErrorInvalidValue);
  DxArgs a;
  a.dy = dyf;
  a.w = w;
  a.rows = static_cast<const int*>(rows);
  a.keys = static_cast<const int*>(keys);
  a.roffs = static_cast<const int*>(roffs);
  a.ents = static_cast<const int*>(ents);
  a.dx = dxf;
  a.B = B;
  a.V1 = V1;
  a.C = C;
  a.S = S;
  a.Co = Co;
  a.R = R;
  a.E = E;
  const int bt = ntc > 0 ? 8 * (32 / ntc) : 1;
  a.n_bt = (B + bt - 1) / bt;
  a.wst = (Co + kNB - 1) / kNB * kNB + 4;
  a.veca = (Co % 4 == 0) && (reinterpret_cast<uintptr_t>(dy) % 16 == 0);
  a.vecw = (Co % 4 == 0) &&
           (reinterpret_cast<uintptr_t>(w) % (w_is_bf16 ? 8 : 16) == 0);
  cudaError_t err;
  if (w_is_bf16)
    err = dx_dispatch<__nv_bfloat16>(dyf, w, of, cl, clo, chi, lr, co, pf, dxf,
                                     a, ntc, nw, nbx, smem, B, V1, C, S,
                                     Co, long_thresh, n_long, n_chunks, st);
  else
    err = dx_dispatch<float>(dyf, w, of, cl, clo, chi, lr, co, pf, dxf, a,
                             ntc, nw, nbx, smem, B, V1, C, S, Co,
                             long_thresh, n_long, n_chunks, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

const char* sh_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
