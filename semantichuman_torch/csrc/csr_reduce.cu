// Scatter-free CSR row reduce for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel benchmarks/pallas_dma_gather_probe.py:
// dma_csr_reduce (kernel _csr_reduce_kernel).  It computes
//
//   out[b, u, c] = sum_{j in [offs[u], offs[u+1])} wt[j] * g[b, cols[j], c]
//
// g [B, M, C] float32, offs [V1+1] and cols [nnz] int32, wt [nnz] float32
// in CSR order or null (every weight 1: no multiply), out [B, V1, C]
// float32.  In the port it is the backward of every row gather of the
// training path (ops/row_gather.py:GatherRowsFn; weighted for unpool's
// barycentric taps) and the spiral conv's input gradient on the unfused
// route, where g is dy' @ W^T viewed as [B, V1*S, C] and (offs, cols) the
// inverse spiral table.  Every sum runs in a fixed order (no atomics) and
// a weighted term is rounded before it is added (__fmul_rn, __fadd_rn: no
// FMA), so the result repeats from run to run.
//
// Bound on an H100 SXM: bytes.  Each element of g read once, each output
// written once, one add per 4 bytes read.  At the largest weighted call
// of the training step, unpool L1 -> L0's backward at B = 384 (g
// [384, 6893, 32], out [384, 3447, 32]), that is 0.34 GB read and
// 0.17 GB written, 0.15 ms at 3.35 TB/s.  The reads are gathers: each g
// row of an unpool is read by its three taps' rows, so 1.02 GB crosses
// from L2.  What holds a gather kernel to L2's rate is the number of
// bytes in flight, which a thread per (b, u, c) with 4-byte loads, one
// dependent chain each (cols[j] -> g), and the table reloaded for every
// batch element does not reach.
//
// Design.  Rows of these tables are short (unpool inverses at most 27
// entries, pool inverses 0 or 1, spiral inverses at most 38) except the
// dummy row of a spiral inverse, which every spiral pad points at (34,041
// of level 0's 103,395 entries).  Rows are split by length at a threshold
// the wrapper passes:
//   * short rows, one thread per (row u, 16-byte unit of C), u slowest,
//     flat over V1 * units: that flat index is also the unit's offset in
//     out[b], so every warp stores one contiguous run.  A thread reads
//     offs[u], offs[u+1] once and each entry's cols[j] and wt[j] once per
//     tile of BT batch elements (grid.y = ceil(B / BT)).  It takes the
//     entries in groups of E = 8 / BT: first the group's E column
//     indices, then its E * BT loads of g, all issued before any is used,
//     then the adds in ascending j: 8 loads in flight a thread whatever
//     the row's length.  Loads past the row's end or the tile's last batch
//     element read the last valid ones again instead of branching (a
//     branch per entry made each load of g wait for its index: the C = 3
//     calls at B = 4 ran some 20 % slower than the port's first kernel,
//     one thread per (b, u, c)).  The wrapper picks BT
//     (ops/csr_reduce.py:plan): up to 4 while the grid keeps one card's
//     worth of threads; 1 for 4-byte units (C odd) over rows of 4 or more
//     entries on average, which measured faster there (the faces'
//     backward, rows of 12 bytes).  BT = 8 and 16 measured slower (BT = 16
//     needs some 160 registers a thread, one block an SM).  Units of 8 or
//     4 bytes where C is not a multiple of 4.
//   * long rows take a fixed reduction tree, which fixes the order of the
//     sums: chunks of equal length; in a chunk, warp w sums
//     the entries w, w + 8, w + 16, ...; the 8 warp sums are added in warp
//     order into a partial per chunk; a last kernel adds each long row's
//     chunk partials in chunk order.  Here a warp's lanes run over (batch
//     element, unit) pairs, up to 32 / units batch elements a warp where a
//     row is at most 32 units, so a lane moves 16 bytes a load and no lane
//     idles at C = 16, 32 or 64; the wrapper gives a warp fewer batch
//     elements where the grid would leave SMs idle (the Trainer's batch
//     12).
// The wrapper allocates the partial-sum scratch [n_chunks, B, C].

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = 8;       // warps over a long row's chunk (the tree)

template <int NV>
struct VecOf;
template <>
struct VecOf<4> {
  using T = float4;
};
template <>
struct VecOf<2> {
  using T = float2;
};
template <>
struct VecOf<1> {
  using T = float;
};

__device__ __forceinline__ void unpack(float4 a, float* v) {
  v[0] = a.x;
  v[1] = a.y;
  v[2] = a.z;
  v[3] = a.w;
}
__device__ __forceinline__ void unpack(float2 a, float* v) {
  v[0] = a.x;
  v[1] = a.y;
}
__device__ __forceinline__ void unpack(float a, float* v) { v[0] = a; }
__device__ __forceinline__ void pack(const float* v, float4& a) {
  a = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void pack(const float* v, float2& a) {
  a = make_float2(v[0], v[1]);
}
__device__ __forceinline__ void pack(const float* v, float& a) { a = v[0]; }

// acc + wt * v, the product rounded on its own (the weighted instance),
// or acc + v
template <bool W>
__device__ __forceinline__ float add_term(float acc, float w, float v) {
  return __fadd_rn(acc, W ? __fmul_rn(w, v) : v);
}

template <int NV, int BT, bool W>
__global__ void __launch_bounds__(kThreads)
csr_rows_kernel(const typename VecOf<NV>::T* __restrict__ g,
                const int* __restrict__ offs, const int* __restrict__ cols,
                const float* __restrict__ wt,
                typename VecOf<NV>::T* __restrict__ out, int units,
                int n_units, long long g_batch, int B, int long_thresh) {
  using V = typename VecOf<NV>::T;
  const int k = blockIdx.x * kThreads + threadIdx.x;
  if (k >= n_units) return;
  const int u = k / units;
  const int q = k - u * units;
  const int lo = __ldg(offs + u);
  const int hi = __ldg(offs + u + 1);
  if (hi - lo > long_thresh) return;        // written by the long-row path
  const int b0 = blockIdx.y * BT;
  const int nb = min(BT, B - b0);
  const V* gb = g + static_cast<long long>(b0) * g_batch + q;
  float acc[BT][NV];
#pragma unroll
  for (int t = 0; t < BT; ++t)
#pragma unroll
    for (int i = 0; i < NV; ++i) acc[t][i] = 0.f;
  // entries in groups of E: the group's column indices and weights, then
  // its E * BT loads of g are issued together (indices clamped to the
  // row's last entry and batch elements to the tile's last, so no load
  // waits behind a branch), then added in ascending j
  constexpr int E = 8 / BT;
  for (int j0 = lo; j0 < hi; j0 += E) {
    int col[E];
    float w[E];
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int j = min(j0 + e, hi - 1);
      col[e] = __ldg(cols + j);
      w[e] = W ? __ldg(wt + j) : 1.f;
    }
    V v[E][BT];
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const V* src = gb + static_cast<long long>(col[e]) * units;
#pragma unroll
      for (int t = 0; t < BT; ++t)
        v[e][t] = __ldg(src + min(t, nb - 1) * g_batch);
    }
#pragma unroll
    for (int e = 0; e < E; ++e) {
      if (j0 + e < hi) {
#pragma unroll
        for (int t = 0; t < BT; ++t) {
          if (t < nb) {
            float f[NV];
            unpack(v[e][t], f);
#pragma unroll
            for (int i = 0; i < NV; ++i)
              acc[t][i] = add_term<W>(acc[t][i], w[e], f[i]);
          }
        }
      }
    }
  }
  V* dst = out + static_cast<long long>(b0) * n_units + k;
#pragma unroll
  for (int t = 0; t < BT; ++t) {
    if (t < nb) {
      V o;
      pack(acc[t], o);
      dst[static_cast<long long>(t) * n_units] = o;
    }
  }
}

// One block per (chunk k, group of bpw batch elements, slice of 32
// units): lane l takes batch element b0 + l / upw and unit q0 + l % upw,
// warp w the chunk's entries w, w + kWarps, ...; the warp sums are added
// in warp order.  upw = min(units, 32), bpw * upw <= 32.
template <int NV, bool W>
__global__ void __launch_bounds__(32 * kWarps)
csr_rows_long_kernel(const typename VecOf<NV>::T* __restrict__ g,
                     const int* __restrict__ cols,
                     const float* __restrict__ wt,
                     const int* __restrict__ chunk_lo,
                     const int* __restrict__ chunk_hi,
                     typename VecOf<NV>::T* __restrict__ partial, int B,
                     int units, int upw, int bpw, long long g_batch) {
  using V = typename VecOf<NV>::T;
  __shared__ float red[kWarps][32][NV];
  const int k = blockIdx.x;
  const int lane = threadIdx.x;
  const int warp = threadIdx.y;
  const int b = blockIdx.y * bpw + lane / upw;
  const int q = blockIdx.z * 32 + lane % upw;
  const bool active = lane < bpw * upw && b < B && q < units;
  float acc[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) acc[i] = 0.f;
  if (active) {
    const V* gb = g + static_cast<long long>(b) * g_batch + q;
    const int hi = chunk_hi[k];
#pragma unroll 4
    for (int j = chunk_lo[k] + warp; j < hi; j += kWarps) {
      const float w = W ? __ldg(wt + j) : 1.f;
      float f[NV];
      unpack(__ldg(gb + static_cast<long long>(__ldg(cols + j)) * units), f);
#pragma unroll
      for (int i = 0; i < NV; ++i) acc[i] = add_term<W>(acc[i], w, f[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < NV; ++i) red[warp][lane][i] = acc[i];
  __syncthreads();
  if (warp != 0 || !active) return;
  float s[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    s[i] = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s[i] = __fadd_rn(s[i], red[w][lane][i]);
  }
  V o;
  pack(s, o);
  partial[(static_cast<long long>(k) * B + b) * units + q] = o;
}

// One thread per (long row i, batch element b, unit q): the row's chunk
// partials added in chunk order.
template <int NV>
__global__ void __launch_bounds__(kThreads)
csr_rows_finish_kernel(const typename VecOf<NV>::T* __restrict__ partial,
                       const int* __restrict__ long_rows,
                       const int* __restrict__ chunk_offs,
                       typename VecOf<NV>::T* __restrict__ out, int B,
                       int V1, int units, int n_long) {
  using V = typename VecOf<NV>::T;
  const long long n = static_cast<long long>(n_long) * B * units;
  const long long t = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (t >= n) return;
  const int q = static_cast<int>(t % units);
  const int b = static_cast<int>((t / units) % B);
  const int i = static_cast<int>(t / (static_cast<long long>(units) * B));
  float s[NV];
#pragma unroll
  for (int c = 0; c < NV; ++c) s[c] = 0.f;
  for (int k = chunk_offs[i]; k < chunk_offs[i + 1]; ++k) {
    float f[NV];
    unpack(partial[(static_cast<long long>(k) * B + b) * units + q], f);
#pragma unroll
    for (int c = 0; c < NV; ++c) s[c] = __fadd_rn(s[c], f[c]);
  }
  V o;
  pack(s, o);
  out[(static_cast<long long>(b) * V1 + long_rows[i]) * units + q] = o;
}

struct Args {
  const void* g;
  const int* offs;
  const int* cols;
  const float* wt;
  const int* chunk_lo;
  const int* chunk_hi;
  const int* long_rows;
  const int* chunk_offs;
  void* partial;
  void* out;
  int B, M, V1, units, long_thresh, n_long, n_chunks, bt, long_bpw;
};

template <int NV, int BT, bool W>
void launch_rows(const Args& a, cudaStream_t st) {
  using V = typename VecOf<NV>::T;
  const int n_units = a.V1 * a.units;
  const dim3 grid((n_units + kThreads - 1) / kThreads, (a.B + BT - 1) / BT);
  csr_rows_kernel<NV, BT, W><<<grid, kThreads, 0, st>>>(
      static_cast<const V*>(a.g), a.offs, a.cols, a.wt,
      static_cast<V*>(a.out), a.units, n_units,
      static_cast<long long>(a.M) * a.units, a.B, a.long_thresh);
}

template <int NV, bool W>
int launch(const Args& a, cudaStream_t st) {
  using V = typename VecOf<NV>::T;
  switch (a.bt) {
    case 1: launch_rows<NV, 1, W>(a, st); break;
    case 2: launch_rows<NV, 2, W>(a, st); break;
    case 4: launch_rows<NV, 4, W>(a, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (a.n_long == 0) return 0;
  const int upw = a.units < 32 ? a.units : 32;
  const int bpw = a.long_bpw;
  if (bpw < 1 || bpw * upw > 32)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid_part(a.n_chunks, (a.B + bpw - 1) / bpw,
                       (a.units + 31) / 32);
  const long long g_batch = static_cast<long long>(a.M) * a.units;
  csr_rows_long_kernel<NV, W><<<grid_part, dim3(32, kWarps), 0, st>>>(
      static_cast<const V*>(a.g), a.cols, a.wt, a.chunk_lo, a.chunk_hi,
      static_cast<V*>(a.partial), a.B, a.units, upw, bpw, g_batch);
  const long long n_fin = static_cast<long long>(a.n_long) * a.B * a.units;
  csr_rows_finish_kernel<NV><<<static_cast<unsigned>(
      (n_fin + kThreads - 1) / kThreads), kThreads, 0, st>>>(
      static_cast<const V*>(a.partial), a.long_rows, a.chunk_offs,
      static_cast<V*>(a.out), a.B, a.V1, a.units, a.n_long);
  return 0;
}

template <int NV>
int launch_weighted(const Args& a, cudaStream_t st) {
  return a.wt != nullptr ? launch<NV, true>(a, st) : launch<NV, false>(a, st);
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for a unit or tile the kernels do not take.  `unit`
// (16, 8 or 4 bytes) divides C * 4 and the addresses of g, out and
// partial; `bt` (1, 2 or 4) is the batch tile, `long_bpw` the batch
// elements a warp of the long-row kernel takes (long_bpw * min(units, 32)
// <= 32).  The caller has
// checked shapes, types, contiguity, that V1 * C / (unit / 4) and
// ceil(B / bt) fit the grid, B <= 65535, and that rows longer than
// long_thresh are exactly the n_long rows of long_rows, cut into the
// n_chunks chunks [chunk_lo[k], chunk_hi[k]), chunks chunk_offs[i] ..
// chunk_offs[i+1] of long row i.  `wt` is null for the unweighted reduce.
int sh_csr_reduce(const void* g, const void* offs, const void* cols,
                  const void* wt, const void* chunk_lo, const void* chunk_hi,
                  const void* long_rows, const void* chunk_offs,
                  void* partial, void* out, int B, int M, int V1, int C,
                  int long_thresh, int n_long, int n_chunks, int unit,
                  int bt, int long_bpw, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || V1 <= 0 || C <= 0) return 0;
  if ((unit != 16 && unit != 8 && unit != 4) || (C * 4) % unit != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{g, static_cast<const int*>(offs),
               static_cast<const int*>(cols), static_cast<const float*>(wt),
               static_cast<const int*>(chunk_lo),
               static_cast<const int*>(chunk_hi),
               static_cast<const int*>(long_rows),
               static_cast<const int*>(chunk_offs), partial, out, B, M, V1,
               C * 4 / unit, long_thresh, n_long, n_chunks, bt, long_bpw};
  int rc = 0;
  switch (unit) {
    case 16: rc = launch_weighted<4>(a, st); break;
    case 8: rc = launch_weighted<2>(a, st); break;
    default: rc = launch_weighted<1>(a, st); break;
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

const char* sh_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
