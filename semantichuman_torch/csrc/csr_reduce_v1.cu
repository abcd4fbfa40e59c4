// Scatter-free CSR row reduce for Hopper (sm_90a), plain C interface:
// the port's first kernel, kept as the yardstick of `csrc/csr_reduce.cu`
// (`csr_reduce_v1` in ops/csr_reduce.py).  No main path launches it; it
// runs one thread per (b, u, c) over the short rows.
//
// Replaces the TPU kernel benchmarks/pallas_dma_gather_probe.py:
// dma_csr_reduce (kernel _csr_reduce_kernel).  It computes
//
//   out[b, u, c] = sum_{j in [offs[u], offs[u+1])} wt[j] * g[b, cols[j], c]
//
// g [B, M, C] float32, offs [V1+1] and cols [nnz] int32, wt [nnz] float32
// in CSR order or null (every weight 1: no multiply), out [B, V1, C]
// float32.  In the port it is the spiral conv's input gradient: g is the
// gathered-row gradient dy' @ W^T viewed as [B, V1*S, C], and (offs, cols)
// is the inverse spiral table, so `out` is the transpose of the gather
// x[b, spiral[v, s]] without a scatter.  It is also the backward of every
// row gather of the training path (ops/row_gather.py:GatherRowsFn), where
// the weighted form is the transpose of unpool's barycentric taps.  Every
// sum runs in a fixed order (no atomics), so the result is the same from
// run to run; a weighted term is rounded before it is added (__fmul_rn,
// no FMA), as the plain version computes it.
//
// Bound on an H100 SXM: bytes.  Each element of g is read once and each
// output written once, one add per 4 bytes read; at the training step's
// largest call (B = 384, level 0, V1*S = 103,395 rows of C = 32) that is
// 5.08 GB read + 0.34 GB written, 1.6 ms at 3.35 TB/s.
//
// Design.  Rows of the inverse table are short (at most 38 entries at
// level 0) except the dummy row V1-1, which every spiral pad points at:
// 34,041 of level 0's 103,395 entries.  One schedule for all rows would
// serialise on it, so rows are split by length at a threshold the wrapper
// passes:
//   * short rows: one thread per (b, u, c), c fastest, so a warp reads
//     consecutive channels of the same gathered rows; it sums the row's
//     entries in order;
//   * long rows (the dummy row in practice) are cut into chunks of equal
//     length.  One block per (chunk, b): lanes run over channels (up to 4
//     per lane, 128 per grid.z slice), 8 warps over the chunk's entries;
//     the 8 warp sums are added in warp order into a partial sum per
//     chunk.  A last kernel adds each long row's chunk partials in chunk
//     order.
// The wrapper allocates the partial-sum scratch [n_chunks, B, C].

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kPerLane = 4;                 // channels per lane in a slice
constexpr int kSlice = 32 * kPerLane;       // channels per grid.z slice

// the term of entry j: g's value, times wt[j] in the weighted instance
// (a template parameter, so the unweighted loop is the plain sum)
template <bool W>
__device__ __forceinline__ float term(const float* __restrict__ wt, int j,
                                      float v) {
  if constexpr (W) return __fmul_rn(__ldg(wt + j), v);
  return v;
}

template <bool W>
__global__ void csr_v1_short_kernel(const float* __restrict__ g,
                                 const int* __restrict__ offs,
                                 const int* __restrict__ cols,
                                 const float* __restrict__ wt,
                                 float* __restrict__ out, int M, int V1,
                                 int C, int long_thresh) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= V1 * C) return;
  const int b = blockIdx.y;
  const int u = idx / C;
  const int c = idx - u * C;
  const int lo = offs[u];
  const int hi = offs[u + 1];
  if (hi - lo > long_thresh) return;        // written by the long-row path
  const float* gb = g + (size_t)b * M * C + c;
  float acc = 0.f;
  for (int j = lo; j < hi; ++j)
    acc += term<W>(wt, j, gb[(size_t)cols[j] * C]);
  out[((size_t)b * V1 + u) * C + c] = acc;
}

template <bool W>
__global__ void __launch_bounds__(32 * kWarps)
csr_v1_long_partial_kernel(const float* __restrict__ g,
                        const int* __restrict__ cols,
                        const float* __restrict__ wt,
                        const int* __restrict__ chunk_lo,
                        const int* __restrict__ chunk_hi,
                        float* __restrict__ partial, int B, int M, int C) {
  __shared__ float red[kWarps][kSlice];
  const int k = blockIdx.x;
  const int b = blockIdx.y;
  const int c0 = blockIdx.z * kSlice;
  const int lane = threadIdx.x;
  const int warp = threadIdx.y;
  const float* gb = g + (size_t)b * M * C;
  float acc[kPerLane];
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) acc[i] = 0.f;
  const int hi = chunk_hi[k];
  for (int j = chunk_lo[k] + warp; j < hi; j += kWarps) {
    const float* row = gb + (size_t)cols[j] * C;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      const int c = c0 + lane + 32 * i;
      if (c < C) acc[i] += term<W>(wt, j, row[c]);
    }
  }
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) red[warp][lane + 32 * i] = acc[i];
  __syncthreads();
  if (warp != 0) return;
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const int c = c0 + lane + 32 * i;
    if (c >= C) continue;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[w][lane + 32 * i];
    partial[((size_t)k * B + b) * C + c] = s;
  }
}

__global__ void csr_v1_long_finish_kernel(const float* __restrict__ partial,
                                       const int* __restrict__ long_rows,
                                       const int* __restrict__ chunk_offs,
                                       float* __restrict__ out, int B,
                                       int V1, int C) {
  const int i = blockIdx.x;
  const int b = blockIdx.y;
  const int u = long_rows[i];
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float s = 0.f;
    for (int k = chunk_offs[i]; k < chunk_offs[i + 1]; ++k)
      s += partial[((size_t)k * B + b) * C + c];
    out[((size_t)b * V1 + u) * C + c] = s;
  }
}

}  // namespace

extern "C" {

// Launches the three kernels on `stream` and returns cudaGetLastError()
// (0 on success).  The caller has checked shapes, types, contiguity,
// B <= 65535 and that rows longer than long_thresh are exactly the
// n_long rows of long_rows, cut into the n_chunks chunks
// [chunk_lo[k], chunk_hi[k]), chunks chunk_offs[i]..chunk_offs[i+1] of
// long row i.  `wt` is null for the unweighted reduce.
int sh_csr_reduce_v1(const void* g, const void* offs, const void* cols,
                  const void* wt, const void* chunk_lo, const void* chunk_hi,
                  const void* long_rows, const void* chunk_offs,
                  void* partial, void* out, int B, int M, int V1, int C,
                  int long_thresh, int n_long, int n_chunks, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* gf = static_cast<const float*>(g);
  const int* cl = static_cast<const int*>(cols);
  const float* wf = static_cast<const float*>(wt);
  float* of = static_cast<float*>(out);
  const int threads = 256;
  const dim3 grid_short((V1 * C + threads - 1) / threads, B);
  const int* of_in = static_cast<const int*>(offs);
  if (wf != nullptr) {
    csr_v1_short_kernel<true><<<grid_short, threads, 0, st>>>(
        gf, of_in, cl, wf, of, M, V1, C, long_thresh);
  } else {
    csr_v1_short_kernel<false><<<grid_short, threads, 0, st>>>(
        gf, of_in, cl, nullptr, of, M, V1, C, long_thresh);
  }
  if (n_long > 0) {
    const dim3 grid_part(n_chunks, B, (C + kSlice - 1) / kSlice);
    const int* lo = static_cast<const int*>(chunk_lo);
    const int* hi = static_cast<const int*>(chunk_hi);
    float* part = static_cast<float*>(partial);
    if (wf != nullptr) {
      csr_v1_long_partial_kernel<true><<<grid_part, dim3(32, kWarps), 0, st>>>(
          gf, cl, wf, lo, hi, part, B, M, C);
    } else {
      csr_v1_long_partial_kernel<false><<<grid_part, dim3(32, kWarps), 0, st>>>(
          gf, cl, nullptr, lo, hi, part, B, M, C);
    }
    const dim3 grid_fin(n_long, B);
    csr_v1_long_finish_kernel<<<grid_fin, 128, 0, st>>>(
        static_cast<const float*>(partial),
        static_cast<const int*>(long_rows),
        static_cast<const int*>(chunk_offs), of, B, V1, C);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* sh_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
