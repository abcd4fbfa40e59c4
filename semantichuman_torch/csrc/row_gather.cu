// Batched, weighted row gather for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel benchmarks/pallas_dma_gather_probe.py:dma_gather
// (kernel _gather_kernel), which copied each selected row with its own DMA
// into a VMEM window.  It computes
//
//   out[b, r, :] = sum_{t < T} w[r, t] * x[b, idx[r, t], :]
//
// x [B, N, C] with packed rows (batch stride xs, any), idx [R, T] int32
// (T = 1 or 3), w [R, T] float32 or null (every weight 1), out [B, R, C]
// contiguous.  It is the forward of every row gather of the port's
// training path (ops/row_gather.py:GatherRowsFn): pool (T = 1), unpool's
// barycentric taps (T = 3, weighted), the part heads, the face corners,
// the part buckets of the distance loss, and the banded routes' fix-up
// rows (B = 1, T = 1).  Two kernels:
//   * copy (T = 1, no weights): rows move as raw 16/8/4/2-byte units of any
//     element type, so the result is x's bits;
//   * sum (weighted, or T > 1): float32 or bfloat16 elements, the T taps
//     summed in float32 in tap order, each product and sum rounded on its
//     own (__fmul_rn, __fadd_rn: no FMA), which is what the plain version
//     computes; the sum is rounded once to the element type.
//
// Thread map: one thread per (row r, unit u) of a batch element, u fastest,
// flat over R * units.  That flat index is also the unit's offset in
// out[b], so every warp stores one contiguous run, even at C = 3 float32
// (12-byte rows, 3 units a row), where a warp a row would leave 29 of 32
// lanes idle.  A thread reads its row's T indices and weights once and
// then loops over a tile of bt batch elements (grid.y = ceil(B / bt)), so
// the table is read once per tile, not once per batch element.  Sources
// are read through L2: a coarse row feeds up to 27 fine rows of an unpool.
//
// Bound on an H100 SXM: bytes.  Each distinct source row read once, each
// output row written once, plus the table.  At the largest call of the
// training step, unpool L1 -> L0 at B = 384 (R = 6894, T = 3, C = 32
// float32), that is 0.17 GB read and 0.34 GB written: 0.15 ms at
// 3.35 TB/s.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

template <typename U>
__global__ void __launch_bounds__(kThreads)
gather_copy_kernel(const U* __restrict__ x, const int* __restrict__ idx,
                   U* __restrict__ out, int units, long long n_units,
                   long long xs, int B, int bt) {
  const long long k = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (k >= n_units) return;
  const int r = static_cast<int>(k / units);
  const int u = static_cast<int>(k - static_cast<long long>(r) * units);
  const U* src = x + static_cast<long long>(__ldg(idx + r)) * units + u;
  U* dst = out + k;
  const int b0 = blockIdx.y * bt;
  const int b1 = min(B, b0 + bt);
#pragma unroll 4
  for (int b = b0; b < b1; ++b) dst[b * n_units] = src[b * xs];
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_float(float v, float& o) { o = v; }
__device__ __forceinline__ void from_float(float v, __nv_bfloat16& o) {
  o = __float2bfloat16_rn(v);
}

// NV elements of type E moved as one aligned unit
template <typename E, int NV>
struct alignas(sizeof(E) * NV) Unit {
  E v[NV];
};

template <typename E, int NV, int T, bool W>
__global__ void __launch_bounds__(kThreads)
gather_sum_kernel(const Unit<E, NV>* __restrict__ x,
                  const int* __restrict__ idx, const float* __restrict__ w,
                  Unit<E, NV>* __restrict__ out, int units, long long n_units,
                  long long xs, int B, int bt) {
  const long long k = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (k >= n_units) return;
  const int r = static_cast<int>(k / units);
  const int u = static_cast<int>(k - static_cast<long long>(r) * units);
  const Unit<E, NV>* src[T];
  float wt[T];
#pragma unroll
  for (int t = 0; t < T; ++t) {
    src[t] = x + static_cast<long long>(__ldg(idx + r * T + t)) * units + u;
    wt[t] = W ? __ldg(w + r * T + t) : 1.f;
  }
  Unit<E, NV>* dst = out + k;
  const int b0 = blockIdx.y * bt;
  const int b1 = min(B, b0 + bt);
#pragma unroll 2
  for (int b = b0; b < b1; ++b) {
    float acc[NV];
#pragma unroll
    for (int t = 0; t < T; ++t) {
      const Unit<E, NV> a = src[t][b * xs];
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const float v = to_float(a.v[i]);
        const float p = W ? __fmul_rn(wt[t], v) : v;
        acc[i] = t == 0 ? p : __fadd_rn(acc[i], p);
      }
    }
    Unit<E, NV> o;
#pragma unroll
    for (int i = 0; i < NV; ++i) from_float(acc[i], o.v[i]);
    dst[b * n_units] = o;
  }
}

struct Shape {
  int B, R, T, row_bytes, x_batch_bytes, unit, bt;
};

template <typename U>
void launch_copy(const void* x, const void* idx, void* out, const Shape& s,
                 cudaStream_t st) {
  const int units = s.row_bytes / s.unit;
  const long long n_units = static_cast<long long>(s.R) * units;
  const dim3 grid(static_cast<unsigned>((n_units + kThreads - 1) / kThreads),
                  (s.B + s.bt - 1) / s.bt);
  gather_copy_kernel<U><<<grid, kThreads, 0, st>>>(
      static_cast<const U*>(x), static_cast<const int*>(idx),
      static_cast<U*>(out), units, n_units, s.x_batch_bytes / s.unit, s.B,
      s.bt);
}

template <typename E, int NV, int T>
void launch_sum(const void* x, const void* idx, const void* w, void* out,
                const Shape& s, cudaStream_t st) {
  using V = Unit<E, NV>;
  const int units = s.row_bytes / s.unit;
  const long long n_units = static_cast<long long>(s.R) * units;
  const dim3 grid(static_cast<unsigned>((n_units + kThreads - 1) / kThreads),
                  (s.B + s.bt - 1) / s.bt);
  const long long xs = s.x_batch_bytes / s.unit;
  if (w != nullptr) {
    gather_sum_kernel<E, NV, T, true><<<grid, kThreads, 0, st>>>(
        static_cast<const V*>(x), static_cast<const int*>(idx),
        static_cast<const float*>(w), static_cast<V*>(out), units, n_units,
        xs, s.B, s.bt);
  } else {
    gather_sum_kernel<E, NV, T, false><<<grid, kThreads, 0, st>>>(
        static_cast<const V*>(x), static_cast<const int*>(idx), nullptr,
        static_cast<V*>(out), units, n_units, xs, s.B, s.bt);
  }
}

template <typename E, int T>
int dispatch_unit(const void* x, const void* idx, const void* w, void* out,
                  const Shape& s, cudaStream_t st) {
  constexpr int es = static_cast<int>(sizeof(E));
  switch (s.unit / es) {
    case 1: launch_sum<E, 1, T>(x, idx, w, out, s, st); return 0;
    case 2: launch_sum<E, 2, T>(x, idx, w, out, s, st); return 0;
    case 4: launch_sum<E, 4, T>(x, idx, w, out, s, st); return 0;
    case 8:
      if constexpr (es == 2) {
        launch_sum<E, 8, T>(x, idx, w, out, s, st);
        return 0;
      }
      break;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename E>
int dispatch_taps(const void* x, const void* idx, const void* w, void* out,
                  const Shape& s, cudaStream_t st) {
  if (s.unit < static_cast<int>(sizeof(E)))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (s.T) {
    case 1: return dispatch_unit<E, 1>(x, idx, w, out, s, st);
    case 3: return dispatch_unit<E, 3>(x, idx, w, out, s, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for a combination the kernels do not take.
// `unit` (16, 8, 4 or 2 bytes) divides row_bytes, x_batch_bytes and both
// pointers' alignment; `dtype` is 0 for float32, 1 for bfloat16 (read by
// the sum kernel only).  The copy kernel runs for T = 1 without weights.
// The caller has checked every idx entry against the rows of x, B >= 1,
// R >= 1 and ceil(B / bt) <= 65535.
int sh_gather_rows(const void* x, const void* idx, const void* w, void* out,
                   int B, int R, int T, int row_bytes, int x_batch_bytes,
                   int unit, int bt, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || R <= 0 || row_bytes <= 0) return 0;
  if (bt <= 0 || row_bytes % unit != 0 || x_batch_bytes % unit != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Shape s{B, R, T, row_bytes, x_batch_bytes, unit, bt};
  int rc = 0;
  if (T == 1 && w == nullptr) {
    switch (unit) {
      case 16: launch_copy<uint4>(x, idx, out, s, st); break;
      case 8: launch_copy<uint2>(x, idx, out, s, st); break;
      case 4: launch_copy<unsigned int>(x, idx, out, s, st); break;
      case 2: launch_copy<unsigned short>(x, idx, out, s, st); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  } else if (dtype == 0) {
    rc = dispatch_taps<float>(x, idx, w, out, s, st);
  } else if (dtype == 1) {
    rc = dispatch_taps<__nv_bfloat16>(x, idx, w, out, s, st);
  } else {
    rc = static_cast<int>(cudaErrorInvalidValue);
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

const char* sh_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
