// Row gather for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel benchmarks/pallas_dma_gather_probe.py:dma_gather
// (kernel _gather_kernel), which copied each selected row with its own DMA
// into a VMEM window.  It computes
//
//   out[k, :] = x[idx[k], :]      x [N, D], idx [n_out] int32
//
// on packed rows of any element type, as a copy of 2-16 byte units.  In the
// port it is the banded routes' out-of-band fix-up gather take(xp, fix_src)
// (ops/spiral_conv.py, ops/sampling.py), over rows of B*C values.
//
// Design: a block of 8 warps takes 8 output rows; the lanes of a warp copy
// one row's units in order, so every load and store of a warp is one
// contiguous run (coalesced), and a 16-byte unit moves 512 bytes per warp
// instruction.  The per-row DMA window of the TPU kernel has no counterpart.
//
// Bound on an H100 SXM: bytes.  Each gathered row is read once and written
// once, plus 4 bytes of index a row.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kRowsPerBlock = 8;

template <typename U>
__global__ void __launch_bounds__(32 * kRowsPerBlock)
row_gather_kernel(const U* __restrict__ x, const int* __restrict__ idx,
                  U* __restrict__ out, int n_out, int mu) {
  const int k = blockIdx.x * kRowsPerBlock + threadIdx.y;
  if (k >= n_out) return;
  const U* src = x + static_cast<long long>(__ldg(idx + k)) * mu;
  U* dst = out + static_cast<long long>(k) * mu;
  for (int m = threadIdx.x; m < mu; m += 32) dst[m] = src[m];
}

template <typename U>
void launch(const void* x, const void* idx, void* out, int n_out,
            int row_bytes, cudaStream_t st) {
  const int grid = (n_out + kRowsPerBlock - 1) / kRowsPerBlock;
  row_gather_kernel<U><<<grid, dim3(32, kRowsPerBlock), 0, st>>>(
      static_cast<const U*>(x), static_cast<const int*>(idx),
      static_cast<U*>(out), n_out,
      row_bytes / static_cast<int>(sizeof(U)));
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// `unit` (16, 8, 4 or 2 bytes) divides row_bytes and both pointers'
// alignment; the caller has checked every idx[k] against the rows of x.
int sh_row_gather(const void* x, const void* idx, void* out, int n_out,
                  int row_bytes, int unit, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_out <= 0 || row_bytes <= 0) return 0;
  switch (unit) {
    case 16: launch<uint4>(x, idx, out, n_out, row_bytes, st); break;
    case 8: launch<uint2>(x, idx, out, n_out, row_bytes, st); break;
    case 4: launch<unsigned int>(x, idx, out, n_out, row_bytes, st); break;
    case 2: launch<unsigned short>(x, idx, out, n_out, row_bytes, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* sh_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
