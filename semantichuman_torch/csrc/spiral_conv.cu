// Spiral convolution forward for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel semantichuman_tpu/ops/pallas/spiral_conv_pallas.py:
// spiral_conv_fused (kernel _kernel, activation _act), whose XLA form is
// semantichuman_tpu/ops/spiral_conv.py:spiral_conv_take.  It computes
//
//   y[b, v, n] = act(sum_{s, c} x[b, spiral[v, s], c] * W[s*C + c, n] + bias[n])
//   y[b, V1-1, :] = 0                                   (the dummy row)
//
// x [B, V1, C] in float32 or bfloat16, spiral [V1, S] int32 (pads already
// point at the dummy row V1-1, which is gathered like any other row),
// W [S*C, Co] in x's type, bias [Co] float32, y [B, V1, Co] float32.
// Products and sums are float32 (a bf16 x bf16 product is exact in f32), so
// the two input types differ from the plain PyTorch version only in the
// order of the f32 sums.
//
// Bound on an H100 SXM at the serving path's shapes (9 convs, B = 64,
// float32): 2*B*V1*S*C*Co = 37.2 GFLOP per forward, 0.555 ms at the
// 67 TFLOP/s float32 FMA peak of the CUDA cores.  The bytes the convs must
// move (x, W, spiral and bias read once, y written once) are 0.42 GB, 0.13 ms
// at 3.35 TB/s; the largest is the level-0 decoder conv (x 57 MB + y 28 MB).
// Seven convs do 58-170 FLOP per byte, well above the card's float32 ridge
// of 20, and are bound by operations; the two 3-channel convs (input 3->16,
// output 16->3) do 19 and sit at the ridge.  With bf16 inputs the same work
// could run on the tensor cores (989 TFLOP/s) and every conv becomes bound
// by bytes; this kernel still multiplies on the CUDA cores, which is the
// first thing a faster version changes (wgmma).
//
// Design: one thread block computes a BM (vertices) x BN (output channels)
// tile of one batch element.  The K = S*C reduction is walked in chunks of
// BK: the block gathers the BM spiral rows' chunk of x into shared memory
// (converted to f32), stages the matching BK x BN slice of W, and every
// thread accumulates a TM x TN sub-tile in registers with fmaf.  Tiling K
// keeps shared memory small whatever S*C*Co is (W at the level-3 convs is
// 256 KB, more than a block may hold).  The four tile shapes follow Co so
// that the narrow convs (Co = 16, 3) waste few lanes.  No vector loads: rows
// of 3 channels (12 bytes) and Co = 3 outputs are handled element-wise.
// Each thread's rows and columns are strided by the thread grid so that
// shared-memory reads of a warp hit distinct banks and the output stores of
// a warp are contiguous in channels.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

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

template <typename T, int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
spiral_conv_fwd_kernel(const T* __restrict__ x, const int* __restrict__ spiral,
                       const T* __restrict__ w, const float* __restrict__ bias,
                       float* __restrict__ y, int V1, int C, int S, int Co,
                       int act) {
  constexpr int TX = BN / TN;  // threads along output channels
  constexpr int TY = BM / TM;  // threads along vertices
  constexpr int NT = TX * TY;
  // +1 column: the gather writes a warp's elements down one column of As
  __shared__ float As[BK][BM + 1];
  __shared__ float Bs[BK][BN];

  const int K = S * C;
  const int b = blockIdx.z;
  const int v0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const T* xb = x + (size_t)b * V1 * C;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // gather: kk runs fastest so that a warp reads consecutive channels of
    // the same source rows
    for (int e = tid; e < BM * BK; e += NT) {
      const int m = e / BK;
      const int kk = e % BK;
      const int v = v0 + m;
      const int k = k0 + kk;
      float val = 0.f;
      if (v < V1 && k < K) {
        const int s = k / C;
        const int c = k - s * C;
        const int src = spiral[(size_t)v * S + s];
        val = to_f32(xb[(size_t)src * C + c]);
      }
      As[kk][m] = val;
    }
    for (int e = tid; e < BK * BN; e += NT) {
      const int kk = e / BN;
      const int n = e % BN;
      const int k = k0 + kk;
      const int col = n0 + n;
      Bs[kk][n] = (k < K && col < Co) ? to_f32(w[(size_t)k * Co + col]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM];
      float bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk][ty + i * TY];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = Bs[kk][tx + j * TX];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int v = v0 + ty + i * TY;
    if (v >= V1) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = n0 + tx + j * TX;
      if (col >= Co) continue;
      const float r = (v == V1 - 1) ? 0.f : apply_act(acc[i][j] + bias[col], act);
      y[((size_t)b * V1 + v) * Co + col] = r;
    }
  }
}

template <typename T, int BM, int BN, int BK, int TM, int TN>
void launch(const void* x, const int* spiral, const void* w, const float* bias,
            float* y, int B, int V1, int C, int S, int Co, int act,
            cudaStream_t stream) {
  const dim3 grid((V1 + BM - 1) / BM, (Co + BN - 1) / BN, B);
  const dim3 block((BM / TM) * (BN / TN));
  spiral_conv_fwd_kernel<T, BM, BN, BK, TM, TN><<<grid, block, 0, stream>>>(
      static_cast<const T*>(x), spiral, static_cast<const T*>(w), bias, y, V1,
      C, S, Co, act);
}

template <typename T>
void dispatch(const void* x, const int* spiral, const void* w,
              const float* bias, float* y, int B, int V1, int C, int S, int Co,
              int act, cudaStream_t stream) {
  // 256 threads in every shape; BN follows Co so narrow outputs waste little
  if (Co > 32)
    launch<T, 64, 64, 16, 4, 4>(x, spiral, w, bias, y, B, V1, C, S, Co, act, stream);
  else if (Co > 16)
    launch<T, 128, 32, 16, 4, 4>(x, spiral, w, bias, y, B, V1, C, S, Co, act, stream);
  else if (Co > 4)
    launch<T, 256, 16, 16, 4, 4>(x, spiral, w, bias, y, B, V1, C, S, Co, act, stream);
  else
    launch<T, 256, 4, 16, 1, 4>(x, spiral, w, bias, y, B, V1, C, S, Co, act, stream);
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 on success); the
// caller has checked shapes, types, contiguity and B <= 65535.
int sh_spiral_conv_fwd(const void* x, const void* spiral, const void* w,
                       const void* bias, void* y, int B, int V1, int C, int S,
                       int Co, int act, int x_is_bf16, void* stream) {
  const int* sp = static_cast<const int*>(spiral);
  const float* bi = static_cast<const float*>(bias);
  float* out = static_cast<float*>(y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_is_bf16)
    dispatch<__nv_bfloat16>(x, sp, w, bi, out, B, V1, C, S, Co, act, st);
  else
    dispatch<float>(x, sp, w, bi, out, B, V1, C, S, Co, act, st);
  return static_cast<int>(cudaGetLastError());
}

const char* sh_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
