// The training step's optimizer for Hopper (sm_90a), plain C interface:
// the gradients' global norm and one step of Adam with the norm clip and
// the coupled weight decay, over a table of every leaf.
//
// Replaces no TPU kernel: the JAX package's optimizer is optax's chain
// (semantichuman_tpu/train/optim.py), which XLA fuses on the TPU.  Its
// plain version on the card was a chain of PyTorch library calls
// (train/optim.py: `global_norm`, `Adam._moments`): 150-300 launches a
// step, each reading and writing whole arrays.  Here it is three kernels:
//   adam_sumsq_kernel   the sum of g^2 of each chunk and a flag, set where
//                       an entry of the chunk is NaN or Inf
//   adam_norm_kernel    one block: the chunks' sums in a fixed order, the
//                       square root, the flags or-ed: (norm, nonfinite)
//   adam_update_kernel  per entry, the plain version's operations in its
//                       order (train/optim.py:Adam._moments, update_):
//     g  = (g / norm) * clip           where clip_on and !(norm < clip)
//     g  = g + wd p                    where wd_on
//     m' = g (1 - b1) + m b1
//     v' = (g g) (1 - b2) + v b2
//     u  = ((m' / bc1) / (sqrt(v' / bc2) + eps)) * neg_lr
//     in place: p += u, m = m', v = v' (p += 0 and m, v kept where the
//     device flag `keep` is 0); out of place: u, m', v' written to fresh
//     arrays and p, m, v only read.
//   neg_lr, bc1 and bc2 are read from the device (the step's row of
//   `Adam.step_scalars`), so a captured graph replays any step.
//
// Rounding: every product, sum, quotient and square root is rounded as
// the plain version's separate kernels round it (__fmul_rn, __fadd_rn,
// __fdiv_rn, __fsqrt_rn: never contracted), except the decay: PyTorch's
// `_foreach_add(g, p, alpha=wd)` computes g + wd * p in one functor, which
// nvcc contracts into one fused multiply-add, and so does this kernel
// (__fmaf_rn).  The update is then the plain chain's bit for bit for a
// given norm.  The norm is summed in another order than torch.sum's, so it
// and the clip's divisor differ from the plain chain's by rounding.
//
// The leaf table: each leaf's pointers and entries, and the first of its
// chunks (`first`, a prefix over the leaves of ceil(n / chunk)).  A block
// takes one chunk, finds its leaf by a scan of `first`, and walks the
// chunk's entries 16 bytes a thread where every pointer of the leaf is
// 16-byte aligned (bit i of `vec`), else one float a thread.  The table
// goes to the kernel by value, as a kernel parameter (2.2 KB of the 4 KB),
// so that a captured graph records it; a longer leaf list takes more than
// one launch (the host's plan, ops/adam.py:leaf_plan).
//
// Bound on an H100 SXM: bytes.  The update reads g, p, m and v and writes
// p, m and v, 28 bytes an entry; the norm reads g once more.  Each chunk's
// sum is a fixed tree (per-thread sums, a shuffle tree, the warps in
// order), and the finish adds the chunks in one block's fixed tree, with
// no atomics: two runs give the same bits.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxLeaves = 32;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

struct Table {
  const float* g[kMaxLeaves];
  float* p[kMaxLeaves];
  float* m[kMaxLeaves];
  float* v[kMaxLeaves];
  float* mo[kMaxLeaves];   // m' and v' (in place: m and v)
  float* vo[kMaxLeaves];
  float* u[kMaxLeaves];    // the update (in place: null, p += u)
  long long n[kMaxLeaves];
  int first[kMaxLeaves + 1];
  int n_leaves;
  unsigned vec;
};

struct Hyper {
  float clip, wd, b1, c1, b2, c2, eps;
  int clip_on, wd_on;
};

__device__ __forceinline__ int leaf_of(const Table& t, int c) {
  int leaf = 0;
  while (leaf + 1 < t.n_leaves && t.first[leaf + 1] <= c) ++leaf;
  return leaf;
}

__device__ __forceinline__ bool nonfinite(float x) {
  return (__float_as_uint(x) & 0x7f800000u) == 0x7f800000u;
}

__device__ __forceinline__ float sq_add(float acc, float x) {
  return __fadd_rn(acc, __fmul_rn(x, x));
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1)
    x = __fadd_rn(x, __shfl_xor_sync(kFull, x, off));
  return x;
}

// The block's sum of x in a fixed order: lanes by the shuffle tree, then
// the warps' sums in warp order; valid in thread 0.
__device__ __forceinline__ float block_sum(float x, float* red) {
  x = warp_sum(x);
  const int w = threadIdx.x / 32;
  if ((threadIdx.x & 31) == 0) red[w] = x;
  __syncthreads();
  float s = 0.0f;
  if (threadIdx.x == 0)
    for (int i = 0; i < kWarps; ++i) s = __fadd_rn(s, red[i]);
  return s;
}

__global__ void __launch_bounds__(kThreads)
adam_sumsq_kernel(Table t, int chunk, float2* __restrict__ partial) {
  __shared__ float red[kWarps];
  const int c = blockIdx.x;
  const int leaf = leaf_of(t, c);
  const long long lo = static_cast<long long>(c - t.first[leaf]) * chunk;
  const long long hi = min(lo + chunk, t.n[leaf]);
  const float* __restrict__ g = t.g[leaf];
  float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
  bool bad = false;
  long long i = lo;
  if ((t.vec >> leaf) & 1u) {
    const long long n4 = (hi - lo) / 4;
    const float4* __restrict__ g4 = reinterpret_cast<const float4*>(g + lo);
    for (long long j = threadIdx.x; j < n4; j += kThreads) {
      const float4 x = g4[j];
      a0 = sq_add(a0, x.x);
      a1 = sq_add(a1, x.y);
      a2 = sq_add(a2, x.z);
      a3 = sq_add(a3, x.w);
      bad |= nonfinite(x.x) | nonfinite(x.y) | nonfinite(x.z)
             | nonfinite(x.w);
    }
    i = lo + n4 * 4;
  }
  for (long long j = i + threadIdx.x; j < hi; j += kThreads) {
    const float x = g[j];
    a0 = sq_add(a0, x);
    bad |= nonfinite(x);
  }
  const float s = block_sum(__fadd_rn(__fadd_rn(a0, a1), __fadd_rn(a2, a3)),
                            red);
  const int any_bad = __syncthreads_or(bad);
  if (threadIdx.x == 0) partial[c] = make_float2(s, any_bad ? 1.0f : 0.0f);
}

// out[0] = sqrt(sum of the chunks' sums), out[1] = 1 where a chunk had a
// NaN or an Inf, else 0.
__global__ void __launch_bounds__(kThreads)
adam_norm_kernel(const float2* __restrict__ partial, int n, float* out) {
  __shared__ float red[kWarps];
  float s = 0.0f;
  bool bad = false;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const float2 q = partial[i];
    s = __fadd_rn(s, q.x);
    bad |= q.y != 0.0f;
  }
  s = block_sum(s, red);
  const int any_bad = __syncthreads_or(bad);
  if (threadIdx.x == 0) {
    out[0] = __fsqrt_rn(s);
    out[1] = any_bad ? 1.0f : 0.0f;
  }
}

struct Step {
  Hyper h;
  bool clip;      // the clip engaged this step
  float norm;
  float neg_lr, bc1, bc2;

  // -> the update of one entry; m and v become m' and v'
  __device__ __forceinline__ float operator()(float g, float p, float& m,
                                              float& v) const {
    if (clip) g = __fmul_rn(__fdiv_rn(g, norm), h.clip);
    if (h.wd_on) g = __fmaf_rn(h.wd, p, g);
    m = __fadd_rn(__fmul_rn(g, h.c1), __fmul_rn(m, h.b1));
    v = __fadd_rn(__fmul_rn(__fmul_rn(g, g), h.c2), __fmul_rn(v, h.b2));
    const float d = __fadd_rn(__fsqrt_rn(__fdiv_rn(v, bc2)), h.eps);
    return __fmul_rn(__fdiv_rn(__fdiv_rn(m, bc1), d), neg_lr);
  }
};

__device__ __forceinline__ void entry(const Step& st, bool apply,
                                      bool in_place, float g, float& p,
                                      float& m, float& v, float& u) {
  float m1 = m, v1 = v;
  const float upd = st(g, p, m1, v1);
  if (in_place) {
    p = __fadd_rn(p, apply ? upd : 0.0f);
    if (apply) {
      m = m1;
      v = v1;
    }
  } else {
    u = upd;
    m = m1;
    v = v1;
  }
}

__global__ void __launch_bounds__(kThreads)
adam_update_kernel(Table t, int chunk, Hyper h,
                   const float* __restrict__ scalars,
                   const float* __restrict__ norm,
                   const unsigned char* __restrict__ keep) {
  const int c = blockIdx.x;
  const int leaf = leaf_of(t, c);
  const long long lo = static_cast<long long>(c - t.first[leaf]) * chunk;
  const long long hi = min(lo + chunk, t.n[leaf]);
  Step st;
  st.h = h;
  st.norm = h.clip_on ? norm[0] : 1.0f;
  st.clip = h.clip_on && !(st.norm < h.clip);
  st.neg_lr = scalars[0];
  st.bc1 = scalars[1];
  st.bc2 = scalars[2];
  const bool apply = keep == nullptr || keep[0] != 0;
  // m and mo (v and vo) are one array in place: no __restrict__
  const float* __restrict__ g = t.g[leaf];
  float* p = t.p[leaf];
  const float* m = t.m[leaf];
  const float* v = t.v[leaf];
  float* mo = t.mo[leaf];
  float* vo = t.vo[leaf];
  float* u = t.u[leaf];
  const bool in_place = u == nullptr;
  long long i = lo;
  if ((t.vec >> leaf) & 1u) {
    const long long n4 = (hi - lo) / 4;
    for (long long j = threadIdx.x; j < n4; j += kThreads) {
      const long long k = lo + 4 * j;
      const float4 g4 = *reinterpret_cast<const float4*>(g + k);
      float4 p4 = *reinterpret_cast<const float4*>(p + k);
      float4 m4 = *reinterpret_cast<const float4*>(m + k);
      float4 v4 = *reinterpret_cast<const float4*>(v + k);
      float4 u4;
      entry(st, apply, in_place, g4.x, p4.x, m4.x, v4.x, u4.x);
      entry(st, apply, in_place, g4.y, p4.y, m4.y, v4.y, u4.y);
      entry(st, apply, in_place, g4.z, p4.z, m4.z, v4.z, u4.z);
      entry(st, apply, in_place, g4.w, p4.w, m4.w, v4.w, u4.w);
      if (in_place) {
        *reinterpret_cast<float4*>(p + k) = p4;
      } else {
        *reinterpret_cast<float4*>(u + k) = u4;
      }
      if (!in_place || apply) {
        *reinterpret_cast<float4*>(mo + k) = m4;
        *reinterpret_cast<float4*>(vo + k) = v4;
      }
    }
    i = lo + n4 * 4;
  }
  for (long long k = i + threadIdx.x; k < hi; k += kThreads) {
    float pk = p[k], mk = m[k], vk = v[k], uk;
    entry(st, apply, in_place, g[k], pk, mk, vk, uk);
    if (in_place) {
      p[k] = pk;
    } else {
      u[k] = uk;
    }
    if (!in_place || apply) {
      mo[k] = mk;
      vo[k] = vk;
    }
  }
}

// The table of one launch from the host's arrays; false where the host's
// plan does not fit it.
bool make_table(Table* t, void* const* ptrs, const long long* n,
                const int* first, int n_leaves, unsigned vec, int roles) {
  if (n_leaves < 1 || n_leaves > kMaxLeaves) return false;
  *t = Table{};
  for (int i = 0; i < n_leaves; ++i) {
    t->g[i] = static_cast<const float*>(ptrs[i]);
    if (roles == 7) {
      t->p[i] = static_cast<float*>(ptrs[n_leaves + i]);
      t->m[i] = static_cast<float*>(ptrs[2 * n_leaves + i]);
      t->v[i] = static_cast<float*>(ptrs[3 * n_leaves + i]);
      t->mo[i] = static_cast<float*>(ptrs[4 * n_leaves + i]);
      t->vo[i] = static_cast<float*>(ptrs[5 * n_leaves + i]);
      t->u[i] = static_cast<float*>(ptrs[6 * n_leaves + i]);
    }
    t->n[i] = n[i];
    if (n[i] < 0 || first[i + 1] < first[i]) return false;
  }
  for (int i = 0; i <= n_leaves; ++i) t->first[i] = first[i];
  t->n_leaves = n_leaves;
  t->vec = vec;
  return true;
}

}  // namespace

extern "C" {

// Each launches on `stream` and returns cudaGetLastError() (0 on success),
// or cudaErrorInvalidValue for a table the kernels do not take.  A launch's
// leaves are n_leaves <= 32 float32 arrays of n[i] entries; its chunks are
// first[0] = 0 .. first[n_leaves], leaf i's first[i] .. first[i+1] - 1,
// each `chunk` entries of the leaf (the last one the rest), chunk a
// positive multiple of 4.  Bit i of `vec` is set only where every pointer
// of leaf i is 16-byte aligned.  The caller has checked the arrays'
// devices, types and contiguity.

// ptrs: the gradients [n_leaves]; partial: float2 [first[n_leaves]].
int sh_adam_sumsq(void* const* ptrs, const long long* n, const int* first,
                  int n_leaves, unsigned vec, int chunk, void* partial,
                  void* stream) {
  Table t;
  if (chunk <= 0 || chunk % 4 != 0
      || !make_table(&t, ptrs, n, first, n_leaves, vec, 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (first[n_leaves] == 0) return 0;
  adam_sumsq_kernel<<<first[n_leaves], kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      t, chunk, static_cast<float2*>(partial));
  return static_cast<int>(cudaGetLastError());
}

// partial: float2 [n] (every launch's chunks); out: float [2].
int sh_adam_norm(const void* partial, int n, void* out, void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  adam_norm_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(partial), n, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// ptrs: [7][n_leaves] by role: g, p, m, v, m', v', u (u null: in place,
// and then m' = m, v' = v).  scalars: float [3] (neg_lr, bc1, bc2) on the
// device; norm: float [1] on the device, read where clip_on; keep: uint8
// [1] on the device or null (apply every step).
int sh_adam_update(void* const* ptrs, const long long* n, const int* first,
                   int n_leaves, unsigned vec, int chunk, const void* scalars,
                   const void* norm, const void* keep, float clip, float wd,
                   float b1, float c1, float b2, float c2, float eps,
                   int clip_on, int wd_on, void* stream) {
  Table t;
  if (chunk <= 0 || chunk % 4 != 0 || (clip_on && norm == nullptr)
      || !make_table(&t, ptrs, n, first, n_leaves, vec, 7))
    return static_cast<int>(cudaErrorInvalidValue);
  if (first[n_leaves] == 0) return 0;
  const Hyper h{clip, wd, b1, c1, b2, c2, eps, clip_on, wd_on};
  adam_update_kernel<<<first[n_leaves], kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      t, chunk, h, static_cast<const float*>(scalars),
      static_cast<const float*>(norm),
      static_cast<const unsigned char*>(keep));
  return static_cast<int>(cudaGetLastError());
}

const char* sh_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
