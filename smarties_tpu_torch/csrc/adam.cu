// The Adam step of every learner, one launch over all parameter leaves.
//
// Replaces no TPU kernel: the JAX package's Adam
// (smarties_tpu/models/optim.py) is elementwise jnp code that XLA fuses
// into the jitted step. The port ran it as PyTorch ops, about 23
// elementwise kernels per leaf plus 8 for the step size: 178 launches in
// the captured V-RACER step, 0.193 ms of its 0.82 ms on the H100, for
// 0.15 us of memory work (17,539 parameters x 28 B, read w, g, m1, m2 and
// written w, m1, m2, all in L2). So the bound is the launch, not bytes or
// operations, and the design is one launch: a table of the leaves in the
// kernel's parameters, with the first block of each leaf, tells a block
// which leaf and which 1024 elements it updates.
//
// The arithmetic is the loop's of models/optim.py::adam_update_plain_,
// operation by operation in its order, every operation rounded to nearest
// (the __f*_rn intrinsics never contract into an FMA; the library is also
// built with --fmad=false), so the kernel is bit-equal to it on the card:
//   dw = gf * g
//   m1 = b1 * m1 + (1 - b1) * dw
//   m2 = maximum(b2 * m2 + ((1 - b2) * dw) * dw, m1 * m1)   NaN first
//   ret = (b1 * m1 + (1 - b1) * dw) / (eps + sqrt(m2))     Nesterov
//   w += eta_t * (ret + (-w) * lambda)                        AdamW
// with eta_t = (1 / (1 + step * time_inv)) * eta * sqrt(1 - beta_t_2)
// / (1 - beta_t_1) read from the device scalars, as the 0-d tensor ops
// compute it (PyTorch's `float / tensor` is reciprocal(tensor) * float).
// The constants arrive as float arguments, rounded from the Python
// doubles as PyTorch rounds a Python scalar for a float32 op.
//
// `advance_kernel`, one thread: beta_t *= beta, 0 below eps, for both
// betas, then step += 1 (models/optim.py::adam_advance_plain_).
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlockElems = 4 * kThreads;  // one float4 a thread
// leaves per launch: the table below stays within 4 KB of parameters
constexpr int kMaxLeaves = 64;

struct Leaf {
  float* w;
  const float* g;
  float* m1;
  float* m2;
  long long n;
  int block0;   // the leaf's first block
  int vec;      // all four arrays 16-byte aligned: float4 access
};

struct Table {
  Leaf leaf[kMaxLeaves];
  int n_leaves;
};

struct Scalars {
  float gf, b1, omb1, b2, omb2, eps, lambda, eta, time_inv;
};

__device__ __forceinline__ float max_nan(float a, float b) {
  // torch.maximum: a NaN operand is the result
  if (a != a) return a;
  if (b != b) return b;
  return fmaxf(a, b);
}

struct Elem {
  float w, m1, m2;
};

__device__ __forceinline__ Elem update(float w, float g, float m1, float m2,
                                       const Scalars& s, float eta_t) {
  const float dw = __fmul_rn(s.gf, g);
  const float m1n = __fadd_rn(__fmul_rn(s.b1, m1), __fmul_rn(s.omb1, dw));
  const float m2n = max_nan(
      __fadd_rn(__fmul_rn(s.b2, m2), __fmul_rn(__fmul_rn(s.omb2, dw), dw)),
      __fmul_rn(m1n, m1n));
  const float numer = __fadd_rn(__fmul_rn(s.b1, m1n), __fmul_rn(s.omb1, dw));
  const float ret = __fdiv_rn(numer, __fadd_rn(__fsqrt_rn(m2n), s.eps));
  const float penal = __fmul_rn(-w, s.lambda);
  return {__fadd_rn(w, __fmul_rn(eta_t, __fadd_rn(ret, penal))), m1n, m2n};
}

__global__ void __launch_bounds__(kThreads)
update_kernel(const __grid_constant__ Table t, const int* step,
              const float* beta_t_1, const float* beta_t_2,
              const __grid_constant__ Scalars s) {
  const int b = blockIdx.x;
  int i = 0;
  while (i + 1 < t.n_leaves && b >= t.leaf[i + 1].block0) ++i;
  const Leaf& L = t.leaf[i];

  // the bias-corrected, annealed step size, from the device scalars
  const float den = __fadd_rn(__fmul_rn(__int2float_rn(*step), s.time_inv),
                              1.0f);
  const float eta = __fmul_rn(__fdiv_rn(1.0f, den), s.eta);
  const float eta_t = __fdiv_rn(
      __fmul_rn(eta, __fsqrt_rn(__fsub_rn(1.0f, *beta_t_2))),
      __fsub_rn(1.0f, *beta_t_1));

  const long long lo = static_cast<long long>(b - L.block0) * kBlockElems;
  const long long hi = min(lo + kBlockElems, L.n);
  long long e = lo + threadIdx.x;
  if (L.vec) {
    const long long k = (lo >> 2) + threadIdx.x;   // lo is a multiple of 4
    if (4 * k + 3 < hi) {
      const float4 w = reinterpret_cast<const float4*>(L.w)[k];
      const float4 g = reinterpret_cast<const float4*>(L.g)[k];
      const float4 m1 = reinterpret_cast<const float4*>(L.m1)[k];
      const float4 m2 = reinterpret_cast<const float4*>(L.m2)[k];
      const Elem x = update(w.x, g.x, m1.x, m2.x, s, eta_t);
      const Elem y = update(w.y, g.y, m1.y, m2.y, s, eta_t);
      const Elem z = update(w.z, g.z, m1.z, m2.z, s, eta_t);
      const Elem q = update(w.w, g.w, m1.w, m2.w, s, eta_t);
      reinterpret_cast<float4*>(L.w)[k] = make_float4(x.w, y.w, z.w, q.w);
      reinterpret_cast<float4*>(L.m1)[k] =
          make_float4(x.m1, y.m1, z.m1, q.m1);
      reinterpret_cast<float4*>(L.m2)[k] =
          make_float4(x.m2, y.m2, z.m2, q.m2);
    }
    // the tail past the last whole float4
    e = lo + ((hi - lo) & ~3LL) + threadIdx.x;
  }
  for (; e < hi; e += kThreads) {
    const Elem x = update(L.w[e], L.g[e], L.m1[e], L.m2[e], s, eta_t);
    L.w[e] = x.w;
    L.m1[e] = x.m1;
    L.m2[e] = x.m2;
  }
}

__global__ void advance_kernel(float* beta_t_1, float* beta_t_2, int* step,
                               float b1, float b2, float eps) {
  const float t1 = __fmul_rn(*beta_t_1, b1);
  const float t2 = __fmul_rn(*beta_t_2, b2);
  *beta_t_1 = t1 < eps ? 0.0f : t1;
  *beta_t_2 = t2 < eps ? 0.0f : t2;
  *step += 1;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15ULL) == 0;
}

}  // namespace

extern "C" int smt_adam_max_leaves() { return kMaxLeaves; }

// ptrs: n_leaves x (w, g, m1, m2) device pointers, host array; numel:
// n_leaves element counts. One launch per kMaxLeaves leaves; a launch
// with no element is skipped. step: int32, beta_t_1 / beta_t_2: float32,
// 0-d on the device. Returns the first CUDA error, 0 if none.
extern "C" int smt_adam_update(void* const* ptrs, const long long* numel,
                               int n_leaves, const void* step,
                               const void* beta_t_1, const void* beta_t_2,
                               float gf, float b1, float omb1, float b2,
                               float omb2, float eps, float lambda, float eta,
                               float time_inv, void* stream) {
  const Scalars s{gf, b1, omb1, b2, omb2, eps, lambda, eta, time_inv};
  for (int first = 0; first < n_leaves; first += kMaxLeaves) {
    Table t;
    t.n_leaves = n_leaves - first < kMaxLeaves ? n_leaves - first
                                               : kMaxLeaves;
    long long blocks = 0;
    for (int j = 0; j < t.n_leaves; ++j) {
      void* const* p = ptrs + 4 * (first + j);
      const long long n = numel[first + j];
      t.leaf[j] = {static_cast<float*>(p[0]), static_cast<const float*>(p[1]),
                   static_cast<float*>(p[2]), static_cast<float*>(p[3]), n,
                   static_cast<int>(blocks),
                   aligned16(p[0]) && aligned16(p[1]) && aligned16(p[2]) &&
                       aligned16(p[3])};
      blocks += (n + kBlockElems - 1) / kBlockElems;
    }
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    if (blocks == 0) continue;
    update_kernel<<<static_cast<int>(blocks), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
        t, static_cast<const int*>(step),
        static_cast<const float*>(beta_t_1),
        static_cast<const float*>(beta_t_2), s);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// beta_t_1, beta_t_2: float32, step: int32, 0-d on the device.
extern "C" int smt_adam_advance(void* beta_t_1, void* beta_t_2, void* step,
                                float b1, float b2, float eps, void* stream) {
  advance_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(beta_t_1), static_cast<float*>(beta_t_2),
      static_cast<int*>(step), b1, b2, eps);
  return static_cast<int>(cudaGetLastError());
}
