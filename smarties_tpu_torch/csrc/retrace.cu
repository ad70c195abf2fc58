// K1: the Retrace / GAE suffix scan, hand-written for Hopper (sm_90a).
//
// Replaces the one TPU kernel of the JAX package,
// smarties_tpu/ops/pallas_retrace.py::affine_suffix_scan (kernel body
// `_kernel`), together with the coefficient build and output mask of
// its wrapper `batched_retrace_pallas` (`retrace_coeffs`).
//
// What it computes, for every replay slot e, walking t = L1-1 ... 0:
//     q[e, t] = a[e, t] + b[e, t] * q[e, t+1],   q beyond L1-1 = 0.
// The fused entry point builds (a, b) on the fly from the replay fields
// (Retrace: a = r + g(V - lam c (A + V)), b = g lam c with c = min(1, rho);
// GAE: a = r + g(1 - lam) V, b = g lam; both read at t+1; a = bootstrap,
// b = 0 at t == length; zero beyond) and writes 0 for t > length.
//
// What bounds it on the H100: bytes. It does 3-6 flops per element and
// reads each input element once, and only at t = 1..length: at most
// 4 arrays x E x L1 x 4 B in (r, V, A, rho; ~33 MB at E = 4096,
// L1 = 501) plus 1 x E x L1 x 4 B out (~8.2 MB), so at most ~41 MB:
// ~12 us at the card's published 3.35 TB/s.
//
// What the design does about it: one thread per episode carries q in a
// register and walks t backwards, so every element is read and written
// exactly once and no intermediate (a, b or the unmasked q) reaches
// device memory. The replay stores its fields time-major ([L1, E]), so
// at each t the 32 threads of a warp read 32 neighbouring episodes:
// every load and store is coalesced. The same code also takes slot-major
// [E, L1] arrays (the wrapper passes the strides); there a warp's loads
// are L1 * 4 B apart and do not coalesce, which is why the replay is
// time-major. At E = 4096 one thread per episode fills only 32 blocks of
// 128 threads on 132 SMs, so the loop is latency- rather than
// bandwidth-limited; the chunked-time form (compose the affine maps per
// time chunk, then scan across chunks) is the next step.
//
// The arithmetic uses round-to-nearest intrinsics in the order of the
// plain torch version (ops/returns.py), so nvcc does not contract it
// into FMAs: the two should agree to the last bit on the same inputs
// (chip_smoke.py measures the largest difference).
//
// Interface: plain C functions, bound with ctypes. Each launches on the
// given stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

// the device loop shared by both entry points: walk t = t_hi ... 0 with
// q carried in a register from its value `acc` at t_hi + 1;
// coef(t, &a, &b) supplies the map at t
template <typename Coef>
__device__ __forceinline__ void suffix_scan(const Coef& coef, float* q,
                                            long long st, int t_hi,
                                            float acc) {
  for (int t = t_hi; t >= 0; --t) {
    float a, b;
    coef(t, &a, &b);
    acc = __fadd_rn(a, __fmul_rn(b, acc));
    q[t * st] = acc;
  }
}

struct AffineCoef {
  const float* a;
  const float* b;
  long long st;
  __device__ void operator()(int t, float* pa, float* pb) const {
    *pa = a[t * st];
    *pb = b[t * st];
  }
};

__global__ void affine_suffix_scan_kernel(const float* __restrict__ a,
                                          const float* __restrict__ b,
                                          float* __restrict__ q, int E,
                                          int L1, long long se,
                                          long long st) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;
  const long long off = e * se;
  suffix_scan(AffineCoef{a + off, b + off, st}, q + off, st, L1 - 1,
              0.f);
}

// coefficients of the shifted recursion at t < length: entries at t+1
struct RetraceCoef {
  const float* r;
  const float* v;
  const float* adv;
  const float* rho;
  long long st;
  float gamma, lam, c_gl, c_g1l;
  bool gae;
  __device__ void operator()(int t, float* pa, float* pb) const {
    const long long i = (t + 1) * st;
    const float ri = r[i], vi = v[i];
    if (gae) {
      // a = r + (g (1 - lam)) V ; b = g lam
      *pa = __fadd_rn(ri, __fmul_rn(c_g1l, vi));
      *pb = c_gl;
    } else {
      // a = r + g (V - (lam c) (A + V)) ; b = (g lam) c
      const float c = fminf(rho[i], 1.f);
      const float s = __fmul_rn(__fmul_rn(lam, c), __fadd_rn(adv[i], vi));
      *pa = __fadd_rn(ri, __fmul_rn(gamma, __fsub_rn(vi, s)));
      *pb = __fmul_rn(c_gl, c);
    }
  }
};

__global__ void batched_retrace_kernel(
    const float* __restrict__ r, const float* __restrict__ v,
    const float* __restrict__ adv, const float* __restrict__ rho,
    const int32_t* __restrict__ length, const uint8_t* __restrict__ terminal,
    float* __restrict__ q, int E, int L1, long long se, long long st,
    float gamma, float lam, float c_gl, float c_g1l, int gae) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;
  const long long off = e * se;
  float* qe = q + off;
  // a stored episode has 0 <= length <= L1-1; clamp so that a corrupt
  // length cannot read or write outside the slot
  int T = length[e];
  T = T < 0 ? 0 : (T > L1 - 1 ? L1 - 1 : T);
  for (int t = L1 - 1; t > T; --t) qe[t * st] = 0.f;
  // t == T: the map (bootstrap, 0); the t > T maps are (0, 0) and leave
  // q == 0, so the walk starts here with q[T] = bootstrap
  const float boot = terminal[e] ? 0.f : v[off + T * st];
  qe[T * st] = boot;
  const RetraceCoef coef{r + off, v + off, adv + off, rho + off, st,
                         gamma, lam, c_gl, c_g1l, gae != 0};
  suffix_scan(coef, qe, st, T - 1, boot);
}

inline int blocks_for(int E) { return (E + kThreads - 1) / kThreads; }

}  // namespace

extern "C" int smt_affine_suffix_scan(const void* a, const void* b, void* q,
                                      int E, int L1, long long se,
                                      long long st, void* stream) {
  affine_suffix_scan_kernel<<<blocks_for(E), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<float*>(q), E, L1, se, st);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int smt_batched_retrace(const void* r, const void* v,
                                   const void* adv, const void* rho,
                                   const void* length, const void* terminal,
                                   void* q, int E, int L1, long long se,
                                   long long st, float gamma, float lam,
                                   float c_gl, float c_g1l, int gae,
                                   void* stream) {
  batched_retrace_kernel<<<blocks_for(E), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(r), static_cast<const float*>(v),
      static_cast<const float*>(adv), static_cast<const float*>(rho),
      static_cast<const int32_t*>(length),
      static_cast<const uint8_t*>(terminal), static_cast<float*>(q), E, L1,
      se, st, gamma, lam, c_gl, c_g1l, gae);
  return static_cast<int>(cudaGetLastError());
}
