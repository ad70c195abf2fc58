// V-RACER's continuous policy head, from the net's output to its analytic
// output gradient, in one launch.
//
// Replaces no TPU kernel: the JAX package's head (smarties_tpu/algos/
// vracer.py, smarties_tpu/ops/continuous_policy.py) is jnp code that XLA
// fuses into the jitted step. The port ran it as PyTorch ops: 167 small
// kernels in the captured V-RACER step at cart-pole's shapes (B = 256,
// nA = 1), each about 1.3 us of busy device time on [256] rows, some
// 0.21 ms of a 0.42 ms step on the H100 for 17 KB of data. So the bound
// is the launch, and the design is one thread per sampled row with a loop
// over the nA action dims, in the order of algos/vracer.py::
// VRacer.output_grad_plain:
//   V = scale_net2v(v_raw), sigma = softplus(sigma_raw);
//   rho = exp(clip(log pi(a) - log mu(a), +-7)), the tanh Jacobian on
//   bounded dims and the mean clamped to +-MEAN_MAX there;
//   DKL(pi || mu) (OPPOSITE_KL), with the unclamped mean;
//   is_far = C > 1 and (rho > C or rho < 1/C);
//   A_ret = Q_ret - V, delta = A_ret - A (A = 0: V-RACER);
//   g_V = far ? 0 : min(1, rho) * delta * beta * scale_vdiff(v_raw);
//   g_pol = beta * gradLogP(far ? 0 : A_ret * min(C, rho)), zero where
//   far, + (1 - beta) * gradKL(-1), the saturated-mean gate of gradLogP
//   on bounded dims;
//   g = valid ? [g_V, g_pol] : 0.
//
// Every output is bit-equal to the PyTorch chain on the card: each
// operation is the chain's, in its order, rounded to nearest (the __f*_rn
// intrinsics never contract into an FMA; the library is also built with
// --fmad=false), and logf, expf, tanhf are the functions the chain's
// kernels call. PyTorch's `float / tensor` is reciprocal(tensor) * float,
// and so here; `tensor / 2` is a multiply by 0.5, exact either way. The
// sums over the action dims take the order of PyTorch's reduce kernel
// for a row of n <= 32 floats (`row_sum`). The chain's Python constants
// arrive as float arguments, rounded from the doubles as PyTorch rounds a
// Python scalar for a float32 op.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 64;
// action dims a row may have: the per-dim terms of a row's sums live in
// arrays of this size
constexpr int kMaxDims = 32;

struct Inputs {
  const float* out;               // [B, 1 + 2nA]: V, means, sigma_raw
  const float* action;            // [B, nA]
  const float* mu;                // [B, 2nA]: behaviour means, stdevs
  const float* qret;              // [B]
  const unsigned char* valid;     // [B]
  const unsigned char* bounded;   // [nA]
  const float* cmax;              // 0-d: the replay's cmax_ret
  const float* cinv;              // 0-d: cinv_ret
  const float* beta;              // 0-d: the ReF-ER beta
};

struct Outputs {
  float* g;                       // [B, 1 + 2nA]
  float* rho;                     // [B]
  float* dkl;                     // [B]
  float* delta;                   // [B]
  float* value;                   // [B]
  float* adv;                     // [B], zeros
  unsigned char* is_far;          // [B]
};

// MEAN_MAX, log(sqrt(2 pi)), float32's smallest normal, the log-weight
// clip
struct Consts {
  float mean_max, log_sqrt_2pi, tiny, logw_clip;
};

// torch.minimum: a NaN operand is the result
__device__ __forceinline__ float min_nan(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return fminf(a, b);
}

// torch.clamp: NaN stays NaN
__device__ __forceinline__ float clamp_nan(float v, float lo, float hi) {
  return v != v ? v : fminf(fmaxf(v, lo), hi);
}

__device__ __forceinline__ float clamp_min_nan(float v, float lo) {
  return v != v ? v : fmaxf(v, lo);
}

// torch.sum over the last dim of a contiguous [B, n] float32 tensor, as
// PyTorch's reduce kernel orders it for 0 < n <= 32 (checked on the card
// against PyTorch 2.11 for every n to 16, 24, 31 and 32): the row is
// split over w = the largest power of two <= n lanes, lane x adds
// elements x and x + w, then the lanes combine in a tree of shuffles at
// offsets w / 2, w / 4, ..., 1
__device__ __forceinline__ float row_sum(float* v, int n) {
  int w = 1;
  while (2 * w <= n) w *= 2;
  for (int x = 0; x + w < n; ++x) v[x] = __fadd_rn(v[x], v[x + w]);
  for (int off = w / 2; off > 0; off /= 2) {
    for (int x = 0; x < off; ++x) v[x] = __fadd_rn(v[x], v[x + off]);
  }
  return v[0];
}

// ops/softplus.py: (x + sqrt(1 + x * x)) / 2 and (1 + x / sqrt(1 + x * x))
// / 2
__device__ __forceinline__ float softplus(float x) {
  return __fmul_rn(__fadd_rn(x, __fsqrt_rn(__fadd_rn(__fmul_rn(x, x), 1.0f))),
                   0.5f);
}

__device__ __forceinline__ float softplus_diff(float x) {
  return __fmul_rn(
      __fadd_rn(__fdiv_rn(x, __fsqrt_rn(__fadd_rn(__fmul_rn(x, x), 1.0f))),
                1.0f),
      0.5f);
}

// ops/value_scale.py::scale_net2v and scale_vdiff, op by op
__device__ __forceinline__ float net2v(float x) {
  if (x > 0.0f) {
    return __fsub_rn(
        __fmul_rn(__fadd_rn(x, 51.0f), 100.0f),
        __fmul_rn(__fsqrt_rn(__fadd_rn(__fmul_rn(x, 100.0f), 2601.0f)),
                  100.0f));
  }
  if (x < 0.0f) {
    return __fadd_rn(
        __fmul_rn(__fsub_rn(x, 51.0f), 100.0f),
        __fmul_rn(__fsqrt_rn(__fsub_rn(2601.0f, __fmul_rn(x, 100.0f))),
                  100.0f));
  }
  return 0.0f;
}

__device__ __forceinline__ float vdiff(float x) {
  const float s = x > 0.0f
      ? __fsqrt_rn(__fadd_rn(__fmul_rn(x, 100.0f), 2601.0f))
      : __fsqrt_rn(__fsub_rn(2601.0f, __fmul_rn(x, 100.0f)));
  return __fsub_rn(100.0f, __fmul_rn(__fdiv_rn(1.0f, s), 5000.0f));
}

// ops/continuous_policy.py::_logprob_dims at one dim
__device__ __forceinline__ float logprob_dim(float a, float m_eff,
                                             float sigma, bool bounded,
                                             const Consts& c) {
  const float inv_s = __fdiv_rn(1.0f, sigma);
  const float z = __fmul_rn(__fsub_rn(a, m_eff), inv_s);
  const float arg = __fmul_rn(-__fmul_rn(z, z), 0.5f);
  const float base = __fsub_rn(__fadd_rn(arg, logf(inv_s)), c.log_sqrt_2pi);
  if (!bounded) return base;
  const float sq = tanhf(a);
  const float jac = clamp_min_nan(__fsub_rn(1.0f, __fmul_rn(sq, sq)), c.tiny);
  return __fsub_rn(base, logf(jac));
}

// ops/continuous_policy.py::kl_div's term at one dim, DKL(pi || mu)
__device__ __forceinline__ float kl_dim(float m_mu, float s_mu, float mean,
                                        float sigma) {
  const float r = __fdiv_rn(sigma, s_mu);
  const float c = __fmul_rn(r, r);
  const float q = __fdiv_rn(__fsub_rn(mean, m_mu), s_mu);
  const float dm = __fmul_rn(q, q);
  return __fmul_rn(__fsub_rn(__fadd_rn(__fsub_rn(c, 1.0f), dm), logf(c)),
                   0.5f);
}

__global__ void __launch_bounds__(kThreads)
head_kernel(const Inputs in, const Outputs o, const Consts c, int n_rows,
            int n_act) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_rows) return;
  const int width = 1 + 2 * n_act;
  const float* out = in.out + static_cast<long long>(i) * width;
  const float* act = in.action + static_cast<long long>(i) * n_act;
  const float* mu = in.mu + static_cast<long long>(i) * 2 * n_act;
  const float cmax = *in.cmax, cinv = *in.cinv, beta = *in.beta;

  // the rows: V, log pi(a) and log mu(a) by dim, the KL by dim
  const float v_raw = out[0];
  const float value = net2v(v_raw);
  float lp_pi[kMaxDims], lp_mu[kMaxDims], kl[kMaxDims];
  for (int d = 0; d < n_act; ++d) {
    const bool bnd = in.bounded[d] != 0;
    const float mean = out[1 + d];
    const float sigma = softplus(out[1 + n_act + d]);
    const float m_eff = bnd ? clamp_nan(mean, -c.mean_max, c.mean_max)
                            : mean;
    lp_pi[d] = logprob_dim(act[d], m_eff, sigma, bnd, c);
    lp_mu[d] = logprob_dim(act[d], mu[d], mu[n_act + d], bnd, c);
    kl[d] = kl_dim(mu[d], mu[n_act + d], mean, sigma);
  }
  const float logw = __fsub_rn(row_sum(lp_pi, n_act), row_sum(lp_mu, n_act));
  const float rho = expf(clamp_nan(logw, -c.logw_clip, c.logw_clip));
  const float dkl = row_sum(kl, n_act);
  const bool far = cmax > 1.0f && (rho > cmax || rho < cinv);
  const float a_ret = __fsub_rn(in.qret[i], value);
  const float delta = __fsub_rn(a_ret, 0.0f);
  o.rho[i] = rho;
  o.dkl[i] = dkl;
  o.delta[i] = delta;
  o.value[i] = value;
  o.adv[i] = 0.0f;
  o.is_far[i] = far;

  // the gradient: the value's, then gradLogP and gradKL mixed by beta
  const bool valid = in.valid[i] != 0;
  float* g = o.g + static_cast<long long>(i) * width;
  const float ver = __fmul_rn(min_nan(1.0f, rho), delta);
  g[0] = (valid && !far) ? __fmul_rn(__fmul_rn(ver, beta), vdiff(v_raw))
                         : 0.0f;
  const float pg_coef = far ? 0.0f : __fmul_rn(a_ret, min_nan(cmax, rho));
  const float omb = __fsub_rn(1.0f, beta);
  for (int d = 0; d < n_act; ++d) {
    const bool bnd = in.bounded[d] != 0;
    const float a = act[d], mean = out[1 + d], s_raw = out[1 + n_act + d];
    const float m_mu = mu[d], s_mu = mu[n_act + d];
    const float sigma = softplus(s_raw);
    const float inv_s = __fdiv_rn(1.0f, sigma);
    const float spd = softplus_diff(s_raw);
    // pol_grad(coef = pg_coef), zero on far-policy rows
    float pg_m = 0.0f, pg_s = 0.0f;
    if (!far) {
      const float m_eff = bnd ? clamp_nan(mean, -c.mean_max, c.mean_max)
                              : mean;
      const float d_mean = __fmul_rn(
          __fmul_rn(__fmul_rn(pg_coef, __fsub_rn(a, mean)), inv_s), inv_s);
      const float u = __fmul_rn(__fsub_rn(a, m_eff), inv_s);
      pg_s = __fmul_rn(__fmul_rn(__fmul_rn(spd, pg_coef),
                                 __fsub_rn(__fmul_rn(u, u), 1.0f)),
                       inv_s);
      const bool sat = (mean >= c.mean_max && d_mean > 0.0f) ||
                       (mean <= -c.mean_max && d_mean < 0.0f);
      pg_m = (bnd && sat) ? 0.0f : d_mean;
    }
    // kl_grad(coef = -1): coef * x is -x
    const float inv_var_mu = __fdiv_rn(1.0f, __fmul_rn(s_mu, s_mu));
    const float pn_m = __fmul_rn(-__fsub_rn(mean, m_mu), inv_var_mu);
    const float pn_s = __fmul_rn(
        __fmul_rn(-spd, __fsub_rn(inv_var_mu,
                                  __fdiv_rn(1.0f, __fmul_rn(sigma, sigma)))),
        sigma);
    g[1 + d] = valid ? __fadd_rn(__fmul_rn(beta, pg_m), __fmul_rn(omb, pn_m))
                     : 0.0f;
    g[1 + n_act + d] =
        valid ? __fadd_rn(__fmul_rn(beta, pg_s), __fmul_rn(omb, pn_s))
              : 0.0f;
  }
}

}  // namespace

extern "C" int smt_policy_head_max_dims() { return kMaxDims; }

// in: 9 device pointers (out [B, 1 + 2nA], action [B, nA], mu [B, 2nA],
// qret [B] float32; valid [B], bounded [nA] bool; cmax, cinv, beta 0-d
// float32), all contiguous. outs: 7 device pointers (g [B, 1 + 2nA], rho,
// dkl, delta, value, advantage [B] float32; is_far [B] bool). 0 < n_act
// <= kMaxDims. Returns the CUDA error of the launch, 0 if none.
extern "C" int smt_policy_head(void* const* in, void* const* outs,
                               int n_rows, int n_act, float mean_max,
                               float log_sqrt_2pi, float tiny,
                               float logw_clip, void* stream) {
  if (n_act <= 0 || n_act > kMaxDims || n_rows <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Inputs i{static_cast<const float*>(in[0]),
                 static_cast<const float*>(in[1]),
                 static_cast<const float*>(in[2]),
                 static_cast<const float*>(in[3]),
                 static_cast<const unsigned char*>(in[4]),
                 static_cast<const unsigned char*>(in[5]),
                 static_cast<const float*>(in[6]),
                 static_cast<const float*>(in[7]),
                 static_cast<const float*>(in[8])};
  const Outputs o{static_cast<float*>(outs[0]), static_cast<float*>(outs[1]),
                  static_cast<float*>(outs[2]), static_cast<float*>(outs[3]),
                  static_cast<float*>(outs[4]), static_cast<float*>(outs[5]),
                  static_cast<unsigned char*>(outs[6])};
  const Consts c{mean_max, log_sqrt_2pi, tiny, logw_clip};
  head_kernel<<<(n_rows + kThreads - 1) / kThreads, kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(i, o, c, n_rows, n_act);
  return static_cast<int>(cudaGetLastError());
}
