// The tail of a learner's grad step, after Adam, in two launches (three
// under a learner mesh).
//
// Replaces no TPU kernel: the JAX package's write-backs, ReF-ER scalars,
// step metrics and gradient statistics (smarties_tpu/algos/base.py,
// smarties_tpu/replay/buffer.py) are jnp code that XLA fuses into the
// jitted step. The port ran them as PyTorch ops: 174 small kernels in the
// captured V-RACER step (0.234 ms of its 0.63 ms on the H100) and 189 in
// RACER_atari's, each about 1.4 us of busy device time for a few bytes.
// The tail moves 0.14 MB at cart-pole's shapes and 7.6 MB at the conv
// net's, mostly the gradients (0.04 and 2.3 us at 3.35 TB/s), so the bound
// is the launch, and the design is two launches:
//
// `grad_stats_kernel`: the sum of squares and the largest |g| over every
//   gradient leaf, a table of the leaves in the kernel's parameters as in
//   csrc/adam.cu; each block writes one partial of each to a scratch.
//   Its first block also zeroes the tail's arrival counter.
// `tail_kernel`: every block reduces its share of the E replay slots
//   (stored steps, far-policy count); the block that arrives last does
//   the rest alone, in the order of algos/base.py::step_tail_plain_:
//   V(s_t+1) (optionally through scale_net2v), the write-back of the B
//   sampled rows (rho, KL, delta, value, advantage at [t, ep], the
//   far-count update, the v_trunc refresh), update_cmax, the beta / alpha
//   fixed point, the max_abs_error EMA, the step metrics and the gradient
//   statistics from the first launch's partials.
// Under a learner mesh (parallel/mesh.py) the collectives sit between the
// rows and the scalars: the last block writes this rank's stored and far
// counts, its largest |delta| and its five means, which the wrapper
// all-reduces as the chain does (a sum, a max, a sum), and
// `finish_kernel`, one thread, does the scalars and the metrics from the
// totals: three launches and the chain's three collectives.
//
// Every ReF-ER scalar and replay value is bit-equal to the PyTorch chain:
// each operation is the chain's, in its order, rounded to nearest (the
// __f*_rn intrinsics never contract into an FMA; the library is also
// built with --fmad=false), with the chain's constants as float
// arguments rounded from the Python doubles as PyTorch rounds a Python
// scalar for a float32 op; `float / tensor` is reciprocal(tensor) * float
// there, and so here. The counts are integers: stored steps in 64 bits,
// far-policy steps as sums of +-1 in float (exact below 2^24). The step
// metrics are sums over the rows and leaves, taken here in double in a
// fixed order (deterministic from run to run, within float rounding of
// PyTorch's own order); frac_far_data, beta and grad_max are exact.
//
// Rows with valid == 0 write no field and no far count (the JAX package's
// mode="drop"); v_trunc takes every truncated row, valid or not, as in the
// chain and the JAX package. A row whose (ep, t) repeats stores one of the
// repeated rows' values, and each adds its own far-count delta, as
// index_add_ does.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// gradient elements per grad_stats block, replay slots per tail block
constexpr int kStatElems = 16 * kThreads;
constexpr int kSlotElems = 4 * kThreads;
// leaves per grad_stats launch: the table stays within 4 KB of parameters
constexpr int kMaxLeaves = 64;
constexpr int kMetrics = 9;

struct Leaf {
  const float* g;
  long long n;
  int block0;   // the leaf's first block
};

struct Table {
  Leaf leaf[kMaxLeaves];
  int n_leaves;
};

// the B sampled rows: 1-D inputs of any element stride
struct Rows {
  const float* rho;
  const float* dkl;
  const float* delta;
  const float* value;
  const float* adv;
  const float* v_next;
  const float* rho_old;
  const unsigned char* valid;
  const unsigned char* trunc;
  const unsigned char* is_far;
  const void* ep;
  const void* t;
  long long s_rho, s_dkl, s_delta, s_value, s_adv, s_vnext, s_rho_old,
      s_valid, s_trunc, s_far, s_ep, s_t;
  int n;
  int ep64, t64, net2v;
};

// the replay's fields ([L1, E] time-major, [E] per slot) and 0-d scalars
struct Replay {
  float* rho;
  float* kl;
  float* delta;
  float* value;
  float* adv;
  float* far_count;
  float* v_trunc;
  const int* slot_len;
  const int* slot_id;
  float* cmax;
  float* cinv;
  float* beta;
  float* alpha;
  float* max_abs_error;
  const int* step;
  int E;
};

// clipImpWeight, epsAnneal, 0.1 * batchSize, maxTotObsNum, penalTol, 1e-3
struct Consts {
  float clip, eps_anneal, lr_num, max_obs, penal_tol, tol;
};

struct Scratch {
  long long* part_n;        // [tail blocks]
  double* part_far;         // [tail blocks]
  const double* grad_sq;    // [n_grad]
  const float* grad_max;    // [n_grad]
  int* arrivals;
  float* metrics;           // [kMetrics]
  // under a mesh (else null): the collectives' buffers, this rank's
  // before the all-reduce and the totals after it (stored and far
  // counts; the largest |delta|; the means of dkl, rho, far rows,
  // delta^2 and value), and the gradient statistics for finish_kernel
  long long* coll_counts;   // [2]
  float* coll_err;          // [1]
  float* coll_means;        // [5]
  double* grad_tot;         // [2]: sum of squares, largest |g|
  int n_grad;
};

// what the scalars and the metrics read: one rank's counts, largest error
// and means, or their all-reduced totals over the ranks
struct Totals {
  long long n_stored, n_far;
  float max_err;
  float mean[5];
  double g_sq;
  float g_max;
};

// torch.max / torch.maximum / torch.minimum: a NaN operand is the result
__device__ __forceinline__ float max_nan(float a, float b) {
  return (b != b || b > a) ? b : a;
}

__device__ __forceinline__ float min_nan(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return fminf(a, b);
}

struct Add {
  template <typename T>
  __device__ T operator()(T a, T b) const { return a + b; }
};

struct MaxNan {
  __device__ float operator()(float a, float b) const {
    return max_nan(a, b);
  }
};

// a block's reduction in a fixed order (shuffles, then the warps in
// turn); the result is thread 0's
template <typename T, typename Op>
__device__ T block_reduce(T v, Op op) {
  __shared__ T part[kWarps];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    v = op(v, __shfl_down_sync(0xffffffffu, v, o));
  }
  __syncthreads();   // part[] may still be read by a previous reduction
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kWarps; ++w) v = op(v, part[w]);
  }
  return v;
}

__global__ void __launch_bounds__(kThreads)
grad_stats_kernel(const __grid_constant__ Table t, double* part_sq,
                  float* part_max, int* arrivals) {
  if (arrivals != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
    *arrivals = 0;
  }
  const int b = blockIdx.x;
  int i = 0;
  while (i + 1 < t.n_leaves && b >= t.leaf[i + 1].block0) ++i;
  const Leaf& L = t.leaf[i];
  const long long lo = static_cast<long long>(b - L.block0) * kStatElems;
  const long long hi = min(lo + kStatElems, L.n);
  double sq = 0.0;
  float mx = -INFINITY;
#pragma unroll 4
  for (long long e = lo + threadIdx.x; e < hi; e += kThreads) {
    const float x = L.g[e];
    sq += static_cast<double>(__fmul_rn(x, x));
    mx = max_nan(mx, fabsf(x));
  }
  sq = block_reduce(sq, Add());
  mx = block_reduce(mx, MaxNan());
  if (threadIdx.x == 0) {
    part_sq[b] = sq;
    part_max[b] = mx;
  }
}

template <typename T>
__device__ __forceinline__ T at(const T* p, long long s, int i) {
  return p[static_cast<long long>(i) * s];
}

__device__ __forceinline__ long long index_at(const void* p, int is64,
                                              long long s, int i) {
  return is64 ? at(static_cast<const long long*>(p), s, i)
              : static_cast<long long>(at(static_cast<const int*>(p), s, i));
}

// ops/value_scale.py::scale_net2v, op by op
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

// replay/buffer.py::is_far_policy
__device__ __forceinline__ bool far_policy(float rho, float cmax,
                                           float cinv) {
  return cmax > 1.0f && (rho > cmax || rho < cinv);
}

// update_beta_alpha's fix_point
__device__ __forceinline__ float fix_point(float val, bool go_to_0,
                                           float learn_r) {
  const float lr = min_nan(learn_r, val);
  const float kept = __fmul_rn(__fsub_rn(1.0f, lr), val);
  return go_to_0 ? kept
                 : __fadd_rn(kept, min_nan(learn_r, __fsub_rn(1.0f, val)));
}

// post_step_processing, then default_metrics and grad_stats, from the
// counts and sums of `t` over `n_ranks` ranks: the chain's scalar ops in
// its order
__device__ void finish(const Totals& t, float n_ranks, const Replay& p,
                       const Consts& c, float* m) {
  // stored_and_far's counts, each to float
  const float n_data = __ll2float_rn(t.n_stored);
  const float n_far = __ll2float_rn(t.n_far);
  // update_cmax: c = 1 + clip / (1 + step * epsAnneal), cinv = 1 / c
  const float den = __fadd_rn(
      __fmul_rn(__int2float_rn(*p.step), c.eps_anneal), 1.0f);
  const float cm = __fadd_rn(__fmul_rn(__fdiv_rn(1.0f, den), c.clip), 1.0f);
  *p.cmax = cm;
  *p.cinv = __fdiv_rn(1.0f, cm);
  // update_beta_alpha
  const float frac_off = __fdiv_rn(n_far, fmaxf(n_data, 1.0f));
  const float learn_r = __fmul_rn(__fdiv_rn(1.0f, fmaxf(n_data, c.max_obs)),
                                  c.lr_num);
  const float beta = fix_point(*p.beta, frac_off > c.penal_tol, learn_r);
  *p.beta = beta;
  *p.alpha = fix_point(
      *p.alpha, fabsf(__fsub_rn(c.penal_tol, frac_off)) < c.tol, learn_r);
  // the max_abs_error EMA (the same learn_r from the same count)
  const float mae = *p.max_abs_error;
  *p.max_abs_error = __fadd_rn(mae, __fmul_rn(learn_r,
                                              __fsub_rn(t.max_err, mae)));
  // default_metrics (each mean over the ranks), then grad_stats
  m[0] = __fdiv_rn(t.mean[0], n_ranks);             // avg_dkl
  m[1] = __fdiv_rn(t.mean[1], n_ranks);             // avg_rho
  m[2] = __fdiv_rn(t.mean[2], n_ranks);             // frac_far_batch
  m[3] = frac_off;                                   // frac_far_data
  m[4] = beta;                                       // beta
  m[5] = __fsqrt_rn(__fdiv_rn(t.mean[3], n_ranks)); // rmse
  m[6] = __fdiv_rn(t.mean[4], n_ranks);             // avg_v
  m[7] = __fsqrt_rn(static_cast<float>(t.g_sq));    // grad_norm
  m[8] = t.g_max;                                    // grad_max
}

__global__ void __launch_bounds__(kThreads)
tail_kernel(const __grid_constant__ Rows r, const __grid_constant__ Replay p,
            const __grid_constant__ Consts c,
            const __grid_constant__ Scratch s) {
  // ---- this block's slots: stored steps and far-policy count, read
  // before the write-back (which comes after every block's arrival)
  long long n_part = 0;
  double far_part = 0.0;
  const int lo = blockIdx.x * kSlotElems;
#pragma unroll
  for (int k = 0; k < kSlotElems / kThreads; ++k) {
    const int e = lo + k * kThreads + threadIdx.x;
    if (e < p.E) {
      if (p.slot_id[e] >= 0) n_part += p.slot_len[e];
      far_part += static_cast<double>(p.far_count[e]);
    }
  }
  n_part = block_reduce(n_part, Add());
  far_part = block_reduce(far_part, Add());
  __shared__ bool last;
  if (threadIdx.x == 0) {
    s.part_n[blockIdx.x] = n_part;
    s.part_far[blockIdx.x] = far_part;
    __threadfence();
    last = atomicAdd(s.arrivals, 1) == static_cast<int>(gridDim.x) - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();

  // ---- the last block: the partials, in block order
  long long n_stored = 0;
  double far_pre = 0.0;
  for (int k = threadIdx.x; k < static_cast<int>(gridDim.x); k += kThreads) {
    n_stored += __ldcg(s.part_n + k);
    far_pre += __ldcg(s.part_far + k);
  }
  double g_sq = 0.0;
  float g_max = -INFINITY;
  for (int k = threadIdx.x; k < s.n_grad; k += kThreads) {
    g_sq += s.grad_sq[k];
    g_max = max_nan(g_max, s.grad_max[k]);
  }

  // ---- the rows: write-back under the pre-update cmax / cinv
  const float cmax = *p.cmax, cinv = *p.cinv;
  double sum_dkl = 0.0, sum_rho = 0.0, sum_far = 0.0, sum_sq = 0.0,
         sum_v = 0.0;
  long long d_far = 0;
  float max_err = -INFINITY;
  for (int i = threadIdx.x; i < r.n; i += kThreads) {
    const long long ep = index_at(r.ep, r.ep64, r.s_ep, i);
    const long long t = index_at(r.t, r.t64, r.s_t, i);
    const float rho = at(r.rho, r.s_rho, i);
    const float dkl = at(r.dkl, r.s_dkl, i);
    const float delta = at(r.delta, r.s_delta, i);
    const float value = at(r.value, r.s_value, i);
    if (at(r.valid, r.s_valid, i)) {
      const long long k = t * p.E + ep;
      p.rho[k] = rho;
      p.kl[k] = dkl;
      p.delta[k] = delta;
      p.value[k] = value;
      p.adv[k] = at(r.adv, r.s_adv, i);
      const bool was = far_policy(at(r.rho_old, r.s_rho_old, i), cmax, cinv);
      const bool now = far_policy(rho, cmax, cinv);
      if (now != was) {
        atomicAdd(p.far_count + ep, now ? 1.0f : -1.0f);
        d_far += now ? 1 : -1;
      }
    }
    if (at(r.trunc, r.s_trunc, i)) {
      const float vn = at(r.v_next, r.s_vnext, i);
      p.v_trunc[ep] = r.net2v ? net2v(vn) : vn;
    }
    sum_dkl += static_cast<double>(dkl);
    sum_rho += static_cast<double>(rho);
    sum_far += at(r.is_far, r.s_far, i) ? 1.0 : 0.0;
    sum_sq += static_cast<double>(__fmul_rn(delta, delta));
    sum_v += static_cast<double>(value);
    max_err = max_nan(max_err, fabsf(delta));
  }
  n_stored = block_reduce(n_stored, Add());
  far_pre = block_reduce(far_pre, Add());
  g_sq = block_reduce(g_sq, Add());
  g_max = block_reduce(g_max, MaxNan());
  sum_dkl = block_reduce(sum_dkl, Add());
  sum_rho = block_reduce(sum_rho, Add());
  sum_far = block_reduce(sum_far, Add());
  sum_sq = block_reduce(sum_sq, Add());
  sum_v = block_reduce(sum_v, Add());
  d_far = block_reduce(d_far, Add());
  max_err = block_reduce(max_err, MaxNan());
  if (threadIdx.x != 0) return;

  // ---- this rank's counts and means: stored_and_far's count of far
  // steps is the far count's float sum truncated to int32, then widened
  Totals tot;
  tot.n_stored = n_stored;
  tot.n_far = static_cast<int>(
      static_cast<float>(far_pre + static_cast<double>(d_far)));
  tot.max_err = max_err;
  const double n = static_cast<double>(r.n);
  tot.mean[0] = static_cast<float>(sum_dkl / n);
  tot.mean[1] = static_cast<float>(sum_rho / n);
  tot.mean[2] = static_cast<float>(sum_far / n);
  tot.mean[3] = static_cast<float>(sum_sq / n);
  tot.mean[4] = static_cast<float>(sum_v / n);
  tot.g_sq = g_sq;
  tot.g_max = g_max;
  if (s.coll_counts == nullptr) {
    finish(tot, 1.0f, p, c, s.metrics);
    return;
  }
  // under a mesh: the collectives' inputs, for finish_kernel after them
  s.coll_counts[0] = tot.n_stored;
  s.coll_counts[1] = tot.n_far;
  s.coll_err[0] = tot.max_err;
  for (int k = 0; k < 5; ++k) s.coll_means[k] = tot.mean[k];
  s.grad_tot[0] = tot.g_sq;
  s.grad_tot[1] = static_cast<double>(tot.g_max);
}

// under a mesh, after the collectives: the scalars and the metrics from
// the totals over n_ranks ranks
__global__ void finish_kernel(const __grid_constant__ Replay p,
                              const __grid_constant__ Consts c,
                              const __grid_constant__ Scratch s,
                              float n_ranks) {
  Totals t;
  t.n_stored = s.coll_counts[0];
  t.n_far = s.coll_counts[1];
  t.max_err = s.coll_err[0];
  for (int k = 0; k < 5; ++k) t.mean[k] = s.coll_means[k];
  t.g_sq = s.grad_tot[0];
  t.g_max = static_cast<float>(s.grad_tot[1]);
  finish(t, n_ranks, p, c, s.metrics);
}

}  // namespace

extern "C" int smt_step_tail_max_leaves() { return kMaxLeaves; }
extern "C" int smt_step_tail_stat_elems() { return kStatElems; }
extern "C" int smt_step_tail_slot_elems() { return kSlotElems; }
extern "C" int smt_step_tail_metrics() { return kMetrics; }

// grads: n_leaves device pointers, host array; numel: their element
// counts. One launch per kMaxLeaves leaves, each of at least one block;
// launch j's partials follow launch j-1's in part_sq / part_max. The first
// launch zeroes *arrivals. Returns the first CUDA error, 0 if none.
extern "C" int smt_grad_stats(void* const* grads, const long long* numel,
                              int n_leaves, void* part_sq, void* part_max,
                              void* arrivals, void* stream) {
  long long done = 0;
  for (int first = 0; first == 0 || first < n_leaves; first += kMaxLeaves) {
    Table t;
    t.n_leaves = n_leaves - first < kMaxLeaves ? n_leaves - first
                                               : kMaxLeaves;
    long long blocks = 0;
    for (int j = 0; j < t.n_leaves; ++j) {
      const long long n = numel[first + j];
      t.leaf[j] = {static_cast<const float*>(grads[first + j]), n,
                   static_cast<int>(blocks)};
      blocks += (n + kStatElems - 1) / kStatElems;
    }
    if (blocks == 0) {   // no element: one block writes empty partials
      t.n_leaves = 1;
      t.leaf[0] = {nullptr, 0, 0};
      blocks = 1;
    }
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    grad_stats_kernel<<<static_cast<int>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        t, static_cast<double*>(part_sq) + done,
        static_cast<float*>(part_max) + done,
        first == 0 ? static_cast<int*>(arrivals) : nullptr);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    done += blocks;
  }
  return 0;
}

namespace {

Replay replay_of(void* const* replay, int n_slots) {
  return Replay{static_cast<float*>(replay[0]),
                static_cast<float*>(replay[1]),
                static_cast<float*>(replay[2]),
                static_cast<float*>(replay[3]),
                static_cast<float*>(replay[4]),
                static_cast<float*>(replay[5]),
                static_cast<float*>(replay[6]),
                static_cast<const int*>(replay[7]),
                static_cast<const int*>(replay[8]),
                static_cast<float*>(replay[9]),
                static_cast<float*>(replay[10]),
                static_cast<float*>(replay[11]),
                static_cast<float*>(replay[12]),
                static_cast<float*>(replay[13]),
                static_cast<const int*>(replay[14]),
                n_slots};
}

Scratch scratch_of(void* const* scratch, int n_grad) {
  return Scratch{static_cast<long long*>(scratch[0]),
                 static_cast<double*>(scratch[1]),
                 static_cast<const double*>(scratch[2]),
                 static_cast<const float*>(scratch[3]),
                 static_cast<int*>(scratch[4]),
                 static_cast<float*>(scratch[5]),
                 static_cast<long long*>(scratch[6]),
                 static_cast<float*>(scratch[7]),
                 static_cast<float*>(scratch[8]),
                 static_cast<double*>(scratch[9]),
                 n_grad};
}

}  // namespace

// rows: 12 device pointers (rho, dkl, delta, value, advantage, v_next,
// rho_old, valid, truncated, is_far, ep, t) and their 12 element strides;
// flags: bit 0 ep is int64, bit 1 t is int64, bit 2 v_next is the net's
// raw output (scale_net2v applied here). replay: 15 device pointers
// (rho, kl, delta, value, advantage [L1, E]; far_count, v_trunc,
// slot_len, slot_id [E]; cmax, cinv, beta, alpha, max_abs_error, step).
// scratch: 10 device pointers: part_n, part_far ((E + kSlotElems - 1) /
// kSlotElems each), grad_sq, grad_max (n_grad each, from smt_grad_stats),
// arrivals (zeroed by smt_grad_stats), metrics (kMetrics floats), then
// under a mesh the collectives' buffers (counts [2] int64, largest error
// [1] and means [5] float) and the gradient totals ([2] double), null
// with no mesh. With them the launch stops before the scalars:
// smt_step_tail_finish does them after the collectives.
extern "C" int smt_step_tail(void* const* rows, const long long* strides,
                             int flags, int n_rows, void* const* replay,
                             int n_slots, float clip, float eps_anneal,
                             float lr_num, float max_obs, float penal_tol,
                             float tol, void* const* scratch, int n_grad,
                             void* stream) {
  const Rows r{static_cast<const float*>(rows[0]),
               static_cast<const float*>(rows[1]),
               static_cast<const float*>(rows[2]),
               static_cast<const float*>(rows[3]),
               static_cast<const float*>(rows[4]),
               static_cast<const float*>(rows[5]),
               static_cast<const float*>(rows[6]),
               static_cast<const unsigned char*>(rows[7]),
               static_cast<const unsigned char*>(rows[8]),
               static_cast<const unsigned char*>(rows[9]),
               rows[10], rows[11],
               strides[0], strides[1], strides[2], strides[3], strides[4],
               strides[5], strides[6], strides[7], strides[8], strides[9],
               strides[10], strides[11],
               n_rows, flags & 1, (flags >> 1) & 1, (flags >> 2) & 1};
  const Consts c{clip, eps_anneal, lr_num, max_obs, penal_tol, tol};
  const int blocks = n_slots > 0 ? (n_slots + kSlotElems - 1) / kSlotElems
                                 : 1;
  tail_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      r, replay_of(replay, n_slots), c, scratch_of(scratch, n_grad));
  return static_cast<int>(cudaGetLastError());
}

// Under a mesh, after smt_step_tail and the all-reduce of its buffers
// over n_ranks ranks: the ReF-ER scalars and the metrics, one thread.
// replay, the constants and scratch as smt_step_tail's.
extern "C" int smt_step_tail_finish(void* const* replay, int n_slots,
                                    float clip, float eps_anneal,
                                    float lr_num, float max_obs,
                                    float penal_tol, float tol,
                                    void* const* scratch, int n_grad,
                                    int n_ranks, void* stream) {
  const Consts c{clip, eps_anneal, lr_num, max_obs, penal_tol, tol};
  finish_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      replay_of(replay, n_slots), c, scratch_of(scratch, n_grad),
      static_cast<float>(n_ranks));
  return static_cast<int>(cudaGetLastError());
}
