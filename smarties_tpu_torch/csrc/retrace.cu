// K1: the Retrace / GAE suffix scan, hand-written for Hopper (sm_90a).
//
// Replaces the one TPU kernel of the JAX package,
// smarties_tpu/ops/pallas_retrace.py::affine_suffix_scan (kernel body
// `_kernel`), together with the coefficient build and output mask of
// its wrapper `batched_retrace_pallas` (`retrace_coeffs`).
//
// What it computes, for every replay slot e, walking t = L1-1 ... 0:
//     q[e, t] = a[e, t] + b[e, t] * q[e, t+1],   q beyond L1-1 = 0.
// Three entry points share the device code:
// - smt_affine_suffix_scan: the recursion on given (a, b);
// - smt_batched_retrace: builds (a, b) on the fly from the replay fields
//   (Retrace: a = r + g(V - lam c (A + V)), b = g lam c with c = min(1, rho);
//   GAE: a = r + g(1 - lam) V, b = g lam; both read at t+1; a = bootstrap,
//   b = 0 at t == length; zero beyond) and writes 0 for t > length;
// - smt_retrace_sweep: the replay's sweep in place. It reads the stored
//   time-major fields, scales the reward as (r - mean) * scale, takes
//   v_trunc[e] wherever the value at t == length is read, and writes q
//   only into the rows of selected slots (zeros into the others when
//   asked); an unselected slot's inputs are never read.
//
// What bounds it on the H100: bytes. It does 3-10 flops per element and
// reads each input element once, and only at t = 1..length. With all
// E = 4096 slots full at length 500 (the trained cart-pole's replay)
// that is 4 fields x E x 500 x 4 B in plus E x 501 x 4 B out, ~41 MB:
// 12.2 us at the card's published 3.35 TB/s (the full-length case). With
// lengths uniform in 1..500 (the case chip_smoke.py has timed since the
// first version) the needed elements come to ~24.6 MB: 7.3 us. GAE reads
// two of the four fields.
//
// What the design does about it (time-major [L1, E] fields):
// - the recursion stays sequential in t with q in a register, so every
//   element is read and written once and no intermediate (a, b, the
//   scaled reward, the unmasked q) reaches device memory. A block owns
//   32 neighbouring slots, one per lane, so a field's row at one t is one
//   128-B segment; E = 4096 gives 128 blocks on the card's 132 SMs;
// - a plain loop of loads that are consumed at once keeps ~16 B per lane
//   in flight, ~64 KB on the whole card, where 3.35 TB/s at ~0.6 us of
//   latency needs ~2 MB. So each lane prefetches its own column through
//   a ring in shared memory, filled with 4-byte cp.async copies, one
//   commit group per tile, and cp.async.wait_group<kStages-1> before a
//   tile is read. A lane reads only what it copied itself, so the ring
//   needs no barrier. Copies are predicated on 1 <= t <= length (and on
//   the slot being selected), so ragged and unselected slots ask for no
//   bytes;
// - one warp that does all of this per step (copies with their
//   addresses, shared loads, the coefficient arithmetic, selects, the
//   dependent multiply-add, the store) is bound by its own instruction
//   stream: ~40 instructions a step, one warp per SM, measured 0.058 ms
//   whatever the ring's depth. Only the multiply-add depends on the step
//   before, so the block is kProd producer warps and one consumer warp
//   over the same 32 slots. Of each tile of kTT = kProd x kTS steps,
//   producer w prefetches and reads steps w kTS .. w kTS + kTS-1 and
//   writes their maps (a, b) - recursion, bootstrap at t == length, or
//   (0, 0) beyond - into one of two tiles in shared memory; the consumer
//   walks the other: one 8-byte shared load, a multiply, an add and one
//   coalesced 128-B store of q per step. One __syncthreads per tile
//   hands a tile over both ways. With kProd = 7, kTS = 4, kStages = 4
//   that is 128 blocks x 3 tiles x 28 steps x 4 fields x 128 B = 5.5 MB
//   in flight.
// What is left (bench_retrace.py): the full-length case runs at the time
// of a device-to-device copy of as many bytes, about half the published
// rate. With lengths in random order over the slots the time is the
// same: memory moves whole 32-B sectors of 8 neighbouring slots as long
// as one of the 8 is live, about 8/9 of the full case's input, whatever
// the count of needed elements says.
// Slot-major [E, L1] input (never on the replay's path) keeps the plain
// loop: there a warp's loads are L1 * 4 B apart and do not coalesce.
//
// The arithmetic uses round-to-nearest intrinsics in the order of the
// plain torch version (ops/returns.py), so nvcc does not contract it
// into FMAs and the pipeline changes only how the bytes arrive: the two
// agree to the last bit on the same inputs (chip_smoke.py checks it).
//
// Interface: plain C functions, bound with ctypes. Each launches on the
// given stream, does not synchronise, and returns the launch's error.
// Build-time knobs (-D): SMT_PRODUCERS, SMT_STEPS, SMT_STAGES.

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef SMT_PRODUCERS
#define SMT_PRODUCERS 7
#endif
#ifndef SMT_STEPS
#define SMT_STEPS 4
#endif
#ifndef SMT_STAGES
#define SMT_STAGES 4
#endif

namespace {

// ---------------------------------------------------------------------
// the plain loop (slot-major input; the yardstick of the pipeline)
// ---------------------------------------------------------------------

constexpr int kThreads = 128;

// walk t = t_hi ... 0 with q carried in a register from its value `acc`
// at t_hi + 1; coef(t, &a, &b) supplies the map at t
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

// the constants of one sweep
struct Consts {
  float gamma, lam, c_gl, c_g1l;   // c_gl = g lam, c_g1l = g (1 - lam)
};

// GAE: a = r + (g (1 - lam)) V ; b = g lam
__device__ __forceinline__ void gae_coef(const Consts& c, float r, float v,
                                         float* a, float* b) {
  *a = __fadd_rn(r, __fmul_rn(c.c_g1l, v));
  *b = c.c_gl;
}

// Retrace: a = r + g (V - (lam c) (A + V)) ; b = (g lam) c, c = min(1, rho)
__device__ __forceinline__ void retrace_coef(const Consts& c, float r,
                                             float v, float adv, float rho,
                                             float* a, float* b) {
  const float cw = fminf(rho, 1.f);
  const float s = __fmul_rn(__fmul_rn(c.lam, cw), __fadd_rn(adv, v));
  *a = __fadd_rn(r, __fmul_rn(c.gamma, __fsub_rn(v, s)));
  *b = __fmul_rn(c.c_gl, cw);
}

// coefficients of the shifted recursion at t < length: entries at t+1
struct RetraceCoef {
  const float* r;
  const float* v;
  const float* adv;
  const float* rho;
  long long st;
  Consts c;
  bool gae;
  __device__ void operator()(int t, float* pa, float* pb) const {
    const long long i = (t + 1) * st;
    if (gae) {
      gae_coef(c, r[i], v[i], pa, pb);
    } else {
      retrace_coef(c, r[i], v[i], adv[i], rho[i], pa, pb);
    }
  }
};

__device__ __forceinline__ int clamp_length(int T, int L1) {
  // a stored episode has 0 <= length <= L1-1; clamp so that a corrupt
  // length cannot read or write outside the slot
  return T < 0 ? 0 : (T > L1 - 1 ? L1 - 1 : T);
}

__global__ void batched_retrace_kernel(
    const float* __restrict__ r, const float* __restrict__ v,
    const float* __restrict__ adv, const float* __restrict__ rho,
    const int32_t* __restrict__ length, const uint8_t* __restrict__ terminal,
    float* __restrict__ q, int E, int L1, long long se, long long st,
    Consts c, int gae) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;
  const long long off = e * se;
  float* qe = q + off;
  const int T = clamp_length(length[e], L1);
  for (int t = L1 - 1; t > T; --t) qe[t * st] = 0.f;
  // t == T: the map (bootstrap, 0); the t > T maps are (0, 0) and leave
  // q == 0, so the walk starts here with q[T] = bootstrap
  const float boot = terminal[e] ? 0.f : v[off + T * st];
  qe[T * st] = boot;
  const RetraceCoef coef{r + off, v + off, adv + off, rho + off, st, c,
                         gae != 0};
  suffix_scan(coef, qe, st, T - 1, boot);
}

inline int blocks_for(int E) { return (E + kThreads - 1) / kThreads; }

// ---------------------------------------------------------------------
// the pipeline (time-major input)
// ---------------------------------------------------------------------

constexpr int kProd = SMT_PRODUCERS;   // producer warps of a block
constexpr int kTS = SMT_STEPS;         // steps of a tile per producer
constexpr int kTT = kProd * kTS;       // steps per tile
constexpr int kStages = SMT_STAGES;    // tiles in a producer's ring
constexpr int kBlock = 32 * (kProd + 1);
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ void cp_async4(float* smem_dst,
                                          const float* gmem_src) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(gmem_src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Shared memory of a block, in floats: two tiles of maps, [kTT][32]
// (a, b) pairs each, then per producer a ring of kStages tiles of
// [kTS steps][F fields][32 lanes], so the 32 lanes of one (step, field)
// fill one 128-B row of all banks.
constexpr int kMapFloats = 2 * kTT * 32 * 2;
template <int F>
__host__ __device__ constexpr int tile_floats() { return kTS * F * 32; }
template <int F>
__host__ __device__ constexpr size_t smem_bytes() {
  return sizeof(float) * (kMapFloats + kProd * kStages * tile_floats<F>());
}

template <int F>
struct Fields {
  const float* p[F];   // field base + this lane's slot
};

// copies of one producer's share of a tile: indices i0, i0-1, ...; a lane
// copies only i_lo <= i <= lane_hi
template <int F>
__device__ __forceinline__ void copy_tile(const Fields<F>& src, long long E,
                                           int i0, int i_lo, int lane_hi,
                                           float* tile) {
#pragma unroll
  for (int s = 0; s < kTS; ++s) {
    const int i = i0 - s;
    if (i >= i_lo && i <= lane_hi) {
#pragma unroll
      for (int f = 0; f < F; ++f)
        cp_async4(tile + (s * F + f) * 32, src.p[f] + i * E);
    }
  }
}

// the dependent chain over one tile of maps; n of its kTT steps exist.
// The maps are taken into registers first: q may alias anything as far
// as the compiler knows, so a load placed after a store of q would wait
// for it, and every step would pay a shared-memory round trip.
template <bool kPartial>
__device__ __forceinline__ float chain_tile(const float2* maps, float* qp,
                                            long long E, int n, bool wr,
                                            float acc) {
  float2 m[kTT];
#pragma unroll
  for (int j = 0; j < kTT; ++j) m[j] = maps[j * 32];
#pragma unroll
  for (int j = 0; j < kTT; ++j) {
    if (kPartial && j >= n) break;
    acc = __fadd_rn(m[j].x, __fmul_rn(m[j].y, acc));
    if (wr) *qp = acc;
    qp -= E;
  }
  return acc;
}

// What a block does for its 32 slots. An index i walks from i_hi down to
// i_lo (the same for the whole block); map(i, x, &a, &b) turns the F
// field values x at i into the affine map of that step, whose result
// goes to q[(i - shift) * E]. A lane copies only i <= lane_hi; for other
// i its x is whatever the ring held, and map must not use it.
template <typename Map>
__device__ __forceinline__ void pipelined_scan(
    const Map& map, const Fields<Map::F>& src, long long E, int i_hi,
    int i_lo, int lane_hi, float* q, int shift, bool wr, float acc) {
  constexpr int F = Map::F;
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float2* maps = reinterpret_cast<float2*>(smem) + lane;
  const int n_tiles = i_hi >= i_lo ? (i_hi - i_lo) / kTT + 1 : 0;
  // tile k holds i = i_hi - k kTT - j, j = 0 .. kTT-1, in maps[k & 1];
  // producer w makes j = w kTS .. w kTS + kTS-1 of it
  if (warp < kProd) {
    float* ring = smem + kMapFloats + warp * kStages * tile_floats<F>() + lane;
    const int first = i_hi - warp * kTS;
    // fill the ring: kStages commit groups, empty ones past the last tile
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      if (s < n_tiles)
        copy_tile<F>(src, E, first - s * kTT, i_lo, lane_hi,
                      ring + s * tile_floats<F>());
      cp_async_commit();
    }
    int stage = 0;
    for (int k = 0; k <= n_tiles; ++k) {
      if (k < n_tiles) {
        // kStages + k groups are committed; all but the newest
        // kStages - 1 are complete, so this warp's share of tile k is in
        cp_async_wait<kStages - 1>();
        float* tile = ring + stage * tile_floats<F>();
        float2* out = maps + ((k & 1) * kTT + warp * kTS) * 32;
        const int i0 = first - k * kTT;
        // all loads before the first store, for the same reason
        float x[kTS][F];
#pragma unroll
        for (int s = 0; s < kTS; ++s) {
#pragma unroll
          for (int f = 0; f < F; ++f) x[s][f] = tile[(s * F + f) * 32];
        }
#pragma unroll
        for (int s = 0; s < kTS; ++s) {
          float a, b;
          map(i0 - s, x[s], &a, &b);
          out[s * 32] = make_float2(a, b);
        }
        // the share just read is free: refill it kStages tiles ahead
        if (k + kStages < n_tiles)
          copy_tile<F>(src, E, i0 - kStages * kTT, i_lo, lane_hi, tile);
        cp_async_commit();
        stage = stage + 1 == kStages ? 0 : stage + 1;
      }
      __syncthreads();   // tile k is made; tile k-1 is walked
    }
  } else {
    for (int k = 0; k <= n_tiles; ++k) {
      if (k > 0) {
        const int t0 = i_hi - (k - 1) * kTT;
        const float2* in = maps + ((k - 1) & 1) * kTT * 32;
        float* qp = q + static_cast<long long>(t0 - shift) * E;
        const int n = t0 - i_lo + 1;
        acc = n >= kTT ? chain_tile<false>(in, qp, E, n, wr, acc)
                       : chain_tile<true>(in, qp, E, n, wr, acc);
      }
      __syncthreads();
    }
  }
}

struct AffineMap {
  static constexpr int F = 2;
  __device__ __forceinline__ void operator()(int, const float (&x)[2],
                                             float* a, float* b) const {
    *a = x[0];
    *b = x[1];
  }
};

__global__ void __launch_bounds__(kBlock)
    affine_pipelined_kernel(const float* __restrict__ a,
                            const float* __restrict__ b,
                            float* __restrict__ q, int E, int L1) {
  const int e = blockIdx.x * 32 + (threadIdx.x & 31);
  const bool in = e < E;
  const Fields<2> src{{a + e, b + e}};
  pipelined_scan(AffineMap{}, src, E, L1 - 1, 0, in ? L1 - 1 : -1, q + e, 0,
                 in, 0.f);
}

// The map of one step of the Retrace (F = 4: r, V, A, rho) or GAE (F = 2:
// r, V) recursion: index i holds the fields at t + 1 and gives q[t],
// t = i - 1. For i <= T it is the recursion's; at i == T + 1 it is
// (bootstrap, 0), which sets q[T]; above, (0, 0), which writes zeros.
template <bool kSweep, bool kGae>
struct RetraceMap {
  static constexpr int F = kGae ? 2 : 4;
  int T;           // length; -1 for a lane that computes nothing
  float boot;
  float v_T;       // kSweep: v_trunc, the value at t == T
  float mean, scale;   // kSweep: the reward's scaling
  Consts c;
  __device__ __forceinline__ void operator()(int i, const float (&x)[F],
                                             float* pa, float* pb) const {
    float r = x[0], v = x[1];
    if (kSweep) {
      r = __fmul_rn(__fsub_rn(r, mean), scale);
      v = i == T ? v_T : v;
    }
    float a, b;
    if (kGae) {
      gae_coef(c, r, v, &a, &b);
    } else {
      retrace_coef(c, r, v, x[F - 2], x[F - 1], &a, &b);
    }
    const bool live = i <= T;
    *pa = live ? a : (i == T + 1 ? boot : 0.f);
    *pb = live ? b : 0.f;
  }
};

// kSweep: q is the replay's qret, written in place for selected slots;
// v_trunc, select, rew_mean, rew_scale and zero_unselected are read.
// Otherwise every slot is computed and the bootstrap is v[length].
template <bool kSweep, bool kGae>
__global__ void __launch_bounds__(kBlock) retrace_pipelined_kernel(
    const float* __restrict__ r, const float* __restrict__ v,
    const float* __restrict__ adv, const float* __restrict__ rho,
    const float* __restrict__ v_trunc, const int32_t* __restrict__ length,
    const uint8_t* __restrict__ terminal, const uint8_t* __restrict__ select,
    const float* __restrict__ rew_mean, const float* __restrict__ rew_scale,
    float* q, int E, int L1, Consts c, int zero_unselected) {
  using Map = RetraceMap<kSweep, kGae>;
  constexpr int F = Map::F;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int e = blockIdx.x * 32 + lane;
  const bool in = e < E;
  bool sel = in;
  if (kSweep && in) sel = select[e] != 0;
  const bool wr = in && (sel || (kSweep && zero_unselected != 0));
  // every warp of the block holds the same 32 slots, so all leave together
  if (!__any_sync(kFullMask, wr)) return;

  Map map;
  map.T = -1;
  map.boot = 0.f;
  map.v_T = 0.f;
  if (sel) {
    map.T = clamp_length(length[e], L1);
    map.v_T = kSweep ? v_trunc[e] : v[static_cast<long long>(map.T) * E + e];
    map.boot = terminal[e] ? 0.f : map.v_T;
  }
  map.mean = 0.f;
  map.scale = 1.f;
  if (kSweep) {
    map.mean = *rew_mean;
    map.scale = *rew_scale;
  }
  map.c = c;
  // the block walks down from the longest of its computed slots
  const int T_max = __reduce_max_sync(kFullMask, map.T);

  Fields<F> src;
  src.p[0] = r + e;
  src.p[1] = v + e;
  if (!kGae) {
    src.p[F - 2] = adv + e;
    src.p[F - 1] = rho + e;
  }

  // the rows from the end down to T_max, which no step of the walk
  // writes (q[T] = bootstrap where T == T_max), spread over the producers
  float* qe = q + e;
  if (wr && warp < kProd) {
    for (int t = L1 - 1 - warp; t >= (T_max > 0 ? T_max : 0); t -= kProd)
      qe[static_cast<long long>(t) * E] = t == map.T ? map.boot : 0.f;
  }
  pipelined_scan(map, src, E, T_max, 1, map.T, qe, 1, wr, map.boot);
}

inline int pipeline_blocks(int E) { return (E + 31) / 32; }

// shared memory above 48 KB per block has to be asked for
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <bool kSweep, bool kGae>
int launch_retrace(const void* r, const void* v, const void* adv,
                   const void* rho, const void* v_trunc, const void* length,
                   const void* terminal, const void* select,
                   const void* rew_mean, const void* rew_scale, void* q,
                   int E, int L1, Consts c, int zero_unselected,
                   void* stream) {
  auto kernel = retrace_pipelined_kernel<kSweep, kGae>;
  constexpr size_t smem = smem_bytes<kGae ? 2 : 4>();
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<pipeline_blocks(E), kBlock, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(r), static_cast<const float*>(v),
      static_cast<const float*>(adv), static_cast<const float*>(rho),
      static_cast<const float*>(v_trunc),
      static_cast<const int32_t*>(length),
      static_cast<const uint8_t*>(terminal),
      static_cast<const uint8_t*>(select),
      static_cast<const float*>(rew_mean),
      static_cast<const float*>(rew_scale), static_cast<float*>(q), E, L1, c,
      zero_unselected);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dynamic shared memory of a pipelined block that reads n_fields fields
extern "C" int smt_pipeline_smem_bytes(int n_fields) {
  return static_cast<int>(n_fields == 2 ? smem_bytes<2>() : smem_bytes<4>());
}

// a, b, q: [E, L1] with strides (se, st). Time-major storage (se == 1,
// st == E) takes the pipeline unless `pipelined` is 0; anything else the
// plain loop.
extern "C" int smt_affine_suffix_scan(const void* a, const void* b, void* q,
                                      int E, int L1, long long se,
                                      long long st, int pipelined,
                                      void* stream) {
  const float* fa = static_cast<const float*>(a);
  const float* fb = static_cast<const float*>(b);
  float* fq = static_cast<float*>(q);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pipelined && se == 1 && st == E) {
    constexpr size_t smem = smem_bytes<2>();
    cudaError_t err = allow_smem(affine_pipelined_kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    affine_pipelined_kernel<<<pipeline_blocks(E), kBlock, smem, s>>>(
        fa, fb, fq, E, L1);
  } else {
    affine_suffix_scan_kernel<<<blocks_for(E), kThreads, 0, s>>>(
        fa, fb, fq, E, L1, se, st);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int smt_batched_retrace(const void* r, const void* v,
                                   const void* adv, const void* rho,
                                   const void* length, const void* terminal,
                                   void* q, int E, int L1, long long se,
                                   long long st, float gamma, float lam,
                                   float c_gl, float c_g1l, int gae,
                                   int pipelined, void* stream) {
  const Consts c{gamma, lam, c_gl, c_g1l};
  if (pipelined && se == 1 && st == E) {
    return (gae ? launch_retrace<false, true>
                : launch_retrace<false, false>)(
        r, v, adv, rho, nullptr, length, terminal, nullptr, nullptr,
        nullptr, q, E, L1, c, 0, stream);
  }
  batched_retrace_kernel<<<blocks_for(E), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(r), static_cast<const float*>(v),
      static_cast<const float*>(adv), static_cast<const float*>(rho),
      static_cast<const int32_t*>(length),
      static_cast<const uint8_t*>(terminal), static_cast<float*>(q), E, L1,
      se, st, c, gae);
  return static_cast<int>(cudaGetLastError());
}

// The replay's sweep, in place on time-major [L1, E] fields; select,
// terminal: [E] bytes; rew_mean, rew_scale: device scalars.
extern "C" int smt_retrace_sweep(void* q, const void* r, const void* v,
                                 const void* adv, const void* rho,
                                 const void* v_trunc, const void* length,
                                 const void* terminal, const void* select,
                                 const void* rew_mean, const void* rew_scale,
                                 int E, int L1, float gamma, float lam,
                                 float c_gl, float c_g1l, int gae,
                                 int zero_unselected, void* stream) {
  const Consts c{gamma, lam, c_gl, c_g1l};
  return (gae ? launch_retrace<true, true> : launch_retrace<true, false>)(
      r, v, adv, rho, v_trunc, length, terminal, select, rew_mean, rew_scale,
      q, E, L1, c, zero_unselected, stream);
}
