// The LSTM's truncated-BPTT window: a persistent forward launch, a
// persistent backward launch and a fixed-order sum of the weight
// gradients over the batch rows.
//
// Replaces no TPU kernel: the JAX package's cells (smarties_tpu/models/
// net.py::apply_net under smarties_tpu/algos/base.py::seq_outputs) are
// jnp code that XLA fuses into the jitted step. The port ran the window
// as a Python loop of models/net.py::apply_net under autograd: at
// RACER_RNN's shapes (LSTM [32, 32], 17 positions, batch 128) about
// 3,056 small kernels a grad step on the H100, each ~2 us of a
// [128 x 32] x [32 x 32] product or a 128 x 32 elementwise op, 6.19 ms
// for 157.7 MFLOP. What bounds the window is the serial chain: 17
// positions x L layers forward and 16 x L backward, each cell waiting on
// the one before it. So the design keeps the whole chain of one batch row
// inside one block, with no launch and no trip to device memory between
// two cells, and spends the block's threads on each cell's latency:
//   - one block a row; a layer's 4H gate units (gate g of unit j, u =
//     g H + j) each take `lanes` adjacent threads (4 where 16 x the
//     widest layer fits a block) that split the unit's dot and join it
//     with warp shuffles;
//   - every layer's leaves (Wc Wi Wf Wo [in, H], Rc Ri Rf Ro [H, H],
//     bc bi bf bo [H]) copied into shared memory once, all copies in
//     flight together (cp.async), as one row a gate unit, [W column; R
//     column], padded to a stride = lanes (mod 32) so that the lanes of
//     a warp read distinct banks, then the 4H biases;
//   - forward: for each position, layer by layer, a unit's pre-activation
//     is the dot of [x, h_prev] with its row, then tanh / sigmoid,
//     c = f c_prev + i z and h = o tanh(c) (Layer_LSTM.h); the next
//     position's input is copied in while the cells run; z, i, f, o and
//     c of every (row, position, layer) go to a scratch tensor for the
//     backward, with the last active position before each (`prev`);
//   - backward: from t down the chain of active positions that `prev`
//     links (the inactive ones between pass the carry's gradient through
//     and compute nothing), layers top to bottom, the hand-derived
//     gradients of the cell; the next position's saved block is copied
//     into shared memory while the current one runs; dx = W dgates and
//     dh_prev = R dgates are sums over the 4H units split into groups
//     and joined in a fixed order. The weight gradients are off this
//     chain: each step records its gate gradients and its cell's inputs
//     [x, h_prev] (`hist`), and after the walk a thread sums a tile of 4
//     units x 4 words of dW, dR and db over the steps, from the records
//     staged back into shared memory; the row's sums go to `part` [B,
//     weights] in the leaves' order;
//   - reduce: one thread a weight sums `part` over the rows in row
//     order. No float atomics: a call is deterministic, and a captured
//     replay equals an eager call bit for bit.
// The carry is zero at position 0 and held where `active` is False (the
// mask is general); a position that is inactive and is neither t nor t+1
// computes nothing, since nothing reads its outputs. The cotangent enters
// the top layer at t only; the net's input takes no gradient.
//
// float32 storage and accumulation, no tensor cores, the accurate expf
// and tanhf (no --use_fast_math). Not bit-equal to cuBLAS's chain.
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kMaxLayers = 8;
constexpr int kLeaves = 12;        // Wc Wi Wf Wo Rc Ri Rf Ro bc bi bf bo
constexpr int kMaxThreads = 1024;
constexpr int kSaved = 5;          // z, i, f, o, c of a cell
constexpr int kReduceThreads = 256;

// A layer: its input width, width, the length n = in + h of a gate unit's
// row [W column; R column] and the row's padded stride; the offsets of
// its rows (then its 4h biases) in the shared weights, of its input
// vector [x, h] in the block's vectors, of its leaves in the packed leaf
// order, of its units in a carry and (x5) in a saved block, and of its
// part of a backward step's record (its 4h gate gradients, then its n
// inputs [x, h_prev], padded to `rec` floats, a multiple of 4).
struct Layer {
  int in, h, n, stride;
  int w_off, xh_off, leaf_off, h_off, rec_off, rec;
};

struct Net {
  const float* leaf[kMaxLayers][kLeaves];
  Layer layer[kMaxLayers];
  int n_layers, n_in;
  int lanes, threads;
  int n_smem_w;      // floats of every layer's rows and biases
  int n_weights;     // floats of every layer's leaves
  int n_rec;         // floats of a backward step's record
  int sum_h, h_max, n_max, total_n;
};

// shared memory of a block, in floats
__host__ __device__ inline long long forward_floats(const Net& n) {
  return static_cast<long long>(n.n_smem_w) + n.total_n +
         n.layer[n.n_layers - 1].h + n.sum_h + 4LL * n.h_max;
}

__host__ __device__ inline long long backward_floats(const Net& n) {
  return static_cast<long long>(n.n_smem_w) +
         3LL * (kSaved * n.sum_h + n.n_in) + n.n_max + 5LL * n.h_max +
         n.threads + 2LL * n.sum_h;
}

__device__ __forceinline__ float sigm(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// a cell's output from its saved o and c
__device__ __forceinline__ float h_of(const float* s, int h, int j) {
  return s[3 * h + j] * tanhf(s[4 * h + j]);
}

// 4 bytes from global to shared memory, asynchronously (cp.async)
__device__ __forceinline__ void copy_async(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  size_t g;
  asm("cvta.to.global.u64 %0, %1;" : "=l"(g) : "l"(src));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(g)
               : "memory");
}

// 16 bytes, both addresses 16-byte aligned
__device__ __forceinline__ void copy_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  size_t g;
  asm("cvta.to.global.u64 %0, %1;" : "=l"(g) : "l"(src));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(g)
               : "memory");
}

// this thread's copies have landed (a __syncthreads() then shows them all)
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// sum over k = r, r + K, ... < n of x[k] w[k], in four interleaved
// partial sums (the lane r of a unit's K lanes)
__device__ __forceinline__ float dot_lanes(const float* x, const float* w,
                                           int n, int r, int K) {
  float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
  int k = r;
  for (; k + 3 * K < n; k += 4 * K) {
    a0 = fmaf(x[k], w[k], a0);
    a1 = fmaf(x[k + K], w[k + K], a1);
    a2 = fmaf(x[k + 2 * K], w[k + 2 * K], a2);
    a3 = fmaf(x[k + 3 * K], w[k + 3 * K], a3);
  }
  for (; k < n; k += K) a0 = fmaf(x[k], w[k], a0);
  return (a0 + a1) + (a2 + a3);
}

// sum over u0 <= u < u1 of col[u stride] d[u], four partial sums
__device__ __forceinline__ float dot_units(const float* col, int stride,
                                           const float* d, int u0, int u1) {
  float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
  int u = u0;
  for (; u + 4 <= u1; u += 4) {
    a0 = fmaf(col[u * stride], d[u], a0);
    a1 = fmaf(col[(u + 1) * stride], d[u + 1], a1);
    a2 = fmaf(col[(u + 2) * stride], d[u + 2], a2);
    a3 = fmaf(col[(u + 3) * stride], d[u + 3], a3);
  }
  for (; u < u1; ++u) a0 = fmaf(col[u * stride], d[u], a0);
  return (a0 + a1) + (a2 + a3);
}

// the leaves into the shared rows: row g h + j holds column j of gate g's
// W leaf, then of its R leaf; the biases after the rows. A row's words are
// split over the threads that share its u, so neighbouring threads copy
// neighbouring words of a leaf.
__device__ void load_weights(const Net& n, float* w) {
  for (int l = 0; l < n.n_layers; ++l) {
    const Layer L = n.layer[l];
    const int U = 4 * L.h, chunks = blockDim.x / U;
    const int u = threadIdx.x % U, kc = threadIdx.x / U;
    if (kc >= chunks) continue;
    const int g = u / L.h, j = u - g * L.h;
    float* row = w + L.w_off + u * L.stride;
    const float* wsrc = n.leaf[l][g] + j;
    const float* rsrc = n.leaf[l][4 + g] + j;
    for (int k = kc; k < L.n; k += chunks) {
      copy_async(row + k, k < L.in ? wsrc + k * L.h : rsrc + (k - L.in) * L.h);
    }
    if (kc == 0) copy_async(w + L.w_off + U * L.stride + u, n.leaf[l][8 + g] + j);
  }
}

// a position's block (its saved gates and c, then its input) into dst
__device__ __forceinline__ void fetch_position(float* dst, const float* srow,
                                               const float* xrow, int pos,
                                               int S, int n_in) {
  for (int e = threadIdx.x; e < S; e += blockDim.x) {
    copy_async(dst + e, srow + static_cast<size_t>(pos) * S + e);
  }
  for (int e = threadIdx.x; e < n_in; e += blockDim.x) {
    copy_async(dst + S + e, xrow + static_cast<size_t>(pos) * n_in + e);
  }
}

__global__ void __launch_bounds__(kMaxThreads)
forward_kernel(const __grid_constant__ Net n, const float* __restrict__ xs,
               const unsigned char* __restrict__ active, int P,
               float* __restrict__ h_t, float* __restrict__ h_t1,
               float* __restrict__ saved, int* __restrict__ prev) {
  extern __shared__ __align__(16) float sm[];
  const Layer top = n.layer[n.n_layers - 1];
  float* w = sm;
  float* xh = w + n.n_smem_w;        // per layer [input, carry h]
  float* htop = xh + n.total_n;      // [top h] the top layer's new h at p
  float* cc = htop + top.h;          // [sum_h] the carry's c
  float* gates = cc + n.sum_h;       // [4 h_max] z, i, f, o of a layer
  const int b = blockIdx.x, tid = threadIdx.x, T = blockDim.x;
  const int K = n.lanes, u = tid / K, r = tid - u * K;
  const int S = kSaved * n.sum_h;
  const float* xrow = xs + static_cast<size_t>(b) * P * n.n_in;
  const unsigned char* arow = active + static_cast<size_t>(b) * P;
  load_weights(n, w);
  for (int e = tid; e < n.total_n; e += T) xh[e] = 0.0f;
  for (int e = tid; e < n.sum_h; e += T) cc[e] = 0.0f;
  // the first position that computes: active, or t, or t+1
  int p = 0;
  bool on = arow[0] != 0;
  while (!on && p < P - 2) on = arow[++p] != 0;
  __syncthreads();
  for (int e = tid; e < n.n_in; e += T) {
    copy_async(xh + e, xrow + static_cast<size_t>(p) * n.n_in + e);
  }
  wait_copies();
  __syncthreads();
  int last = -1;     // the last active position before p
  for (;;) {
    // the flag of p + 1, in flight while layer 0 runs
    bool on_next = p + 1 < P && arow[p + 1] != 0;
    int next = p + 1;
    if (prev != nullptr && tid == 0) prev[static_cast<size_t>(b) * P + p] = last;
    for (int l = 0; l < n.n_layers; ++l) {
      const Layer L = n.layer[l];
      float* x = xh + L.xh_off;
      const float* rows = w + L.w_off;
      float s = 0.0f;
      if (u < 4 * L.h) s = dot_lanes(x, rows + u * L.stride, L.n, r, K);
      // the unit's lanes are adjacent lanes of one warp
      for (int o = K / 2; o > 0; o >>= 1) {
        s += __shfl_xor_sync(0xffffffffu, s, o);
      }
      if (u < 4 * L.h && r == 0) {
        const float a = rows[4 * L.h * L.stride + u] + s;
        gates[u] = u < L.h ? tanhf(a) : sigm(a);
      }
      __syncthreads();
      if (l == 0) {
        // layer 0's input is read: copy in the next computing position's
        while (next < P - 2 && !on_next) on_next = arow[++next] != 0;
        if (next < P) {
          for (int e = tid; e < n.n_in; e += T) {
            copy_async(xh + e, xrow + static_cast<size_t>(next) * n.n_in + e);
          }
        }
      }
      if (tid < L.h) {
        const int H = L.h, j = tid;
        const float z = gates[j], i = gates[H + j];
        const float f = gates[2 * H + j], o = gates[3 * H + j];
        const float c = f * cc[L.h_off + j] + i * z;
        const float h = o * tanhf(c);
        if (saved != nullptr) {
          float* sv = saved + (static_cast<size_t>(b) * P + p) * S +
                      kSaved * L.h_off;
          sv[j] = z;
          sv[H + j] = i;
          sv[2 * H + j] = f;
          sv[3 * H + j] = o;
          sv[4 * H + j] = c;
        }
        if (l + 1 < n.n_layers) {
          xh[n.layer[l + 1].xh_off + j] = h;
        } else {
          htop[j] = h;
        }
        if (on) {
          cc[L.h_off + j] = c;
          x[L.in + j] = h;
        }
      }
      __syncthreads();
    }
    if (on) last = p;
    if (p >= P - 2) {
      float* out = (p == P - 2 ? h_t : h_t1) + static_cast<size_t>(b) * top.h;
      for (int e = tid; e < top.h; e += T) out[e] = htop[e];
    }
    if (next >= P) break;
    p = next;
    on = on_next;
    wait_copies();
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kMaxThreads)
backward_kernel(const __grid_constant__ Net n, const float* __restrict__ xs,
                int P, const float* __restrict__ g_t,
                const float* __restrict__ saved,
                const int* __restrict__ prev, float* __restrict__ hist,
                float* __restrict__ part) {
  extern __shared__ __align__(16) float sm[];
  const int b = blockIdx.x, tid = threadIdx.x, T = blockDim.x;
  const int S = kSaved * n.sum_h, blk = S + n.n_in;
  float* w = sm;                     // the weights; after the walk, records
  float* buf = w + n.n_smem_w;       // 3 position blocks: saved, then x
  float* xh = buf + 3 * blk;         // [n_max] the cell's [x, h_prev]
  float* dpre = xh + n.n_max;        // [4 h_max] d pre-activations
  float* dxup = dpre + 4 * n.h_max;  // [h_max] d input of layer l
  float* red = dxup + n.h_max;       // [T] partial sums
  float* dh = red + T;               // [sum_h] d carry h out of the step
  float* dc = dh + n.sum_h;          // [sum_h] d carry c out of the step
  const float* srow = saved + static_cast<size_t>(b) * P * S;
  const float* xrow = xs + static_cast<size_t>(b) * P * n.n_in;
  const int* prow = prev + static_cast<size_t>(b) * P;
  // the row's step records: [P - 1][n_rec]
  float* hrow = hist + static_cast<size_t>(b) * (P - 1) * n.n_rec;
  load_weights(n, w);
  for (int e = tid; e < n.sum_h; e += T) {
    dh[e] = 0.0f;
    dc[e] = 0.0f;
  }
  // The walk: t, then each last active position before the one before.
  // The carry's gradient into the step after t is zero (t+1 takes none),
  // and the positions between two steps pass it unchanged: a step's
  // carry gradients are the dh_prev and dc_prev of the step before it in
  // the walk, whether or not t itself is active.
  const int p = P - 2;
  int q = prow[p];
  float* cur = buf;                  // position p's block
  float* car = buf + blk;            // position q's: the carry into p
  float* spare = buf + 2 * blk;
  fetch_position(cur, srow, xrow, p, S, n.n_in);
  if (q >= 0) fetch_position(car, srow, xrow, q, S, n.n_in);
  int qq = q >= 0 ? prow[q] : -1;
  wait_copies();
  __syncthreads();
  const int top = n.n_layers - 1;
  int steps = 0;
  for (;;) {
    if (qq >= 0) fetch_position(spare, srow, xrow, qq, S, n.n_in);
    const int qqq = qq >= 0 ? prow[qq] : -1;
    float* rec = hrow + static_cast<size_t>(steps) * n.n_rec;
    for (int l = top; l >= 0; --l) {
      const Layer L = n.layer[l];
      const int H = L.h;
      // the cell's [x, h_prev], from what the forward saved
      for (int e = tid; e < L.n; e += T) {
        float v;
        if (e < L.in) {
          v = l == 0 ? cur[S + e]
                     : h_of(cur + kSaved * n.layer[l - 1].h_off, L.in, e);
        } else {
          v = q >= 0 ? h_of(car + kSaved * L.h_off, H, e - L.in) : 0.0f;
        }
        xh[e] = v;
      }
      if (tid < H) {
        const int j = tid;
        const float* sv = cur + kSaved * L.h_off;
        const float z = sv[j], i = sv[H + j], f = sv[2 * H + j];
        const float o = sv[3 * H + j], c = sv[4 * H + j];
        const float cp = q >= 0 ? car[kSaved * L.h_off + 4 * H + j] : 0.0f;
        float dhn = dh[L.h_off + j];
        if (l < top) {
          dhn += dxup[j];
        } else if (steps == 0) {
          dhn += g_t[static_cast<size_t>(b) * H + j];
        }
        const float tc = tanhf(c);
        const float dct = dc[L.h_off + j] + dhn * o * (1.0f - tc * tc);
        dpre[j] = dct * i * (1.0f - z * z);
        dpre[H + j] = dct * z * i * (1.0f - i);
        dpre[2 * H + j] = dct * cp * f * (1.0f - f);
        dpre[3 * H + j] = dhn * tc * o * (1.0f - o);
        dc[L.h_off + j] = dct * f;
      }
      __syncthreads();
      // the step's record, for the weight gradients after the walk
      for (int e = tid; e < 4 * H; e += T) rec[L.rec_off + e] = dpre[e];
      for (int e = tid; e < L.n; e += T) rec[L.rec_off + 4 * H + e] = xh[e];
      // dx (above the first layer) and dh_prev: the row words k0 <= k < n,
      // each summed over the 4H units in Q groups
      const float* rows = w + L.w_off;
      const int k0 = l > 0 ? 0 : L.in, n_o = L.n - k0;
      const int Q = T / n_o < 4 * H ? T / n_o : 4 * H;
      if (tid < Q * n_o) {
        const int grp = tid / n_o, k = k0 + (tid - grp * n_o);
        red[tid] = dot_units(rows + k, L.stride, dpre, grp * 4 * H / Q,
                             (grp + 1) * 4 * H / Q);
      }
      __syncthreads();
      if (tid < n_o) {
        float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
        int g = 0;
        for (; g + 4 <= Q; g += 4) {
          a0 += red[g * n_o + tid];
          a1 += red[(g + 1) * n_o + tid];
          a2 += red[(g + 2) * n_o + tid];
          a3 += red[(g + 3) * n_o + tid];
        }
        for (; g < Q; ++g) a0 += red[g * n_o + tid];
        const float a = (a0 + a1) + (a2 + a3);
        const int k = k0 + tid;
        if (k < L.in) {
          dxup[k] = a;
        } else {
          dh[L.h_off + (k - L.in)] = a;
        }
      }
      __syncthreads();
    }
    ++steps;
    if (q < 0) break;
    wait_copies();
    __syncthreads();
    float* done = cur;
    cur = car;
    car = spare;
    spare = done;
    q = qq;
    qq = qqq;
  }
  // the weight gradients: dW[u][k] = sum over the steps of dgates[u] x
  // [x, h_prev][k], db[u] = sum of dgates[u], in step order. A thread sums
  // a tile of 4 units x 4 words; the records come into the weights'
  // shared memory, as many steps at once as it holds.
  float* out = part + static_cast<size_t>(b) * n.n_weights;
  for (int l = 0; l < n.n_layers; ++l) {
    const Layer L = n.layer[l];
    const int H = L.h, U = 4 * H, n_tk = (L.n + 3) / 4;
    const int tiles = (U / 4) * n_tk, chunk = n.n_smem_w / L.rec;
    for (int t0 = 0; t0 < tiles; t0 += T) {
      const int tile = t0 + tid;
      const bool mine = tile < tiles;
      const int tu = mine ? tile / n_tk : 0, tk = mine ? tile - tu * n_tk : 0;
      float acc[4][4] = {}, accb[4] = {};
      for (int i0 = 0; i0 < steps; i0 += chunk) {
        const int ci = steps - i0 < chunk ? steps - i0 : chunk;
        __syncthreads();
        for (int e = tid; e < ci * (L.rec / 4); e += T) {
          const int i = e / (L.rec / 4), v = e - i * (L.rec / 4);
          copy_async16(w + i * L.rec + 4 * v,
                       hrow + static_cast<size_t>(i0 + i) * n.n_rec +
                           L.rec_off + 4 * v);
        }
        wait_copies();
        __syncthreads();
        if (mine) {
          for (int i = 0; i < ci; ++i) {
            const float4 d =
                *reinterpret_cast<const float4*>(w + i * L.rec + 4 * tu);
            const float4 x =
                *reinterpret_cast<const float4*>(w + i * L.rec + U + 4 * tk);
            const float dv[4] = {d.x, d.y, d.z, d.w};
            const float xv[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
            for (int a = 0; a < 4; ++a) {
#pragma unroll
              for (int c = 0; c < 4; ++c) {
                acc[a][c] = fmaf(dv[a], xv[c], acc[a][c]);
              }
              accb[a] += dv[a];
            }
          }
        }
      }
      if (mine) {
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int uu = 4 * tu + a, g = uu / H, j = uu - g * H;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int k = 4 * tk + c;
            if (k < L.n) {
              const int idx = k < L.in
                                  ? (g * L.in + k) * H + j
                                  : 4 * L.in * H + (g * H + k - L.in) * H + j;
              out[L.leaf_off + idx] = acc[a][c];
            }
          }
          if (tk == 0) out[L.leaf_off + 4 * (L.in + H) * H + uu] = accb[a];
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kReduceThreads)
reduce_kernel(const float* __restrict__ part, int B, int nw,
              float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nw) return;
  float a = 0.0f;
  for (int b = 0; b < B; ++b) a += part[static_cast<size_t>(b) * nw + i];
  out[i] = a;
}

// widths of n_layers layers over n_in inputs -> the net's sizes and
// layout; the leaves stay null. False where the kernel takes no such net.
bool net_of(const int* widths, int n_layers, int n_in, Net* n) {
  if (n_layers < 1 || n_layers > kMaxLayers || n_in < 1) return false;
  *n = Net{};
  n->n_layers = n_layers;
  n->n_in = n_in;
  for (int l = 0; l < n_layers; ++l) {
    if (widths[l] < 1) return false;
    if (widths[l] > n->h_max) n->h_max = widths[l];
  }
  n->lanes = 16 * n->h_max <= kMaxThreads ? 4
             : 8 * n->h_max <= kMaxThreads ? 2 : 1;
  n->threads = (4 * n->h_max * n->lanes + 31) / 32 * 32;
  if (n->threads > kMaxThreads) return false;
  int in = n_in;
  for (int l = 0; l < n_layers; ++l) {
    Layer& L = n->layer[l];
    L.in = in;
    L.h = widths[l];
    L.n = in + L.h;
    L.stride = L.n + ((n->lanes - L.n) % 32 + 32) % 32;
    L.w_off = n->n_smem_w;
    L.xh_off = n->total_n;
    L.leaf_off = n->n_weights;
    L.h_off = n->sum_h;
    L.rec_off = n->n_rec;
    L.rec = (4 * L.h + L.n + 3) / 4 * 4;
    n->n_rec += L.rec;
    n->n_smem_w += 4 * L.h * L.stride + 4 * L.h;
    n->total_n += L.n;
    n->n_weights += 4 * L.h * (L.n + 1);
    n->sum_h += L.h;
    if (L.n > n->n_max) n->n_max = L.n;
    in = L.h;
  }
  return true;
}

template <typename Kernel>
cudaError_t launchable(Kernel kernel, long long floats) {
  const long long bytes = floats * static_cast<long long>(sizeof(float));
  if (bytes > 0x7fffffffLL) return cudaErrorInvalidValue;
  // shared memory above 48 KB per block has to be asked for
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

bool with_leaves(void* const* leaves, const int* widths, int n_layers,
                 int n_in, Net* n) {
  if (!net_of(widths, n_layers, n_in, n)) return false;
  for (int l = 0; l < n_layers; ++l) {
    for (int q = 0; q < kLeaves; ++q) {
      n->leaf[l][q] = static_cast<const float*>(leaves[l * kLeaves + q]);
    }
  }
  return true;
}

}  // namespace

extern "C" int smt_lstm_window_max_layers() { return kMaxLayers; }

// Shared memory of a block of the forward (backward 0) or the backward
// (backward 1) launch, in bytes; -1 where the kernel takes no such net.
extern "C" int smt_lstm_window_smem(const int* widths, int n_layers,
                                    int n_in, int backward) {
  Net n;
  if (!net_of(widths, n_layers, n_in, &n)) return -1;
  const long long bytes = (backward ? backward_floats(n) : forward_floats(n)) *
                          static_cast<long long>(sizeof(float));
  return bytes > 0x7fffffffLL ? -1 : static_cast<int>(bytes);
}

// Floats of a backward step's record: per layer 4H gate gradients and the
// cell's in + H inputs, padded to a multiple of 4; -1 where the kernel
// takes no such net.
extern "C" int smt_lstm_window_record(const int* widths, int n_layers,
                                      int n_in) {
  Net n;
  return net_of(widths, n_layers, n_in, &n) ? n.n_rec : -1;
}

// leaves: 12 device pointers a layer (Wc Wi Wf Wo [in, H], Rc Ri Rf Ro
// [H, H], bc bi bf bo [H]), layer after layer; widths: the layers' H.
// xs [B, P, n_in] float32, active [B, P] bool; h_t, h_t1 [B, H_top].
// saved [B, P, 5 x sum of widths] and prev [B, P] int32, or both null
// (a forward that no backward follows). Returns the CUDA error, 0 if none.
extern "C" int smt_lstm_window_forward(void* const* leaves,
                                       const int* widths, int n_layers,
                                       int n_in, int B, int P,
                                       const void* xs, const void* active,
                                       void* h_t, void* h_t1, void* saved,
                                       void* prev, void* stream) {
  Net n;
  if (!with_leaves(leaves, widths, n_layers, n_in, &n) || B < 1 || P < 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long floats = forward_floats(n);
  cudaError_t err =
      launchable(forward_kernel, floats);
  if (err != cudaSuccess) return static_cast<int>(err);
  forward_kernel<<<B, n.threads, floats * sizeof(float),
                   static_cast<cudaStream_t>(stream)>>>(
      n, static_cast<const float*>(xs),
      static_cast<const unsigned char*>(active), P,
      static_cast<float*>(h_t), static_cast<float*>(h_t1),
      static_cast<float*>(saved), static_cast<int*>(prev));
  return static_cast<int>(cudaGetLastError());
}

// The forward's leaves, widths, xs, saved and prev; g_t [B, H_top]
// the cotangent of h_t; hist [B, P - 1, record floats] the backward
// steps' records (smt_lstm_window_record); part [B, weights] the rows'
// sums; grads [weights] their sum over the rows, the leaves' gradients
// packed in the leaves' order. Two launches. Returns the first CUDA
// error, 0 if none.
extern "C" int smt_lstm_window_backward(void* const* leaves,
                                        const int* widths, int n_layers,
                                        int n_in, int B, int P,
                                        const void* xs, const void* g_t,
                                        const void* saved,
                                        const void* prev, void* hist,
                                        void* part, void* grads,
                                        void* stream) {
  Net n;
  if (!with_leaves(leaves, widths, n_layers, n_in, &n) || B < 1 || P < 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long floats = backward_floats(n);
  cudaError_t err =
      launchable(backward_kernel, floats);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  backward_kernel<<<B, n.threads, floats * sizeof(float), s>>>(
      n, static_cast<const float*>(xs), P, static_cast<const float*>(g_t), static_cast<const float*>(saved),
      static_cast<const int*>(prev), static_cast<float*>(hist),
      static_cast<float*>(part));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  reduce_kernel<<<(n.n_weights + kReduceThreads - 1) / kReduceThreads,
                  kReduceThreads, 0, s>>>(static_cast<const float*>(part), B,
                                          n.n_weights,
                                          static_cast<float*>(grads));
  return static_cast<int>(cudaGetLastError());
}
