// Phase stamps: device timestamps written from inside a captured program.
//
// The traced grad step (runtime/trainer.py, utils/profiler.py) marks each
// boundary between its phases with one launch of `stamp_kernel`: a single
// thread reads the card's global timer (%globaltimer, nanoseconds) and
// stores it at row `row[0]`, column `col` of an int64 [rows, n_cols]
// buffer. The row is read from a device counter, as the step's metric
// rows are, so a replayed graph writes a new row each step with no host
// involvement. A stamp runs when the kernel before it on the stream has
// finished, so two stamps bracket the kernels launched between them.
//
// `ticks_kernel` measures the timer's resolution: the differences of n
// successive distinct readings.
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ long long global_timer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return static_cast<long long>(t);
}

__global__ void stamp_kernel(long long* buf, const long long* row,
                             int n_cols, int col) {
  const long long r = row != nullptr ? row[0] : 0;
  buf[r * n_cols + col] = global_timer();
}

__global__ void ticks_kernel(long long* out, int n) {
  long long last = global_timer();
  for (int k = 0; k < n; ++k) {
    long long t;
    do {
      t = global_timer();
    } while (t == last);
    out[k] = t - last;
    last = t;
  }
}

}  // namespace

// buf: int64 [rows, n_cols]; row: int64 [1] on the device, or null for
// row 0.
extern "C" int smt_stamp(void* buf, const void* row, int n_cols, int col,
                         void* stream) {
  stamp_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<long long*>(buf), static_cast<const long long*>(row),
      n_cols, col);
  return static_cast<int>(cudaGetLastError());
}

// out: int64 [n]
extern "C" int smt_timer_ticks(void* out, int n, void* stream) {
  ticks_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<long long*>(out), n);
  return static_cast<int>(cudaGetLastError());
}
