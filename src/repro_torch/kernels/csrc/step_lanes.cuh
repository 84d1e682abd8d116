// What the step kernels (exec_lanes.cu, transient_lanes.cu) share: the
// warp-wide constants, 4-byte cp.async copies, a compile-time step parity,
// and the phase clocks a source builds with when it defines
// LANES_PHASE_CLOCKS (before including this header).
#pragma once

#include <cuda_runtime.h>

constexpr unsigned FULL = 0xffffffffu;
// steps whose inputs (windows, draws) a warp kernel stages at a time, and
// whose outputs it writes at a time
constexpr int CHUNK = 32;

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

template <int P>
struct Parity {
  static constexpr int value = P;
};

#ifdef LANES_PHASE_CLOCKS
// [kernel: 0 block, 1 warp][phase]: cycles summed over launches, and the
// steps they cover in the last slot; the source names its phases.  One
// thread of the first lane marks the end of each phase (clock64), sums in
// registers, and adds its sums once a launch.
constexpr int N_PHASES = 6;
__device__ unsigned long long phase_clocks[2][N_PHASES + 1];
struct PhaseClock {
  long long t0 = 0, acc[N_PHASES] = {};
  unsigned sink = 0;  // values a mark waits for, kept live
  bool on = false;
  __device__ void start(bool who) {
    on = who;
    t0 = clock64();
  }
  __device__ __forceinline__ void mark(int ph) {
    if (!on) return;
    const long long now = clock64();
    acc[ph] += now - t0;
    t0 = now;
  }
  __device__ void flush(int kernel, long long steps) {
    if (!on) return;
    for (int ph = 0; ph < N_PHASES; ++ph)
      atomicAdd(&phase_clocks[kernel][ph], (unsigned long long)acc[ph]);
    atomicAdd(&phase_clocks[kernel][N_PHASES],
              (unsigned long long)steps + (sink == 0x7fc00001u ? 1 : 0));
  }
};
#define PHASE_CLOCK PhaseClock clk
#define PHASE_START(who) clk.start(who)
#define PHASE_MARK(ph) clk.mark(ph)
#define PHASE_SINK(x) (clk.sink ^= __float_as_uint(x))
#define PHASE_FLUSH(kernel, steps) clk.flush(kernel, steps)

// Copies phase_clocks ([2][N_PHASES + 1]) to `out` and, if `reset`, zeroes
// them; the CUDA error.
__host__ inline int copy_phase_clocks(unsigned long long* out, int reset) {
  cudaError_t err = cudaDeviceSynchronize();
  if (err == cudaSuccess && out != nullptr)
    err = cudaMemcpyFromSymbol(out, phase_clocks, sizeof(phase_clocks));
  if (err == cudaSuccess && reset) {
    static const unsigned long long zeros[2][N_PHASES + 1] = {};
    err = cudaMemcpyToSymbol(phase_clocks, zeros, sizeof(phase_clocks));
  }
  return static_cast<int>(err);
}
#else
#define PHASE_CLOCK
#define PHASE_START(who)
#define PHASE_MARK(ph)
#define PHASE_SINK(x)
#define PHASE_FLUSH(kernel, steps)
#endif
