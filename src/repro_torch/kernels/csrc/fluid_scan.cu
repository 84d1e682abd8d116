// The fluid pipeline's step loop for Hopper (sm_90a).
//
// Replaces no Pallas kernel: it is the body of the reference's lax.scan,
// src/repro/core/simulator.py:115 _fluid_scan_impl, which the reference
// vmaps over the rows of a [M, K] demand matrix and jits into one device
// call (:149 _fluid_scan_batch).  For each row m, with
//   budget_k = rate_k dt,  rate_k = 1 / max(d_k, 1e-12) where d_k > 0,
//                                   +inf otherwise,
// q starting as [n_clients, 0, ..., 0] and done at 0, each step i:
//   served_k = min(q_k, budget_k)
//   q_k      = (q_k - served_k) + served_{k-1 mod K}
//   done     = done + served_{K-1};  flows[m, i] = served_{K-1}
// in float32.  A zero-demand column serves its whole queue (min(q, inf) =
// q), so padding columns stay inert.  It equals the plain version,
// src/repro_torch/kernels/ref.py:ref_fluid_scan, bit for bit: every value
// is one rounding of the same operands (min is exact, NaN propagating as
// torch.minimum does).
//
// Bound: neither bytes nor operations.  A call reads M K demands once and
// writes M (n_steps + 1) floats; it does about 4 K float32 operations a
// row and step.  What takes the time is the serial chain: every step needs
// the queues of the step before, and each column the service of its left
// neighbour.  So:
//   * one warp a row, one launch for every step: the step loop runs inside
//     the kernel, and M rows are ceil(M / 4) blocks of four warps;
//   * lane l owns columns l, l + 32, ...; a row of up to 32 * CPL columns
//     keeps its budgets and queues in registers (CPL = 1, 2, 4, 8 or 16:
//     K <= 512) and passes each column's service to its right neighbour
//     by one shuffle per 32 columns, the last column's to column 0 by a
//     broadcast; past 512 columns (CPL = 0) each lane walks its columns
//     through global memory, the services kept in a scratch row between
//     the two halves of the step (__syncwarp orders them);
//   * a step's flow is kept by lane (step mod 32) and written 32 steps at
//     a time, one coalesced store a 32 steps.
// Float arithmetic is written __fadd_rn / __fsub_rn / __fmul_rn /
// __fdiv_rn: nvcc contracts nothing into an FMA.  Offsets are 64-bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

constexpr int WARPS = 4;  // rows a block
constexpr unsigned FULL = 0xffffffffu;

// torch.minimum: NaN if either operand is NaN, else the smaller.
__device__ __forceinline__ float min_nan(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}

__device__ __forceinline__ float budget_of(float d, float dt) {
  const float rate = d > 0.f ? __fdiv_rn(1.f, fmaxf(d, 1e-12f)) : INFINITY;
  return __fmul_rn(rate, dt);
}

template <int CPL>
__global__ void __launch_bounds__(WARPS * 32) fluid_scan_kernel(
    const float* __restrict__ demands, float n_clients, float dt,
    int n_rows, int k, int n_steps, float* __restrict__ done_all,
    float* __restrict__ flows_all, float* __restrict__ scratch) {
  const int lane = threadIdx.x & 31;
  const long long m = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (m >= n_rows) return;  // the whole warp leaves together
  const float* d_row = demands + m * k;
  float* flows = flows_all + m * n_steps;
  const int last_lane = (k - 1) & 31, last_i = (k - 1) >> 5;
  float done = 0.f, fb = 0.f;
  if constexpr (CPL > 0) {
    float b[CPL], q[CPL];
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
      const int c = lane + 32 * i;
      b[i] = c < k ? budget_of(d_row[c], dt) : 0.f;
      q[i] = c == 0 ? n_clients : 0.f;
    }
    for (int j = 0; j < n_steps; ++j) {
      // column c = lane + 32 i takes column c - 1's service: lane - 1's of
      // the same i, or on lane 0 lane 31's of the previous i; column 0
      // takes the last column's, after the loop
      float mine = 0.f, left_prev = 0.f;
#pragma unroll
      for (int i = 0; i < CPL; ++i) {
        const float s = min_nan(q[i], b[i]);
        q[i] = __fsub_rn(q[i], s);
        const float left = __shfl_sync(FULL, s, (lane + 31) & 31);
        if (i == last_i) mine = s;
        if (lane + 32 * i < k && (lane > 0 || i > 0))
          q[i] = __fadd_rn(q[i], lane > 0 ? left : left_prev);
        left_prev = left;
      }
      const float last = __shfl_sync(FULL, mine, last_lane);
      if (lane == 0) q[0] = __fadd_rn(q[0], last);
      done = __fadd_rn(done, last);
      if ((j & 31) == lane) fb = last;
      if ((j & 31) == 31 || j == n_steps - 1) {
        const int jj = (j & ~31) + lane;
        if (jj <= j) flows[jj] = fb;
      }
    }
  } else {
    float* q = scratch + 2 * m * k;
    float* sv = q + k;
    for (int c = lane; c < k; c += 32) q[c] = c == 0 ? n_clients : 0.f;
    for (int j = 0; j < n_steps; ++j) {
      for (int c = lane; c < k; c += 32) {
        const float s = min_nan(q[c], budget_of(d_row[c], dt));
        sv[c] = s;
        q[c] = __fsub_rn(q[c], s);
      }
      __syncwarp();
      const float last = sv[k - 1];
      for (int c = lane; c < k; c += 32)
        q[c] = __fadd_rn(q[c], c > 0 ? sv[c - 1] : last);
      __syncwarp();  // every lane has read sv before the next step
      done = __fadd_rn(done, last);
      if ((j & 31) == lane) fb = last;
      if ((j & 31) == 31 || j == n_steps - 1) {
        const int jj = (j & ~31) + lane;
        if (jj <= j) flows[jj] = fb;
      }
    }
  }
  if (lane == 0) done_all[m] = done;
}

// Columns a lane keeps in registers for K columns: 1, 2, 4, 8 or 16; 0
// past 512 (the global-memory walk).
static int columns_per_lane(int k) {
  int cpl = 1;
  while (cpl * 32 < k) cpl *= 2;
  return cpl <= 16 ? cpl : 0;
}

extern "C" int fluid_scan_launch(const float* demands, float n_clients,
                                 float dt, int n_rows, int k, int n_steps,
                                 float* done, float* flows, float* scratch,
                                 void* stream) {
  if (n_rows <= 0 || k <= 0 || n_steps <= 0) return 0;
  const dim3 grid((n_rows + WARPS - 1) / WARPS), block(WARPS * 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FLUID_LAUNCH(CPL)                                                  \
  fluid_scan_kernel<CPL><<<grid, block, 0, s>>>(                           \
      demands, n_clients, dt, n_rows, k, n_steps, done, flows, scratch)
  switch (columns_per_lane(k)) {
    case 1: FLUID_LAUNCH(1); break;
    case 2: FLUID_LAUNCH(2); break;
    case 4: FLUID_LAUNCH(4); break;
    case 8: FLUID_LAUNCH(8); break;
    case 16: FLUID_LAUNCH(16); break;
    default: FLUID_LAUNCH(0);
  }
#undef FLUID_LAUNCH
  return (int)cudaGetLastError();
}
