// Exact single-class Mean Value Analysis for Hopper (sm_90a).
//
// Replaces no Pallas kernel: it is the body of the reference's lax.scan,
// src/repro/core/simulator.py:38 _mva_scan_impl, which the reference vmaps
// over the rows of a [M, K] demand matrix and jits into one device call
// (:61 _mva_scan_batch).  For each row m and N = 1..n_max:
//   r_k = d_k (1 + q_k)       residence time per station
//   r   = sum_k r_k
//   x   = N / (think + r)     closed-loop throughput
//   q_k = x r_k               Little's law per station
// and X[m, N-1] = x, R[m, N-1] = r, in float32.  It equals the plain
// version, src/repro_torch/kernels/ref.py:ref_mva_scan, bit for bit.
//
// The row sum's order, which the plain version repeats: lane l of the
// row's warp sums columns l, l + 32, l + 64, ... in column order, from
// +0 (a column past K adds d = 0, q = 0, so r_k = +0, as the plain
// version's zero padding to a multiple of 32 does); then an xor butterfly
// at offsets 16, 8, 4, 2, 1 (p += p of lane l ^ offset) leaves every lane
// the same total, since each addition's two operands are the same pair on
// both lanes and a float addition is commutative.
//
// Bound: neither bytes nor operations.  A call reads M K demands once and
// writes 2 M n_max floats; it does about 3 K + 3 float32 operations a row
// and step.  At the Fig. 29 grid (32 rows, K = 15, n_max 512) that is a
// few microseconds' worth of either.  What takes the time is the serial
// chain: every step needs the queue lengths of the step before, and within
// a step the sum needs every column.  So:
//   * one warp a row, one launch for every step: the step loop runs inside
//     the kernel, and M rows are ceil(M / 4) blocks of four warps;
//   * a row of up to 32 * CPL columns keeps its demands and queue lengths
//     in registers (CPL = 1, 2, 4, 8 or 16: K <= 512); past it (CPL = 0)
//     each lane walks its columns through global memory, the residence
//     times kept in a scratch row between the sum and the update;
//   * the sum is five shuffles deep, with no shared memory and no barrier;
//   * a step's x and r are kept by lane (step mod 32) and written 32 steps
//     at a time, one coalesced store of each a 32 steps.
// Float arithmetic is written __fadd_rn / __fmul_rn / __fdiv_rn: nvcc
// contracts nothing into an FMA, and every value rounds as the plain
// version's separate torch ops do.  Offsets into the outputs are 64-bit.

#include <cuda_runtime.h>
#include <stdint.h>

constexpr int WARPS = 4;  // rows a block
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float row_sum(float p) {
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1)
    p = __fadd_rn(p, __shfl_xor_sync(FULL, p, off));
  return p;
}

// Keep x and r of step j in lane j mod 32; write them every 32 steps.
__device__ __forceinline__ void emit(float x, float r, int j, int n_max,
                                     int lane, float& xb, float& rb,
                                     float* __restrict__ xs,
                                     float* __restrict__ rs) {
  if ((j & 31) == lane) {
    xb = x;
    rb = r;
  }
  if ((j & 31) == 31 || j == n_max - 1) {
    const int jj = (j & ~31) + lane;
    if (jj <= j) {
      xs[jj] = xb;
      rs[jj] = rb;
    }
  }
}

template <int CPL>
__global__ void __launch_bounds__(WARPS * 32) mva_scan_kernel(
    const float* __restrict__ demands, float think, int n_rows, int k,
    int n_max, float* __restrict__ xs_all, float* __restrict__ rs_all,
    float* __restrict__ scratch) {
  const int lane = threadIdx.x & 31;
  const long long m = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (m >= n_rows) return;  // the whole warp leaves together
  const float* d_row = demands + m * k;
  float* xs = xs_all + m * n_max;
  float* rs = rs_all + m * n_max;
  float xb = 0.f, rb = 0.f;
  if constexpr (CPL > 0) {
    float d[CPL], q[CPL], rk[CPL];
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
      const int c = lane + 32 * i;
      d[i] = c < k ? d_row[c] : 0.f;
      q[i] = 0.f;
    }
    for (int j = 0; j < n_max; ++j) {
      float p = 0.f;
#pragma unroll
      for (int i = 0; i < CPL; ++i) {
        rk[i] = __fmul_rn(d[i], __fadd_rn(1.f, q[i]));
        p = __fadd_rn(p, rk[i]);
      }
      const float r = row_sum(p);
      const float x = __fdiv_rn((float)(j + 1), __fadd_rn(think, r));
#pragma unroll
      for (int i = 0; i < CPL; ++i) q[i] = __fmul_rn(x, rk[i]);
      emit(x, r, j, n_max, lane, xb, rb, xs, rs);
    }
  } else {
    // q lives in the scratch row; the residence times overwrite it between
    // the sum and the update.  Each lane touches only its own columns.
    float* q = scratch + m * k;
    for (int c = lane; c < k; c += 32) q[c] = 0.f;
    const int k32 = (k + 31) & ~31;
    for (int j = 0; j < n_max; ++j) {
      float p = 0.f;
      for (int c = lane; c < k32; c += 32) {
        float rk = 0.f;
        if (c < k) {
          rk = __fmul_rn(d_row[c], __fadd_rn(1.f, q[c]));
          q[c] = rk;
        }
        p = __fadd_rn(p, rk);
      }
      const float r = row_sum(p);
      const float x = __fdiv_rn((float)(j + 1), __fadd_rn(think, r));
      for (int c = lane; c < k; c += 32) q[c] = __fmul_rn(x, q[c]);
      emit(x, r, j, n_max, lane, xb, rb, xs, rs);
    }
  }
}

// Columns a lane keeps in registers for K columns: 1, 2, 4, 8 or 16; 0
// past 512 (the global-memory walk).
static int columns_per_lane(int k) {
  int cpl = 1;
  while (cpl * 32 < k) cpl *= 2;
  return cpl <= 16 ? cpl : 0;
}

extern "C" int mva_scan_launch(const float* demands, float think, int n_rows,
                               int k, int n_max, float* xs, float* rs,
                               float* scratch, void* stream) {
  if (n_rows <= 0 || n_max <= 0) return 0;
  const dim3 grid((n_rows + WARPS - 1) / WARPS), block(WARPS * 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MVA_LAUNCH(CPL)                                                    \
  mva_scan_kernel<CPL><<<grid, block, 0, s>>>(demands, think, n_rows, k,   \
                                              n_max, xs, rs, scratch)
  switch (columns_per_lane(k)) {
    case 1: MVA_LAUNCH(1); break;
    case 2: MVA_LAUNCH(2); break;
    case 4: MVA_LAUNCH(4); break;
    case 8: MVA_LAUNCH(8); break;
    case 16: MVA_LAUNCH(16); break;
    default: MVA_LAUNCH(0);
  }
#undef MVA_LAUNCH
  return (int)cudaGetLastError();
}
