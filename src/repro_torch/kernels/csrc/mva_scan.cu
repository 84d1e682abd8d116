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
// The row sum's order is a function of K alone, which the plain version
// repeats (src/repro_torch/kernels/mva_scan.py:plan):
//   * K <= 512: the strided pairwise tree over the row padded with zeros
//     to N, the power of two at or above K (a padding column has d = 0,
//     q = 0, so r_k = +0, which leaves every sum exact): a level adds the
//     upper half onto the lower, t_i = t_i + t_i+N/2, down to t_0.  Up to
//     32 columns that is also the order of a warp holding one column a
//     lane and summing by an xor butterfly at 16, ..., 1 (its additions
//     past K add zeros).  The kernel holds the row on LR lanes of W
//     columns (W LR = N; the wrapper's plan picks the split): lane s holds
//     columns s,
//     s + LR, s + 2 LR, ..., sums them by the strided tree over its W, and
//     an xor butterfly over the row's LR lanes at offsets LR / 2, ..., 1
//     (p += p of lane s ^ offset) finishes the same tree: each of its
//     additions pairs columns s and s + offset, and leaves both lanes the
//     same value, a float addition being commutative.
//   * K > 512 (W = 0, the global-memory walk): lane l of the row's warp
//     sums columns l, l + 32, l + 64, ... in column order, from +0, then
//     the xor butterfly at offsets 16, 8, 4, 2, 1.
//
// Bound: neither bytes nor operations.  A call reads M K demands once and
// writes 2 M n_max floats; it does about 4 K + 2 float32 operations a row
// and step.  At the Fig. 29 grid (32 rows, K = 15, n_max 512) that is a
// few microseconds' worth of either.  What takes the time is the serial
// chain: every step needs the queue lengths of the step before, and within
// a step the sum needs every column.  So the design shortens the chain:
//   * one launch for every step: the step loop runs inside the kernel, one
//     warp a block, 32 / LR rows a warp;
//   * a row's demands, queues and residence times live in registers, W a
//     lane, and its sum is a tree of log2 W dependent additions in the
//     lane, then log2 LR shuffles.  A warp issues its instructions in
//     order and one warp a block has nothing to hide them behind, so a
//     lane keeps at most 8 columns up to 256 (the Fig. 29 grid's 15
//     columns on 2 lanes: a step of some 50 instructions a lane and one
//     shuffle, where one thread a row issued nearly twice as many), and
//     N / 32 past that (the sharded (32, 480) grid: 16 a lane, as many as
//     when a lane summed them in column order, in a tree 4 additions
//     deep, not 16);
//   * past 512 columns each lane walks its columns through global memory,
//     the residence times kept in a scratch row between the sum and the
//     update;
//   * stores are off the chain: the step loop runs in chunks of 32 steps,
//     and the row's lane s keeps x and r of the chunk's steps s, s + LR,
//     ... in registers (a predicated move a step; the chunk is unrolled
//     where a lane keeps more than one step, so the index is known at
//     compile time), writing them when the chunk ends.  Every chunk runs
//     its 32 steps; a step past n_max is computed, not stored.
//     (Staging them in shared memory instead ran 204 cycles a step at
//     (32, 15) on an H100, against 177.)
// Float arithmetic is written __fadd_rn / __fmul_rn / __fdiv_rn: nvcc
// contracts nothing into an FMA, and every value rounds as the plain
// version's separate torch ops do.  Offsets into the outputs are 64-bit.

#include <cuda_runtime.h>
#include <stdint.h>

constexpr unsigned FULL = 0xffffffffu;
constexpr int CHUNK = 32;  // steps of an unrolled chunk

// log2 of a power of two, at compile time
__host__ __device__ constexpr int log2_of(int w) {
  return w > 1 ? 1 + log2_of(w / 2) : 0;
}

// The strided pairwise tree over t[0..N-1], N a power of two: a level
// adds the upper half onto the lower (t_i = t_i + t_i+N/2), then the same
// over the lower half; every index is known at compile time, so t stays
// in registers.  t is overwritten.
template <int N, int W>
__device__ __forceinline__ float strided_tree(float (&t)[W]) {
  if constexpr (N == 1) {
    return t[0];
  } else {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) t[i] = __fadd_rn(t[i], t[i + N / 2]);
    return strided_tree<N / 2>(t);
  }
}

// W register columns a lane (0: the global-memory walk), LR lanes a row.
template <int W, int LR>
__global__ void __launch_bounds__(32) mva_scan_kernel(
    const float* __restrict__ demands, float think, int n_rows, int k,
    int n_max, float* __restrict__ xs, float* __restrict__ rs,
    float* __restrict__ scratch) {
  constexpr int R = 32 / LR;      // rows a warp
  constexpr int S = CHUNK / LR;   // steps of a chunk a lane keeps
  const int lane = threadIdx.x;
  const int sub = lane % LR;   // lane within the row
  const int rho = lane / LR;   // row within the warp
  const long long m = (long long)blockIdx.x * R + rho;
  const bool row_ok = m < n_rows;
  // a row past the matrix runs a harmless chain (every demand 1) so that
  // its lanes stay in step with the warp; nothing of it is stored
  const long long mr = row_ok ? m : 0;
  const float* d_row = demands + mr * k;
  float* x_row = xs + mr * n_max;
  float* r_row = rs + mr * n_max;

  float d[W > 0 ? W : 1], q[W > 0 ? W : 1], rk[W > 0 ? W : 1];
  float* qg = scratch + mr * k;
  if constexpr (W > 0) {
#pragma unroll
    for (int i = 0; i < W; ++i) {
      const int c = sub + LR * i;
      d[i] = row_ok ? (c < k ? d_row[c] : 0.f) : 1.f;
      q[i] = 0.f;
    }
  } else {
    // q lives in the scratch row; the residence times overwrite it between
    // the sum and the update.  Each lane touches only its own columns.
    if (row_ok)
      for (int c = lane; c < k; c += 32) qg[c] = 0.f;
  }

  float xb[S], rb[S];  // steps sub, sub + LR, ... of the chunk
  for (int j0 = 0; j0 < n_max; j0 += CHUNK) {
    // step j0 + jj; xb and rb are indexed at compile time where jj is
    auto step = [&](int jj) {
      float p;
      if constexpr (W > 0) {
#pragma unroll
        for (int i = 0; i < W; ++i)
          rk[i] = __fmul_rn(d[i], __fadd_rn(1.f, q[i]));
        float t[W];
#pragma unroll
        for (int i = 0; i < W; ++i) t[i] = rk[i];
        p = strided_tree<W>(t);
      } else {
        p = 0.f;
        if (row_ok)
          for (int c = lane; c < k; c += 32) {
            const float r = __fmul_rn(d_row[c], __fadd_rn(1.f, qg[c]));
            qg[c] = r;
            p = __fadd_rn(p, r);
          }
      }
#pragma unroll
      for (int level = log2_of(LR) - 1; level >= 0; --level)  // LR/2 .. 1
        p = __fadd_rn(p, __shfl_xor_sync(FULL, p, 1 << level));
      const float x = __fdiv_rn((float)(j0 + jj + 1), __fadd_rn(think, p));
      if constexpr (W > 0) {
#pragma unroll
        for (int i = 0; i < W; ++i) q[i] = __fmul_rn(x, rk[i]);
      } else {
        if (row_ok)
          for (int c = lane; c < k; c += 32) qg[c] = __fmul_rn(x, qg[c]);
      }
      if (sub == jj % LR) {
        xb[jj / LR] = x;
        rb[jj / LR] = p;
      }
    };
    if constexpr (S == 1) {
      // a lane keeps one step of the chunk, so a loop indexes its
      // registers at compile time too: no 32 copies of a long step
#pragma unroll 1
      for (int jj = 0; jj < CHUNK; ++jj) step(jj);
    } else {
#pragma unroll
      for (int jj = 0; jj < CHUNK; ++jj) step(jj);
    }
    if (row_ok) {
#pragma unroll
      for (int i = 0; i < S; ++i) {
        const int j = j0 + sub + LR * i;
        if (j < n_max) {
          x_row[j] = xb[i];
          r_row[j] = rb[i];
        }
      }
    }
  }
}

// C entry point: launches on `stream` and returns cudaGetLastError() (or
// cudaErrorInvalidValue for a plan the source has no kernel for).
// (width, lanes) is the wrapper's plan: (1..8, 1) one thread a row,
// (8, 2..32) and (16, 32) lanes a row, (0, 32) the global walk.
extern "C" int mva_scan_launch(const float* demands, float think, int n_rows,
                               int k, int n_max, int width, int lanes,
                               float* xs, float* rs, float* scratch,
                               void* stream) {
  if (n_rows <= 0 || n_max <= 0) return 0;
  if (lanes <= 0 || lanes > 32) return (int)cudaErrorInvalidValue;
  const long long blocks = ((long long)n_rows * lanes + 31) / 32;
  if (blocks >= (1LL << 31)) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)blocks), block(32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MVA_LAUNCH(W, LR)                                                  \
  case W * 64 + LR:                                                        \
    mva_scan_kernel<W, LR><<<grid, block, 0, s>>>(demands, think, n_rows,  \
                                                  k, n_max, xs, rs,        \
                                                  scratch);                \
    break
  switch (width * 64 + lanes) {
    MVA_LAUNCH(1, 1); MVA_LAUNCH(2, 1); MVA_LAUNCH(4, 1); MVA_LAUNCH(8, 1);
    MVA_LAUNCH(8, 2); MVA_LAUNCH(8, 4); MVA_LAUNCH(8, 8); MVA_LAUNCH(8, 16);
    MVA_LAUNCH(8, 32); MVA_LAUNCH(16, 32);
    MVA_LAUNCH(0, 32);
    default: return (int)cudaErrorInvalidValue;
  }
#undef MVA_LAUNCH
  return (int)cudaGetLastError();
}
