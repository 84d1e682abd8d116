// Flash attention forward (prefill, and the training forward) for Hopper
// (sm_90a).
//
// Replaces the Pallas kernel src/repro/kernels/flash_attention.py:
// _flash_kernel.  For q (B, H, S_q, d) and k, v (B, H_kv, S_k, d), query
// head h reading kv head h / (H / H_kv):
//   o[b, h, i] = sum_j softmax_j(q_i . k_j * d^-1/2) v_j
// over j <= i when causal, over all j otherwise, and with a window w > 0
// only over i - j < w besides (the reference's local attention,
// src/repro/models/attention.py:chunked_attention).  A causal or windowed
// call has S_q == S_k (the wrapper checks); a full one takes any S_k
// (whisper's cross-attention: the decoder's queries against the encoder's
// 1500 keys).  Scores, running max and running sum are float32; masked
// scores are -1e30 (the reference's value, not -inf); the output is
// acc / max(l, 1e-30) in the input type.  Given a non-null `lse` (the
// training forward) the kernel also writes each row's float32 log-sum-exp
// of its scaled scores, m + ln l, (B, H, S_q) dense, from which the
// backward (flash_attention_bwd.cu) recomputes P; serving passes null and
// runs as before.
// Inputs are float32 or bfloat16, head dim 16, 32, 64, 128 or 256, and
// any S: the ragged last tile is masked here (the TPU kernel asserted that
// S divides by its 128-row blocks).  Each tensor comes with its own
// strides (the last dimension contiguous), so the model hands in
// transposed views of its (B, S, H, d) activations without a copy.  The
// bfloat16 kernel copies rows in 16-byte pieces, so its base pointers are
// 16-byte aligned and its strides multiples of 8 elements: the wrapper
// copies a view that is not (flash_attention.py:aligned_rows).
//
// Bound: operations.  About 4 d flops per computed (query, key) pair
// against a few bytes per element moved: at granite-3-2b's 2048-token
// causal prefill, q (1, 32, 2048, 64), 17.2 GFLOP take 0.0174 ms at the
// tensor cores' dense bf16 rate of 989 TFLOP/s; float32 inputs run at the
// 67 TFLOP/s of the CUDA cores.
//
// The walk.  On the TPU the KV axis is the innermost, sequential grid
// axis and (m, l, acc) live in VMEM across its steps.  On Hopper blocks
// run in parallel and in no order, so the KV loop moves inside the block:
// one block per (b, h, query tile); with a causal mask the grid's slowest
// axis walks the query tiles from the last, so the blocks with the most
// key tiles start first.  A block walks the key tiles from the first any
// of its rows can see (tile 0 without a window, the tile of key
// q0 - w + 1 with one) up to the diagonal.  Without a window a row's
// first tile holds a valid key (key 0).  With one, a block can straddle
// the window's start, and a row's first tile (or two) may hold no key it
// sees: its scores are all -1e30, its running max stays -1e30, and
// exp(0) = 1 terms enter l and acc.  They are wiped at the row's first
// tile with a valid key, whose rescale is exp(-1e30 - m) = 0, and every
// row reaches one (the key of its own position, in the diagonal tile, at
// the latest).  The argument holds for any tile size, and so for the
// tiles below.
//
// bfloat16 (the serving path's type): FlashAttention-2 on `mma.sync`
// m16n8k16 with float32 accumulation.
//   * Tiles by head dim, each warp owning 16 query rows: d = 64, 8 warps
//     and 128 query rows; d = 16, 32, 128, 4 warps and 64 rows; 64-key
//     tiles; d = 256, 4 warps, 64 rows and 32-key tiles.  Shared memory
//     holds the Q tile and a two-stage ring of K and V tiles: 55 KB at
//     d = 64, 87 KB at 128, 101 KB at 256, so two blocks fit an SM.
//   * Copies: every tile comes in by 16-byte `cp.async.cg` copies, rows
//     past S zero-filled through the copy's source size.  Key tile kt+1 is
//     in flight while tile kt is multiplied: one wait_group and one
//     __syncthreads() per tile, after which the ring's other stage is free
//     to refill.
//   * Fragments: Q and K as A and B fragments by `ldmatrix.x4`; V stays
//     row-major and its B fragments for P.V come from `ldmatrix.x4.trans`.
//     Rows are padded by 8 halves (16 bytes), so the 8 rows an ldmatrix
//     phase reads, and the 16-byte copies of a row, fall in distinct
//     banks; no swizzle.  Up to d = 128 a warp keeps its Q fragments in
//     registers; at d = 256 (128 accumulator registers for the output) it
//     reads them from the Q tile at each k-step.
//   * Softmax: scores are scaled by d^-1/2 log2(e) (inside the
//     exponent's FMA on interior tiles) and exponentiated with ex2; the
//     causal and window mask is applied only where a tile crosses the
//     warp's diagonal, the window's start or S, and a warp skips a tile
//     none of its rows can see.  The accumulators are rescaled only when a
//     row maximum of the warp moved.  Each lane keeps its part of the row
//     sums and reduces them over the 4 lanes of a row once, at the end.
//     P enters P.V rounded to bf16 straight from the S accumulators (the
//     row sums stay float32).
//   * The output goes through the warp's own rows of the Q tile and out
//     in 16-byte stores.
// What is left: `wgmma` on warpgroups fed by TMA from a producer warp
// (warp specialisation), the next redesign toward half the bound
// (0.0348 ms at granite's prefill).
//
// float32 (tests and the card/CPU comparison): exact float32 FMAs on the
// CUDA cores (no TF32), to hold 2e-5 (at head dim 256 its tiles take
// 217 KB of the 227 KB of shared memory: one block per SM).  256 threads;
// thread (ty, tx) of a 16 x 16 arrangement owns query rows 4ty..4ty+3 and
// keys tx + 16j (j < 4) of the tile's 64 x 64 score block, read as float4
// vectors from rows padded to d + 4 floats (free of bank conflicts); row
// maxima and sums are reduced over the 16 lanes of a row with shuffles;
// probabilities go through shared memory for the P.V product.  Its tiles
// are copied element by element.
// Offsets are 64-bit.


#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per tile
constexpr int THREADS = 256;  // 16 x 16
constexpr int LDP = BK + 4;   // padded row of the probability tile
constexpr float NEG = -1e30f;

struct Strides {
  long long b, h, s;
};

// ---------------------------------------------------------------------------
// float32 on the CUDA cores
// ---------------------------------------------------------------------------

// Copy a (rows x D) tile starting at row r0 into shared memory, rows at or
// past S filled with zeros.
template <int D, int LD>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          Strides st, int r0, int S) {
  for (int idx = threadIdx.x; idx < BK * D; idx += THREADS) {
    const int r = idx / D, c = idx % D;
    const int row = r0 + r;
    dst[r * LD + c] = row < S ? src[(long long)row * st.s + c] : 0.f;
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o,
                       float* __restrict__ lse, int group, int Sq, int Sk,
                       float scale, int causal, int window, Strides qs,
                       Strides ks, Strides vs, Strides os) {
  constexpr int LD = D + 4;  // padded row, float4-aligned
  constexpr int NC = D / 16;  // output columns per thread
  extern __shared__ float4 smem4[];
  float* sq = reinterpret_cast<float*>(smem4);  // BQ x LD
  float* sk = sq + BQ * LD;                     // BK x LD
  float* sv = sk + BK * LD;                     // BK x LD
  float* sp = sv + BK * LD;                     // BQ x LDP

  const int n_qt = gridDim.x;
  const int qt = causal ? n_qt - 1 - blockIdx.x : blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / group;
  const int q0 = qt * BQ;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  const float* qb = q + b * qs.b + h * qs.h + (long long)q0 * qs.s;
  load_tile<D, LD>(sq, qb, qs, 0, Sq - q0);
  const float* kb = k + b * ks.b + hk * ks.h;
  const float* vb = v + b * vs.b + hk * vs.h;

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  const int n_kt_all = (Sk + BK - 1) / BK;
  const int n_kt = causal ? min(n_kt_all, (q0 + BQ - 1) / BK + 1) : n_kt_all;
  const int kt_lo = window > 0 ? max(0, q0 - window + 1) / BK : 0;
  for (int kt = kt_lo; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    load_tile<D, LD>(sk, kb, ks, k0, Sk);
    load_tile<D, LD>(sv, vb, vs, k0, Sk);
    __syncthreads();

    // scores s[i][j] = q[4ty+i] . k[tx+16j]
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(&sq[(4 * ty + i) * LD + d]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(&sk[(tx + 16 * j) * LD + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }

    // online softmax over the tile, rows shared by 16 lanes
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + 4 * ty + i;
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        const bool ok = kpos < Sk && (!causal || kpos <= qpos) &&
                        (window <= 0 || qpos - kpos < window);
        s[i][j] = ok ? s[i][j] * scale : NEG;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        sp[(4 * ty + i) * LDP + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float alpha = expf(m[i] - m_new);
      l[i] = alpha * l[i] + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    // acc[i][c] += sum_j p[4ty+i][j] * v[j][tx+16c]
#pragma unroll 2
    for (int j = 0; j < BK; j += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(&sp[(4 * ty + i) * LDP + j]);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float v0 = sv[(j + 0) * LD + tx + 16 * c];
        const float v1 = sv[(j + 1) * LD + tx + 16 * c];
        const float v2 = sv[(j + 2) * LD + tx + 16 * c];
        const float v3 = sv[(j + 3) * LD + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][c] = fmaf(pv[i].x, v0, acc[i][c]);
          acc[i][c] = fmaf(pv[i].y, v1, acc[i][c]);
          acc[i][c] = fmaf(pv[i].z, v2, acc[i][c]);
          acc[i][c] = fmaf(pv[i].w, v3, acc[i][c]);
        }
      }
    }
    __syncthreads();
  }

  float* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + 4 * ty + i;
    if (qpos >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c)
      ob[(long long)qpos * os.s + tx + 16 * c] = acc[i][c] / denom;
    if (lse != nullptr && tx == 0)
      lse[((long long)b * gridDim.y + h) * Sq + qpos] = m[i] + logf(denom);
  }
}

// ---------------------------------------------------------------------------
// bfloat16 on the tensor cores
// ---------------------------------------------------------------------------

#include "mma_bf16.cuh"

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <int D>
struct MmaTile {
  static constexpr int WARPS = D == 64 ? 8 : 4;  // 16 query rows each
  static constexpr int BQ = 16 * WARPS;          // query rows per block
  static constexpr int BK = D == 256 ? 32 : 64;  // keys per tile
  static constexpr int LD = D + 8;               // halves per smem row
  static constexpr int THREADS = 32 * WARPS;
  // the Q tile and two stages of K and V
  static constexpr size_t SMEM =
      sizeof(__nv_bfloat16) * (size_t)(BQ + 4 * BK) * LD;
};

template <int D>
__global__ void __launch_bounds__(MmaTile<D>::THREADS, 2)
flash_attention_mma_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           __nv_bfloat16* __restrict__ o,
                           float* __restrict__ lse, int H, int group, int Sq,
                           int Sk, float scale_log2, int causal, int window,
                           Strides qs, Strides ks, Strides vs, Strides os) {
  using T = MmaTile<D>;
  constexpr int BQT = T::BQ, BKT = T::BK, LD = T::LD, NTH = T::THREADS;
  constexpr int KS = D / 16;   // k-steps of Q.K^T over the head dim
  constexpr int NO = D / 8;    // n-tiles of the output
  constexpr int NT = BKT / 8;  // n-tiles of the score block
  constexpr bool Q_REGS = D <= 128;  // Q fragments held in registers
  extern __shared__ float4 smem4[];
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem4);  // BQ x LD
  __nv_bfloat16* sk = sq + BQT * LD;  // 2 stages of BK x LD
  __nv_bfloat16* sv = sk + 2 * BKT * LD;

  const int n_qt = gridDim.y;
  const int qt = causal ? n_qt - 1 - blockIdx.y : blockIdx.y;
  const int b = blockIdx.x / H, h = blockIdx.x % H, hk = h / group;
  const int q0 = qt * BQT;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tig = lane & 3;  // fragment row / column pair
  const int r0 = warp * 16;                 // the warp's rows in the tile
  const int row_lo = q0 + r0;
  const int row_a = row_lo + g, row_b = row_a + 8;  // this lane's rows
  // ldmatrix addresses: A fragments (rows lane & 15, column half lane >> 4),
  // B fragments of K (8-key half lane >> 4, column half (lane >> 3) & 1),
  // of V transposed (8-key half (lane >> 3) & 1, column half lane >> 4)
  const int a_row = lane & 15, a_col = (lane >> 4) * 8;
  const int k_row = (lane >> 4) * 8 + (lane & 7), k_col = ((lane >> 3) & 1) * 8;
  const int v_row = ((lane >> 3) & 1) * 8 + (lane & 7), v_col = (lane >> 4) * 8;

  const __nv_bfloat16* qb = q + b * qs.b + h * qs.h + (long long)q0 * qs.s;
  const __nv_bfloat16* kb = k + b * ks.b + hk * ks.h;
  const __nv_bfloat16* vb = v + b * vs.b + hk * vs.h;

  const int n_kt_all = (Sk + BKT - 1) / BKT;
  const int n_kt = causal ? min(n_kt_all, (q0 + BQT - 1) / BKT + 1) : n_kt_all;
  const int kt_lo = window > 0 ? max(0, q0 - window + 1) / BKT : 0;

  copy_tile<BQT, D, NTH>(sq, qb, qs.s, 0, Sq - q0);
  copy_tile<BKT, D, NTH>(sk, kb, ks.s, kt_lo * BKT, Sk);
  copy_tile<BKT, D, NTH>(sv, vb, vs.s, kt_lo * BKT, Sk);
  cp_async_commit();

  uint32_t qa[Q_REGS ? KS : 1][4];
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  // running maxima of this lane's two rows (log2 units), and this lane's
  // part of their sums
  float m_a = NEG, m_b = NEG, l_a = 0.f, l_b = 0.f;

  for (int kt = kt_lo; kt < n_kt; ++kt) {
    const int stage = (kt - kt_lo) & 1;
    cp_async_wait<0>();  // tile kt (and, the first time, Q) has landed
    __syncthreads();      // ... for every thread; the other stage is free
    if (kt + 1 < n_kt) {
      const int nxt = (stage ^ 1) * BKT * LD;
      copy_tile<BKT, D, NTH>(sk + nxt, kb, ks.s, (kt + 1) * BKT, Sk);
      copy_tile<BKT, D, NTH>(sv + nxt, vb, vs.s, (kt + 1) * BKT, Sk);
      cp_async_commit();
    }
    if constexpr (Q_REGS) {
      if (kt == kt_lo) {
#pragma unroll
        for (int kk = 0; kk < KS; ++kk)
          ldmatrix_x4(qa[kk], smem_addr(sq + (r0 + a_row) * LD + kk * 16 +
                                        a_col));
      }
    }
    const int k0 = kt * BKT;
    // a tile none of the warp's rows can see (past its diagonal, before
    // its window, or rows all past S_q) changes nothing: skip it
    if (row_lo >= Sq || (causal && k0 > row_lo + 15) ||
        (window > 0 && k0 + BKT - 1 <= row_lo - window))
      continue;
    const __nv_bfloat16* skt = sk + stage * BKT * LD;
    const __nv_bfloat16* svt = sv + stage * BKT * LD;

    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t qf[4];
      if constexpr (Q_REGS) {
#pragma unroll
        for (int e = 0; e < 4; ++e) qf[e] = qa[kk][e];
      } else {
        ldmatrix_x4(qf, smem_addr(sq + (r0 + a_row) * LD + kk * 16 + a_col));
      }
#pragma unroll
      for (int n = 0; n < NT; n += 2) {
        uint32_t kf[4];
        ldmatrix_x4(kf, smem_addr(skt + (n * 8 + k_row) * LD + kk * 16 +
                                  k_col));
        mma_bf16(s[n], qf, kf[0], kf[1]);
        mma_bf16(s[n + 1], qf, kf[2], kf[3]);
      }
    }

    // scores into log2 units (scale sc); mask only a tile that crosses
    // the warp's diagonal, its window's start or S_k, scaling it here (sc
    // becomes 1); an interior tile's scale rides in the exponent's FMA.
    // Element e of tile n is row (e < 2 ? a : b), key k0 + 8n + 2tig +
    // (e & 1)
    const bool edge = k0 + BKT > Sk || (causal && k0 + BKT - 1 > row_lo) ||
                      (window > 0 && row_lo + 15 - k0 >= window);
    float sc = scale_log2;
    if (edge) {
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + n * 8 + tig * 2 + (e & 1);
          const int row = e < 2 ? row_a : row_b;
          const bool ok = key < Sk && (!causal || key <= row) &&
                          (window <= 0 || row - key < window);
          s[n][e] = ok ? s[n][e] * scale_log2 : NEG;
        }
      sc = 1.f;
    }
    float mx_a = NEG, mx_b = NEG;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      mx_a = fmaxf(mx_a, fmaxf(s[n][0], s[n][1]));
      mx_b = fmaxf(mx_b, fmaxf(s[n][2], s[n][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
    }
    const float mn_a = fmaxf(m_a, mx_a * sc), mn_b = fmaxf(m_b, mx_b * sc);
    const float al_a = ex2(m_a - mn_a), al_b = ex2(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      s[n][0] = ex2(fmaf(s[n][0], sc, -mn_a));
      s[n][1] = ex2(fmaf(s[n][1], sc, -mn_a));
      s[n][2] = ex2(fmaf(s[n][2], sc, -mn_b));
      s[n][3] = ex2(fmaf(s[n][3], sc, -mn_b));
      sum_a += s[n][0] + s[n][1];
      sum_b += s[n][2] + s[n][3];
    }
    l_a = al_a * l_a + sum_a;
    l_b = al_b * l_b + sum_b;
    // a rescale by exactly 1 (no row maximum of the warp moved) is skipped
    if (__any_sync(0xffffffffu, al_a != 1.f || al_b != 1.f)) {
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        acc[n][0] *= al_a;
        acc[n][1] *= al_a;
        acc[n][2] *= al_b;
        acc[n][3] *= al_b;
      }
    }

    // acc += P.V: the S accumulators of tiles 2kk, 2kk+1 are the A
    // fragment of P's keys 16kk..16kk+15
#pragma unroll
    for (int kk = 0; kk < BKT / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int n = 0; n < NO; n += 2) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, smem_addr(svt + (kk * 16 + v_row) * LD +
                                        n * 8 + v_col));
        mma_bf16(acc[n], pa, vf[0], vf[1]);
        mma_bf16(acc[n + 1], pa, vf[2], vf[3]);
      }
    }
  }
  if (row_lo >= Sq) return;

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  if (lse != nullptr && tig == 0) {
    // m is in log2 units: ln(sum) = (m + log2 l) ln 2
    float* lb = lse + ((long long)b * H + h) * Sq;
    if (row_a < Sq) lb[row_a] = (m_a + log2f(fmaxf(l_a, 1e-30f))) * LN2;
    if (row_b < Sq) lb[row_b] = (m_b + log2f(fmaxf(l_b, 1e-30f))) * LN2;
  }
  // the output through the warp's own 16 rows of the Q tile (no other
  // warp reads them), then out in 16-byte stores
  const float den_a = fmaxf(l_a, 1e-30f), den_b = fmaxf(l_b, 1e-30f);
  __nv_bfloat16* so = sq + r0 * LD;
  __syncwarp();
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int c = n * 8 + tig * 2;
    *reinterpret_cast<__nv_bfloat162*>(so + g * LD + c) =
        __floats2bfloat162_rn(acc[n][0] / den_a, acc[n][1] / den_a);
    *reinterpret_cast<__nv_bfloat162*>(so + (g + 8) * LD + c) =
        __floats2bfloat162_rn(acc[n][2] / den_b, acc[n][3] / den_b);
  }
  __syncwarp();
  __nv_bfloat16* ob = o + b * os.b + h * os.h;
  constexpr int CH = D / 8;
#pragma unroll
  for (int i = lane; i < 16 * CH; i += 32) {
    const int r = i / CH, c = (i % CH) * 8, row = row_lo + r;
    if (row < Sq)
      *reinterpret_cast<uint4*>(ob + (long long)row * os.s + c) =
          *reinterpret_cast<const uint4*>(so + r * LD + c);
  }
}

template <int D>
int launch_mma(const void* q, const void* k, const void* v, void* o,
               float* lse, int B, int H, int H_kv, int Sq, int Sk, int causal,
               int window, float scale, const long long* st,
               cudaStream_t stream) {
  using T = MmaTile<D>;
  static bool attr_set = false;  // once per instantiation and process
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_attention_mma_kernel<D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::SMEM);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  // query tiles on the slowest axis: with a causal mask the tiles with the
  // most key tiles of every (b, h) go first
  const dim3 grid(B * H, (Sq + T::BQ - 1) / T::BQ);
  flash_attention_mma_kernel<D><<<grid, T::THREADS, T::SMEM, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      lse, H, H / H_kv, Sq, Sk, scale * LOG2E, causal, window, Strides{st[0], st[1], st[2]},
      Strides{st[3], st[4], st[5]}, Strides{st[6], st[7], st[8]},
      Strides{st[9], st[10], st[11]});
  return (int)cudaGetLastError();
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o,
               float* lse, int B, int H, int H_kv, int Sq, int Sk, int causal,
               int window, float scale, const long long* st,
               cudaStream_t stream) {
  constexpr size_t shmem =
      sizeof(float) * (size_t)(BQ * (D + 4) + 2 * BK * (D + 4) + BQ * LDP);
  static bool attr_set = false;  // once per instantiation and process
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_attention_kernel<D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_attention_kernel<D><<<grid, THREADS, shmem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, H / H_kv,
      Sq, Sk, scale, causal, window, Strides{st[0], st[1], st[2]},
      Strides{st[3], st[4], st[5]}, Strides{st[6], st[7], st[8]},
      Strides{st[9], st[10], st[11]});
  return (int)cudaGetLastError();
}

}  // namespace

// C entry point: launches on `stream` and returns cudaGetLastError().
// is_bf16 selects bfloat16 (1, the tensor-core kernel) or float32 (0, the
// CUDA-core kernel) for q, k, v and o alike.  lse: null, or float32
// (B, H, S_q) dense for each row's log-sum-exp.  S_q == S_k where causal
// or windowed.  window: 0 for none, else query i sees key j only where
// i - j < window.  strides: 12 element strides, (batch, head, seq) of q,
// k, v, o in turn.
extern "C" int flash_attention_launch(int is_bf16, int d, const void* q,
                                      const void* k, const void* v, void* o,
                                      float* lse, int B, int H, int H_kv,
                                      int Sq, int Sk, int causal, int window,
                                      float scale, const long long* strides,
                                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FA_ARGS \
  q, k, v, o, lse, B, H, H_kv, Sq, Sk, causal, window, scale, strides, st
  switch (d * 2 + (is_bf16 ? 1 : 0)) {
    case 16 * 2: return launch_f32<16>(FA_ARGS);
    case 32 * 2: return launch_f32<32>(FA_ARGS);
    case 64 * 2: return launch_f32<64>(FA_ARGS);
    case 128 * 2: return launch_f32<128>(FA_ARGS);
    case 256 * 2: return launch_f32<256>(FA_ARGS);
    case 16 * 2 + 1: return launch_mma<16>(FA_ARGS);
    case 32 * 2 + 1: return launch_mma<32>(FA_ARGS);
    case 64 * 2 + 1: return launch_mma<64>(FA_ARGS);
    case 128 * 2 + 1: return launch_mma<128>(FA_ARGS);
    case 256 * 2 + 1: return launch_mma<256>(FA_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef FA_ARGS
}
