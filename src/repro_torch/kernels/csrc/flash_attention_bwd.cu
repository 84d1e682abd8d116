// Flash attention backward (training) for Hopper (sm_90a).
//
// The JAX package has no Pallas backward: its train step differentiates
// its jnp oracle src/repro/models/attention.py:chunked_attention, which
// the port's forward (flash_attention.cu, the counterpart of
// src/repro/kernels/flash_attention.py:_flash_kernel) replaced.  This is
// the gradient of that forward.  For q (B, H, S_q, d), k, v
// (B, H_kv, S_k, d), the forward's output o (B, H, S_q, d) and its
// float32 log-sum-exp lse (B, H, S_q), and the output's cotangent do:
//   P      = exp(q k^T d^-1/2 - lse)          (recomputed, masked to 0)
//   delta  = rowsum(do o)                      (kernel 1)
//   dS     = P (do v^T - delta)
//   dq     = dS k d^-1/2                       (kernel 2)
//   dk     = sum over the group of dS^T q d^-1/2,
//   dv     = sum over the group of P^T do      (kernel 3)
// with the forward's masks: causal (key j <= query i), a window
// (i - j < w, S_q == S_k) or none with any S_q and S_k (cross-attention).
//
// Bound: operations.  Five products of (pairs x d) multiply-adds, 10 d
// flops a computed (query, key) pair: at granite-3-2b's training shape,
// q (4, 32, 1024, 64) causal, 43 GFLOP, 0.0435 ms at the tensor cores'
// dense bf16 rate of 989 TFLOP/s.  The exponentials (one a pair in each
// of dq's and dk/dv's walk) are the next limit: 16 a cycle an SM.
//
// bfloat16 at head dims 64, 128 and 256 (the models that train on the
// card), three launches, the last two programmatic dependents of the one
// before (they start while it ends and wait for its writes):
//   1. delta: rowsum(do o) and lse2 = lse log2(e) for every (b, h) row
//      padded to PAD_ROWS (+inf past S_q, so P = 0 there: no query needs
//      a bound check), 16-byte loads.
//   2. one launch of two roles (a block of 384 threads: a producer
//      warpgroup, whose one thread issues the copy engine's loads and
//      which hands its registers to the consumers by setmaxnreg, and two
//      consumer warpgroups):
//      * dk/dv, one block per (b, kv head, key block): 128 keys at d = 64
//        and 128, 64 a consumer; it walks every head of the group and
//        each query tile (kv_q_tile rows: 128 at d = 64, 64 at d = 128
//        and 256; 16 or 32 where S_q is smaller) that sees its keys; K
//        and V stay in shared memory, the q / do tiles and their lse2 /
//        delta come through a ring of 3 stages (2 at d = 128 and 256).
//        S^T = K Q^T and dP^T = V dO^T on wgmma with both operands in
//        shared memory, P^T and dS^T in registers (masked only on tiles
//        that cross the diagonal or the window's edge; a tile that no
//        pair of a consumer sees is skipped), rounded to bf16 and fed
//        straight back as A: dV += P^T dO, dK += dS^T Q.  The group is
//        summed in the block: no atomics.
//        At d = 256 a consumer's two 64 x 256 float32 accumulators would
//        take 256 registers a thread, so a block has 64 keys and its two
//        consumers split the products, not the keys: consumer 0 computes
//        S^T, P^T and dV and hands P^T to consumer 1 in float32 through
//        shared memory (16 KB at 64 rows, on two mbarriers), which
//        computes dP^T, dS^T and dK; each holds one accumulator.  Where
//        the (b, kv head, key block) blocks are fewer than the SMs
//        (recurrentgemma-2b's 1 kv head for 10 query heads) the group's
//        heads are split over n_gsplit blocks (bwd_plan), each writing
//        float32 dk / dv partials.
//      * dq, one block per (b, h, 128 query rows, key split) walking the
//        key tiles (64 keys, 32 at d = 256) its rows see through the same
//        kind of ring: S = Q K^T, dP = dO V^T, dQ += dS K.  Where few
//        queries leave SMs idle (whisper's cross-attention) bwd_plan
//        splits the keys; each split writes a float32 partial.
//      The dk/dv blocks come first, longest causal walks first, then the
//      dq blocks: each role fills the other's last wave.
//   3. (key or group splits only) the partials summed in split order.
//   Every tile lands by TMA with the 128-byte swizzle: one layout serves
//   as K-major operand (S, dP) and MN-major one (dV, dK, dQ).  No atomics
//   anywhere: every run gives the same bits.  The launch plan (tiles,
//   splits, and every block's walk: its tiles and which of them each
//   consumer skips or masks) is kernels/flash_attention.py:bwd_plan's;
//   the kernel reads its walk from the plan's table.
// Registers (ptxas -v, sm_90a): every wgmma instantiation 168 a thread at
// launch, 24 / 240 after setmaxnreg, no spill; delta 26, merge 36.
// Shared memory a block (the larger role's, + 1 KB for alignment): d = 64
// 83,000 B (kv_q_tile 16, 32), 84,536 (64), 135,224 (128); d = 128
// 132,136 (16, 32), 133,160 (64); d = 256 230,456 at every kv_q_tile (the
// dq role's: q and do of 128 rows, 128 KB, and 3 stages of 32-key K and
// V, 96 KB; the dk/dv role's at 64 rows: K and V 64 KB, 2 stages of q
// and do 128 KB, P^T 16 KB, 215,096 B).
// Times (scripts/attention_ab.py --only backward, in turns against the
// version before; one NVIDIA H100 80GB HBM3 at a 700.00 W power limit):
// granite-3-2b's training shape 0.2246-0.2263 ms (the mma.sync version
// 0.4396-0.4447; SDPA's backward 0.2270-0.2273), whisper-tiny's cross 16
// x 1500 0.0229-0.0230 (0.0657-0.0665; SDPA 0.0223-0.0224), encoder 1500
// x 1500 0.0987-0.0994 (0.1943-0.1959; SDPA 0.0976-0.0983), causal 16 x
// 16 0.0100-0.0103 (0.0152-0.0155; SDPA 0.0169-0.0171), qwen3-moe's 32 /
// 4 heads at d = 128, causal 2048, 0.5122-0.5200 (1.1001-1.1109; SDPA
// 0.2883-0.2903); recurrentgemma-2b's training shape, 10 / 1 heads at d
// = 256, causal 1024, 0.1910-0.1917 (the CUDA-core path it replaced
// 6.8216-6.8650; SDPA 0.2868).  More in PERF.md, row 2b.
//
// float32: three simple launches (delta, dq, dk/dv) on the CUDA cores,
// float32 FMAs, to float32 rounding.  Kernel 2 (dq): one block per (b,
// h, 64 query rows) walks the key tiles its rows see; kernel 3 (dk, dv):
// one block per (b, kv head, key tile) walks the query tiles that see
// its keys, for every query head of the group in turn.  P and dS go
// through shared memory for the products over the other axis.  256
// threads as 16 x 16: thread (ty, tx) owns query rows 4ty..4ty+3 and keys
// tx + 16j of a score tile, and key rows ty + 16r (kernel 3) or query
// rows 4ty..4ty+3 (kernel 2) by columns tx + 16c of the accumulators.
// Rows are padded to d + 4 floats (float4 reads free of bank conflicts).
// Key tiles are 64 keys, 32 at d = 256, which keeps kernel 3's two
// accumulators at 64 registers a thread and its shared memory (q, do, k,
// v, P, dS) at 214 KB.  Offsets are 64-bit.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;  // 16 x 16
constexpr int BQ = 64;        // query rows per tile

struct Strides {
  long long b, h, s;
};

template <int D>
struct Tile {
  static constexpr int BK = D == 256 ? 32 : 64;  // keys per tile
  static constexpr int JK = BK / 16;  // keys (score tile) / key rows a thread
  static constexpr int NC = D / 16;   // accumulator columns a thread
  static constexpr int LD = D + 4;    // padded float row
  static constexpr int LDP = BK + 4;  // padded row of a P or dS tile
};

// ROWS x D rows r0.. of src (row stride rs) into dst as float, rows at or
// past n zero.
template <int ROWS, int D, int LD>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          long long rs, int r0, int n) {
  for (int idx = threadIdx.x; idx < ROWS * D; idx += THREADS) {
    const int r = idx / D, c = idx % D;
    const int row = r0 + r;
    dst[r * LD + c] = row < n ? src[(long long)row * rs + c] : 0.f;
  }
}

__device__ __forceinline__ bool visible(int qpos, int kpos, int Sq, int Sk,
                                        int causal, int window) {
  return qpos < Sq && kpos < Sk && (!causal || kpos <= qpos) &&
         (window <= 0 || qpos - kpos < window);
}

// s[i][j] = q[4ty+i] . k[tx+16j] and dp[i][j] = do[4ty+i] . v[tx+16j]
// over the tiles in shared memory.
template <int D>
__device__ __forceinline__ void score_tiles(const float* sq, const float* sdo,
                                            const float* sk, const float* sv,
                                            float (&s)[4][Tile<D>::JK],
                                            float (&dp)[4][Tile<D>::JK]) {
  constexpr int JK = Tile<D>::JK, LD = Tile<D>::LD;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < JK; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    float4 qv[4], dov[4], kv[JK], vv[JK];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qv[i] = *reinterpret_cast<const float4*>(&sq[(4 * ty + i) * LD + d]);
      dov[i] = *reinterpret_cast<const float4*>(&sdo[(4 * ty + i) * LD + d]);
    }
#pragma unroll
    for (int j = 0; j < JK; ++j) {
      kv[j] = *reinterpret_cast<const float4*>(&sk[(tx + 16 * j) * LD + d]);
      vv[j] = *reinterpret_cast<const float4*>(&sv[(tx + 16 * j) * LD + d]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < JK; ++j) {
        s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
        s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
        s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
        s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        dp[i][j] = fmaf(dov[i].x, vv[j].x, dp[i][j]);
        dp[i][j] = fmaf(dov[i].y, vv[j].y, dp[i][j]);
        dp[i][j] = fmaf(dov[i].z, vv[j].z, dp[i][j]);
        dp[i][j] = fmaf(dov[i].w, vv[j].w, dp[i][j]);
      }
  }
}

// Kernel 1: delta[row] = sum_d do[row, d] o[row, d], one warp a row of
// the (B, H, S_q) rows.
__global__ void __launch_bounds__(THREADS)
bwd_delta_kernel(const float* __restrict__ o, const float* __restrict__ dout,
                 float* __restrict__ delta, int H, int Sq, int D,
                 long long n_rows, Strides os, Strides ds) {
  const long long row = (long long)blockIdx.x * (THREADS / 32) +
                        threadIdx.x / 32;
  if (row >= n_rows) return;
  const int lane = threadIdx.x % 32;
  const long long b = row / ((long long)H * Sq);
  const int h = (int)((row / Sq) % H), i = (int)(row % Sq);
  const float* orow = o + b * os.b + h * os.h + (long long)i * os.s;
  const float* drow = dout + b * ds.b + h * ds.h + (long long)i * ds.s;
  float acc = 0.f;
  for (int c = lane; c < D; c += 32)
    acc = fmaf(orow[c], drow[c], acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

// Kernel 2: dq for 64 query rows of one (b, h).
template <int D>
__global__ void __launch_bounds__(THREADS)
bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              float* __restrict__ dq, int H, int group, int Sq, int Sk,
              float scale, int causal, int window, Strides qs, Strides ks,
              Strides vs, Strides dos, Strides dqs) {
  using C = Tile<D>;
  constexpr int BK = C::BK, JK = C::JK, NC = C::NC, LD = C::LD,
                LDP = C::LDP;
  extern __shared__ float4 smem4[];
  float* sq = reinterpret_cast<float*>(smem4);  // BQ x LD
  float* sdo = sq + BQ * LD;                    // BQ x LD
  float* sk = sdo + BQ * LD;                    // BK x LD
  float* sv = sk + BK * LD;                     // BK x LD
  float* sds = sv + BK * LD;                    // BQ x LDP

  const int n_qt = gridDim.x;
  const int qt = causal ? n_qt - 1 - blockIdx.x : blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / group;
  const int q0 = qt * BQ;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  load_rows<BQ, D, LD>(sq, q + b * qs.b + h * qs.h, qs.s, q0, Sq);
  load_rows<BQ, D, LD>(sdo, dout + b * dos.b + h * dos.h, dos.s, q0, Sq);
  const long long row0 = ((long long)b * H + h) * Sq;
  float lse_r[4], dl_r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + 4 * ty + i;
    lse_r[i] = qpos < Sq ? lse[row0 + qpos] : 0.f;
    dl_r[i] = qpos < Sq ? delta[row0 + qpos] : 0.f;
  }
  const float* kb = k + b * ks.b + hk * ks.h;
  const float* vb = v + b * vs.b + hk * vs.h;

  float acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;

  const int n_kt_all = (Sk + BK - 1) / BK;
  const int n_kt = causal ? min(n_kt_all, (q0 + BQ - 1) / BK + 1) : n_kt_all;
  const int kt_lo = window > 0 ? max(0, q0 - window + 1) / BK : 0;
  for (int kt = kt_lo; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's reads are done
    load_rows<BK, D, LD>(sk, kb, ks.s, k0, Sk);
    load_rows<BK, D, LD>(sv, vb, vs.s, k0, Sk);
    __syncthreads();
    float s[4][JK], dp[4][JK];
    score_tiles<D>(sq, sdo, sk, sv, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + 4 * ty + i;
#pragma unroll
      for (int j = 0; j < JK; ++j) {
        const int kpos = k0 + tx + 16 * j;
        const float p = visible(qpos, kpos, Sq, Sk, causal, window)
                            ? expf(fmaf(s[i][j], scale, -lse_r[i]))
                            : 0.f;
        sds[(4 * ty + i) * LDP + tx + 16 * j] = p * (dp[i][j] - dl_r[i]);
      }
    }
    __syncthreads();
    // acc[i][c] += sum_kk dS[4ty+i][kk] k[kk][tx+16c]
#pragma unroll 2
    for (int kk = 0; kk < BK; kk += 4) {
      float4 dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        dsv[i] = *reinterpret_cast<const float4*>(&sds[(4 * ty + i) * LDP +
                                                        kk]);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float k0v = sk[(kk + 0) * LD + tx + 16 * c];
        const float k1v = sk[(kk + 1) * LD + tx + 16 * c];
        const float k2v = sk[(kk + 2) * LD + tx + 16 * c];
        const float k3v = sk[(kk + 3) * LD + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][c] = fmaf(dsv[i].x, k0v, acc[i][c]);
          acc[i][c] = fmaf(dsv[i].y, k1v, acc[i][c]);
          acc[i][c] = fmaf(dsv[i].z, k2v, acc[i][c]);
          acc[i][c] = fmaf(dsv[i].w, k3v, acc[i][c]);
        }
      }
    }
  }

  float* ob = dq + b * dqs.b + h * dqs.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + 4 * ty + i;
    if (qpos >= Sq) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      ob[(long long)qpos * dqs.s + tx + 16 * c] = acc[i][c] * scale;
  }
}

// Kernel 3: dk and dv for one key tile of one (b, kv head), summed over
// the kv head's group of query heads.
template <int D>
__global__ void __launch_bounds__(THREADS)
bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, float* __restrict__ dk,
                float* __restrict__ dv, int H, int group, int Sq, int Sk,
                float scale, int causal, int window, Strides qs, Strides ks,
                Strides vs, Strides dos, Strides dks, Strides dvs) {
  using C = Tile<D>;
  constexpr int BK = C::BK, JK = C::JK, NC = C::NC, LD = C::LD,
                LDP = C::LDP;
  extern __shared__ float4 smem4[];
  float* sq = reinterpret_cast<float*>(smem4);  // BQ x LD
  float* sdo = sq + BQ * LD;                    // BQ x LD
  float* sk = sdo + BQ * LD;                    // BK x LD
  float* sv = sk + BK * LD;                     // BK x LD
  float* sp = sv + BK * LD;                     // BQ x LDP
  float* sds = sp + BQ * LDP;                   // BQ x LDP
  float* slse = sds + BQ * LDP;                 // BQ
  float* sdl = slse + BQ;                       // BQ

  const int kt = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int k0 = kt * BK;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  load_rows<BK, D, LD>(sk, k + b * ks.b + hk * ks.h, ks.s, k0, Sk);
  load_rows<BK, D, LD>(sv, v + b * vs.b + hk * vs.h, vs.s, k0, Sk);

  float dk_acc[JK][NC], dv_acc[JK][NC];
#pragma unroll
  for (int r = 0; r < JK; ++r)
#pragma unroll
    for (int c = 0; c < NC; ++c) dk_acc[r][c] = dv_acc[r][c] = 0.f;

  // the query tiles that see a key of [k0, k0 + BK): from the diagonal
  // (causal) to the window's end past the tile's last key
  const int qt_lo = causal ? k0 / BQ : 0;
  const int q_end = window > 0 ? min(Sq, k0 + BK - 1 + window) : Sq;
  const int qt_hi = (q_end + BQ - 1) / BQ;
  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    const long long row0 = ((long long)b * H + h) * Sq;
    const float* qb = q + b * qs.b + h * qs.h;
    const float* db = dout + b * dos.b + h * dos.h;
    for (int qt = qt_lo; qt < qt_hi; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();  // the previous tile's reads are done
      load_rows<BQ, D, LD>(sq, qb, qs.s, q0, Sq);
      load_rows<BQ, D, LD>(sdo, db, dos.s, q0, Sq);
      for (int r = threadIdx.x; r < BQ; r += THREADS) {
        slse[r] = q0 + r < Sq ? lse[row0 + q0 + r] : 0.f;
        sdl[r] = q0 + r < Sq ? delta[row0 + q0 + r] : 0.f;
      }
      __syncthreads();
      float s[4][JK], dp[4][JK];
      score_tiles<D>(sq, sdo, sk, sv, s, dp);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qpos = q0 + 4 * ty + i;
#pragma unroll
        for (int j = 0; j < JK; ++j) {
          const int kpos = k0 + tx + 16 * j;
          const float p = visible(qpos, kpos, Sq, Sk, causal, window)
                              ? expf(fmaf(s[i][j], scale,
                                          -slse[4 * ty + i]))
                              : 0.f;
          sp[(4 * ty + i) * LDP + tx + 16 * j] = p;
          sds[(4 * ty + i) * LDP + tx + 16 * j] =
              p * (dp[i][j] - sdl[4 * ty + i]);
        }
      }
      __syncthreads();
      // dv[key][c] += sum_i P[i][key] do[i][c]; dk[key][c] += dS[i][key]
      // q[i][c], key = ty + 16r, c = tx + 16c'
#pragma unroll 4
      for (int i = 0; i < BQ; ++i) {
        float pv[JK], dsv[JK];
#pragma unroll
        for (int r = 0; r < JK; ++r) {
          pv[r] = sp[i * LDP + ty + 16 * r];
          dsv[r] = sds[i * LDP + ty + 16 * r];
        }
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float dov = sdo[i * LD + tx + 16 * c];
          const float qv = sq[i * LD + tx + 16 * c];
#pragma unroll
          for (int r = 0; r < JK; ++r) {
            dv_acc[r][c] = fmaf(pv[r], dov, dv_acc[r][c]);
            dk_acc[r][c] = fmaf(dsv[r], qv, dk_acc[r][c]);
          }
        }
      }
    }
  }

  float* kout = dk + b * dks.b + hk * dks.h;
  float* vout = dv + b * dvs.b + hk * dvs.h;
#pragma unroll
  for (int r = 0; r < JK; ++r) {
    const int kpos = k0 + ty + 16 * r;
    if (kpos >= Sk) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      kout[(long long)kpos * dks.s + tx + 16 * c] = dk_acc[r][c] * scale;
      vout[(long long)kpos * dvs.s + tx + 16 * c] = dv_acc[r][c];
    }
  }
}

template <typename K>
int set_smem(K kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* delta, void* dq,
           void* dk, void* dv, int B, int H, int H_kv, int Sq, int Sk,
           int causal, int window, float scale, const long long* st,
           cudaStream_t stream) {
  using C = Tile<D>;
  constexpr size_t dq_smem =
      sizeof(float) * ((size_t)(2 * BQ + 2 * C::BK) * C::LD + BQ * C::LDP);
  constexpr size_t dkdv_smem =
      sizeof(float) * ((size_t)(2 * BQ + 2 * C::BK) * C::LD +
                       2 * BQ * C::LDP + 2 * BQ);
  static bool attr_set = false;  // once per instantiation and process
  if (!attr_set) {
    int e = set_smem(bwd_dq_kernel<D>, dq_smem);
    if (e == 0) e = set_smem(bwd_dkdv_kernel<D>, dkdv_smem);
    if (e != 0) return e;
    attr_set = true;
  }
  auto S = [&](int t) { return Strides{st[3 * t], st[3 * t + 1], st[3 * t + 2]}; };
  // tensors: q 0, k 1, v 2, o 3, dout 4, dq 5, dk 6, dv 7
  const float* tq = static_cast<const float*>(q);
  const float* tk = static_cast<const float*>(k);
  const float* tv = static_cast<const float*>(v);
  const float* tdo = static_cast<const float*>(dout);
  const long long n_rows = (long long)B * H * Sq;
  bwd_delta_kernel<<<(unsigned)((n_rows + 7) / 8), THREADS, 0, stream>>>(
      static_cast<const float*>(o), tdo, delta, H, Sq, D, n_rows, S(3), S(4));
  int e = (int)cudaGetLastError();
  if (e != 0) return e;
  const dim3 gq((Sq + BQ - 1) / BQ, H, B);
  bwd_dq_kernel<D><<<gq, THREADS, dq_smem, stream>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<float*>(dq), H, H / H_kv, Sq, Sk,
      scale, causal, window, S(0), S(1), S(2), S(4), S(5));
  e = (int)cudaGetLastError();
  if (e != 0) return e;
  const dim3 gk((Sk + C::BK - 1) / C::BK, H_kv, B);
  bwd_dkdv_kernel<D><<<gk, THREADS, dkdv_smem, stream>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<float*>(dk),
      static_cast<float*>(dv),
      H, H / H_kv, Sq, Sk, scale, causal, window, S(0), S(1), S(2), S(4),
      S(6), S(7));
  return (int)cudaGetLastError();
}


// ---------------------------------------------------------------------------
// bfloat16: wgmma fed by the copy engine
// ---------------------------------------------------------------------------

#include "mma_bf16.cuh"
#include "tma.cuh"
#include "wgmma.cuh"

constexpr float LOG2E = 1.4426950408889634f;
constexpr int WG_THREADS = 384;  // a producer warpgroup, two consumers
constexpr int DQ_ROWS = 128;     // query rows of a dq block, 64 a consumer
constexpr int PAD_ROWS = 128;    // lse2 and delta rows are padded to this

// Keys of a dk/dv block (d = 64, 128: 64 a consumer; d = 256: the same
// 64 for both consumers, which split the products) and of a dq tile.
template <int D>
struct WgTiles {
  static constexpr int KV = D == 256 ? 64 : 128;
  static constexpr int DQK = D == 256 ? 32 : 64;
};
// registers a producer / consumer thread after setmaxnreg: the whole
// file, 128 x 24 + 256 x 240 = 384 x 168
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;
constexpr int ROW_B = 128;       // bytes of a swizzled row: 64 bf16

// The tensor maps of q, do, k and v, each a (B, H, S, d) view described
// as dims (d, S, H, B), read in swizzled boxes of (64, rows, 1, 1).
struct BwdMaps {
  CUtensorMap q, dout, k, v;
};

struct BwdArgs {
  const float* lse2;   // (B, H, S_pad): the forward's lse x log2(e), +inf
                       // past S_q (so P = 0 there)
  const float* delta;  // (B, H, S_pad): rowsum(do o), 0 past S_q
  const int4* walks;   // the plan's walk table: WALK_INTS ints a block
  int B, H, group, Sq, Sk, S_pad, causal, window, n_split;
  int n_gsplit;        // splits of a group's heads over dk/dv blocks
  float scale;
};

// A block's walk (kernels/flash_attention.py:BwdPlan.walks), one record
// a key block (dk/dv) and a (split, query tile) (dq): three int4s, the
// block's tiles [y, z) (x and w unused), then for consumer 0 and 1
// (vis_lo, full_lo, full_hi, vis_hi): it computes tiles [vis_lo, vis_hi)
// of the walk and masks those outside [full_lo, full_hi).
constexpr int WALK_INTS = 12;

// What consumer span does with tile t: -1 skip it (no pair visible), 1
// mask it, 0 compute it whole.
__device__ __forceinline__ int tile_kind(const int4& span, int t) {
  if (t < span.x || t >= span.w) return -1;
  return t < span.y || t >= span.z ? 1 : 0;
}

// Programmatic dependent launch: the main kernel and the merge are
// launched while their predecessor in the stream still runs (their
// launch and prologue overlap its tail); grid_wait() holds a thread until
// the predecessor has finished and its writes are visible, and
// let_dependents_start() lets the next such launch begin.
__device__ __forceinline__ void grid_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}
__device__ __forceinline__ void let_dependents_start() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// Key j is visible to query i (both inside the tensors).
__device__ __forceinline__ bool sees(int i, int j, int causal, int window) {
  return (!causal || j <= i) && (window <= 0 || i - j < window);
}

// Kernel 1: lse2 and delta for each of the (B, H, S_pad) rows, D / 8
// threads a row (16-byte loads of o and do): rows past S_q get lse2 =
// +inf and delta = 0.
template <int D>
__global__ void __launch_bounds__(256)
bwd_delta_lse_kernel(const __nv_bfloat16* __restrict__ o,
                     const __nv_bfloat16* __restrict__ dout,
                     const float* __restrict__ lse, float* __restrict__ lse2,
                     float* __restrict__ delta, int H, int Sq, int S_pad,
                     long long n_rows, Strides os, Strides ds) {
  constexpr int TPR = D / 8, RPB = 256 / TPR;  // threads a row, rows a block
  let_dependents_start();
  const long long row = (long long)blockIdx.x * RPB + threadIdx.x / TPR;
  const int part = threadIdx.x % TPR;
  const long long bh = row / S_pad;
  const int i = (int)(row % S_pad);
  const bool real = row < n_rows && i < Sq;
  float acc = 0.f;
  if (real) {
    const long long b = bh / H;
    const int h = (int)(bh % H);
    const uint4 x = *reinterpret_cast<const uint4*>(
        o + b * os.b + h * os.h + (long long)i * os.s + 8 * part);
    const uint4 y = *reinterpret_cast<const uint4*>(
        dout + b * ds.b + h * ds.h + (long long)i * ds.s + 8 * part);
    const uint32_t xs[4] = {x.x, x.y, x.z, x.w}, ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 u = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&xs[e]));
      const float2 w = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&ys[e]));
      acc = fmaf(u.x, w.x, fmaf(u.y, w.y, acc));
    }
  }
#pragma unroll
  for (int off = TPR / 2; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (row < n_rows && part == 0) {
    delta[row] = acc;
    lse2[row] = real ? lse[bh * Sq + i] * LOG2E : __int_as_float(0x7f800000);
  }
}

// The dk/dv block's shared memory: the K and V tiles (128 keys), then a
// ring of NS stages of q and do tiles (BQ rows), then the stages' lse2
// and delta, then the barriers.  Every tile is 1024-byte aligned.
// At d = 256 a float32 P^T tile (64 keys x BQ queries) follows the ring:
// one consumer writes it, the other reads it.
template <int D, int BQ>
struct KvSmem {
  static constexpr int NCB = D / 64;  // 64-column boxes of a row
  static constexpr int KEYS = WgTiles<D>::KV;
  static constexpr int NS = D == 64 ? 3 : 2;
  static constexpr int KT_B = NCB * KEYS * ROW_B;  // K (or V) tile
  static constexpr int Q_B = NCB * BQ * ROW_B;     // q (or do) tile
  static constexpr int K = 0, V = KT_B, RING = 2 * KT_B;
  static constexpr int PT = RING + NS * 2 * Q_B;
  static constexpr int LSE = PT + (D == 256 ? KEYS * BQ * 4 : 0);
  static constexpr int DL = LSE + NS * BQ * 4;
  static constexpr int BAR = DL + NS * BQ * 4;
  // K/V full, the ring's full and empty, (d = 256) P^T full and empty
  static constexpr int N_BAR = 1 + 2 * NS + (D == 256 ? 2 : 0);
  static constexpr int BYTES = BAR + 8 * N_BAR + 1024;  // + align
  static_assert(Q_B % 1024 == 0 && BQ % 16 == 0, "aligned tiles");
};

// Shared memory from a 1024-byte aligned address (the swizzle's atoms).
__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  return raw + ((1024 - (smem_addr(raw) & 1023)) & 1023);
}

__device__ __forceinline__ void store_bf16x2(__nv_bfloat16* p, float x,
                                             float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// The dk/dv role's producer, run by one thread: K and V of keys k0..
// (KvSmem::KEYS of them) of (b, kv head hk), then, through the NS-stage
// ring, the q, do, lse2 and delta tiles of query tiles [qt_lo, qt_hi) of
// each of the group's heads g_lo .. g_hi - 1 in turn.
template <int D, int BQ>
__device__ __forceinline__ void kv_producer(unsigned char* smem,
                                            const BwdArgs& a,
                                            const BwdMaps& maps, int b,
                                            int hk, int k0, int g_lo,
                                            int g_hi, int qt_lo, int qt_hi) {
  using L = KvSmem<D, BQ>;
  constexpr int NCB = L::NCB, NS = L::NS;
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + L::BAR);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + NS;
  mbar_expect(kv_full, 2 * L::KT_B);
  for (int cb = 0; cb < NCB; ++cb) {
    tma_load(smem + L::K + cb * L::KEYS * ROW_B, &maps.k, 64 * cb, k0, hk,
             b, kv_full);
    tma_load(smem + L::V + cb * L::KEYS * ROW_B, &maps.v, 64 * cb, k0, hk,
             b, kv_full);
  }
  grid_wait();  // lse2 and delta are the previous launch's
  int it = 0;
  for (int gi = g_lo; gi < g_hi; ++gi) {
    const int h = hk * a.group + gi;
    const long long r0 = ((long long)b * a.H + h) * a.S_pad;
    for (int qt = qt_lo; qt < qt_hi; ++qt, ++it) {
      const int s = it % NS, r = it / NS;
      if (r > 0) mbar_wait_or_trap(empty + s, (r - 1) & 1);
      unsigned char* st = smem + L::RING + s * 2 * L::Q_B;
      mbar_expect(full + s, 2 * L::Q_B + 2 * BQ * 4);
      for (int cb = 0; cb < NCB; ++cb) {
        tma_load(st + cb * BQ * ROW_B, &maps.q, 64 * cb, qt * BQ, h, b,
                 full + s);
        tma_load(st + L::Q_B + cb * BQ * ROW_B, &maps.dout, 64 * cb,
                 qt * BQ, h, b, full + s);
      }
      bulk_load(smem + L::LSE + s * BQ * 4, a.lse2 + r0 + qt * BQ, BQ * 4,
                full + s);
      bulk_load(smem + L::DL + s * BQ * 4, a.delta + r0 + qt * BQ, BQ * 4,
                full + s);
    }
  }
}

// The dk/dv role: dk and dv for 128 keys (block by) of one (b, kv head)
// (block bx), summed over the kv head's group.  Warpgroup 0 is the
// producer: one thread (kv_producer) keeps the copy engine's loads of the
// q, do, lse2 and delta tiles of every (group head, query tile) in turn
// in flight in an NS-stage ring.
// Warpgroup 1 + c (c < 2) owns keys k0 + 64 c .. + 63 and, for each
// tile: S^T = K Q^T and dP^T = V dO^T (both operands in shared memory),
// P^T = exp2(S^T scale log2(e) - lse2) and dS^T = P^T (dP^T - delta) in
// registers (masked only on tiles that cross the diagonal or the
// window's edge), then dV += P^T dO and dK += dS^T Q (A from registers).
template <int D, int BQ>
__device__ __forceinline__ void dkdv_block(
    unsigned char* smem, __nv_bfloat16* __restrict__ dk,
    __nv_bfloat16* __restrict__ dv, const BwdArgs& a, const Strides& dks,
    const Strides& dvs, const BwdMaps& maps, int bx, int by) {
  using L = KvSmem<D, BQ>;
  constexpr int NCB = L::NCB, NS = L::NS, NT = BQ / 8;
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + L::BAR);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + NS;

  const int H_kv = a.H / a.group;
  const int hk = bx % H_kv, b = bx / H_kv;
  const int k0 = by * L::KEYS;
  const int n_cons = a.Sk - k0 > 64 ? 2 : 1;  // consumers with keys
  // the query tiles that see a key of the block
  const int4 walk = a.walks[by * (WALK_INTS / 4)];
  const int qt_lo = walk.y, qt_hi = walk.z;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < NS; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 128 * n_cons);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // warp-uniform to the compiler (a shuffle), so that the roles' branches
  // do not serialise the products
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  if (wg == 0) {
    // ====== producer ======
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0)
      kv_producer<D, BQ>(smem, a, maps, b, hk, k0, 0, a.group, qt_lo, qt_hi);
    return;
  }

  // ====== consumers ======
  setmaxnreg_inc<CONSUMER_REGS>();
  const int c = wg - 1;
  if (c >= n_cons) return;  // no keys here (the barrier does not count it)
  const int t = threadIdx.x % 128, wq = t / 32, lane = t % 32;
  const int g = lane / 4, tq = lane % 4;
  const int kw = k0 + 64 * c;  // the consumer's first key
  const int4 span = a.walks[by * (WALK_INTS / 4) + 1 + c];
  const int key_a = kw + 16 * wq + g, key_b = key_a + 8;
  const float sl2 = a.scale * LOG2E;
  const unsigned char* sk = smem + L::K + c * 64 * ROW_B;
  const unsigned char* sv = smem + L::V + c * 64 * ROW_B;

  float dk_acc[NCB][32], dv_acc[NCB][32];
#pragma unroll
  for (int cb = 0; cb < NCB; ++cb)
#pragma unroll
    for (int i = 0; i < 32; ++i) dk_acc[cb][i] = dv_acc[cb][i] = 0.f;

  mbar_wait_or_trap(kv_full, 0);
  __syncwarp();
  int it = 0;
  for (int gi = 0; gi < a.group; ++gi) {
    for (int qt = qt_lo; qt < qt_hi; ++qt, ++it) {
      const int s = it % NS, r = it / NS;
      mbar_wait_or_trap(full + s, r & 1);
      __syncwarp();
      const int q0 = qt * BQ;
      const int kind = tile_kind(span, qt);
      if (kind < 0) {  // no pair of its keys and the tile's queries is visible
        mbar_arrive(empty + s);
        continue;
      }
      const bool masked = kind > 0;  // the diagonal or the window's edge
      const unsigned char* sq = smem + L::RING + s * 2 * L::Q_B;
      const unsigned char* sdo = sq + L::Q_B;
      const float* slse =
          reinterpret_cast<const float*>(smem + L::LSE + s * BQ * 4);
      const float* sdl =
          reinterpret_cast<const float*>(smem + L::DL + s * BQ * 4);
      float st[BQ / 2], dpt[BQ / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<BQ>(st,
                     sw128_desc(sk + (kk / 4) * L::KEYS * ROW_B +
                                (kk % 4) * 32),
                     sw128_desc(sq + (kk / 4) * BQ * ROW_B + (kk % 4) * 32),
                     kk);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<BQ>(dpt,
                     sw128_desc(sv + (kk / 4) * L::KEYS * ROW_B +
                                (kk % 4) * 32),
                     sw128_desc(sdo + (kk / 4) * BQ * ROW_B + (kk % 4) * 32),
                     kk);
      wgmma_commit();
      wgmma_wait<1>();  // S^T is done, dP^T may still run
      reg_fence(st);
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = 8 * j + 2 * tq + (e & 1);
          float p = ex2(fmaf(st[4 * j + e], sl2, -slse[qi]));
          if (masked && !sees(q0 + qi, e < 2 ? key_a : key_b, a.causal,
                              a.window))
            p = 0.f;
          st[4 * j + e] = p;  // P^T
        }
      wgmma_wait<0>();
      reg_fence(dpt);
      uint32_t pa[BQ / 16][4], da[BQ / 16][4];  // P^T, dS^T as A operands
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int i0 = 8 * kk + 2 * x, qi = 8 * (i0 / 4) + 2 * tq;
          pa[kk][x] = pack_bf16(st[i0], st[i0 + 1]);
          da[kk][x] = pack_bf16(st[i0] * (dpt[i0] - sdl[qi]),
                                st[i0 + 1] * (dpt[i0 + 1] - sdl[qi + 1]));
        }
      wgmma_fence();
#pragma unroll
      for (int cb = 0; cb < NCB; ++cb)
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk)
          wgmma_rs_64(dv_acc[cb], pa[kk],
                      sw128_desc(sdo + cb * BQ * ROW_B + kk * 16 * ROW_B));
#pragma unroll
      for (int cb = 0; cb < NCB; ++cb)
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk)
          wgmma_rs_64(dk_acc[cb], da[kk],
                      sw128_desc(sq + cb * BQ * ROW_B + kk * 16 * ROW_B));
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int cb = 0; cb < NCB; ++cb) {
        reg_fence(dv_acc[cb]);
        reg_fence(dk_acc[cb]);
      }
      mbar_arrive(empty + s);
    }
  }

  __nv_bfloat16* kout = dk + b * dks.b + hk * dks.h;
  __nv_bfloat16* vout = dv + b * dvs.b + hk * dvs.h;
#pragma unroll
  for (int cb = 0; cb < NCB; ++cb)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 64 * cb + 8 * j + 2 * tq, i = 4 * j;
      if (key_a < a.Sk) {
        store_bf16x2(kout + (long long)key_a * dks.s + col,
                     dk_acc[cb][i] * a.scale, dk_acc[cb][i + 1] * a.scale);
        store_bf16x2(vout + (long long)key_a * dvs.s + col, dv_acc[cb][i],
                     dv_acc[cb][i + 1]);
      }
      if (key_b < a.Sk) {
        store_bf16x2(kout + (long long)key_b * dks.s + col,
                     dk_acc[cb][i + 2] * a.scale, dk_acc[cb][i + 3] * a.scale);
        store_bf16x2(vout + (long long)key_b * dvs.s + col,
                     dv_acc[cb][i + 2], dv_acc[cb][i + 3]);
      }
    }
}

// The dk/dv role at d = 256: dk and dv for 64 keys (block by) of one
// (b, kv head) and one share of the kv head's group (block bx: split gs
// of n_gsplit takes heads [gs group / n_gsplit, (gs + 1) group /
// n_gsplit)).  The producer is dkdv_block's (kv_producer), over the
// share's heads.  The two consumers take the same 64 keys and split the
// products, so that each holds one 64 x 256 float32 accumulator (128
// registers a thread, where one consumer with both would need 256):
// consumer 0 computes S^T = K Q^T, P^T (masked on edge tiles) and dV +=
// P^T dO, and hands P^T in float32 through shared memory; consumer 1
// computes dP^T = V dO^T, reads P^T, forms dS^T = P^T
// (dP^T - delta) and dK += dS^T Q.  With one split dk and dv are written
// in bf16; with more, each split writes float32 partials to part
// ((2, n_gsplit, B, H_kv, S_k, D): dk's, then dv's) and the merge launch
// sums them in split order.
template <int BQ>
__device__ __forceinline__ void dkdv_block_256(
    unsigned char* smem, __nv_bfloat16* __restrict__ dk,
    __nv_bfloat16* __restrict__ dv, float* __restrict__ part,
    const BwdArgs& a, const Strides& dks, const Strides& dvs,
    const BwdMaps& maps, int bx, int by) {
  constexpr int D = 256;
  using L = KvSmem<D, BQ>;
  constexpr int NCB = L::NCB, NS = L::NS, NT = BQ / 8;
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + L::BAR);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + NS;
  // the P^T tile: written by consumer 0 (p_full), read by consumer 1
  // (p_empty); phase n is the n-th tile the consumers compute
  uint64_t* p_full = empty + NS;
  uint64_t* p_empty = p_full + 1;

  const int H_kv = a.H / a.group;
  const int hk = bx % H_kv, b = (bx / H_kv) % a.B, gs = bx / (H_kv * a.B);
  const int g_lo = gs * a.group / a.n_gsplit;
  const int g_hi = (gs + 1) * a.group / a.n_gsplit;
  const int k0 = by * L::KEYS;
  const int4 walk = a.walks[by * (WALK_INTS / 4)];
  const int qt_lo = walk.y, qt_hi = walk.z;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < NS; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 256);
    }
    mbar_init(p_full, 128);
    mbar_init(p_empty, 128);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  if (wg == 0) {
    // ====== producer ======
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0)
      kv_producer<D, BQ>(smem, a, maps, b, hk, k0, g_lo, g_hi, qt_lo, qt_hi);
    return;
  }

  // ====== consumers ======
  setmaxnreg_inc<CONSUMER_REGS>();
  const int c = wg - 1;  // 0: S^T, P^T, dV; 1: dP^T, dS^T, dK
  const int t = threadIdx.x % 128, wq = t / 32, lane = t % 32;
  const int g = lane / 4, tq = lane % 4;
  const int4 span = a.walks[by * (WALK_INTS / 4) + 1];  // both consumers'
  const int key_a = k0 + 16 * wq + g, key_b = key_a + 8;
  const float sl2 = a.scale * LOG2E;
  // P^T: element 4 j + e of thread t at float4 j * 128 + t
  float4* spt = reinterpret_cast<float4*>(smem + L::PT);

  float acc[NCB][32];  // dV (consumer 0) or dK (consumer 1)
#pragma unroll
  for (int cb = 0; cb < NCB; ++cb)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[cb][i] = 0.f;

  mbar_wait_or_trap(kv_full, 0);
  __syncwarp();
  int it = 0, n = 0;  // n: the tiles computed so far
  for (int gi = g_lo; gi < g_hi; ++gi) {
    for (int qt = qt_lo; qt < qt_hi; ++qt, ++it) {
      const int s = it % NS, r = it / NS;
      mbar_wait_or_trap(full + s, r & 1);
      __syncwarp();
      const int kind = tile_kind(span, qt);
      if (kind < 0) {  // no pair of the keys and the tile's queries is visible
        mbar_arrive(empty + s);
        continue;
      }
      const unsigned char* sq = smem + L::RING + s * 2 * L::Q_B;
      const unsigned char* sdo = sq + L::Q_B;
      float st[BQ / 2];
      if (c == 0) {
        const bool masked = kind > 0;  // the diagonal or the window's edge
        const int q0 = qt * BQ;
        const float* slse =
            reinterpret_cast<const float*>(smem + L::LSE + s * BQ * 4);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss<BQ>(st,
                       sw128_desc(smem + L::K + (kk / 4) * L::KEYS * ROW_B +
                                  (kk % 4) * 32),
                       sw128_desc(sq + (kk / 4) * BQ * ROW_B + (kk % 4) * 32),
                       kk);
        wgmma_commit();
        wgmma_wait<0>();
        reg_fence(st);
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qi = 8 * j + 2 * tq + (e & 1);
            float p = ex2(fmaf(st[4 * j + e], sl2, -slse[qi]));
            if (masked && !sees(q0 + qi, e < 2 ? key_a : key_b, a.causal,
                                a.window))
              p = 0.f;
            st[4 * j + e] = p;  // P^T
          }
        uint32_t pa[BQ / 16][4];  // P^T as A operands
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
          for (int x = 0; x < 4; ++x)
            pa[kk][x] = pack_bf16(st[8 * kk + 2 * x], st[8 * kk + 2 * x + 1]);
        // consumer 1 has read the last tile's P^T
        if (n > 0) mbar_wait_or_trap(p_empty, (n - 1) & 1);
#pragma unroll
        for (int j = 0; j < NT; ++j)
          spt[j * 128 + t] = make_float4(st[4 * j], st[4 * j + 1],
                                         st[4 * j + 2], st[4 * j + 3]);
        mbar_arrive(p_full);
        wgmma_fence();
#pragma unroll
        for (int cb = 0; cb < NCB; ++cb)
#pragma unroll
          for (int kk = 0; kk < BQ / 16; ++kk)
            wgmma_rs_64(acc[cb], pa[kk],
                        sw128_desc(sdo + cb * BQ * ROW_B + kk * 16 * ROW_B));
      } else {
        const float* sdl =
            reinterpret_cast<const float*>(smem + L::DL + s * BQ * 4);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss<BQ>(st,
                       sw128_desc(smem + L::V + (kk / 4) * L::KEYS * ROW_B +
                                  (kk % 4) * 32),
                       sw128_desc(sdo + (kk / 4) * BQ * ROW_B + (kk % 4) * 32),
                       kk);
        wgmma_commit();
        wgmma_wait<0>();
        reg_fence(st);  // dP^T
        mbar_wait_or_trap(p_full, n & 1);  // consumer 0 wrote this P^T
        uint32_t da[BQ / 16][4];  // dS^T as A operands
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk) {
          const float4 p0 = spt[(2 * kk) * 128 + t];
          const float4 p1 = spt[(2 * kk + 1) * 128 + t];
          const float pv[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            const int i0 = 8 * kk + 2 * x, qi = 8 * (i0 / 4) + 2 * tq;
            da[kk][x] = pack_bf16(pv[2 * x] * (st[i0] - sdl[qi]),
                                  pv[2 * x + 1] * (st[i0 + 1] - sdl[qi + 1]));
          }
        }
        mbar_arrive(p_empty);
        wgmma_fence();
#pragma unroll
        for (int cb = 0; cb < NCB; ++cb)
#pragma unroll
          for (int kk = 0; kk < BQ / 16; ++kk)
            wgmma_rs_64(acc[cb], da[kk],
                        sw128_desc(sq + cb * BQ * ROW_B + kk * 16 * ROW_B));
      }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int cb = 0; cb < NCB; ++cb) reg_fence(acc[cb]);
      mbar_arrive(empty + s);
      ++n;
    }
  }

  const float mul = c == 0 ? 1.f : a.scale;
  const long long slot = (long long)b * H_kv + hk;
  if (a.n_gsplit == 1) {
    __nv_bfloat16* out = c == 0 ? dv + b * dvs.b + hk * dvs.h
                                : dk + b * dks.b + hk * dks.h;
    const long long rs = c == 0 ? dvs.s : dks.s;
#pragma unroll
    for (int cb = 0; cb < NCB; ++cb)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 64 * cb + 8 * j + 2 * tq, i = 4 * j;
        if (key_a < a.Sk)
          store_bf16x2(out + (long long)key_a * rs + col, acc[cb][i] * mul,
                       acc[cb][i + 1] * mul);
        if (key_b < a.Sk)
          store_bf16x2(out + (long long)key_b * rs + col,
                       acc[cb][i + 2] * mul, acc[cb][i + 3] * mul);
      }
  } else {
    // dk's partials, then dv's: (n_gsplit, B, H_kv, S_k) rows of D floats
    const long long rows = (long long)a.B * H_kv * a.Sk;
    float* pb = part + ((c == 0 ? a.n_gsplit : 0) + gs) * rows * D +
                slot * a.Sk * D;
#pragma unroll
    for (int cb = 0; cb < NCB; ++cb)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 64 * cb + 8 * j + 2 * tq, i = 4 * j;
        if (key_a < a.Sk)
          *reinterpret_cast<float2*>(pb + (long long)key_a * D + col) =
              make_float2(acc[cb][i] * mul, acc[cb][i + 1] * mul);
        if (key_b < a.Sk)
          *reinterpret_cast<float2*>(pb + (long long)key_b * D + col) =
              make_float2(acc[cb][i + 2] * mul, acc[cb][i + 3] * mul);
      }
  }
}

// The dq block's shared memory: its q and do tiles (128 rows), a ring of
// NS stages of K and V tiles (64 keys, 32 at d = 256), the barriers.
template <int D>
struct DqSmem {
  static constexpr int NCB = D / 64;
  static constexpr int NS = D == 128 ? 2 : 3;
  static constexpr int Q_B = NCB * DQ_ROWS * ROW_B;
  static constexpr int KT_B = NCB * WgTiles<D>::DQK * ROW_B;
  static constexpr int Q = 0, DO = Q_B, RING = 2 * Q_B;
  static constexpr int BAR = RING + NS * 2 * KT_B;
  static constexpr int BYTES = BAR + 8 * (1 + 2 * NS) + 1024;
};

// The dq role: dq for 128 query rows (tile y of n_qt, from the last in a
// causal grid) of one (b, h) (block x of n_bh), over the key split z of
// the key tiles (DQK keys) they see: the
// producer keeps K and V tiles in flight in the ring; consumer c owns
// rows q0 + 64 c .. + 63: S = Q K^T and dP = dO V^T, dS = P (dP -
// delta), dQ += dS K.  With one split dq is written in bf16; with more,
// each split writes its float32 partial (scaled) to part[split] and
// kernel 3 sums them in split order.
template <int D>
__device__ __forceinline__ void dq_block(
    unsigned char* smem, __nv_bfloat16* __restrict__ dq,
    float* __restrict__ part, const BwdArgs& a, const Strides& dqs,
    const BwdMaps& maps, int x, int y, int split, int n_qt, int n_bh,
    int n_kb) {
  using L = DqSmem<D>;
  constexpr int NCB = L::NCB, NS = L::NS, DQK = WgTiles<D>::DQK;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::BAR);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + NS;

  const int h = x % a.H, b = x / a.H;
  const int hk = h / a.group;
  const int qt = a.causal ? n_qt - 1 - y : y;  // the longest walks first
  const int q0 = qt * DQ_ROWS;
  const int n_cons = a.Sq - q0 > 64 ? 2 : 1;  // consumers with rows
  // this split's share of the key tiles the rows see
  const int4* rec = a.walks + (n_kb + split * n_qt + qt) * (WALK_INTS / 4);
  const int4 walk = rec[0];
  const int s_lo = walk.y, s_hi = walk.z;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < NS; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 128 * n_cons);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // warp-uniform to the compiler (a shuffle), so that the roles' branches
  // do not serialise the products
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  if (wg == 0) {
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x != 0) return;
    mbar_expect(q_full, 2 * L::Q_B);
    for (int cb = 0; cb < NCB; ++cb) {
      tma_load(smem + L::Q + cb * DQ_ROWS * ROW_B, &maps.q, 64 * cb, q0, h,
               b, q_full);
      tma_load(smem + L::DO + cb * DQ_ROWS * ROW_B, &maps.dout, 64 * cb, q0,
               h, b, q_full);
    }
    for (int kt = s_lo; kt < s_hi; ++kt) {
      const int it = kt - s_lo, s = it % NS, r = it / NS;
      if (r > 0) mbar_wait_or_trap(empty + s, (r - 1) & 1);
      unsigned char* st = smem + L::RING + s * 2 * L::KT_B;
      mbar_expect(full + s, 2 * L::KT_B);
      for (int cb = 0; cb < NCB; ++cb) {
        tma_load(st + cb * DQK * ROW_B, &maps.k, 64 * cb, kt * DQK,
                 hk, b, full + s);
        tma_load(st + L::KT_B + cb * DQK * ROW_B, &maps.v, 64 * cb,
                 kt * DQK, hk, b, full + s);
      }
    }
    return;
  }

  setmaxnreg_inc<CONSUMER_REGS>();
  const int c = wg - 1;
  if (c >= n_cons) return;
  const int t = threadIdx.x % 128, wq = t / 32, lane = t % 32;
  const int g = lane / 4, tq = lane % 4;
  const int qw = q0 + 64 * c;  // the consumer's first row
  const int4 span = rec[1 + c];
  const int row_a = qw + 16 * wq + g, row_b = row_a + 8;
  const long long r0 = ((long long)b * a.H + h) * a.S_pad;
  grid_wait();  // lse2 and delta are the previous launch's
  const float lse_a = a.lse2[r0 + row_a], lse_b = a.lse2[r0 + row_b];
  const float dl_a = a.delta[r0 + row_a], dl_b = a.delta[r0 + row_b];
  const float sl2 = a.scale * LOG2E;
  const unsigned char* sq = smem + L::Q + c * 64 * ROW_B;
  const unsigned char* sdo = smem + L::DO + c * 64 * ROW_B;

  float acc[NCB][32];
#pragma unroll
  for (int cb = 0; cb < NCB; ++cb)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[cb][i] = 0.f;

  mbar_wait_or_trap(q_full, 0);
  __syncwarp();
  for (int kt = s_lo; kt < s_hi; ++kt) {
    const int it = kt - s_lo, s = it % NS, r = it / NS;
    mbar_wait_or_trap(full + s, r & 1);
    __syncwarp();
    const int k0 = kt * DQK;
    const int kind = tile_kind(span, kt);
    if (kind < 0) {
      mbar_arrive(empty + s);  // no pair visible
      continue;
    }
    // the diagonal, the window's edge or the last key
    const bool masked = kind > 0;
    const unsigned char* sk = smem + L::RING + s * 2 * L::KT_B;
    const unsigned char* sv = sk + L::KT_B;
    float sc[DQK / 2], dp[DQK / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<DQK>(sc,
                        sw128_desc(sq + (kk / 4) * DQ_ROWS * ROW_B +
                                   (kk % 4) * 32),
                        sw128_desc(sk + (kk / 4) * DQK * ROW_B +
                                   (kk % 4) * 32),
                        kk);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<DQK>(dp,
                        sw128_desc(sdo + (kk / 4) * DQ_ROWS * ROW_B +
                                   (kk % 4) * 32),
                        sw128_desc(sv + (kk / 4) * DQK * ROW_B +
                                   (kk % 4) * 32),
                        kk);
    wgmma_commit();
    wgmma_wait<1>();
    reg_fence(sc);
#pragma unroll
    for (int j = 0; j < DQK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + 8 * j + 2 * tq + (e & 1);
        const int row = e < 2 ? row_a : row_b;
        float p = ex2(fmaf(sc[4 * j + e], sl2, e < 2 ? -lse_a : -lse_b));
        if (masked && !(key < a.Sk && sees(row, key, a.causal, a.window)))
          p = 0.f;
        sc[4 * j + e] = p;
      }
    wgmma_wait<0>();
    reg_fence(dp);
    uint32_t da[DQK / 16][4];  // dS as A operands
#pragma unroll
    for (int kk = 0; kk < DQK / 16; ++kk)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int i0 = 8 * kk + 2 * x;
        const float dl = x % 2 == 0 ? dl_a : dl_b;
        da[kk][x] = pack_bf16(sc[i0] * (dp[i0] - dl),
                              sc[i0 + 1] * (dp[i0 + 1] - dl));
      }
    wgmma_fence();
#pragma unroll
    for (int cb = 0; cb < NCB; ++cb)
#pragma unroll
      for (int kk = 0; kk < DQK / 16; ++kk)
        wgmma_rs_64(acc[cb], da[kk],
                    sw128_desc(sk + cb * DQK * ROW_B + kk * 16 * ROW_B));
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int cb = 0; cb < NCB; ++cb) reg_fence(acc[cb]);
    mbar_arrive(empty + s);
  }

  if (a.n_split == 1) {
    __nv_bfloat16* ob = dq + b * dqs.b + h * dqs.h;
#pragma unroll
    for (int cb = 0; cb < NCB; ++cb)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 64 * cb + 8 * j + 2 * tq, i = 4 * j;
        if (row_a < a.Sq)
          store_bf16x2(ob + (long long)row_a * dqs.s + col,
                       acc[cb][i] * a.scale, acc[cb][i + 1] * a.scale);
        if (row_b < a.Sq)
          store_bf16x2(ob + (long long)row_b * dqs.s + col,
                       acc[cb][i + 2] * a.scale, acc[cb][i + 3] * a.scale);
      }
  } else {
    float* pb = part + (((long long)split * n_bh + x) * a.Sq) *
                           D;  // (split, b, h) rows of D floats
#pragma unroll
    for (int cb = 0; cb < NCB; ++cb)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 64 * cb + 8 * j + 2 * tq, i = 4 * j;
        if (row_a < a.Sq)
          *reinterpret_cast<float2*>(pb + (long long)row_a * D + col) =
              make_float2(acc[cb][i] * a.scale, acc[cb][i + 1] * a.scale);
        if (row_b < a.Sq)
          *reinterpret_cast<float2*>(pb + (long long)row_b * D + col) =
              make_float2(acc[cb][i + 2] * a.scale, acc[cb][i + 3] * a.scale);
      }
  }
}

// Kernel 3: the float32 partials of dq (key splits) and, at d = 256, of
// dk and dv (group splits) summed in split order (the same bits every
// run) and written in bf16; four columns a thread, one job a grid row.
struct MergeJob {
  const float* part;     // (n, rows, D) float32 partials, rows = B H S
  __nv_bfloat16* out;    // (B, H, S, D) with strides st
  int H, S, n;
  long long rows;
  Strides st;
};
struct MergeJobs {
  MergeJob job[3];
};

template <int D>
__global__ void __launch_bounds__(256)
bwd_merge_kernel(const MergeJobs jobs) {
  grid_wait();  // the partials are the previous launch's
  const MergeJob& m = jobs.job[blockIdx.y];
  const long long idx = (long long)blockIdx.x * 256 + threadIdx.x;
  if (idx >= m.rows * (D / 4)) return;
  const long long row = idx / (D / 4);
  const int col = (int)(idx % (D / 4)) * 4;
  float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s = 0; s < m.n; ++s) {
    const float4 x = *reinterpret_cast<const float4*>(
        m.part + ((long long)s * m.rows + row) * D + col);
    sum.x += x.x;
    sum.y += x.y;
    sum.z += x.z;
    sum.w += x.w;
  }
  const long long bh = row / m.S;
  const int i = (int)(row % m.S);
  __nv_bfloat16* p = m.out + (bh / m.H) * m.st.b + (bh % m.H) * m.st.h +
                     (long long)i * m.st.s + col;
  store_bf16x2(p, sum.x, sum.y);
  store_bf16x2(p + 2, sum.z, sum.w);
}

// Kernel 2: the dk/dv blocks (the first n_kv, by key block then (b, kv
// head): the longest causal walks first) and the dq blocks (by (b, h),
// then query tile, then key split) in one launch, so that either fills
// the other's last wave; a block takes the larger of the two roles'
// shared memory.
template <int D, int BQ>
__global__ void __launch_bounds__(WG_THREADS, 1)
bwd_wgmma_kernel(__nv_bfloat16* __restrict__ dq, float* __restrict__ part,
                 __nv_bfloat16* __restrict__ dk,
                 __nv_bfloat16* __restrict__ dv,
                 float* __restrict__ kv_part, BwdArgs a, Strides dqs,
                 Strides dks, Strides dvs, int kv_x, int n_kv, int dq_x,
                 int dq_y, const __grid_constant__ BwdMaps kv_maps,
                 const __grid_constant__ BwdMaps dq_maps) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  let_dependents_start();
  const int i = blockIdx.x;
  if (i < n_kv) {
    if constexpr (D == 256)
      dkdv_block_256<BQ>(smem, dk, dv, kv_part, a, dks, dvs, kv_maps,
                         i % kv_x, i / kv_x);
    else
      dkdv_block<D, BQ>(smem, dk, dv, a, dks, dvs, kv_maps, i % kv_x,
                        i / kv_x);
    return;
  }
  const int j = i - n_kv;
  dq_block<D>(smem, dq, part, a, dqs, dq_maps, j % dq_x, (j / dq_x) % dq_y,
              j / (dq_x * dq_y), dq_y, dq_x, n_kv / kv_x);
}

template <int D, int BQ>
constexpr int bwd_smem() {
  return KvSmem<D, BQ>::BYTES > DqSmem<D>::BYTES ? KvSmem<D, BQ>::BYTES
                                                 : DqSmem<D>::BYTES;
}

// The map of a (B, H, S, D) view with element strides st as dims
// (D, S, H, B), swizzled boxes of (64, rows, 1, 1).
bool bwd_map(CUtensorMap* m, const void* base, int B, int H, int S,
             int D, const Strides& st, int rows) {
  const unsigned long long dims[4] = {(unsigned long long)D,
                                      (unsigned long long)S,
                                      (unsigned long long)H,
                                      (unsigned long long)B};
  const long long strides[4] = {1, st.s, st.h, st.b};
  const unsigned box[4] = {64, (unsigned)rows, 1, 1};
  return encode_map(m, base, true, 4, dims, strides, box, true);
}

// The warp-specialised kernels hand the producer's registers to the
// consumers (setmaxnreg), which needs the whole file the launch bounds
// allow (168 a thread): refuse a build that was given fewer rather than
// launch a kernel whose consumers would wait for registers forever.
template <typename K>
int prepare_wgmma(K kernel, int smem) {
  int e = set_smem(kernel, (size_t)smem);
  if (e != 0) return e;
  cudaFuncAttributes fa;
  e = (int)cudaFuncGetAttributes(&fa, kernel);
  if (e != 0) return e;
  if (fa.numRegs * WG_THREADS < 128 * PRODUCER_REGS + 256 * CONSUMER_REGS)
    return -3;
  return 0;
}

// A launch that may begin while the stream's previous kernel still runs
// (programmatic stream serialisation; the kernel calls grid_wait()
// before it reads that kernel's output).
struct Launch {
  cudaLaunchConfig_t c;
  cudaLaunchAttribute attr[1];
  Launch(unsigned grid, unsigned block, size_t smem, cudaStream_t stream) {
    c = cudaLaunchConfig_t{};
    c.gridDim = dim3(grid);
    c.blockDim = dim3(block);
    c.dynamicSmemBytes = smem;
    c.stream = stream;
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    c.attrs = attr;
    c.numAttrs = 1;
  }
};

template <int D, int BQ>
int launch_main(void* dq, float* part, void* dk, void* dv, float* kv_part,
                const BwdArgs& a, const Strides* st, const void* q,
                const void* dout, const void* k, const void* v, int H_kv,
                int n_kb, int n_qt, cudaStream_t stream) {
  constexpr int SMEM = bwd_smem<D, BQ>();
  static_assert(SMEM <= 232448, "a block's shared memory");
  static int ready = 1;  // once per instantiation and process
  if (ready != 0) {
    ready = prepare_wgmma(bwd_wgmma_kernel<D, BQ>, SMEM);
    if (ready != 0) return ready;
  }
  const int B = a.B;
  BwdMaps km, qm;
  if (!bwd_map(&km.q, q, B, a.H, a.Sq, D, st[0], BQ) ||
      !bwd_map(&km.dout, dout, B, a.H, a.Sq, D, st[4], BQ) ||
      !bwd_map(&km.k, k, B, H_kv, a.Sk, D, st[1], WgTiles<D>::KV) ||
      !bwd_map(&km.v, v, B, H_kv, a.Sk, D, st[2], WgTiles<D>::KV) ||
      !bwd_map(&qm.q, q, B, a.H, a.Sq, D, st[0], DQ_ROWS) ||
      !bwd_map(&qm.dout, dout, B, a.H, a.Sq, D, st[4], DQ_ROWS) ||
      !bwd_map(&qm.k, k, B, H_kv, a.Sk, D, st[1], WgTiles<D>::DQK) ||
      !bwd_map(&qm.v, v, B, H_kv, a.Sk, D, st[2], WgTiles<D>::DQK))
    return -2;
  const int kv_x = B * H_kv * a.n_gsplit;
  const int n_kv = kv_x * n_kb;
  const int n_dq = B * a.H * n_qt * a.n_split;
  Launch cfg(n_kv + n_dq, WG_THREADS, SMEM, stream);
  const int e = (int)cudaLaunchKernelEx(
      &cfg.c, bwd_wgmma_kernel<D, BQ>, static_cast<__nv_bfloat16*>(dq), part,
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv),
      kv_part, a, st[5], st[6], st[7], kv_x, n_kv, B * a.H, n_qt, km, qm);
  return e != 0 ? e : (int)cudaGetLastError();
}

template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, const void* o,
                 const void* dout, const float* lse, float* lse2,
                 float* delta, float* part, float* kv_part, const int* walks,
                 void* dq, void* dk, void* dv, int B, int H, int H_kv,
                 int Sq, int Sk, int causal, int window, float scale,
                 const long long* strides, const int* plan,
                 cudaStream_t stream) {
  using T = __nv_bfloat16;
  // plan: (q rows of a dk/dv step, key splits of dq, padded rows, records
  // of the walk table: one a key block, one a (split, query tile), group
  // splits of dk/dv)
  const int bq = plan[0], n_split = plan[1], S_pad = plan[2];
  const int n_gsplit = plan[4];
  const int n_kb = (Sk + WgTiles<D>::KV - 1) / WgTiles<D>::KV;
  const int n_qt = (Sq + DQ_ROWS - 1) / DQ_ROWS;
  const int group = H / H_kv;
  if (n_split < 1 || S_pad % PAD_ROWS != 0 || S_pad < Sq ||
      plan[3] != n_kb + n_qt * n_split || walks == nullptr ||
      (n_split > 1 && part == nullptr) || n_gsplit < 1 ||
      n_gsplit > group || (n_gsplit > 1 && (D != 256 || kv_part == nullptr)))
    return (int)cudaErrorInvalidValue;
  Strides st[8];
  for (int t = 0; t < 8; ++t)
    st[t] = Strides{strides[3 * t], strides[3 * t + 1], strides[3 * t + 2]};
  // tensors: q 0, k 1, v 2, o 3, dout 4, dq 5, dk 6, dv 7
  const long long n_pad = (long long)B * H * S_pad;
  constexpr int RPB = 256 / (D / 8);
  bwd_delta_lse_kernel<D><<<(unsigned)((n_pad + RPB - 1) / RPB), 256, 0,
                            stream>>>(static_cast<const T*>(o),
                                      static_cast<const T*>(dout), lse, lse2,
                                      delta, H, Sq, S_pad, n_pad, st[3],
                                      st[4]);
  int e = (int)cudaGetLastError();
  if (e != 0) return e;
  const BwdArgs a{lse2,   delta,  reinterpret_cast<const int4*>(walks),
                  B,      H,      group,
                  Sq,     Sk,     S_pad,
                  causal, window, n_split,
                  n_gsplit, scale};
#define BW_MAIN(BQ)                                                         \
  launch_main<D, BQ>(dq, part, dk, dv, kv_part, a, st, q, dout, k, v, H_kv, \
                     n_kb, n_qt, stream)
  switch (bq) {
    case 16: e = BW_MAIN(16); break;
    case 32: e = BW_MAIN(32); break;
    case 64: e = BW_MAIN(64); break;
    case 128:  // d = 64 only (at d = 128 the accumulators would spill)
      if constexpr (D == 64) {
        e = BW_MAIN(128);
        break;
      }
      return (int)cudaErrorInvalidValue;
    default: return (int)cudaErrorInvalidValue;
  }
#undef BW_MAIN
  if (e != 0 || (n_split == 1 && n_gsplit == 1)) return e;
  // the merges: dq's key splits, dk's and dv's group splits
  MergeJobs jobs{};
  int n_jobs = 0;
  long long most = 0;
  if (n_split > 1) {
    jobs.job[n_jobs++] = MergeJob{part, static_cast<T*>(dq), H, Sq, n_split,
                                  (long long)B * H * Sq, st[5]};
  }
  if (n_gsplit > 1) {
    const long long rows = (long long)B * H_kv * Sk;
    jobs.job[n_jobs++] = MergeJob{kv_part, static_cast<T*>(dk), H_kv, Sk,
                                  n_gsplit, rows, st[6]};
    jobs.job[n_jobs++] = MergeJob{kv_part + (long long)n_gsplit * rows * D,
                                  static_cast<T*>(dv), H_kv, Sk, n_gsplit,
                                  rows, st[7]};
  }
  for (int j = 0; j < n_jobs; ++j)
    most = jobs.job[j].rows > most ? jobs.job[j].rows : most;
  Launch cfg((unsigned)((most * (D / 4) + 255) / 256), 256, 0, stream);
  cfg.c.gridDim.y = n_jobs;
  e = (int)cudaLaunchKernelEx(&cfg.c, bwd_merge_kernel<D>, jobs);
  return e != 0 ? e : (int)cudaGetLastError();
}

}  // namespace

// C entry point of the float32 path (bfloat16 takes the wgmma path at
// every head dim): launches the three kernels on `stream` in turn and
// returns the first cudaGetLastError() that is not 0.  q, k, v, o, dout,
// dq, dk and dv are float32; lse (the forward's) and delta (scratch) are
// float32 (B, H, S_q) dense.  S_q == S_k where causal or windowed.
// window: 0 for none.  strides: 24 element strides, (batch, head, seq)
// of q, k, v, o, dout, dq, dk, dv in turn.
extern "C" int flash_attention_bwd_launch(
    int d, const void* q, const void* k, const void* v,
    const void* o, const void* dout, const float* lse, float* delta,
    void* dq, void* dk, void* dv, int B, int H, int H_kv, int Sq, int Sk,
    int causal, int window, float scale, const long long* strides,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define BW_ARGS                                                              \
  q, k, v, o, dout, lse, delta, dq, dk, dv, B, H, H_kv, Sq, Sk, causal,      \
      window, scale, strides, st
  switch (d) {
    case 64: return launch<64>(BW_ARGS);
    case 128: return launch<128>(BW_ARGS);
    case 256: return launch<256>(BW_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef BW_ARGS
}

// C entry point of bfloat16 (the wgmma path, head dims 64, 128 and 256):
// the delta / lse2 kernel, the dk/dv and dq blocks in one launch, and
// the merge of dq's key splits (plan[1] > 1) and of dk's and dv's group
// splits (plan[4] > 1, d = 256) where there are any, on `stream` in turn;
// returns the first error (-2: a tensor map the encoder refused, -3: a
// build without the registers setmaxnreg hands out).  lse: the forward's
// float32 (B, H, S_q) dense; lse2_delta: scratch of 2 x (B, H, plan[2])
// floats; part: scratch of plan[1] x (B, H, S_q, d) floats where plan[1]
// > 1, else null; kv_part: scratch of 2 x plan[4] x (B, H_kv, S_k, d)
// floats where plan[4] > 1, else null; walks: the plan's walk table on
// the card (plan[3] records of WALK_INTS ints).  plan: the 5 ints of
// kernels/flash_attention.py:BwdPlan.c_args.  Strides as above.
extern "C" int flash_attention_bwd_wgmma_launch(
    int d, const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* lse2_delta, float* part,
    float* kv_part, const int* walks, void* dq, void* dk, void* dv, int B,
    int H, int H_kv, int Sq, int Sk, int causal, int window, float scale,
    const long long* strides, const int* plan, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* delta = lse2_delta + (long long)B * H * plan[2];
#define BW_WG(D)                                                            \
  launch_wgmma<D>(q, k, v, o, dout, lse, lse2_delta, delta, part, kv_part,  \
                  walks, dq, dk, dv, B, H, H_kv, Sq, Sk, causal, window,    \
                  scale, strides, plan, st)
  switch (d) {
    case 64: return BW_WG(64);
    case 128: return BW_WG(128);
    case 256: return BW_WG(256);
    default: return (int)cudaErrorInvalidValue;
  }
#undef BW_WG
}
