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
// dense bf16 rate of 989 TFLOP/s.
//
// The design: two simple paths with the same walk.
//   * Kernel 2 (dq): one block per (b, h, 64 query rows) walks the key
//     tiles its rows see (as the forward does) and accumulates dq in
//     registers: no other block writes its rows.
//   * Kernel 3 (dk, dv): one block per (b, kv head, key tile) walks the
//     query tiles that see its keys, for every query head of the kv
//     head's group in turn, and accumulates dk and dv in registers.  The
//     group's sum is taken inside the block, so no atomics are needed and
//     every run gives the same bits.
//   * Both recompute the score tile from q and k (and dP from do and v).
//   * bfloat16 at head dims 64 and 128 (the models that train on the
//     card): the four products of a tile pair on `mma.sync` m16n8k16 with
//     float32 accumulation, as the forward's: 4 warps of 16 rows, 64-row
//     tiles copied by 16-byte `cp.async` (single stage), fragments by
//     `ldmatrix` (`.trans` for the products over the score tile's rows).
//     Kernel 2's warps own query rows: S = Q K^T and dP = dO V^T, then
//     dQ += dS K with dS rounded to bf16 straight from the accumulators.
//     Kernel 3's warps own keys and compute the transposed tiles: S^T =
//     K Q^T and dP^T = V dO^T, then dV += P^T dO and dK += dS^T Q.  P is
//     exp2 of the scores scaled by d^-1/2 log2(e) less lse log2(e).
//   * float32, and bfloat16 at head dim 256: float32 FMAs on the CUDA
//     cores (bfloat16 widened as it lands in shared memory), to float32
//     rounding.  P and dS go through shared memory for the products over
//     the other axis.  256 threads as 16 x 16: thread (ty, tx) owns query
//     rows 4ty..4ty+3 and keys tx + 16j of a score tile, and key rows
//     ty + 16r (kernel 3) or query rows 4ty..4ty+3 (kernel 2) by columns
//     tx + 16c of the accumulators.  Rows are padded to d + 4 floats
//     (float4 reads free of bank conflicts).  Key tiles are 64 keys, 32 at
//     d = 256, which keeps kernel 3's two accumulators at 64 registers a
//     thread and its shared memory (q, do, k, v, P, dS) at 214 KB.
// What is left: double-buffered tiles, and `wgmma` fed by TMA, the
// redesign that ROADMAP.md queues beside the forward's.  Offsets are
// 64-bit.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;  // 16 x 16
constexpr int BQ = 64;        // query rows per tile

struct Strides {
  long long b, h, s;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

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
template <int ROWS, int D, int LD, typename T>
__device__ __forceinline__ void load_rows(float* dst, const T* src,
                                          long long rs, int r0, int n) {
  for (int idx = threadIdx.x; idx < ROWS * D; idx += THREADS) {
    const int r = idx / D, c = idx % D;
    const int row = r0 + r;
    dst[r * LD + c] = row < n ? to_f(src[(long long)row * rs + c]) : 0.f;
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
template <typename T>
__global__ void __launch_bounds__(THREADS)
bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                 float* __restrict__ delta, int H, int Sq, int D,
                 long long n_rows, Strides os, Strides ds) {
  const long long row = (long long)blockIdx.x * (THREADS / 32) +
                        threadIdx.x / 32;
  if (row >= n_rows) return;
  const int lane = threadIdx.x % 32;
  const long long b = row / ((long long)H * Sq);
  const int h = (int)((row / Sq) % H), i = (int)(row % Sq);
  const T* orow = o + b * os.b + h * os.h + (long long)i * os.s;
  const T* drow = dout + b * ds.b + h * ds.h + (long long)i * ds.s;
  float acc = 0.f;
  for (int c = lane; c < D; c += 32)
    acc = fmaf(to_f(orow[c]), to_f(drow[c]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

// Kernel 2: dq for 64 query rows of one (b, h).
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              T* __restrict__ dq, int H, int group, int Sq, int Sk,
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
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;

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

  T* ob = dq + b * dqs.b + h * dqs.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + 4 * ty + i;
    if (qpos >= Sq) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      store(ob + (long long)qpos * dqs.s + tx + 16 * c, acc[i][c] * scale);
  }
}

// Kernel 3: dk and dv for one key tile of one (b, kv head), summed over
// the kv head's group of query heads.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dk,
                T* __restrict__ dv, int H, int group, int Sq, int Sk,
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
    const T* qb = q + b * qs.b + h * qs.h;
    const T* db = dout + b * dos.b + h * dos.h;
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

  T* kout = dk + b * dks.b + hk * dks.h;
  T* vout = dv + b * dvs.b + hk * dvs.h;
#pragma unroll
  for (int r = 0; r < JK; ++r) {
    const int kpos = k0 + ty + 16 * r;
    if (kpos >= Sk) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      store(kout + (long long)kpos * dks.s + tx + 16 * c,
            dk_acc[r][c] * scale);
      store(vout + (long long)kpos * dvs.s + tx + 16 * c, dv_acc[r][c]);
    }
  }
}

template <typename K>
int set_smem(K kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T, int D>
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
    int e = set_smem(bwd_dq_kernel<T, D>, dq_smem);
    if (e == 0) e = set_smem(bwd_dkdv_kernel<T, D>, dkdv_smem);
    if (e != 0) return e;
    attr_set = true;
  }
  auto S = [&](int t) { return Strides{st[3 * t], st[3 * t + 1], st[3 * t + 2]}; };
  // tensors: q 0, k 1, v 2, o 3, dout 4, dq 5, dk 6, dv 7
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* tdo = static_cast<const T*>(dout);
  const long long n_rows = (long long)B * H * Sq;
  bwd_delta_kernel<T><<<(unsigned)((n_rows + 7) / 8), THREADS, 0, stream>>>(
      static_cast<const T*>(o), tdo, delta, H, Sq, D, n_rows, S(3), S(4));
  int e = (int)cudaGetLastError();
  if (e != 0) return e;
  const dim3 gq((Sq + BQ - 1) / BQ, H, B);
  bwd_dq_kernel<T, D><<<gq, THREADS, dq_smem, stream>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<T*>(dq), H, H / H_kv, Sq, Sk,
      scale, causal, window, S(0), S(1), S(2), S(4), S(5));
  e = (int)cudaGetLastError();
  if (e != 0) return e;
  const dim3 gk((Sk + C::BK - 1) / C::BK, H_kv, B);
  bwd_dkdv_kernel<T, D><<<gk, THREADS, dkdv_smem, stream>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      H, H / H_kv, Sq, Sk, scale, causal, window, S(0), S(1), S(2), S(4),
      S(6), S(7));
  return (int)cudaGetLastError();
}


// ---------------------------------------------------------------------------
// bfloat16 at head dims 64 and 128: the products on the tensor cores
// ---------------------------------------------------------------------------

#include "mma_bf16.cuh"

constexpr float LOG2E = 1.4426950408889634f;
constexpr int MW = 4;        // warps a block, 16 rows (queries or keys) each
constexpr int MT = 32 * MW;  // threads a block
constexpr int MB = 16 * MW;  // rows of every tile: 64 queries or keys

template <int D>
struct MmaBwd {
  static constexpr int LD = D + 8;  // halves a shared row (copy_tile's)
  // four bf16 tiles (q, do, k, v) and the query tile's lse and delta
  static constexpr size_t SMEM =
      sizeof(__nv_bfloat16) * 4 * MB * LD + sizeof(float) * 2 * MB;
};

// acc[n][.] (n < 8) = the warp's 16 rows of `a` times the 64 rows of `b`
// transposed, over the head dim (both row-major tiles in shared memory,
// `a` already at the warp's first row): a score tile, as the forward's
// Q.K^T.
template <int D>
__device__ __forceinline__ void mma_abt(float (&acc)[8][4],
                                        const __nv_bfloat16* a,
                                        const __nv_bfloat16* b, int lane) {
  constexpr int LD = MmaBwd<D>::LD;
  const int a_row = lane & 15, a_col = (lane >> 4) * 8;
  const int b_row = (lane >> 4) * 8 + (lane & 7);
  const int b_col = ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t af[4];
    ldmatrix_x4(af, smem_addr(a + a_row * LD + kk * 16 + a_col));
#pragma unroll
    for (int n = 0; n < 8; n += 2) {
      uint32_t bf[4];
      ldmatrix_x4(bf, smem_addr(b + (n * 8 + b_row) * LD + kk * 16 + b_col));
      mma_bf16(acc[n], af, bf[0], bf[1]);
      mma_bf16(acc[n + 1], af, bf[2], bf[3]);
    }
  }
}

// out[n][.] (n < D/8) += p (a 16 x 64 accumulator tile, rounded to bf16 as
// an A operand) times the 64 rows of `b` (row-major in shared memory, read
// transposed by ldmatrix): the forward's P.V.
template <int D>
__device__ __forceinline__ void mma_pb(float (&out)[D / 8][4],
                                       const float (&p)[8][4],
                                       const __nv_bfloat16* b, int lane) {
  constexpr int LD = MmaBwd<D>::LD;
  const int v_row = ((lane >> 3) & 1) * 8 + (lane & 7);
  const int v_col = (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t pa[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                            pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                            pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                            pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
    for (int n = 0; n < D / 8; n += 2) {
      uint32_t vf[4];
      ldmatrix_x4_trans(vf, smem_addr(b + (kk * 16 + v_row) * LD + n * 8 +
                                      v_col));
      mma_bf16(out[n], pa, vf[0], vf[1]);
      mma_bf16(out[n + 1], pa, vf[2], vf[3]);
    }
  }
}

// Kernel 2 on the tensor cores: dq for 64 query rows of one (b, h); warp w
// owns rows 16w..16w+15.  Element e of accumulator tile n is row
// (e < 2 ? a : b) = g (+ 8) of the warp, column n * 8 + 2 tig + (e & 1).
template <int D>
__global__ void __launch_bounds__(MT)
bwd_dq_mma_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  const __nv_bfloat16* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta,
                  __nv_bfloat16* __restrict__ dq, int H, int group, int Sq,
                  int Sk, float scale, int causal, int window, Strides qs,
                  Strides ks, Strides vs, Strides dos, Strides dqs) {
  constexpr int LD = MmaBwd<D>::LD, NO = D / 8;
  extern __shared__ float4 smem4[];
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem4);
  __nv_bfloat16* sdo = sq + MB * LD;
  __nv_bfloat16* sk = sdo + MB * LD;
  __nv_bfloat16* sv = sk + MB * LD;

  const int n_qt = gridDim.x;
  const int qt = causal ? n_qt - 1 - blockIdx.x : blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / group;
  const int q0 = qt * MB;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tig = lane & 3;
  const int r0 = warp * 16;
  const int row_a = q0 + r0 + g, row_b = row_a + 8;

  copy_tile<MB, D, MT>(sq, q + b * qs.b + h * qs.h, qs.s, q0, Sq);
  copy_tile<MB, D, MT>(sdo, dout + b * dos.b + h * dos.h, dos.s, q0, Sq);
  cp_async_commit();
  const long long row0 = ((long long)b * H + h) * Sq;
  const float lse_a = row_a < Sq ? lse[row0 + row_a] * LOG2E : 0.f;
  const float lse_b = row_b < Sq ? lse[row0 + row_b] * LOG2E : 0.f;
  const float dl_a = row_a < Sq ? delta[row0 + row_a] : 0.f;
  const float dl_b = row_b < Sq ? delta[row0 + row_b] : 0.f;
  const __nv_bfloat16* kb = k + b * ks.b + hk * ks.h;
  const __nv_bfloat16* vb = v + b * vs.b + hk * vs.h;
  const float sl2 = scale * LOG2E;

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  const int n_kt_all = (Sk + MB - 1) / MB;
  const int n_kt = causal ? min(n_kt_all, (q0 + MB - 1) / MB + 1) : n_kt_all;
  const int kt_lo = window > 0 ? max(0, q0 - window + 1) / MB : 0;
  for (int kt = kt_lo; kt < n_kt; ++kt) {
    const int k0 = kt * MB;
    __syncthreads();  // the previous tile's reads are done
    copy_tile<MB, D, MT>(sk, kb, ks.s, k0, Sk);
    copy_tile<MB, D, MT>(sv, vb, vs.s, k0, Sk);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    float s[8][4], dp[8][4];
    mma_abt<D>(s, sq + r0 * LD, sk, lane);
    mma_abt<D>(dp, sdo + r0 * LD, sv, lane);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + n * 8 + 2 * tig + (e & 1);
        const int row = e < 2 ? row_a : row_b;
        const float p = visible(row, key, Sq, Sk, causal, window)
                            ? ex2(fmaf(s[n][e], sl2, e < 2 ? -lse_a : -lse_b))
                            : 0.f;
        s[n][e] = p * (dp[n][e] - (e < 2 ? dl_a : dl_b));  // dS
      }
    mma_pb<D>(acc, s, sk, lane);
  }

  __nv_bfloat16* ob = dq + b * dqs.b + h * dqs.h;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int c = n * 8 + 2 * tig;
    if (row_a < Sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + (long long)row_a * dqs.s + c) =
          __floats2bfloat162_rn(acc[n][0] * scale, acc[n][1] * scale);
    if (row_b < Sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + (long long)row_b * dqs.s + c) =
          __floats2bfloat162_rn(acc[n][2] * scale, acc[n][3] * scale);
  }
}

// Kernel 3 on the tensor cores: dk and dv for 64 keys of one (b, kv
// head), summed over the group; warp w owns keys 16w..16w+15, and its
// score tiles are transposed (keys x queries): S^T = K Q^T, dP^T = V dO^T,
// then dV += P^T dO and dK += dS^T Q.
template <int D>
__global__ void __launch_bounds__(MT)
bwd_dkdv_mma_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    __nv_bfloat16* __restrict__ dk,
                    __nv_bfloat16* __restrict__ dv, int H, int group, int Sq,
                    int Sk, float scale, int causal, int window, Strides qs,
                    Strides ks, Strides vs, Strides dos, Strides dks,
                    Strides dvs) {
  constexpr int LD = MmaBwd<D>::LD, NO = D / 8;
  extern __shared__ float4 smem4[];
  __nv_bfloat16* sk = reinterpret_cast<__nv_bfloat16*>(smem4);
  __nv_bfloat16* sv = sk + MB * LD;
  __nv_bfloat16* sq = sv + MB * LD;
  __nv_bfloat16* sdo = sq + MB * LD;
  float* slse = reinterpret_cast<float*>(sdo + MB * LD);
  float* sdl = slse + MB;

  const int kt = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int k0 = kt * MB;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tig = lane & 3;
  const int r0 = warp * 16;
  const int key_a = k0 + r0 + g, key_b = key_a + 8;
  copy_tile<MB, D, MT>(sk, k + b * ks.b + hk * ks.h, ks.s, k0, Sk);
  copy_tile<MB, D, MT>(sv, v + b * vs.b + hk * vs.h, vs.s, k0, Sk);
  cp_async_commit();
  const float sl2 = scale * LOG2E;

  float dk_acc[NO][4], dv_acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  const int qt_lo = causal ? k0 / MB : 0;
  const int q_end = window > 0 ? min(Sq, k0 + MB - 1 + window) : Sq;
  const int qt_hi = (q_end + MB - 1) / MB;
  for (int gi = 0; gi < group; ++gi) {
    const int h = hk * group + gi;
    const long long row0 = ((long long)b * H + h) * Sq;
    const __nv_bfloat16* qb = q + b * qs.b + h * qs.h;
    const __nv_bfloat16* db = dout + b * dos.b + h * dos.h;
    for (int qt = qt_lo; qt < qt_hi; ++qt) {
      const int q0 = qt * MB;
      __syncthreads();  // the previous tile's reads are done
      copy_tile<MB, D, MT>(sq, qb, qs.s, q0, Sq);
      copy_tile<MB, D, MT>(sdo, db, dos.s, q0, Sq);
      cp_async_commit();
      for (int r = threadIdx.x; r < MB; r += MT) {
        slse[r] = q0 + r < Sq ? lse[row0 + q0 + r] * LOG2E : 0.f;
        sdl[r] = q0 + r < Sq ? delta[row0 + q0 + r] : 0.f;
      }
      cp_async_wait<0>();
      __syncthreads();
      float st[8][4], dpt[8][4];
      mma_abt<D>(st, sk + r0 * LD, sq, lane);
      mma_abt<D>(dpt, sv + r0 * LD, sdo, lane);
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = n * 8 + 2 * tig + (e & 1);
          const int key = e < 2 ? key_a : key_b;
          const float p =
              visible(q0 + qi, key, Sq, Sk, causal, window)
                  ? ex2(fmaf(st[n][e], sl2, -slse[qi]))
                  : 0.f;
          dpt[n][e] = p * (dpt[n][e] - sdl[qi]);  // dS^T
          st[n][e] = p;                            // P^T
        }
      mma_pb<D>(dv_acc, st, sdo, lane);
      mma_pb<D>(dk_acc, dpt, sq, lane);
    }
  }

  __nv_bfloat16* kout = dk + b * dks.b + hk * dks.h;
  __nv_bfloat16* vout = dv + b * dvs.b + hk * dvs.h;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int c = n * 8 + 2 * tig;
    if (key_a < Sk) {
      *reinterpret_cast<__nv_bfloat162*>(kout + (long long)key_a * dks.s + c) =
          __floats2bfloat162_rn(dk_acc[n][0] * scale, dk_acc[n][1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(vout + (long long)key_a * dvs.s + c) =
          __floats2bfloat162_rn(dv_acc[n][0], dv_acc[n][1]);
    }
    if (key_b < Sk) {
      *reinterpret_cast<__nv_bfloat162*>(kout + (long long)key_b * dks.s + c) =
          __floats2bfloat162_rn(dk_acc[n][2] * scale, dk_acc[n][3] * scale);
      *reinterpret_cast<__nv_bfloat162*>(vout + (long long)key_b * dvs.s + c) =
          __floats2bfloat162_rn(dv_acc[n][2], dv_acc[n][3]);
    }
  }
}

template <int D>
int launch_mma(const void* q, const void* k, const void* v, const void* o,
               const void* dout, const float* lse, float* delta, void* dq,
               void* dk, void* dv, int B, int H, int H_kv, int Sq, int Sk,
               int causal, int window, float scale, const long long* st,
               cudaStream_t stream) {
  using T = __nv_bfloat16;
  constexpr size_t smem = MmaBwd<D>::SMEM;
  static bool attr_set = false;  // once per instantiation and process
  if (!attr_set) {
    int e = set_smem(bwd_dq_mma_kernel<D>, smem);
    if (e == 0) e = set_smem(bwd_dkdv_mma_kernel<D>, smem);
    if (e != 0) return e;
    attr_set = true;
  }
  auto S = [&](int t) { return Strides{st[3 * t], st[3 * t + 1], st[3 * t + 2]}; };
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* tdo = static_cast<const T*>(dout);
  const long long n_rows = (long long)B * H * Sq;
  bwd_delta_kernel<T><<<(unsigned)((n_rows + 7) / 8), THREADS, 0, stream>>>(
      static_cast<const T*>(o), tdo, delta, H, Sq, D, n_rows, S(3), S(4));
  int e = (int)cudaGetLastError();
  if (e != 0) return e;
  const dim3 gq((Sq + MB - 1) / MB, H, B);
  bwd_dq_mma_kernel<D><<<gq, MT, smem, stream>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<T*>(dq), H, H / H_kv, Sq, Sk,
      scale, causal, window, S(0), S(1), S(2), S(4), S(5));
  e = (int)cudaGetLastError();
  if (e != 0) return e;
  const dim3 gk((Sk + MB - 1) / MB, H_kv, B);
  bwd_dkdv_mma_kernel<D><<<gk, MT, smem, stream>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      H, H / H_kv, Sq, Sk, scale, causal, window, S(0), S(1), S(2), S(4),
      S(6), S(7));
  return (int)cudaGetLastError();
}

}  // namespace

// C entry point: launches the three kernels on `stream` in turn and
// returns the first cudaGetLastError() that is not 0.  is_bf16 selects
// bfloat16 (1) or float32 (0) for q, k, v, o, dout, dq, dk and dv alike;
// lse (the forward's) and delta (scratch) are float32 (B, H, S_q) dense.
// S_q == S_k where causal or windowed.  window: 0 for none.  strides: 24
// element strides, (batch, head, seq) of q, k, v, o, dout, dq, dk, dv in
// turn.
extern "C" int flash_attention_bwd_launch(
    int is_bf16, int d, const void* q, const void* k, const void* v,
    const void* o, const void* dout, const float* lse, float* delta,
    void* dq, void* dk, void* dv, int B, int H, int H_kv, int Sq, int Sk,
    int causal, int window, float scale, const long long* strides,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define BW_ARGS                                                              \
  q, k, v, o, dout, lse, delta, dq, dk, dv, B, H, H_kv, Sq, Sk, causal,      \
      window, scale, strides, st
  switch (d * 2 + (is_bf16 ? 1 : 0)) {
    case 64 * 2: return launch<float, 64>(BW_ARGS);
    case 128 * 2: return launch<float, 128>(BW_ARGS);
    case 256 * 2: return launch<float, 256>(BW_ARGS);
    case 64 * 2 + 1: return launch_mma<64>(BW_ARGS);
    case 128 * 2 + 1: return launch_mma<128>(BW_ARGS);
    case 256 * 2 + 1: return launch<__nv_bfloat16, 256>(BW_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef BW_ARGS
}
