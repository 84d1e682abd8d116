// Split-KV flash decode for Hopper (sm_90a).
//
// Replaces the Pallas kernel src/repro/kernels/decode_attention.py:
// _decode_kernel.  One query token per sequence attends to its KV cache:
// for q (B, H, d), caches (B, H_kv, S_max, d) and cache_len (B,) int32,
//   o[b, h] = sum_{j < cache_len[b]} softmax_j(q . k_j * d^-1/2) v_j
// with query head h reading kv head h / (H / H_kv).  Scores, maxima and
// sums are float32; masked scores are -1e30; the output is
// acc / max(l, 1e-30) in the input type.  Inputs are float32 or bfloat16,
// head dim 16, 32, 64, 128 or 256; group * d <= 2560 for float32
// (recurrentgemma's 10 query heads over one KV head of 256) and group <= 16
// for bfloat16.  Each tensor comes with its own strides (last dimension
// contiguous), so the model hands in transposed views of its
// (B, S_max, H_kv, d) caches without a copy; the bfloat16 kernel copies
// rows in 16-byte pieces, so there base pointers are 16-byte aligned and
// strides multiples of 8 elements (the wrapper copies a view that is not).
// Contract: 1 <= cache_len[b] <= S_max (the model always satisfies it);
// it is not checked on the host, since that would wait on the device, and
// the kernel clamps cache_len to S_max.
//
// Bound: memory bytes.  Each cached key and value up to cache_len is read
// once and used for 2 * group * d flops against 2 * d * sizeof(T) bytes,
// a few flops per byte, far below the card's ~295 bf16 flops per byte.
// What costs time is latency and parallelism: at batch 1 one block per
// (b, kv head) would leave most of the 132 SMs idle, and the whole cache
// of a step is a few MB, a microsecond at the memory rate.
//
// The TPU kernel walks the splits as a sequential grid axis with
// (m, l, acc) in VMEM.  Here the splits run in parallel, grid
// (n_splits, H_kv, B), and each block handles all `group` query heads of
// its kv head over one split of the cache (whole 64-key tiles).
//
// bfloat16 (the serving path's type): one launch, FlashDecoding's GQA form.
//   * The group's query heads are the M rows of `mma.sync` m16n8k16,
//     padded to 16 with zero rows that are never written out; S = Q K^T
//     and acc += P V run on the tensor cores with float32 accumulation,
//     fragments by `ldmatrix` (`.trans` for V) from the bf16 tiles.
//   * Four warps; 64-key tiles come in by 16-byte `cp.async` copies into a
//     three-stage ring, two tiles in flight (so a two-tile split is one
//     round trip to memory; one wait and one barrier per tile), rows past
//     the split's end zero-filled and masked to -1e30.  Warp w owns keys
//     16w..16w+15 of every tile, with its own (m, l, acc) in registers
//     (16 x d accumulators: 128 a thread at d = 256), and skips a slice
//     wholly past the end.
//   * At the split's end the block merges its warps' partials by
//     log-sum-exp in warp order through shared memory (the ring's bytes)
//     and writes (acc, m, l) of its split to the float32 workspace.
//   * Then, after __threadfence(), it takes a ticket from the per-(b, kv
//     head) int32 arrival counter with atomicAdd.  A split that starts at
//     or past cache_len[b] computes nothing but still takes its ticket, so
//     every launch counts n_splits arrivals.  The block that arrives last
//     merges the valid splits in split order, as the float32 merge kernel
//     does, so the result is bitwise the same whatever order the blocks
//     ran in; it writes o and resets the counter to 0 in the same launch,
//     so a CUDA graph can replay the launch.  The wrapper owns the
//     counters (zeroed once, kernels/decode_attention.py), and calls on one
//     device must not overlap on two streams.
//   * The wrapper sizes the splits (kernels/decode_attention.py:
//     split_plan): at least two tiles each, at most 64 splits, enough
//     blocks to cover the SMs once where the cache allows.
//
// float32 (tests and the card/CPU comparison), two launches:
//   * flash_decode_split_kernel: 256 threads; 64-key tiles staged in
//     shared memory as float32: scores for every (head, key) pair, a
//     per-head softmax update by one warp per head (a warp takes a second
//     head where the group has more than the block's 8 warps), then the
//     P.V update of the block's group x d float32 accumulator, held in
//     registers (at most 10 outputs per thread).  It writes (acc, m, l) of
//     its split to the workspace; a split that starts at or past
//     cache_len[b] returns at once and is never read;
//   * flash_decode_merge_kernel: grid (H, B), d threads; merges the valid
//     splits of each (b, h) by log-sum-exp in split order.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int TK = 64;       // keys per tile; the softmax reads 2 per lane
constexpr int MAXACC = 10;   // accumulator outputs per thread
constexpr int MAX_OUT = THREADS * MAXACC;  // group * d at most
constexpr float NEG = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }

struct Strides {
  long long b, h, s;
};

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v,
                          const int* __restrict__ cache_len,
                          float* __restrict__ ws, int group, int S_max,
                          int split_len, float scale, Strides qs, Strides ks,
                          Strides vs) {
  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int len = min(cache_len[b], S_max);
  const int start = split * split_len;
  if (start >= len) return;
  const int end = min(start + split_len, len);
  const int G = group, n_out = G * D;

  extern __shared__ float4 smem4[];
  float* sq = reinterpret_cast<float*>(smem4);  // G x D
  float* sk = sq + n_out;                       // TK x (D + 1)
  float* sv = sk + TK * (D + 1);                // TK x D
  float* ss = sv + TK * D;                      // G x TK scores, then p
  float* sm = ss + G * TK;                      // running max per head
  float* sl = sm + G;                           // running sum per head
  float* sa = sl + G;                           // this tile's rescale

  const int tid = threadIdx.x;
  const T* qb = q + b * qs.b + (long long)hk * G * qs.h;
  for (int i = tid; i < n_out; i += THREADS)
    sq[i] = to_f(qb[(i / D) * qs.h + i % D]);
  for (int g = tid; g < G; g += THREADS) {
    sm[g] = NEG;
    sl[g] = 0.f;
  }
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;

  float acc[MAXACC];
#pragma unroll
  for (int i = 0; i < MAXACC; ++i) acc[i] = 0.f;

  for (int t0 = start; t0 < end; t0 += TK) {
    const int nk = min(TK, end - t0);
    for (int i = tid; i < TK * D; i += THREADS) {
      const int j = i / D, d = i % D;
      const long long row = t0 + j;
      const bool ok = j < nk;
      sk[j * (D + 1) + d] = ok ? to_f(kb[row * ks.s + d]) : 0.f;
      sv[j * D + d] = ok ? to_f(vb[row * vs.s + d]) : 0.f;
    }
    __syncthreads();

    for (int p = tid; p < G * TK; p += THREADS) {
      const int g = p / TK, j = p % TK;
      float s = NEG;
      if (j < nk) {
        float dot = 0.f;
#pragma unroll 16
        for (int d = 0; d < D; ++d)
          dot = fmaf(sq[g * D + d], sk[j * (D + 1) + d], dot);
        s = dot * scale;
      }
      ss[p] = s;
    }
    __syncthreads();

    const int warp = tid / 32, lane = tid % 32;
    for (int g = warp; g < G; g += THREADS / 32) {
      const float s0 = ss[g * TK + lane], s1 = ss[g * TK + lane + 32];
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = sm[g];
      const float m_new = fmaxf(m_old, mx);
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      ss[g * TK + lane] = p0;
      ss[g * TK + lane + 32] = p1;
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        sa[g] = alpha;
        sl[g] = alpha * sl[g] + sum;
        sm[g] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < MAXACC; ++i) {
      const int o = tid + i * THREADS;
      if (o < n_out) {
        const int g = o / D, d = o % D;
        float a = acc[i] * sa[g];
        for (int j = 0; j < nk; ++j)
          a = fmaf(ss[g * TK + j], sv[j * D + d], a);
        acc[i] = a;
      }
    }
    __syncthreads();
  }

  // workspace row of (b, hk, split): acc (G x D), then m (G), then l (G)
  float* w = ws + (((long long)b * gridDim.y + hk) * gridDim.x + split) *
                      (long long)(n_out + 2 * G);
#pragma unroll
  for (int i = 0; i < MAXACC; ++i) {
    const int o = tid + i * THREADS;
    if (o < n_out) w[o] = acc[i];
  }
  for (int g = tid; g < G; g += THREADS) {
    w[n_out + g] = sm[g];
    w[n_out + G + g] = sl[g];
  }
}

template <typename T, int D>
__global__ void flash_decode_merge_kernel(const float* __restrict__ ws,
                                          const int* __restrict__ cache_len,
                                          T* __restrict__ o, int H_kv,
                                          int group, int S_max, int n_splits,
                                          int split_len, long long osb,
                                          long long osh) {
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const int hk = h / group, g = h % group;
  const int len = min(cache_len[b], S_max);
  const int nv = min((len + split_len - 1) / split_len, n_splits);
  const long long row = group * D + 2 * group;
  const float* base = ws + ((long long)b * H_kv + hk) * n_splits * row;
  float M = NEG;
  for (int s = 0; s < nv; ++s) M = fmaxf(M, base[s * row + group * D + g]);
  float L = 0.f, A = 0.f;
  for (int s = 0; s < nv; ++s) {
    const float* r = base + s * row;
    const float w = expf(r[group * D + g] - M);
    L = fmaf(w, r[group * D + group + g], L);
    A = fmaf(w, r[g * D + d], A);
  }
  o[b * osb + h * osh + d] = from_f<T>(A / fmaxf(L, 1e-30f));
}

template <int D>
constexpr size_t max_smem_bytes() {
  constexpr int G = MAX_OUT / D;  // the largest group the kernel takes
  return sizeof(float) *
         (size_t)(MAX_OUT + TK * (D + 1) + TK * D + G * TK + 3 * G);
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const int* cache_len,
           float* ws, void* o, int B, int H, int H_kv, int S_max,
           int n_splits, int split_len, float scale, const long long* st,
           cudaStream_t stream) {
  static bool attr_set = false;  // once per instantiation and process
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_decode_split_kernel<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)max_smem_bytes<D>());
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const int G = H / H_kv;
  const size_t shmem =
      sizeof(float) * (size_t)(G * D + TK * (D + 1) + TK * D + G * TK + 3 * G);
  flash_decode_split_kernel<T, D>
      <<<dim3(n_splits, H_kv, B), THREADS, shmem, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), cache_len, ws, G, S_max, split_len, scale,
          Strides{st[0], st[1], 0}, Strides{st[2], st[3], st[4]},
          Strides{st[5], st[6], st[7]});
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  flash_decode_merge_kernel<T, D><<<dim3(H, B), D, 0, stream>>>(
      ws, cache_len, static_cast<T*>(o), H_kv, G, S_max, n_splits, split_len,
      st[8], st[9]);
  return (int)cudaGetLastError();
}


// ---------------------------------------------------------------------------
// bfloat16 on the tensor cores, one launch
// ---------------------------------------------------------------------------

#include "mma_bf16.cuh"

constexpr float LOG2E = 1.4426950408889634f;
constexpr int MMA_WARPS = 4;
constexpr int MMA_THREADS = 32 * MMA_WARPS;
constexpr int MMA_TK = 16 * MMA_WARPS;  // keys per tile, 16 per warp
constexpr int MMA_STAGES = 3;           // the ring: two tiles in flight
constexpr int MAX_GROUP = 16;           // query heads: the mma's M rows
constexpr int MAX_SPLITS = 64;          // splits the last block merges

template <int D>
constexpr size_t mma_smem_bytes() {
  // Q (16 rows), the ring of K and V, then each warp's row maxima and sums
  return sizeof(__nv_bfloat16) * (size_t)(16 + 2 * MMA_STAGES * MMA_TK) *
             (D + 8) +
         sizeof(float) * 2 * MMA_WARPS * 16;
}

template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
flash_decode_mma_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const int* __restrict__ cache_len,
                        float* __restrict__ ws, int* __restrict__ arrivals,
                        __nv_bfloat16* __restrict__ o, int group, int S_max,
                        int split_len, float scale_log2, Strides qs,
                        Strides ks, Strides vs, long long osb,
                        long long osh) {
  constexpr int LD = D + 8;   // halves per smem row
  constexpr int KS = D / 16;  // k-steps of Q.K^T over the head dim
  constexpr int NO = D / 8;   // n-tiles of the output
  constexpr int CH = D / 8;   // 16-byte pieces per row
  extern __shared__ float4 smem4[];
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem4);  // 16 x LD
  __nv_bfloat16* sk = sq + 16 * LD;  // the ring: stages of TK x LD
  __nv_bfloat16* sv = sk + MMA_STAGES * MMA_TK * LD;
  float* sm = reinterpret_cast<float*>(sv + MMA_STAGES * MMA_TK * LD);
  float* sl = sm + MMA_WARPS * 16;  // W x 16 maxima, then W x 16 sums
  float* sacc = reinterpret_cast<float*>(sk);  // after the loop: W x G x D
  __shared__ float w_split[MAX_SPLITS][MAX_GROUP];  // the last block's
  __shared__ float l_split[MAX_SPLITS][MAX_GROUP];  // merge weights, sums
  __shared__ float l_all[MAX_GROUP];
  __shared__ int ticket;

  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int n_splits = gridDim.x, G = group;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, tig = lane & 3;
  const int len = min(cache_len[b], S_max);
  const int start = split * split_len;
  const int end = min(start + split_len, len);
  // floats per split, rounded up to whole float4s
  const long long row = ((long long)G * D + 2 * G + 3) / 4 * 4;
  float* base = ws + ((long long)b * gridDim.y + hk) * n_splits * row;

  if (start < len) {
    const __nv_bfloat16* qb = q + b * qs.b + (long long)hk * G * qs.h;
    const __nv_bfloat16* kb = k + b * ks.b + hk * ks.h;
    const __nv_bfloat16* vb = v + b * vs.b + hk * vs.h;
    for (int i = tid; i < 16 * CH; i += MMA_THREADS) {
      const int r = i / CH, c = (i % CH) * 8;
      cp_async16(smem_addr(sq + r * LD + c), qb + (r < G ? r * qs.h + c : 0),
                 r < G);
    }
    const int n_t = (end - start + MMA_TK - 1) / MMA_TK;
    // the first two tiles (Q with the first) go out at once
    for (int t = 0; t < min(n_t, MMA_STAGES - 1); ++t) {
      const int r0 = start + t * MMA_TK;
      copy_tile<MMA_TK, D, MMA_THREADS>(sk + t * MMA_TK * LD, kb, ks.s, r0,
                                        end);
      copy_tile<MMA_TK, D, MMA_THREADS>(sv + t * MMA_TK * LD, vb, vs.s, r0,
                                        end);
      cp_async_commit();
    }

    // ldmatrix addresses, as in flash_attention.cu
    const int a_row = lane & 15, a_col = (lane >> 4) * 8;
    const int k_row = (lane >> 4) * 8 + (lane & 7);
    const int k_col = ((lane >> 3) & 1) * 8;
    const int v_row = ((lane >> 3) & 1) * 8 + (lane & 7);
    const int v_col = (lane >> 4) * 8;
    float acc[NO][4];
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
    float m_a = NEG, m_b = NEG, l_a = 0.f, l_b = 0.f;  // rows g, g + 8

    for (int t = 0; t < n_t; ++t) {
      const int stage = t % MMA_STAGES;
      // tile t has landed (tile t + 1 may still be in flight) for every
      // thread, and every warp is done with tile t - 1, whose stage the
      // copy of tile t + 2 then reuses
      if (t + 1 < n_t) cp_async_wait<1>();
      else cp_async_wait<0>();
      __syncthreads();
      if (t + 2 < n_t) {
        const int nxt = (t + 2) % MMA_STAGES * MMA_TK * LD;
        const int r0 = start + (t + 2) * MMA_TK;
        copy_tile<MMA_TK, D, MMA_THREADS>(sk + nxt, kb, ks.s, r0, end);
        copy_tile<MMA_TK, D, MMA_THREADS>(sv + nxt, vb, vs.s, r0, end);
        cp_async_commit();
      }
      const int k0 = start + t * MMA_TK + warp * 16;  // this warp's keys
      if (k0 >= end) continue;
      const __nv_bfloat16* skw = sk + (stage * MMA_TK + warp * 16) * LD;
      const __nv_bfloat16* svw = sv + (stage * MMA_TK + warp * 16) * LD;

      float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t qf[4], kf[4];
        ldmatrix_x4(qf, smem_addr(sq + a_row * LD + kk * 16 + a_col));
        ldmatrix_x4(kf, smem_addr(skw + k_row * LD + kk * 16 + k_col));
        mma_bf16(s[0], qf, kf[0], kf[1]);
        mma_bf16(s[1], qf, kf[2], kf[3]);
      }
      // element e of tile n: row (e < 2 ? g : g + 8), key k0 + 8n + 2tig +
      // (e & 1)
      float mx_a = NEG, mx_b = NEG;
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + n * 8 + tig * 2 + (e & 1);
          s[n][e] = key < end ? s[n][e] * scale_log2 : NEG;
          if (e < 2) mx_a = fmaxf(mx_a, s[n][e]);
          else mx_b = fmaxf(mx_b, s[n][e]);
        }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
      }
      const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
      const float al_a = ex2(m_a - mn_a), al_b = ex2(m_b - mn_b);
      m_a = mn_a;
      m_b = mn_b;
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        s[n][0] = ex2(s[n][0] - mn_a);
        s[n][1] = ex2(s[n][1] - mn_a);
        s[n][2] = ex2(s[n][2] - mn_b);
        s[n][3] = ex2(s[n][3] - mn_b);
      }
      l_a = al_a * l_a + (s[0][0] + s[0][1]) + (s[1][0] + s[1][1]);
      l_b = al_b * l_b + (s[0][2] + s[0][3]) + (s[1][2] + s[1][3]);
      const uint32_t pa[4] = {pack_bf16(s[0][0], s[0][1]),
                              pack_bf16(s[0][2], s[0][3]),
                              pack_bf16(s[1][0], s[1][1]),
                              pack_bf16(s[1][2], s[1][3])};
#pragma unroll
      for (int n = 0; n < NO; n += 2) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, smem_addr(svw + v_row * LD + n * 8 + v_col));
        acc[n][0] *= al_a;
        acc[n][1] *= al_a;
        acc[n][2] *= al_b;
        acc[n][3] *= al_b;
        acc[n + 1][0] *= al_a;
        acc[n + 1][1] *= al_a;
        acc[n + 1][2] *= al_b;
        acc[n + 1][3] *= al_b;
        mma_bf16(acc[n], pa, vf[0], vf[1]);
        mma_bf16(acc[n + 1], pa, vf[2], vf[3]);
      }
    }

    // merge the warps: each scales its sums to the block's row maxima
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
      l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
    }
    __syncthreads();  // every warp is done with the ring, which sacc reuses
    if (tig == 0) {
      sm[warp * 16 + g] = m_a;
      sm[warp * 16 + g + 8] = m_b;
      sl[warp * 16 + g] = l_a;
      sl[warp * 16 + g + 8] = l_b;
    }
    __syncthreads();
    float top_a = NEG, top_b = NEG;
#pragma unroll
    for (int w = 0; w < MMA_WARPS; ++w) {
      top_a = fmaxf(top_a, sm[w * 16 + g]);
      top_b = fmaxf(top_b, sm[w * 16 + g + 8]);
    }
    const float f_a = ex2(m_a - top_a), f_b = ex2(m_b - top_b);
    float* mine = sacc + warp * G * D;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int c = n * 8 + tig * 2;
      if (g < G) {
        mine[g * D + c] = acc[n][0] * f_a;
        mine[g * D + c + 1] = acc[n][1] * f_a;
      }
      if (g + 8 < G) {
        mine[(g + 8) * D + c] = acc[n][2] * f_b;
        mine[(g + 8) * D + c + 1] = acc[n][3] * f_b;
      }
    }
    __syncthreads();
    // the split's row: acc (G x D), then m (G), then l (G)
    float* out = base + split * row;
    for (int i = tid; i < G * D; i += MMA_THREADS) {
      float a = 0.f;
#pragma unroll
      for (int w = 0; w < MMA_WARPS; ++w) a += sacc[w * G * D + i];
      out[i] = a;
    }
    for (int r = tid; r < G; r += MMA_THREADS) {
      float top = NEG, sum = 0.f;
      for (int w = 0; w < MMA_WARPS; ++w) top = fmaxf(top, sm[w * 16 + r]);
      for (int w = 0; w < MMA_WARPS; ++w)
        sum += sl[w * 16 + r] * ex2(sm[w * 16 + r] - top);
      out[G * D + r] = top;
      out[G * D + G + r] = sum;
    }
  }

  // arrive; the last block of (b, hk) merges
  __threadfence();
  __syncthreads();
  int* counter = arrivals + (long long)b * gridDim.y + hk;
  if (tid == 0) ticket = atomicAdd(counter, 1);
  __syncthreads();
  if (ticket != n_splits - 1) return;
  __threadfence();
  const int nv = min((len + split_len - 1) / split_len, n_splits);
  for (int i = tid; i < nv * G; i += MMA_THREADS) {
    const int s = i / G, r = i % G;
    w_split[s][r] = __ldcg(base + s * row + G * D + r);
    l_split[s][r] = __ldcg(base + s * row + G * D + G + r);
  }
  __syncthreads();
  if (tid < G) {
    float top = NEG, sum = 0.f;
    for (int s = 0; s < nv; ++s) top = fmaxf(top, w_split[s][tid]);
    for (int s = 0; s < nv; ++s) {
      const float w = ex2(w_split[s][tid] - top);
      w_split[s][tid] = w;
      sum = fmaf(w, l_split[s][tid], sum);
    }
    l_all[tid] = fmaxf(sum, 1e-30f);
  }
  __syncthreads();
  // four outputs a thread at a time, eight splits' loads in flight
  __nv_bfloat16* ob = o + b * osb + (long long)hk * G * osh;
  for (int i = 4 * tid; i < G * D; i += 4 * MMA_THREADS) {
    const int r = i / D;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
    for (int s = 0; s < nv; ++s) {
      const float w = w_split[s][r];
      const float4 x = __ldcg(reinterpret_cast<const float4*>(base + s * row +
                                                              i));
      a.x = fmaf(w, x.x, a.x);
      a.y = fmaf(w, x.y, a.y);
      a.z = fmaf(w, x.z, a.z);
      a.w = fmaf(w, x.w, a.w);
    }
    const float l = l_all[r];
    __nv_bfloat162* dst =
        reinterpret_cast<__nv_bfloat162*>(ob + r * osh + i % D);
    dst[0] = __floats2bfloat162_rn(a.x / l, a.y / l);
    dst[1] = __floats2bfloat162_rn(a.z / l, a.w / l);
  }
  if (tid == 0) *counter = 0;  // ready for the next launch or replay
}

template <int D>
int launch_mma(const void* q, const void* k, const void* v,
               const int* cache_len, float* ws, int* arrivals, void* o, int B,
               int H, int H_kv, int S_max, int n_splits, int split_len,
               float scale, const long long* st, cudaStream_t stream) {
  const int G = H / H_kv;
  if (G > MAX_GROUP || n_splits > MAX_SPLITS)
    return (int)cudaErrorInvalidValue;
  constexpr size_t shmem = mma_smem_bytes<D>();
  static bool attr_set = false;  // once per instantiation and process
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_decode_mma_kernel<D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  flash_decode_mma_kernel<D>
      <<<dim3(n_splits, H_kv, B), MMA_THREADS, shmem, stream>>>(
          static_cast<const __nv_bfloat16*>(q),
          static_cast<const __nv_bfloat16*>(k),
          static_cast<const __nv_bfloat16*>(v), cache_len, ws, arrivals,
          static_cast<__nv_bfloat16*>(o), G, S_max, split_len,
          scale * LOG2E, Strides{st[0], st[1], 0},
          Strides{st[2], st[3], st[4]}, Strides{st[5], st[6], st[7]}, st[8],
          st[9]);
  return (int)cudaGetLastError();
}

#define FD_ARGS q, k, v, len, ws, o, B, H, H_kv, S_max, n_splits, split_len, \
                scale, st, stream
#define FD_MMA_ARGS q, k, v, len, ws, arrivals, o, B, H, H_kv, S_max, \
                    n_splits, split_len, scale, st, stream

int launch_d(int is_bf16, int d, const void* q, const void* k, const void* v,
             const int* len, float* ws, int* arrivals, void* o, int B, int H,
             int H_kv, int S_max, int n_splits, int split_len, float scale,
             const long long* st, cudaStream_t stream) {
  switch (d * 2 + (is_bf16 ? 1 : 0)) {
    case 16 * 2: return launch<float, 16>(FD_ARGS);
    case 32 * 2: return launch<float, 32>(FD_ARGS);
    case 64 * 2: return launch<float, 64>(FD_ARGS);
    case 128 * 2: return launch<float, 128>(FD_ARGS);
    case 256 * 2: return launch<float, 256>(FD_ARGS);
    case 16 * 2 + 1: return launch_mma<16>(FD_MMA_ARGS);
    case 32 * 2 + 1: return launch_mma<32>(FD_MMA_ARGS);
    case 64 * 2 + 1: return launch_mma<64>(FD_MMA_ARGS);
    case 128 * 2 + 1: return launch_mma<128>(FD_MMA_ARGS);
    case 256 * 2 + 1: return launch_mma<256>(FD_MMA_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
}

#undef FD_ARGS
#undef FD_MMA_ARGS

}  // namespace

// C entry point: launches on `stream` and returns cudaGetLastError().
// is_bf16 selects bfloat16 (1: one launch on the tensor cores) or float32
// (0: the split kernel and its merge) for q, the caches and o.  ws holds
// B * H_kv * n_splits * (group * d + 2 * group, rounded up to a multiple
// of 4) floats.  arrivals: B * H_kv
// int32 counters, zero before the call and zero after it (bfloat16 only).
// strides: 10 element strides, q (batch, head), k (batch, head, seq),
// v (batch, head, seq), o (batch, head).
extern "C" int flash_decode_launch(int is_bf16, int d, const void* q,
                                   const void* k, const void* v,
                                   const void* cache_len, void* ws,
                                   void* arrivals, void* o, int B, int H,
                                   int H_kv, int S_max, int n_splits,
                                   int split_len, float scale,
                                   const long long* strides, void* stream) {
  return launch_d(is_bf16, d, q, k, v, static_cast<const int*>(cache_len),
                  static_cast<float*>(ws), static_cast<int*>(arrivals), o, B,
                  H, H_kv, S_max, n_splits, split_len, scale, strides,
                  static_cast<cudaStream_t>(stream));
}
