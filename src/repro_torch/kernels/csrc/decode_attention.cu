// Split-KV flash decode for Hopper (sm_90a).
//
// Replaces the Pallas kernel src/repro/kernels/decode_attention.py:
// _decode_kernel.  One query token per sequence attends to its KV cache:
// for q (B, H, d), caches (B, H_kv, S_max, d) and cache_len (B,) int32,
//   o[b, h] = sum_{j < cache_len[b]} softmax_j(q . k_j * d^-1/2) v_j
// with query head h reading kv head h / (H / H_kv).  Scores, maxima and
// sums are float32; masked scores are -1e30; the output is
// acc / max(l, 1e-30) in the input type.  Inputs are float32 or bfloat16,
// head dim 16, 32, 64, 128 or 256, group * d <= 2560 (recurrentgemma's
// 10 query heads over one KV head of 256).  Each tensor comes with
// its own strides (last dimension contiguous), so the model hands in
// transposed views of its (B, S_max, H_kv, d) caches without a copy.
// Contract: 1 <= cache_len[b] <= S_max (the model always satisfies it);
// it is not checked on the host, since that would wait on the device, and
// the kernel clamps cache_len to S_max.
//
// Bound: memory bytes.  Each cached key and value up to cache_len is read
// once and used for 2 * group * d flops against 2 * d * sizeof(T) bytes,
// a few flops per byte, far below the card's ~295 bf16 flops per byte.
// What costs time is parallelism: at batch 1 with 8 KV heads, one block
// per (b, kv head) would leave 124 of the 132 SMs idle, and a single
// block cannot pull the card's bandwidth.
//
// Design.  The TPU kernel walks the splits as a sequential grid axis with
// (m, l, acc) in VMEM.  Here the splits run in parallel:
//   * flash_decode_split_kernel: grid (n_splits, H_kv, B), 256 threads;
//     a block handles all `group` query heads of its kv head over one
//     split of the cache, in 64-key tiles staged in shared memory as
//     float32: scores for every (head, key) pair, a per-head softmax
//     update by one warp per head (a warp takes a second head where the
//     group has more than the block's 8 warps), then the P.V update of
//     the block's group x d float32 accumulator, held in registers (at
//     most 10 outputs per thread; at group 10, d 256 the block's shared
//     memory is 141 KB).  It writes (acc, m, l) of its split to a
//     float32 workspace.  A split that starts at or past cache_len[b]
//     returns at once and is never read;
//   * flash_decode_merge_kernel: grid (H, B), d threads; merges the
//     valid splits of each (b, h) by log-sum-exp in split order, so the
//     result does not depend on the order in which blocks ran.
// The wrapper picks the split length (a multiple of 64 keys) so that
// B * H_kv * n_splits fills the card about twice over.

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
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

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

template <typename T>
int launch_d(int d, const void* q, const void* k, const void* v,
             const int* cache_len, float* ws, void* o, int B, int H, int H_kv,
             int S_max, int n_splits, int split_len, float scale,
             const long long* st, cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, cache_len, ws, o, B, H, H_kv, S_max, n_splits, split_len, scale, st, stream);
    case 32: return launch<T, 32>(q, k, v, cache_len, ws, o, B, H, H_kv, S_max, n_splits, split_len, scale, st, stream);
    case 64: return launch<T, 64>(q, k, v, cache_len, ws, o, B, H, H_kv, S_max, n_splits, split_len, scale, st, stream);
    case 128: return launch<T, 128>(q, k, v, cache_len, ws, o, B, H, H_kv, S_max, n_splits, split_len, scale, st, stream);
    case 256: return launch<T, 256>(q, k, v, cache_len, ws, o, B, H, H_kv, S_max, n_splits, split_len, scale, st, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// C entry point: launches both kernels on `stream` and returns
// cudaGetLastError().  is_bf16 selects bfloat16 (1) or float32 (0) for q,
// the caches and o.  ws holds B * H_kv * n_splits * (group * d + 2 * group)
// floats.  strides: 10 element strides, q (batch, head), k (batch, head,
// seq), v (batch, head, seq), o (batch, head).
extern "C" int flash_decode_launch(int is_bf16, int d, const void* q,
                                   const void* k, const void* v,
                                   const void* cache_len, void* ws, void* o,
                                   int B, int H, int H_kv, int S_max,
                                   int n_splits, int split_len, float scale,
                                   const long long* strides, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(cache_len);
  float* w = static_cast<float*>(ws);
  if (is_bf16)
    return launch_d<__nv_bfloat16>(d, q, k, v, len, w, o, B, H, H_kv, S_max,
                                   n_splits, split_len, scale, strides, st);
  return launch_d<float>(d, q, k, v, len, w, o, B, H, H_kv, S_max, n_splits,
                         split_len, scale, strides, st);
}
