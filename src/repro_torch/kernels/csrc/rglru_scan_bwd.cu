// The RG-LRU linear recurrence's backward for Hopper (sm_90a).
//
// The gradient of rglru_scan.cu's recurrence h_t = a_t h_{t-1} + x_t
// (h_{-1} = h0, or 0), which the reference leaves to jax.grad of
// src/repro/models/rglru.py:rglru_scan (an associative scan).  Given dh
// (h's cotangent), with g_t the gradient reaching h_t:
//   g_t = dh_t + a_{t+1} g_{t+1}   (g_{S-1} = dh_{S-1})
//   dx_t = g_t,  da_t = g_t h_{t-1},  dh0 = a_0 g_0.
// dh and a are float32 or bfloat16 alike (dx and da come out in that
// type), h the forward's float32 carry (B, S, D) (the wrapper recomputes
// it in float32 for a bfloat16 input, as autograd through the plain
// version uses the float32 carry), h0 and dh0 float32 (B, D).  dh and a
// come with their own (batch, seq) strides, the channel dimension
// contiguous; h, dx, da and dh0 are dense.
//
// Design: the forward's chunked scan run backwards, in one launch that
// reads dh, a and h once.  A block owns (b, 32 channels, one chunk of L
// steps; L from the forward's plan, kernels/rglru_scan.py:chunk_plan):
//   * it takes its chunk from an atomic ticket, chunks in REVERSE order
//     (the last chunk first), so every chunk it waits on (the later ones)
//     has already started and the launch cannot deadlock;
//   * it stages its chunk of dh and of a shifted by one step (a_{t+1}; 0
//     past S) in shared memory, as float32;
//   * four threads a channel, each a quarter of the chunk: every thread
//     folds its steps backwards from 0 into (prod a, g_start), the
//     quarters fold (last first) into the chunk's summary, which the block
//     writes to the workspace and publishes behind a flag;
//   * the gradient entering the chunk from its end is the fold of the
//     later chunks' summaries, last chunk first, from 0 (G <- P(c) G +
//     L(c)): each of a channel's four threads folds a run of them, and the
//     runs fold in order.  The block waits for all its successors' flags
//     and always folds the same way, so the bits do not depend on block
//     timing;
//   * it rescans its chunk backwards from there, writing dx_t = g_t and
//     da_t = g_t h_{t-1} (h read from global memory, a warp 32 channels
//     of a row), and dh0 at step 0;
//   * the last block to finish resets the ticket, the counter and the
//     flags (the wrapper's, shared with the forward: launches on one
//     stream do not overlap).
// Bound: memory bytes.  Three flops an element against dh, a (in their
// type), h (float32) read and dx, da written.  Offsets are 64-bit.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int CW = 32;                 // channels a block
constexpr int PARTS = THREADS / CW;    // threads a channel
constexpr int MAX_CHUNK = 256;         // steps a chunk at most

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

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;\n"
               :: "l"(p), "r"(v) : "memory");
}

struct Strides {
  long long b, s;
};

// The launch's shared counters: ticket, finished blocks, then one flag a
// (b, channel block, chunk).
struct Sync {
  int* ticket;
  int* done;
  int* flags;
};

template <typename T>
__global__ void __launch_bounds__(THREADS)
rglru_bwd_kernel(const T* __restrict__ dh, const T* __restrict__ a,
                 const float* __restrict__ h, const float* __restrict__ h0,
                 long long h0_stride, T* __restrict__ dx,
                 T* __restrict__ da, float* __restrict__ dh0,
                 float2* __restrict__ summary, Sync sync, int B, int S,
                 int D, int chunk, int n_chunks, Strides ds, Strides as) {
  extern __shared__ float smem[];
  float* sg = smem;                 // (chunk, CW): dh
  float* sa = sg + chunk * CW;      // (chunk, CW): a one step later
  __shared__ float p_part[PARTS][CW], g_part[PARTS][CW];
  __shared__ float p_fold[PARTS][CW], g_fold[PARTS][CW];
  __shared__ int s_job, s_last;

  const int tid = threadIdx.x;
  const int n_cb = (D + CW - 1) / CW;
  if (tid == 0) s_job = atomicAdd(sync.ticket, 1);
  __syncthreads();
  const int job = s_job;
  const int c = n_chunks - 1 - job / (B * n_cb), rest = job % (B * n_cb);
  const int b = rest / n_cb, cb = rest % n_cb;
  const int t0 = c * chunk, n = min(chunk, S - t0);
  const int ch0 = cb * CW;
  int* flags = sync.flags + (long long)(b * n_cb + cb) * n_chunks;

  // -- stage the chunk: dh_t and a_{t+1} ----------------------------------
  {
    const T* dp = dh + b * ds.b + (long long)t0 * ds.s + ch0;
    const T* ap = a + b * as.b + (long long)(t0 + 1) * as.s + ch0;
    for (int idx = tid; idx < chunk * CW; idx += THREADS) {
      const int t = idx / CW, e = idx % CW;
      const bool ok = t < n && ch0 + e < D;
      sg[idx] = ok ? to_f(dp[t * ds.s + e]) : 0.f;
      sa[idx] = ok && t0 + t + 1 < S ? to_f(ap[t * as.s + e]) : 0.f;
    }
  }
  __syncthreads();

  // -- fold each quarter of the chunk backwards from 0 --------------------
  const int j = tid % CW, part = tid / CW;
  const int per = (chunk + PARTS - 1) / PARTS;
  const int lo = part * per, hi = min(n, lo + per);
  {
    float p = 1.f, g = 0.f;
#pragma unroll 8
    for (int t = hi - 1; t >= lo; --t) {
      const float at = sa[t * CW + j];
      g = fmaf(at, g, sg[t * CW + j]);
      p *= at;
    }
    p_part[part][j] = p;
    g_part[part][j] = g;
  }
  __syncthreads();
  const int chn = ch0 + j;
  if (c > 0) {  // publish the chunk's summary
    if (part == 0 && chn < D) {
      float p = 1.f, g = 0.f;
#pragma unroll
      for (int q = PARTS - 1; q >= 0; --q) {
        g = fmaf(p_part[q][j], g, g_part[q][j]);
        p *= p_part[q][j];
      }
      summary[((long long)b * n_chunks + c) * D + chn] = make_float2(p, g);
      __threadfence();
    }
    __syncthreads();
    if (tid == 0) store_release(flags + c, 1);
  }

  // -- the gradient entering the chunk: the later summaries from 0 --------
  for (int q = c + 1 + tid; q < n_chunks; q += THREADS)
    while (load_acquire(flags + q) == 0) {
    }
  __syncthreads();
  {
    // position m counts the later chunks from the last (chunk
    // n_chunks - 1 - m); each of the channel's PARTS threads folds a run
    // of them, then thread 0 folds the runs from 0
    const int n_later = n_chunks - 1 - c;
    const int per_c = (n_later + PARTS - 1) / PARTS;
    const int m_lo = part * per_c, m_hi = min(n_later, m_lo + per_c);
    float p = 1.f, g = 0.f;
    if (chn < D) {
      const float2* sp = summary + (long long)b * n_chunks * D + chn;
      for (int m0 = m_lo; m0 < m_hi; m0 += 8) {
        float2 s8[8];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          s8[e] = m0 + e < m_hi
                      ? __ldcg(sp + (long long)(n_chunks - 1 - m0 - e) * D)
                      : make_float2(1.f, 0.f);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          g = fmaf(s8[e].x, g, s8[e].y);
          p *= s8[e].x;
        }
      }
    }
    p_fold[part][j] = p;
    g_fold[part][j] = g;
  }
  __syncthreads();
  if (part == 0) {
    float g = 0.f;
#pragma unroll
    for (int q = 0; q < PARTS; ++q) g = fmaf(p_fold[q][j], g, g_fold[q][j]);
    // the gradient entering each part of the chunk from its end
#pragma unroll
    for (int q = PARTS - 1; q >= 0; --q) {
      const float pq = p_part[q][j], gq = g_part[q][j];
      p_part[q][j] = g;
      g = fmaf(pq, g, gq);
    }
  }
  __syncthreads();

  // -- rescan backwards from there: dx, da, dh0 ---------------------------
  if (chn < D) {
    float g = p_part[part][j];
    const long long row = (long long)b * S;
#pragma unroll 4
    for (int t = hi - 1; t >= lo; --t) {
      g = fmaf(sa[t * CW + j], g, sg[t * CW + j]);
      const int gt = t0 + t;
      const float hp = gt > 0 ? h[(row + gt - 1) * D + chn]
                              : (h0 ? h0[b * h0_stride + chn] : 0.f);
      dx[(row + gt) * D + chn] = from_f<T>(g);
      da[(row + gt) * D + chn] = from_f<T>(g * hp);
      if (gt == 0 && dh0) dh0[(long long)b * D + chn] = to_f(a[b * as.b + chn]) * g;
    }
  }

  // -- the last block to finish resets the counters and flags -------------
  __syncthreads();
  const int n_blocks = gridDim.x;
  if (tid == 0) s_last = atomicAdd(sync.done, 1) == n_blocks - 1;
  __syncthreads();
  if (s_last) {
    const int n_flags = B * n_cb * n_chunks;
    for (int q = tid; q < n_flags; q += THREADS) sync.flags[q] = 0;
    if (tid == 0) {
      *sync.ticket = 0;
      *sync.done = 0;
    }
  }
}

template <typename T>
int launch(const void* dh, const void* a, const float* h, const float* h0,
           void* dx, void* da, float* dh0, float* ws, int* counters, int B,
           int S, int D, int n_chunks, int chunk, const long long* st,
           cudaStream_t stream) {
  if (chunk < 1 || chunk > MAX_CHUNK) return -1;
  static bool attr_set = false;  // once per instantiation and process
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        rglru_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        2 * MAX_CHUNK * CW * (int)sizeof(float));
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const Strides ds{st[0], st[1]}, as{st[2], st[3]};
  const long long h0s = st[4];
  const int n_cb = (D + CW - 1) / CW;
  const int n_blocks = B * n_cb * n_chunks;
  const size_t bytes = 2 * (size_t)chunk * CW * sizeof(float);
  const Sync sync{counters, counters + 1, counters + 2};
  rglru_bwd_kernel<T><<<n_blocks, THREADS, bytes, stream>>>(
      static_cast<const T*>(dh), static_cast<const T*>(a), h, h0, h0s,
      static_cast<T*>(dx), static_cast<T*>(da), dh0,
      reinterpret_cast<float2*>(ws), sync, B, S, D, chunk, n_chunks, ds, as);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry point: launches on `stream` and returns cudaGetLastError(), or -1
// for a chunk outside 1..256.  is_bf16 selects bfloat16 (1) or float32 (0)
// for dh, a, dx and da.  h is the forward's float32 carry, dense (B, S, D);
// h0 a float32 (B, D) starting state or null (0); dh0 a dense float32
// (B, D) output or null (not wanted).  dx and da are dense (B, S, D).  ws
// holds 2 * B * n_chunks * D floats (the summaries), counters at least
// 2 + B * ceil(D / 32) * n_chunks zeroed ints, which the launch leaves
// zeroed.  strides: 5 element strides, dh (batch, seq), a (batch, seq), h0
// (batch); the channel dimension of all three is contiguous.
extern "C" int rglru_scan_bwd_launch(int is_bf16, const void* dh,
                                     const void* a, const void* h,
                                     const void* h0, void* dx, void* da,
                                     void* dh0, void* ws, void* counters,
                                     int B, int S, int D, int n_chunks,
                                     int chunk, const long long* strides,
                                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* hf = static_cast<const float*>(h);
  const float* h0f = static_cast<const float*>(h0);
  float* dh0f = static_cast<float*>(dh0);
  float* w = static_cast<float*>(ws);
  int* cnt = static_cast<int*>(counters);
  if (is_bf16)
    return launch<__nv_bfloat16>(dh, a, hf, h0f, dx, da, dh0f, w, cnt, B, S,
                                 D, n_chunks, chunk, strides, st);
  return launch<float>(dh, a, hf, h0f, dx, da, dh0f, w, cnt, B, S, D,
                       n_chunks, chunk, strides, st);
}
