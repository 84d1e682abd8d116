// RG-LRU linear recurrence for Hopper (sm_90a).
//
// Replaces the Pallas kernel src/repro/kernels/rglru_scan.py:
// _rglru_kernel.  For x, a (B, S, D):
//   h[b, t, d] = a[b, t, d] * h[b, t - 1, d] + x[b, t, d],
//   h[b, -1, d] = h0[b, d] (a float32 starting state, 0 when none is given)
// with the carry in float32 and the output in x's type.  Inputs are
// float32 or bfloat16 (x and a alike); any B, any S and any D.  x and a
// come with their own (batch, seq) strides, the channel dimension
// contiguous; the output is dense.
//
// Bound: memory bytes.  Two flops per element against one read of x and
// a and one write of h, about 12 bytes per element in float32: far below
// the card's flops per byte, so the least time is those bytes at the
// memory rate.  What costs time is parallelism: one thread per
// (b, channel) walking all of S would keep 20 of the 132 SMs busy at
// B = 1, D = 2560, each thread waiting on one load after another.
//
// Design: one launch that reads x and a once.  The TPU kernel walks S in
// chunks as its innermost sequential grid axis, the carry in VMEM
// scratch.  Here a block owns (b, 32 channels, one chunk of L steps; L is
// the wrapper's, kernels/rglru_scan.py:chunk_plan):
//   * it takes its chunk from an atomic ticket, chunks in order, so every
//     chunk it waits on has already started and the launch cannot
//     deadlock;
//   * it stages its chunk of x and a in shared memory as two boxes by the
//     copy engine (TMA), rows past S zero-filled (4-byte loads and stores
//     where rows are not 16-byte aligned or D is no multiple of 16 bytes);
//   * four threads a channel, each a quarter of the chunk: every thread
//     folds its steps from 0 into (prod a, h_end), the quarters fold into
//     the chunk's summary, which the block writes to the workspace and
//     publishes behind a flag (a fence, then the flag);
//   * the state entering the chunk is the fold of the earlier chunks'
//     summaries in chunk order from h0 (H <- prod_a(c) H + h_end(c)): each
//     of a channel's four threads folds a run of them, and the runs fold
//     in order from h0.  The block waits for all its predecessors' flags
//     and always folds the same way, so the bits do not depend on block
//     timing (a decoupled look-back that took whichever prefix were ready
//     would);
//   * it rescans its chunk out of shared memory from there, writes h over
//     x in shared memory and sends it out as one box by the copy engine;
//   * the last block to finish resets the ticket, the counter of finished
//     blocks and the flags, so the next launch (a CUDA-graph replay too)
//     starts from zero.  The wrapper owns them (zeroed once), and calls on
//     one device must not overlap on two streams.
// A decode step (S = 1) is rglru_step_vec_kernel: h = a h0 + x, a thread
// 16 bytes of channels (rglru_step_kernel, a thread a channel, where rows
// are not 16-byte aligned).  The chunked order of the products (a chunk's state enters as
// prod(a) H_in, not step by step) changes the result only by float32
// rounding.  Offsets are 64-bit.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

#include "mma_bf16.cuh"
#include "tma.cuh"

constexpr int THREADS = 128;
constexpr int CW = 32;                 // channels a block
constexpr int PARTS = THREADS / CW;    // threads a channel
constexpr int MAX_CHUNK = 256;         // steps a chunk at most (a box)

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

// The tensor maps of x, a and the output: (B, S, D) views as dims
// (D, S, B), in boxes of (CW, chunk, 1)
struct Maps {
  CUtensorMap x, a, o;
};

// The launch's shared counters: ticket, finished blocks, then one flag a
// (b, channel block, chunk).
struct Sync {
  int* ticket;
  int* done;
  int* flags;
};

template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS)
rglru_chunk_kernel(const T* __restrict__ x, const T* __restrict__ a,
                   const float* __restrict__ h0, long long h0_stride,
                   T* __restrict__ out, float2* __restrict__ summary,
                   Sync sync, int B, int S, int D, int chunk, int n_chunks,
                   Strides xs, Strides as, const __grid_constant__ Maps maps) {
  extern __shared__ __align__(128) unsigned char smem[];
  T* sx = reinterpret_cast<T*>(smem);              // (chunk, CW), then h
  T* sa = sx + (long long)chunk * CW;              // (chunk, CW)
  __shared__ float p_part[PARTS][CW], h_part[PARTS][CW];
  __shared__ float p_fold[PARTS][CW], h_fold[PARTS][CW];
  __shared__ int s_job, s_last;
  __shared__ __align__(8) uint64_t landed;

  const int tid = threadIdx.x;
  const int n_cb = (D + CW - 1) / CW;
  if (tid == 0) s_job = atomicAdd(sync.ticket, 1);
  __syncthreads();
  const int job = s_job;
  const int c = job / (B * n_cb), rest = job % (B * n_cb);
  const int b = rest / n_cb, cb = rest % n_cb;
  const int t0 = c * chunk, n = min(chunk, S - t0);
  const int ch0 = cb * CW;
  int* flags = sync.flags + (long long)(b * n_cb + cb) * n_chunks;

  // -- stage the chunk ----------------------------------------------------
  if constexpr (VEC) {
    // two boxes by the copy engine (rows past S and channels past D read
    // as 0)
    if (tid == 0) {
      mbar_init(&landed, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      mbar_expect(&landed, 2 * chunk * CW * (int)sizeof(T));
      tma_load(sx, &maps.x, ch0, t0, b, &landed);
      tma_load(sa, &maps.a, ch0, t0, b, &landed);
    }
    __syncthreads();  // the barrier is made before anyone waits on it
    mbar_wait(&landed, 0);
  } else {
    const T* xp = x + b * xs.b + (long long)t0 * xs.s + ch0;
    const T* ap = a + b * as.b + (long long)t0 * as.s + ch0;
    for (int idx = tid; idx < chunk * CW; idx += THREADS) {
      const int t = idx / CW, e = idx % CW;
      const bool ok = t < n && ch0 + e < D;
      sx[idx] = ok ? xp[t * xs.s + e] : from_f<T>(0.f);
      sa[idx] = ok ? ap[t * as.s + e] : from_f<T>(0.f);
    }
  }
  __syncthreads();

  // -- fold each quarter of the chunk from 0 ------------------------------
  const int j = tid % CW, part = tid / CW;
  const int per = (chunk + PARTS - 1) / PARTS;
  const int lo = part * per, hi = min(n, lo + per);
  {
    float p = 1.f, h = 0.f;
#pragma unroll 8
    for (int t = lo; t < hi; ++t) {
      const float at = to_f(sa[t * CW + j]);
      h = fmaf(at, h, to_f(sx[t * CW + j]));
      p *= at;
    }
    p_part[part][j] = p;
    h_part[part][j] = h;
  }
  __syncthreads();
  const int chn = ch0 + j;
  if (c + 1 < n_chunks) {  // publish the chunk's summary
    if (part == 0 && chn < D) {
      float p = 1.f, h = 0.f;
#pragma unroll
      for (int q = 0; q < PARTS; ++q) {
        h = fmaf(p_part[q][j], h, h_part[q][j]);
        p *= p_part[q][j];
      }
      summary[((long long)b * n_chunks + c) * D + chn] = make_float2(p, h);
      __threadfence();
    }
    __syncthreads();
    if (tid == 0) store_release(flags + c, 1);
  }

  // -- the state entering the chunk: the earlier summaries from h0 --------
  for (int q = tid; q < c; q += THREADS)
    while (load_acquire(flags + q) == 0) {
    }
  __syncthreads();
  {
    // each of the channel's PARTS threads folds a run of the summaries
    // (loads in flight together), then thread 0 folds the runs from h0
    const int per_c = (c + PARTS - 1) / PARTS;
    const int q_lo = part * per_c, q_hi = min(c, q_lo + per_c);
    float p = 1.f, h = 0.f;
    if (chn < D) {
      const float2* sp = summary + (long long)b * n_chunks * D + chn;
      for (int q0 = q_lo; q0 < q_hi; q0 += 8) {
        float2 s8[8];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          s8[e] = q0 + e < q_hi ? __ldcg(sp + (long long)(q0 + e) * D)
                                : make_float2(1.f, 0.f);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          h = fmaf(s8[e].x, h, s8[e].y);
          p *= s8[e].x;
        }
      }
    }
    p_fold[part][j] = p;
    h_fold[part][j] = h;
  }
  __syncthreads();
  if (part == 0) {
    float h = (h0 && chn < D) ? h0[b * h0_stride + chn] : 0.f;
#pragma unroll
    for (int q = 0; q < PARTS; ++q) h = fmaf(p_fold[q][j], h, h_fold[q][j]);
    // the state entering each part of the chunk
#pragma unroll
    for (int q = 0; q < PARTS; ++q) {
      const float pq = p_part[q][j], hq = h_part[q][j];
      p_part[q][j] = h;
      h = fmaf(pq, h, hq);
    }
  }
  __syncthreads();

  // -- rescan from there, h over x in shared memory -----------------------
  {
    float h = p_part[part][j];
#pragma unroll 8
    for (int t = lo; t < hi; ++t) {
      h = fmaf(to_f(sa[t * CW + j]), h, to_f(sx[t * CW + j]));
      sx[t * CW + j] = from_f<T>(h);
    }
  }
  // the block's stores to shared memory made visible to the copy engine
  if constexpr (VEC)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  if constexpr (VEC) {
    // one box out by the copy engine (rows past S and channels past D are
    // not written)
    if (tid == 0) {
      asm volatile(
          "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group "
          "[%0, {%1, %2, %3}], [%4];\n" ::"l"(
              reinterpret_cast<uint64_t>(&maps.o)),
          "r"(ch0), "r"(t0), "r"(b), "r"(smem_addr(sx))
          : "memory");
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    }
  } else {
    T* op = out + ((long long)b * S + t0) * D + ch0;
    for (int idx = tid; idx < n * CW; idx += THREADS) {
      const int t = idx / CW, e = idx % CW;
      if (ch0 + e < D) op[(long long)t * D + e] = sx[idx];
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
__global__ void __launch_bounds__(THREADS)
rglru_step_kernel(const T* __restrict__ x, const T* __restrict__ a,
                  const float* __restrict__ h0, long long h0_stride,
                  T* __restrict__ out, int D, Strides xs, Strides as) {
  const int d = blockIdx.x * THREADS + threadIdx.x, b = blockIdx.y;
  if (d >= D) return;
  const float h = h0 ? h0[b * h0_stride + d] : 0.f;
  out[(long long)b * D + d] =
      from_f<T>(fmaf(to_f(a[b * as.b + d]), h, to_f(x[b * xs.b + d])));
}

// A decode step where rows are 16-byte aligned: a thread 16 bytes of x, a
// and h (4 float32 or 8 bfloat16 channels) and the float32 h0 beside them.
constexpr int STEP_THREADS = 64;

template <typename T>
__global__ void __launch_bounds__(STEP_THREADS)
rglru_step_vec_kernel(const T* __restrict__ x, const T* __restrict__ a,
                      const float* __restrict__ h0, long long h0_stride,
                      T* __restrict__ out, int D, Strides xs, Strides as) {
  constexpr int EP = 16 / (int)sizeof(T);
  const int d = (blockIdx.x * STEP_THREADS + threadIdx.x) * EP;
  const int b = blockIdx.y;
  if (d >= D) return;
  union Piece {
    uint4 u;
    T e[EP];
  };
  Piece px, pa, po;
  px.u = *reinterpret_cast<const uint4*>(x + b * xs.b + d);
  pa.u = *reinterpret_cast<const uint4*>(a + b * as.b + d);
  float hh[EP];
#pragma unroll
  for (int q = 0; q < EP; q += 4) {
    float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
    if (h0) f = *reinterpret_cast<const float4*>(h0 + b * h0_stride + d + q);
    hh[q] = f.x; hh[q + 1] = f.y; hh[q + 2] = f.z; hh[q + 3] = f.w;
  }
#pragma unroll
  for (int q = 0; q < EP; ++q)
    po.e[q] = from_f<T>(fmaf(to_f(pa.e[q]), hh[q], to_f(px.e[q])));
  *reinterpret_cast<uint4*>(out + (long long)b * D + d) = po.u;
}

template <typename T>
int launch(const void* x, const void* a, const float* h0, void* out,
           float* ws, int* counters, int vec, int B, int S, int D,
           int n_chunks, int chunk, const long long* st,
           cudaStream_t stream) {
  const Strides xs{st[0], st[1]}, as{st[2], st[3]};
  const long long h0s = st[4];
  const T* xt = static_cast<const T*>(x);
  const T* at = static_cast<const T*>(a);
  T* o = static_cast<T*>(out);
  if (S == 1) {
    if (vec) {
      constexpr int EP = 16 / (int)sizeof(T);
      const int n_pieces = (D + EP - 1) / EP;
      rglru_step_vec_kernel<T><<<dim3((n_pieces + STEP_THREADS - 1) /
                                          STEP_THREADS, B),
                                 STEP_THREADS, 0, stream>>>(
          xt, at, h0, h0s, o, D, xs, as);
    } else {
      rglru_step_kernel<T><<<dim3((D + THREADS - 1) / THREADS, B), THREADS,
                             0, stream>>>(xt, at, h0, h0s, o, D, xs, as);
    }
    return (int)cudaGetLastError();
  }
  if (chunk < 1 || chunk > MAX_CHUNK) return -1;
  static bool attr_set = false;  // once per instantiation and process
  if (!attr_set) {
    const int max_bytes = 2 * MAX_CHUNK * CW * (int)sizeof(T);
    cudaError_t e = cudaFuncSetAttribute(
        rglru_chunk_kernel<T, true>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, max_bytes);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(rglru_chunk_kernel<T, false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               max_bytes);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const int n_cb = (D + CW - 1) / CW;
  const int n_blocks = B * n_cb * n_chunks;
  const size_t bytes = 2 * (size_t)chunk * CW * sizeof(T);
  const Sync sync{counters, counters + 1, counters + 2};
  float2* summary = reinterpret_cast<float2*>(ws);
  Maps m{};
  if (vec) {
    const unsigned long long dims[3] = {(unsigned long long)D,
                                        (unsigned long long)S,
                                        (unsigned long long)B};
    const long long sx_[3] = {1, xs.s, xs.b}, sa_[3] = {1, as.s, as.b};
    const unsigned box[3] = {(unsigned)CW, (unsigned)chunk, 1};
    constexpr bool bf16 = sizeof(T) == 2;
    const long long so_[3] = {1, D, (long long)S * D};
    if (!encode_map(&m.x, x, bf16, 3, dims, sx_, box) ||
        !encode_map(&m.a, a, bf16, 3, dims, sa_, box) ||
        !encode_map(&m.o, out, bf16, 3, dims, so_, box))
      return -2;
    rglru_chunk_kernel<T, true><<<n_blocks, THREADS, bytes, stream>>>(
        xt, at, h0, h0s, o, summary, sync, B, S, D, chunk, n_chunks, xs, as,
        m);
  } else {
    rglru_chunk_kernel<T, false><<<n_blocks, THREADS, bytes, stream>>>(
        xt, at, h0, h0s, o, summary, sync, B, S, D, chunk, n_chunks, xs, as,
        m);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// C entry point: launches on `stream` and returns cudaGetLastError(), -2
// if the tensor maps of x and a cannot be made, or -1 for a chunk outside
// 1..256.  is_bf16 selects bfloat16 (1) or
// float32 (0) for x, a and out.  h0 is a float32 (B, D) starting state or
// null (start from 0).  out is a dense (B, S, D) tensor.  With S > 1: ws
// holds 2 * B * n_chunks * D floats (the summaries), counters at least
// 2 + B * ceil(D / 32) * n_chunks zeroed ints, which the launch leaves
// zeroed; vec (1) says that x's and a's rows (and, for S = 1, h0's) start
// 16-byte aligned and D is a multiple of 16 bytes of elements, so that
// chunks come in and go out by the copy engine, or a decode step moves 16
// bytes a thread.
// strides: 5 element strides, x (batch, seq), a (batch, seq), h0 (batch);
// the channel dimension of all three is contiguous.
extern "C" int rglru_scan_launch(int is_bf16, const void* x, const void* a,
                                 const void* h0, void* out, void* ws,
                                 void* counters, int vec, int B, int S,
                                 int D, int n_chunks, int chunk,
                                 const long long* strides, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(ws);
  int* cnt = static_cast<int*>(counters);
  const float* h = static_cast<const float*>(h0);
  if (is_bf16)
    return launch<__nv_bfloat16>(x, a, h, out, w, cnt, vec, B, S, D,
                                 n_chunks, chunk, strides, st);
  return launch<float>(x, a, h, out, w, cnt, vec, B, S, D, n_chunks, chunk,
                       strides, st);
}
