// RWKV-6 WKV recurrence for Hopper (sm_90a).
//
// Replaces the Pallas kernel src/repro/kernels/rwkv6_scan.py:_wkv6_kernel.
// For r, k, v, logw (B, S, H, d) and u (H, d), per (b, h) a d x d float32
// state S (rows i index k, columns j index v) is carried over the sequence:
//   y[t, j] = sum_i r[t, i] (S[i, j] + u[i] k[t, i] v[t, j])
//   S[i, j] <- exp(logw[t, i]) S[i, j] + k[t, i] v[t, j]
// from S = s0 (a float32 (B, H, d, d) state, 0 when none is given); the
// final S is written to s_last.  y comes out in r's type, the carry is
// float32.  r, k and v are float32 or bfloat16 alike, logw and u float32;
// d is 16, 32, 64 or 128; any B and any S (1 and ragged lengths included:
// the TPU kernel's S % chunk == 0 is not carried).  r, k, v and logw come
// as (B, S, H, d) views with their own (batch, seq, head) strides and the
// last dimension contiguous; y and s_last are dense.  A decode step
// (S = 1) is one launch from s0.
//
// Bound: operations.  A token and head needs 5 d^2 float32 flops (r S: one
// FMA per state element; the update: a product k v and an FMA), 20 k at
// d = 64, against 3 d r/k/v values and d logw values read and d outputs
// written: about 40 flops per byte in bf16, over the card's float32 rate
// per byte outside the tensor cores (67e12 / 3.35e12 = 20).  This kernel
// does 7 d^2 (the bonus is folded into each element's FMA).
//
// Design.  The TPU kernel evaluates the chunked (GLA) form on the MXU,
// the state carried in VMEM across its sequential chunk axis, with
// exponents recentred per chunk so that float32 does not overflow.  Here
// the recurrence is evaluated step by step, which needs no recentring
// (every factor exp(logw) is at most 1) and no padding, with the state in
// registers:
//   * a block owns (b, h, 16 value columns): the columns of S are
//     independent (y[:, j] and S[:, j] read only v[:, j]), so d / 16
//     blocks share a head with no carry between them: 256 blocks at
//     B = 1, H = 64, d = 64, where one block a head would leave 68 of the
//     132 SMs idle;
//   * 8 neighbouring lanes share a column, each holding d / 8 rows of it
//     (8 floats at d = 64) in registers;
//   * the sequence is walked in stages of CH steps (32, or 16 at
//     d = 128): the block stages r, k, exp(logw) and its v columns in
//     shared memory, fetched with coalesced loads into registers one
//     stage ahead, so that device memory's latency hides behind the
//     stage before; then every thread walks the stage with no barrier:
//     per step and row a product k v, two FMAs for y (the bonus u k v
//     folded in) and one for S, its rows read as 16-byte vectors from a
//     padded layout free of bank conflicts;
//   * y[t, j] is the sum of the column's 8 threads' partials: each thread
//     keeps 8 steps' partials and a reduce-scatter over the 8 lanes (7
//     shuffles) leaves lane g with step g's total, which it writes.  A
//     ragged last stage stops at S.
// Each block reads its head's r, k and logw (d / 16 blocks read them
// alike; the L2 serves the repeats).  The tensor-core chunked form is
// left for later.  Offsets are 64-bit.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int G = 8;        // threads per value column
constexpr int JC = 16;      // value columns per block
constexpr int THREADS = G * JC;

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
  long long b, s, h;
};

struct Args {
  Strides r, k, v, w;
  long long s0_b, s0_h;
};

template <int D>
struct Plan {
  static constexpr int R = D / G;                 // rows per thread
  static constexpr int PAD = R >= 8 ? 4 : 0;      // floats after each
                                                  // thread's rows
  static constexpr int RS = G * (R + PAD);        // floats per staged step
  static constexpr int CH = D <= 64 ? 32 : 16;    // steps per stage
  static constexpr int E = CH * D / THREADS;      // r, k, logw elements
                                                  // a thread stages
  static constexpr int EV = CH * JC / THREADS;    // v elements likewise
};

// R consecutive floats of shared memory into registers, as 16-byte (or
// 8-byte) vectors
template <int R>
__device__ __forceinline__ void load_rows(const float* p, float (&out)[R]) {
  if constexpr (R % 4 == 0) {
#pragma unroll
    for (int m = 0; m < R; m += 4) {
      const float4 q = *reinterpret_cast<const float4*>(p + m);
      out[m] = q.x; out[m + 1] = q.y; out[m + 2] = q.z; out[m + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int m = 0; m < R; m += 2) {
      const float2 q = *reinterpret_cast<const float2*>(p + m);
      out[m] = q.x; out[m + 1] = q.y;
    }
  }
}

// Across the 8 lanes of a column (lane & 7 = g), given each lane's 8
// partial sums acc[q] of steps q = 0..7: returns the total of step g.  A
// reduce-scatter in three rounds (4, 2 and 1 shuffles) instead of three
// shuffles for every step.
__device__ __forceinline__ float reduce_scatter8(const float (&acc)[8],
                                                 int g) {
  float a4[4], a2[2];
  const bool hi4 = g & 4, hi2 = g & 2, hi1 = g & 1;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float send = hi4 ? acc[q] : acc[q + 4];
    const float keep = hi4 ? acc[q + 4] : acc[q];
    a4[q] = keep + __shfl_xor_sync(0xffffffffu, send, 4);
  }
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const float send = hi2 ? a4[q] : a4[q + 2];
    const float keep = hi2 ? a4[q + 2] : a4[q];
    a2[q] = keep + __shfl_xor_sync(0xffffffffu, send, 2);
  }
  const float send = hi1 ? a2[0] : a2[1];
  const float keep = hi1 ? a2[1] : a2[0];
  return keep + __shfl_xor_sync(0xffffffffu, send, 1);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
            const T* __restrict__ v, const float* __restrict__ logw,
            const float* __restrict__ u, const float* __restrict__ s0,
            T* __restrict__ y, float* __restrict__ s_last, int S, int H,
            Args a) {
  using P = Plan<D>;
  constexpr int R = P::R, RS = P::RS, CH = P::CH, E = P::E, EV = P::EV;
  __shared__ __align__(16) float sr[CH * RS];
  __shared__ __align__(16) float sk[CH * RS];
  __shared__ __align__(16) float sw[CH * RS];
  __shared__ float sv[CH * JC];

  const int tid = threadIdx.x;
  const int c = tid / G, g = tid % G;           // column, row group
  const int j0 = blockIdx.x * JC;
  const int h = blockIdx.y, b = blockIdx.z;
  const int j = j0 + c;

  const T* rp = r + b * a.r.b + h * a.r.h;
  const T* kp = k + b * a.k.b + h * a.k.h;
  const T* vp = v + b * a.v.b + h * a.v.h + j0;
  const float* wp = logw + b * a.w.b + h * a.w.h;
  T* yp = y + (long long)b * S * H * D + (long long)h * D + j;

  // this thread's rows g * R + m of column j, and u of those rows
  float st[R], uu[R];
#pragma unroll
  for (int m = 0; m < R; ++m) {
    const int i = g * R + m;
    st[m] = s0 ? s0[b * a.s0_b + h * a.s0_h + (long long)i * D + j] : 0.f;
    uu[m] = u[(long long)h * D + i];
  }

  // a stage's inputs, fetched into registers one stage ahead (element
  // tid + THREADS e is step / D, row % D; v's is step / JC, column % JC)
  T pr[E], pk[E], pv[EV];
  float pw[E];
  auto fetch = [&](int t0) {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int idx = tid + THREADS * e;
      const long long ts = t0 + idx / D;
      const int i = idx % D;
      if (ts < S) {
        pr[e] = rp[ts * a.r.s + i];
        pk[e] = kp[ts * a.k.s + i];
        pw[e] = wp[ts * a.w.s + i];
      }
    }
#pragma unroll
    for (int e = 0; e < EV; ++e) {
      const int idx = tid + THREADS * e;
      const long long ts = t0 + idx / JC;
      if (ts < S) pv[e] = vp[ts * a.v.s + idx % JC];
    }
  };

  fetch(0);
  for (int t0 = 0; t0 < S; t0 += CH) {
    const int n = min(CH, S - t0);
    __syncthreads();  // the previous stage is read
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int idx = tid + THREADS * e;
      const int t = idx / D, i = idx % D;
      if (t < n) {
        const int at = t * RS + (i / R) * (R + P::PAD) + i % R;
        sr[at] = to_f(pr[e]);
        sk[at] = to_f(pk[e]);
        sw[at] = expf(pw[e]);
      }
    }
#pragma unroll
    for (int e = 0; e < EV; ++e) {
      const int idx = tid + THREADS * e;
      if (idx / JC < n) sv[idx] = to_f(pv[e]);
    }
    __syncthreads();
    if (t0 + CH < S) fetch(t0 + CH);  // in flight during the stage
    // the recurrence over the stage, 8 steps at a time; no barrier inside
    for (int tb = 0; tb < n; tb += 8) {
      float acc[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int t = tb + q;
        acc[q] = 0.f;
        if (t < n) {
          float rr[R], kk[R], ww[R];
          const int at = t * RS + g * (R + P::PAD);
          load_rows<R>(sr + at, rr);
          load_rows<R>(sk + at, kk);
          load_rows<R>(sw + at, ww);
          const float vj = sv[t * JC + c];
#pragma unroll
          for (int m = 0; m < R; ++m) {
            const float kv = kk[m] * vj;
            acc[q] = fmaf(rr[m], fmaf(uu[m], kv, st[m]), acc[q]);
            st[m] = fmaf(ww[m], st[m], kv);
          }
        }
      }
      const float yt = reduce_scatter8(acc, g);
      if (tb + g < n) yp[(long long)(t0 + tb + g) * H * D] = from_f<T>(yt);
    }
  }
#pragma unroll
  for (int m = 0; m < R; ++m)
    s_last[((long long)b * H + h) * D * D + (long long)(g * R + m) * D + j] =
        st[m];
}

template <typename T, int D>
int launch(const void* r, const void* k, const void* v, const float* logw,
           const float* u, const float* s0, void* y, float* s_last, int B,
           int S, int H, const Args& a, cudaStream_t stream) {
  wkv6_kernel<T, D><<<dim3(D / JC, H, B), THREADS, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), logw, u, s0, static_cast<T*>(y), s_last, S,
      H, a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(int D, const void* r, const void* k, const void* v,
             const float* logw, const float* u, const float* s0, void* y,
             float* s_last, int B, int S, int H, const Args& a,
             cudaStream_t st) {
  switch (D) {
    case 16: return launch<T, 16>(r, k, v, logw, u, s0, y, s_last, B, S, H, a, st);
    case 32: return launch<T, 32>(r, k, v, logw, u, s0, y, s_last, B, S, H, a, st);
    case 64: return launch<T, 64>(r, k, v, logw, u, s0, y, s_last, B, S, H, a, st);
    case 128: return launch<T, 128>(r, k, v, logw, u, s0, y, s_last, B, S, H, a, st);
    default: return -1;
  }
}

}  // namespace

// C entry point: launches on `stream` and returns cudaGetLastError(), or
// -1 for a head dim other than 16, 32, 64 and 128.  is_bf16 selects
// bfloat16 (1) or float32 (0) for r, k, v and y.  logw is float32 with
// r's shape, u a dense float32 (H, d), s0 a float32 (B, H, d, d) state
// with the last two dimensions dense, or null (start from 0).  y is a
// dense (B, S, H, d) tensor, s_last a dense float32 (B, H, d, d).
// strides: 14 element strides: r, k, v and logw (batch, seq, head) each,
// then s0 (batch, head).
extern "C" int wkv6_launch(int is_bf16, int D, const void* r, const void* k,
                           const void* v, const void* logw, const void* u,
                           const void* s0, void* y, void* s_last, int B,
                           int S, int H, const long long* st, void* stream) {
  const Args a{{st[0], st[1], st[2]}, {st[3], st[4], st[5]},
               {st[6], st[7], st[8]}, {st[9], st[10], st[11]}, st[12],
               st[13]};
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  const float* lw = static_cast<const float*>(logw);
  const float* uu = static_cast<const float*>(u);
  const float* s = static_cast<const float*>(s0);
  float* sl = static_cast<float*>(s_last);
  if (is_bf16)
    return launch_d<__nv_bfloat16>(D, r, k, v, lw, uu, s, y, sl, B, S, H, a,
                                   cs);
  return launch_d<float>(D, r, k, v, lw, uu, s, y, sl, B, S, H, a, cs);
}
