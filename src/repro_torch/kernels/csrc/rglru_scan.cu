// RG-LRU linear recurrence for Hopper (sm_90a).
//
// Replaces the Pallas kernel src/repro/kernels/rglru_scan.py:
// _rglru_kernel.  For x, a (B, S, D):
//   h[b, t, d] = a[b, t, d] * h[b, t - 1, d] + x[b, t, d],
//   h[b, -1, d] = h0[b, d] (a float32 starting state, 0 when none is given)
// with the carry in float32 and the output in x's type.  A decode step
// (S = 1) is then one launch of the last kernel below: h = a h0 + x.  Inputs are
// float32 or bfloat16 (x and a alike); any B, any S (1 and ragged
// lengths included) and any D: the TPU kernel's S % chunk == 0 and
// D % 128 == 0 are not carried.  x and a come with their own (batch,
// seq) strides, the channel dimension contiguous; the output is dense.
//
// Bound: memory bytes.  Two flops per element against one read of x and
// a and one write of h, about 12 bytes per element in float32: far below
// the card's flops per byte, so the least time is those bytes at the
// memory rate.  What costs time is parallelism: one thread per
// (b, channel) walking all of S would keep 20 of the 132 SMs busy at
// B = 1, D = 2560, each thread waiting on one load after another.
//
// Design.  The TPU kernel walks S in chunks as its innermost sequential
// grid axis, the carry in VMEM scratch.  Here the chunks run in
// parallel, in three launches on one stream:
//   * rglru_summary_kernel: grid (channel blocks, n_chunks - 1, B), one
//     thread per channel; each walks its chunk from h = 0 and writes the
//     chunk's product of a and its end state (float2) to a workspace;
//   * rglru_carry_kernel: one thread per (b, channel) walks the chunk
//     summaries in order from H_in(0) = h0, H_in(c + 1) = prod_a(c) *
//     H_in(c) + h_end(c), and writes the state entering every chunk;
//   * rglru_scan_kernel: grid (channel blocks, n_chunks, B); each thread
//     walks its chunk again from the state entering it and writes h.
// With one chunk (decode, S = 1) only the last kernel runs, from h0.
// Neighbouring threads read neighbouring channels, so every load and
// store of a warp is one coalesced 128-byte (float32) or 64-byte (bf16)
// access; the loop is unrolled so that several steps' loads are in
// flight, since they do not depend on h.  x and a are read twice (the
// summary and the scan), h written once: 5/3 of the bound's bytes in
// float32.  The chunk length is the wrapper's: chunks are cut so that
// the grid fills the card several times over.  The chunked order of the
// products (a chunk's state enters as prod(a) * H_in, not step by step)
// changes the result only by float32 rounding.
// Offsets are 64-bit.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;

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
  long long b, s;
};

// the state entering the sequence: h0[b * h0_stride + d], or 0
__device__ __forceinline__ float start(const float* h0, long long h0_stride,
                                       int b, int d) {
  return h0 ? h0[b * h0_stride + d] : 0.f;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
rglru_summary_kernel(const T* __restrict__ x, const T* __restrict__ a,
                     float2* __restrict__ summary, int S, int D, int chunk,
                     int n_chunks, Strides xs, Strides as) {
  const int d = blockIdx.x * THREADS + threadIdx.x;
  const int c = blockIdx.y, b = blockIdx.z;
  if (d >= D) return;
  const int t0 = c * chunk, n = min(chunk, S - t0);
  const T* xp = x + b * xs.b + (long long)t0 * xs.s + d;
  const T* ap = a + b * as.b + (long long)t0 * as.s + d;
  float h = 0.f, p = 1.f;
#pragma unroll 8
  for (int t = 0; t < n; ++t) {
    const float at = to_f(ap[(long long)t * as.s]);
    h = fmaf(at, h, to_f(xp[(long long)t * xs.s]));
    p *= at;
  }
  summary[((long long)b * n_chunks + c) * D + d] = make_float2(p, h);
}

__global__ void __launch_bounds__(THREADS)
rglru_carry_kernel(const float2* __restrict__ summary,
                   const float* __restrict__ h0, long long h0_stride,
                   float* __restrict__ carry, int D, int n_chunks) {
  const int d = blockIdx.x * THREADS + threadIdx.x, b = blockIdx.y;
  if (d >= D) return;
  const long long base = (long long)b * n_chunks * D + d;
  float h = start(h0, h0_stride, b, d);
  carry[base] = h;
  for (int c = 0; c + 1 < n_chunks; ++c) {
    const float2 ph = summary[base + (long long)c * D];
    h = fmaf(ph.x, h, ph.y);
    carry[base + (long long)(c + 1) * D] = h;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
rglru_scan_kernel(const T* __restrict__ x, const T* __restrict__ a,
                  const float* __restrict__ carry,
                  const float* __restrict__ h0, long long h0_stride,
                  T* __restrict__ out, int S, int D, int chunk,
                  int n_chunks, Strides xs, Strides as) {
  const int d = blockIdx.x * THREADS + threadIdx.x;
  const int c = blockIdx.y, b = blockIdx.z;
  if (d >= D) return;
  const int t0 = c * chunk, n = min(chunk, S - t0);
  const T* xp = x + b * xs.b + (long long)t0 * xs.s + d;
  const T* ap = a + b * as.b + (long long)t0 * as.s + d;
  T* op = out + ((long long)b * S + t0) * D + d;
  float h = carry ? carry[((long long)b * n_chunks + c) * D + d]
                  : start(h0, h0_stride, b, d);
#pragma unroll 8
  for (int t = 0; t < n; ++t) {
    h = fmaf(to_f(ap[(long long)t * as.s]), h, to_f(xp[(long long)t * xs.s]));
    op[(long long)t * D] = from_f<T>(h);
  }
}

template <typename T>
int launch(const void* x, const void* a, const float* h0, void* out,
           float* ws, int B, int S, int D, int n_chunks, int chunk,
           const long long* st, cudaStream_t stream) {
  const Strides xs{st[0], st[1]}, as{st[2], st[3]};
  const long long h0s = st[4];
  const int n_db = (D + THREADS - 1) / THREADS;
  const T* xt = static_cast<const T*>(x);
  const T* at = static_cast<const T*>(a);
  float* carry = nullptr;
  if (n_chunks > 1) {
    // ws: B * n_chunks * D float2 summaries, then as many float carries
    float2* summary = reinterpret_cast<float2*>(ws);
    carry = ws + 2LL * B * n_chunks * D;
    rglru_summary_kernel<T><<<dim3(n_db, n_chunks - 1, B), THREADS, 0,
                              stream>>>(xt, at, summary, S, D, chunk,
                                        n_chunks, xs, as);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    rglru_carry_kernel<<<dim3(n_db, B), THREADS, 0, stream>>>(
        summary, h0, h0s, carry, D, n_chunks);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  rglru_scan_kernel<T><<<dim3(n_db, n_chunks, B), THREADS, 0, stream>>>(
      xt, at, carry, h0, h0s, static_cast<T*>(out), S, D, chunk, n_chunks,
      xs, as);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry point: launches on `stream` and returns cudaGetLastError().
// is_bf16 selects bfloat16 (1) or float32 (0) for x, a and out.  h0 is a
// float32 (B, D) starting state or null (start from 0).  out is a dense
// (B, S, D) tensor.  With n_chunks > 1, ws holds 3 * B * n_chunks * D
// floats.  strides: 5 element strides, x (batch, seq), a (batch, seq), h0
// (batch); the channel dimension of all three is contiguous.
extern "C" int rglru_scan_launch(int is_bf16, const void* x, const void* a,
                                 const void* h0, void* out, void* ws, int B,
                                 int S, int D, int n_chunks, int chunk,
                                 const long long* strides, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(ws);
  const float* h = static_cast<const float*>(h0);
  if (is_bf16)
    return launch<__nv_bfloat16>(x, a, h, out, w, B, S, D, n_chunks, chunk,
                                 strides, st);
  return launch<float>(x, a, h, out, w, B, S, D, n_chunks, chunk, strides,
                       st);
}
