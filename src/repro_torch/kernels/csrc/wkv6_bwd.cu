// The RWKV-6 WKV recurrence's backward for Hopper (sm_90a).
//
// The gradient of wkv6.cu's recurrence, which the reference leaves to
// jax.grad of src/repro/models/rwkv6.py:wkv6_chunked.  Per (b, h), with S_t
// the d x d float32 state before step t (rows i index k, columns j index
// v) and w_t = exp(logw_t):
//   y_t = r_t (S_t + diag(u) k_t v_t^T),  S_{t+1} = diag(w_t) S_t + k_t v_t^T.
// Given dy (y's cotangent) and ds_last (s_last's, or none), walking back
// from dS_S = ds_last (or 0):
//   dr_t = (S_t + diag(u) k_t v_t^T) dy_t
//   dk_t = (u o r_t)(v_t . dy_t) + dS_{t+1} v_t
//   dv_t = (r_t . (u o k_t)) dy_t + dS_{t+1}^T k_t
//   dlogw_t = w_t o rowsum(S_t o dS_{t+1})
//   du = sum_t r_t o k_t (v_t . dy_t)
//   dS_t = diag(w_t) dS_{t+1} + r_t dy_t^T,  ds0 = dS_0.
// r, k, v and dy are float32 or bfloat16 alike (dr, dk and dv come out in
// that type), logw and u float32 (dlogw and du float32), s0, ds_last and
// ds0 float32 (B, H, d, d); d is 16, 32, 64 or 128.  r, k, v, logw and dy
// come as (B, S, H, d) views with their own (batch, seq, head) strides,
// the last dimension contiguous; the outputs are dense.
//
// Design: the serial form on the CUDA cores, in float32 throughout.  It
// only ever multiplies a state or its gradient by w <= 1, so it stays
// finite for any logw <= 0 with no guard (the forward's chunked form needs
// TOTAL_MIN and FACTOR_MAX for its recentred factors; this has none), and
// it never rebuilds S_t by dividing by w.  A block owns (b, h, VB value
// columns J), d x VB threads, one state element S[i, j] and its gradient
// dS[i, j] each (thread i * VB + j): the columns of S are independent, so
// the d / VB blocks of a head share nothing but the sums over j below.
//   1. a walk forward over the sequence in chunks of C = 16 steps writes
//      the state entering each chunk to a checkpoint buffer (each thread
//      its own element, read back by the same thread in 2);
//   2. a walk back over the chunks, last first: the chunk's states are
//      recomputed forward from its checkpoint into registers (C a thread),
//      then its steps are walked back with dS in a register.  Each step's
//      sums over j (dr, dk, dlogw) are butterflies over the VB lanes of a
//      row (every lane ends with the same sum); its sum over i (dv) is a
//      butterfly over a warp's rows, then the warps' sums are added in
//      warp order when the chunk's outputs are written.
// dv sums all d rows and comes out whole.  dr, dk and dlogw sum only J:
// each block writes its float32 partials, and wkv6_bwd_reduce_kernel adds
// the d / VB partials in column-block order (and du over the batch and the
// column blocks) and casts: a fixed order and no atomics, so the bits do
// not depend on block timing.
//
// Bound: operations.  Per token and head about 12 d^2 float32 flops (the
// two state recomputes, dr, dk, dv, dlogw and the dS update, 2 d^2 each),
// 13.1 GFLOP at rwkv6-7b's training shape (4 x 1024 tokens, 64 heads of
// 64): 0.19 ms at the CUDA cores' peak, against 0.11 ms for the bytes.
// The walks are serial in S, and each step's butterflies are a chain of
// dependent shuffles: this simple form is far from that bound (PERF.md).
// Offsets are 64-bit.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int C = 16;  // steps a chunk

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

// (batch, seq, head) element strides of one (B, S, H, d) input
struct Strides {
  long long b, s, h;
};

struct Inputs {
  Strides r, k, v, w, dy;
};

// Stage chunk c's steps of one head in shared memory as float32: r, k and
// w = exp(logw) (C x d), the block's columns of v and dy (C x VB), and per
// step v . dy over those columns and r . (u o k) over all rows.  Steps past
// S read as r = k = v = dy = 0 and w = 1: they leave S and dS as they are.
// With full == false only k, w and v (the forward walk's).
template <typename T, int D, int VB>
__device__ __forceinline__ void stage(
    const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ logw, const T* __restrict__ dy,
    const Inputs& st, int b, int h, int jb, int t0, int S, bool full,
    const float* su, float* sr, float* sk, float* sw, float* sv, float* sdy,
    float* svdy, float* sruk) {
  constexpr int NT = D * VB;
  const int tid = threadIdx.x;
  for (int idx = tid; idx < C * D; idx += NT) {
    const int t = idx / D, i = idx % D, gt = t0 + t;
    const bool ok = gt < S;
    const long long row = gt;
    sk[idx] = ok ? to_f(k[b * st.k.b + row * st.k.s + h * st.k.h + i]) : 0.f;
    sw[idx] = ok ? expf(logw[b * st.w.b + row * st.w.s + h * st.w.h + i])
                 : 1.f;
    if (full)
      sr[idx] =
          ok ? to_f(r[b * st.r.b + row * st.r.s + h * st.r.h + i]) : 0.f;
  }
  const int j0 = jb * VB;
  for (int idx = tid; idx < C * VB; idx += NT) {
    const int t = idx / VB, j = idx % VB, gt = t0 + t;
    const bool ok = gt < S;
    sv[idx] = ok ? to_f(v[b * st.v.b + (long long)gt * st.v.s + h * st.v.h +
                          j0 + j])
                 : 0.f;
    if (full)
      sdy[idx] = ok ? to_f(dy[b * st.dy.b + (long long)gt * st.dy.s +
                              h * st.dy.h + j0 + j])
                    : 0.f;
  }
  __syncthreads();
  if (full && tid < C) {
    float vdy = 0.f, ruk = 0.f;
    for (int j = 0; j < VB; ++j)
      vdy = fmaf(sv[tid * VB + j], sdy[tid * VB + j], vdy);
    for (int i = 0; i < D; ++i)
      ruk = fmaf(sr[tid * D + i] * su[i], sk[tid * D + i], ruk);
    svdy[tid] = vdy;
    sruk[tid] = ruk;
  }
  __syncthreads();
}

template <int D, int VB>
constexpr int smem_floats() {
  // su, r k w, v dy, v.dy r.(u k), the partials' stage, the warps' dv sums
  return D + 3 * C * D + 2 * C * VB + 2 * C + 3 * C * D +
         C * (D * VB / 32) * VB;
}

template <typename T, int D, int VB>
__global__ void __launch_bounds__(D * VB)
wkv6_bwd_kernel(const T* __restrict__ r, const T* __restrict__ k,
                const T* __restrict__ v, const float* __restrict__ logw,
                const float* __restrict__ u, const float* __restrict__ s0,
                const T* __restrict__ dy, const float* __restrict__ ds_last,
                T* __restrict__ dv, float* __restrict__ part,
                float* __restrict__ du_part, float* __restrict__ ds0,
                float* __restrict__ ckpt, int B, int S, int H,
                const Inputs st) {
  constexpr int NT = D * VB, NW = NT / 32, NCB = D / VB;
  extern __shared__ float sm[];
  float* su = sm;                 // (d)
  float* sr = su + D;             // (C, d)
  float* sk = sr + C * D;         // (C, d)
  float* sw = sk + C * D;         // (C, d)
  float* sv = sw + C * D;         // (C, VB)
  float* sdy = sv + C * VB;       // (C, VB)
  float* svdy = sdy + C * VB;     // (C)
  float* sruk = svdy + C;         // (C)
  float* sout = sruk + C;         // (3, C, d): dr, dk, dlogw over J
  float* sdvw = sout + 3 * C * D; // (C, NW, VB): each warp's dv sums

  const int tid = threadIdx.x, i = tid / VB, jj = tid % VB;
  const int lane = tid % 32, warp = tid / 32;
  const int jb = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int j = jb * VB + jj;
  const int n_chunks = (S + C - 1) / C;
  const long long elem = (((long long)b * H + h) * D + i) * D + j;
  const long long ck_stride = (long long)B * H * D * D;
  for (int q = tid; q < D; q += NT) su[q] = u[h * D + q];
  const float u_i = u[h * D + i];

  // -- 1. forward: the state entering each chunk -------------------------
  float s = s0 ? s0[elem] : 0.f;
  for (int c = 0; c < n_chunks; ++c) {
    stage<T, D, VB>(r, k, v, logw, dy, st, b, h, jb, c * C, S, false, su,
                    sr, sk, sw, sv, sdy, svdy, sruk);
    ckpt[c * ck_stride + elem] = s;
#pragma unroll
    for (int t = 0; t < C; ++t)
      s = fmaf(sw[t * D + i], s, sk[t * D + i] * sv[t * VB + jj]);
    __syncthreads();  // before the next chunk is staged over this one
  }

  // -- 2. back over the chunks, last first -------------------------------
  float ds = ds_last ? ds_last[elem] : 0.f;
  float du = 0.f;
  const long long n_out = (long long)B * S * H * D;
  for (int c = n_chunks - 1; c >= 0; --c) {
    const int t0 = c * C;
    stage<T, D, VB>(r, k, v, logw, dy, st, b, h, jb, t0, S, true, su, sr,
                    sk, sw, sv, sdy, svdy, sruk);
    float hist[C];  // S_t of the chunk's steps, recomputed
    {
      float sc = ckpt[c * ck_stride + elem];
#pragma unroll
      for (int t = 0; t < C; ++t) {
        hist[t] = sc;
        sc = fmaf(sw[t * D + i], sc, sk[t * D + i] * sv[t * VB + jj]);
      }
    }
#pragma unroll
    for (int t = C - 1; t >= 0; --t) {
      const float rt = sr[t * D + i], kt = sk[t * D + i], wt = sw[t * D + i];
      const float vt = sv[t * VB + jj], dyt = sdy[t * VB + jj];
      const float vdy = svdy[t];
      // ds holds dS_{t+1}
      float a_r = hist[t] * dyt, a_k = ds * vt, a_w = hist[t] * ds;
      float col = ds * kt;
#pragma unroll
      for (int m = VB / 2; m >= 1; m >>= 1) {
        a_r += __shfl_xor_sync(0xffffffffu, a_r, m);
        a_k += __shfl_xor_sync(0xffffffffu, a_k, m);
        a_w += __shfl_xor_sync(0xffffffffu, a_w, m);
      }
#pragma unroll
      for (int m = VB; m < 32; m <<= 1)
        col += __shfl_xor_sync(0xffffffffu, col, m);
      if (jj == 0) {
        sout[t * D + i] = fmaf(u_i * kt, vdy, a_r);
        sout[C * D + t * D + i] = fmaf(u_i * rt, vdy, a_k);
        sout[2 * C * D + t * D + i] = wt * a_w;
      }
      if (lane < VB) sdvw[(t * NW + warp) * VB + jj] = col;
      du = fmaf(rt * kt, vdy, du);
      ds = fmaf(wt, ds, rt * dyt);
    }
    __syncthreads();
    // the chunk's outputs: dr, dk, dlogw partials over J; dv whole
    for (int idx = tid; idx < C * D; idx += NT) {
      const int t = idx / D, q = idx % D, gt = t0 + t;
      if (gt >= S) continue;
      const long long e = (((long long)b * S + gt) * H + h) * D + q;
#pragma unroll
      for (int kind = 0; kind < 3; ++kind)
        part[((long long)kind * NCB + jb) * n_out + e] =
            sout[kind * C * D + idx];
    }
    for (int idx = tid; idx < C * VB; idx += NT) {
      const int t = idx / VB, q = idx % VB, gt = t0 + t;
      if (gt >= S) continue;
      float acc = 0.f;
#pragma unroll 8
      for (int w = 0; w < NW; ++w) acc += sdvw[(t * NW + w) * VB + q];
      acc = fmaf(sruk[t], sdy[idx], acc);
      dv[(((long long)b * S + gt) * H + h) * D + jb * VB + q] =
          from_f<T>(acc);
    }
    __syncthreads();  // before the next chunk is staged over this one
  }
  if (ds0) ds0[elem] = ds;
  if (jj == 0) du_part[(((long long)jb * B + b) * H + h) * D + i] = du;
}

// dr, dk (in T) and dlogw (float32): the column blocks' partials added in
// column-block order; a thread an element.
template <typename T>
__global__ void wkv6_bwd_reduce_kernel(const float* __restrict__ part,
                                       int ncb, long long n,
                                       T* __restrict__ dr,
                                       T* __restrict__ dk,
                                       float* __restrict__ dlogw) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float a = 0.f, bk = 0.f, w = 0.f;
  for (int q = 0; q < ncb; ++q) {
    a += part[(long long)q * n + e];
    bk += part[((long long)ncb + q) * n + e];
    w += part[((long long)2 * ncb + q) * n + e];
  }
  dr[e] = from_f<T>(a);
  dk[e] = from_f<T>(bk);
  dlogw[e] = w;
}

// du (H, d): the (column block, batch) partials added batch by batch, the
// column blocks in order within each.
__global__ void wkv6_bwd_du_kernel(const float* __restrict__ du_part,
                                   int ncb, int B, int hd,
                                   float* __restrict__ du) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= hd) return;
  float acc = 0.f;
  for (int b = 0; b < B; ++b)
    for (int q = 0; q < ncb; ++q)
      acc += du_part[((long long)q * B + b) * hd + e];
  du[e] = acc;
}

template <typename T, int D, int VB>
int launch_d(const void* r, const void* k, const void* v, const float* logw,
             const float* u, const float* s0, const void* dy,
             const float* ds_last, void* dr, void* dk, void* dv,
             float* dlogw, float* du, float* ds0, float* ws, int B, int S,
             int H, const Inputs& st, cudaStream_t stream) {
  constexpr int NCB = D / VB;
  const size_t smem = smem_floats<D, VB>() * sizeof(float);
  static bool attr_set = false;  // once per instantiation and process
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        wkv6_bwd_kernel<T, D, VB>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const long long n = (long long)B * S * H * D;
  float* part = ws;                                   // (3, NCB, n)
  float* du_part = part + 3 * NCB * n;                // (NCB, B, H, d)
  float* ckpt = du_part + (long long)NCB * B * H * D; // (chunks, B, H, d, d)
  wkv6_bwd_kernel<T, D, VB><<<dim3(NCB, H, B), D * VB, smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), logw, u, s0, static_cast<const T*>(dy),
      ds_last, static_cast<T*>(dv), part, du_part, ds0, ckpt, B, S, H, st);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (n > 0)
    wkv6_bwd_reduce_kernel<T><<<(unsigned)((n + 255) / 256), 256, 0,
                                stream>>>(part, NCB, n, static_cast<T*>(dr),
                                          static_cast<T*>(dk), dlogw);
  wkv6_bwd_du_kernel<<<(H * D + 255) / 256, 256, 0, stream>>>(
      du_part, NCB, B, H * D, du);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(int D, int vb, const void* r, const void* k, const void* v,
           const float* logw, const float* u, const float* s0,
           const void* dy, const float* ds_last, void* dr, void* dk,
           void* dv, float* dlogw, float* du, float* ds0, float* ws, int B,
           int S, int H, const Inputs& st, cudaStream_t stream) {
  // (d, VB): the wrapper's plan, kernels/wkv6.py:BWD_COLUMNS
  if (D == 16 && vb == 16)
    return launch_d<T, 16, 16>(r, k, v, logw, u, s0, dy, ds_last, dr, dk,
                               dv, dlogw, du, ds0, ws, B, S, H, st, stream);
  if (D == 32 && vb == 32)
    return launch_d<T, 32, 32>(r, k, v, logw, u, s0, dy, ds_last, dr, dk,
                               dv, dlogw, du, ds0, ws, B, S, H, st, stream);
  if (D == 64 && vb == 16)
    return launch_d<T, 64, 16>(r, k, v, logw, u, s0, dy, ds_last, dr, dk,
                               dv, dlogw, du, ds0, ws, B, S, H, st, stream);
  if (D == 128 && vb == 8)
    return launch_d<T, 128, 8>(r, k, v, logw, u, s0, dy, ds_last, dr, dk,
                               dv, dlogw, du, ds0, ws, B, S, H, st, stream);
  return -1;
}

}  // namespace

// C entry point: launches on `stream` and returns cudaGetLastError(), or
// -1 for a (head dim, columns a block) pair other than (16, 16), (32, 32),
// (64, 16) or (128, 8).  is_bf16 selects bfloat16 (1) or float32 (0) for
// r, k, v, dy, dr, dk and dv.  s0 and ds_last may be null (zero), and ds0
// null (not wanted).  dr, dk, dv and dlogw are dense (B, S, H, d), du
// (H, d), ds0 (B, H, d, d).  ws holds 3 ncb n + ncb B H d + chunks B H d^2
// floats (the partials, du's partials, the checkpoints; n = B S H d,
// ncb = d / vb, chunks = ceil(S / 16)).  strides: 15 element strides,
// (batch, seq, head) of r, k, v, logw and dy in that order.
extern "C" int wkv6_bwd_launch(int is_bf16, int D, int vb, const void* r,
                               const void* k, const void* v,
                               const void* logw, const void* u,
                               const void* s0, const void* dy,
                               const void* ds_last, void* dr, void* dk,
                               void* dv, void* dlogw, void* du, void* ds0,
                               void* ws, int B, int S, int H,
                               const long long* strides, void* stream) {
  const long long* q = strides;
  const Inputs st{{q[0], q[1], q[2]},    {q[3], q[4], q[5]},
                  {q[6], q[7], q[8]},    {q[9], q[10], q[11]},
                  {q[12], q[13], q[14]}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* lw = static_cast<const float*>(logw);
  const float* uu = static_cast<const float*>(u);
  const float* s0f = static_cast<const float*>(s0);
  const float* dsl = static_cast<const float*>(ds_last);
  float* dlw = static_cast<float*>(dlogw);
  float* duf = static_cast<float*>(du);
  float* ds0f = static_cast<float*>(ds0);
  float* w = static_cast<float*>(ws);
  if (is_bf16)
    return launch<__nv_bfloat16>(D, vb, r, k, v, lw, uu, s0f, dy, dsl, dr,
                                 dk, dv, dlw, duf, ds0f, w, B, S, H, st, s);
  return launch<float>(D, vb, r, k, v, lw, uu, s0f, dy, dsl, dr, dk, dv,
                       dlw, duf, ds0f, w, B, S, H, st, s);
}
