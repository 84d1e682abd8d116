// Flash attention forward (prefill) for Hopper (sm_90a).
//
// Replaces the Pallas kernel src/repro/kernels/flash_attention.py:
// _flash_kernel.  For q (B, H, S, d) and k, v (B, H_kv, S, d), query head h
// reading kv head h / (H / H_kv):
//   o[b, h, i] = sum_j softmax_j(q_i . k_j * d^-1/2) v_j
// over j <= i when causal, over all j otherwise, and with a window w > 0
// only over i - j < w besides (the reference's local attention,
// src/repro/models/attention.py:chunked_attention).  Scores, running max
// and running sum are float32; masked scores are -1e30 (the reference's
// value, not -inf); the output is acc / max(l, 1e-30) in the input type.
// Inputs are float32 or bfloat16, head dim 16, 32, 64, 128 or 256, and
// any S:
// the ragged last tile is masked here (the TPU kernel asserted that S
// divides by its 128-row blocks).  Each tensor comes with its own strides
// (the last dimension contiguous), so the model hands in transposed views
// of its (B, S, H, d) activations without a copy.
//
// Bound: at the serving path's prefill shapes the work is about 4*d flops
// per (query, key) pair against a few bytes per element moved, so the
// kernel is bound by operations: at the tensor cores' bf16 rate for bf16
// inputs, at the float32 rate for float32 inputs.
//
// Design.  On the TPU the KV axis is the innermost, sequential grid axis
// and (m, l, acc) live in VMEM across its steps.  On Hopper blocks run in
// parallel and in no order, so the KV loop moves inside the block: one
// block per (b, h, 64-query tile), causal blocks with more tiles to walk
// launched first.  The block walks the K/V tiles (64 keys each) from the
// first tile any of its rows can see (tile 0 without a window, the tile
// of key q0 - w + 1 with one) up to the diagonal; tiles wholly below the
// window of all its rows are skipped.  Without a window a row's first
// tile holds a valid key (key 0).  With one, a 64-row block can straddle
// the window's start, and a row's first tile (or two, when w is no
// multiple of 64) may hold no key it sees: its scores are all -1e30, its
// running max stays -1e30, and exp(0) = 1 terms enter l and acc.  They
// are wiped at the row's first tile with a valid key, whose rescale is
// exp(-1e30 - m) = 0, and every row reaches one (the key of its own
// position, in the diagonal tile, at the latest).  Two kernels:
//   * bfloat16 (the serving path's type): `mma.sync` m16n8k16 on the
//     tensor cores with float32 accumulation, FlashAttention-2 style.
//     Four warps of 16 query rows each; a warp keeps its Q rows as A
//     fragments in registers (up to head dim 128; at 256, 64 more
//     registers beside the 128 of its 32 output n-tiles and the 32 of its
//     8 score tiles would spill, so the fragments are read from the Q
//     tile in shared memory at each k-step instead), reads K (row-major)
//     and V (stored transposed) as B fragments from shared memory, rows
//     padded by 8 halves so the fragment loads are free of bank
//     conflicts, and turns its S accumulators straight into the A
//     fragments of P for P.V.  The row statistics live in registers and
//     are reduced over the 4 lanes that share a row.  P enters the product rounded to bf16 (the row sums
//     stay float32), within the bf16 tolerance 2e-2.
//   * float32: exact float32 FMAs on the CUDA cores (no TF32), to hold
//     2e-5 (at head dim 256 its tiles take 217 KB of the 227 KB of
//     shared memory: one block per SM).  256 threads; thread (ty, tx) of
//     a 16 x 16 arrangement owns query rows 4ty..4ty+3 and keys tx + 16j
//     (j < 4) of the tile's 64 x 64 score block, read as float4 vectors
//     from rows padded to d + 4 floats (free of bank conflicts); row
//     maxima and sums are reduced over the 16 lanes of a row with
//     shuffles; probabilities go through shared memory for the P.V
//     product.
// Tiles are copied in element by element, with no cp.async, TMA or
// pipelining: those, `wgmma` and warp specialisation are later work.
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
                       int group, int S, float scale, int causal, int window,
                       Strides qs, Strides ks, Strides vs, Strides os) {
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
  load_tile<D, LD>(sq, qb, qs, 0, S - q0);
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

  const int n_kt_all = (S + BK - 1) / BK;
  const int n_kt = causal ? min(n_kt_all, (q0 + BQ - 1) / BK + 1) : n_kt_all;
  const int kt_lo = window > 0 ? max(0, q0 - window + 1) / BK : 0;
  for (int kt = kt_lo; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    load_tile<D, LD>(sk, kb, ks, k0, S);
    load_tile<D, LD>(sv, vb, vs, k0, S);
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
        const bool ok = kpos < S && (!causal || kpos <= qpos) &&
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
    if (qpos >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c)
      ob[(long long)qpos * os.s + tx + 16 * c] = acc[i][c] / denom;
  }
}

// ---------------------------------------------------------------------------
// bfloat16 on the tensor cores
// ---------------------------------------------------------------------------

constexpr int MMA_THREADS = 128;  // 4 warps x 16 query rows

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// d += a * b for one m16n8k16 tile: a 16x16 row-major, b 16x8 col-major.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
flash_attention_mma_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           __nv_bfloat16* __restrict__ o, int group, int S,
                           float scale, int causal, int window, Strides qs,
                           Strides ks, Strides vs, Strides os) {
  constexpr int LDQ = D + 8;   // halves per Q / K row in shared memory
  constexpr int LDV = BK + 8;  // halves per row of V transposed
  constexpr int KS = D / 16;   // k-steps of Q.K^T over the head dim
  constexpr int NO = D / 8;    // n-tiles of the output
  constexpr int NT = BK / 8;   // n-tiles of the score block
  constexpr bool Q_REGS = D <= 128;  // Q fragments held in registers
  extern __shared__ float4 smem4[];
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem4);  // BQ x LDQ
  __nv_bfloat16* sk = sq + BQ * LDQ;                             // BK x LDQ
  __nv_bfloat16* svt = sk + BK * LDQ;                            // D x LDV

  const int n_qt = gridDim.x;
  const int qt = causal ? n_qt - 1 - blockIdx.x : blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / group;
  const int q0 = qt * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tig = lane & 3;  // fragment row / column pair
  const __nv_bfloat16 zero = __float2bfloat16(0.f);

  const __nv_bfloat16* qb = q + b * qs.b + h * qs.h;
  for (int idx = threadIdx.x; idx < BQ * D; idx += MMA_THREADS) {
    const int r = idx / D, c = idx % D, row = q0 + r;
    sq[r * LDQ + c] = row < S ? qb[(long long)row * qs.s + c] : zero;
  }
  __syncthreads();
  const int r0 = warp * 16;
  // the A fragment of Q's rows r0..r0+15 at k-step kk
  auto load_qa = [&](uint32_t (&f)[4], int kk) {
    const __nv_bfloat16* p = sq + (r0 + g) * LDQ + kk * 16 + tig * 2;
    f[0] = ld32(p);
    f[1] = ld32(p + 8 * LDQ);
    f[2] = ld32(p + 8);
    f[3] = ld32(p + 8 * LDQ + 8);
  };
  uint32_t qa[Q_REGS ? KS : 1][4];
  if constexpr (Q_REGS) {
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) load_qa(qa[kk], kk);
  }
  const __nv_bfloat16* kb = k + b * ks.b + hk * ks.h;
  const __nv_bfloat16* vb = v + b * vs.b + hk * vs.h;
  const int row_a = q0 + r0 + g, row_b = row_a + 8;  // this lane's rows

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m_a = NEG, m_b = NEG, l_a = 0.f, l_b = 0.f;

  const int n_kt_all = (S + BK - 1) / BK;
  const int n_kt = causal ? min(n_kt_all, (q0 + BQ - 1) / BK + 1) : n_kt_all;
  const int kt_lo = window > 0 ? max(0, q0 - window + 1) / BK : 0;
  for (int kt = kt_lo; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's fragments are read
    for (int idx = threadIdx.x; idx < BK * D; idx += MMA_THREADS) {
      const int j = idx / D, c = idx % D, key = k0 + j;
      const bool ok = key < S;
      sk[j * LDQ + c] = ok ? kb[(long long)key * ks.s + c] : zero;
      svt[c * LDV + j] = ok ? vb[(long long)key * vs.s + c] : zero;
    }
    __syncthreads();

    // s[n] sums over the k-steps in ascending order either way
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    if constexpr (Q_REGS) {
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          const __nv_bfloat16* p = sk + (n * 8 + g) * LDQ + kk * 16 + tig * 2;
          mma_bf16(s[n], qa[kk], ld32(p), ld32(p + 8));
        }
    } else {
#pragma unroll 2
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t qf[4];
        load_qa(qf, kk);
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const __nv_bfloat16* p = sk + (n * 8 + g) * LDQ + kk * 16 + tig * 2;
          mma_bf16(s[n], qf, ld32(p), ld32(p + 8));
        }
      }
    }

    // mask and scale; element e of tile n is row (e < 2 ? a : b), key
    // k0 + 8n + 2tig + (e & 1)
    float mx_a = NEG, mx_b = NEG;
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + n * 8 + tig * 2 + (e & 1);
        const int row = e < 2 ? row_a : row_b;
        const bool ok = key < S && (!causal || key <= row) &&
                        (window <= 0 || row - key < window);
        s[n][e] = ok ? s[n][e] * scale : NEG;
        if (e < 2) mx_a = fmaxf(mx_a, s[n][e]);
        else mx_b = fmaxf(mx_b, s[n][e]);
      }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
    }
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      s[n][0] = expf(s[n][0] - mn_a);
      s[n][1] = expf(s[n][1] - mn_a);
      s[n][2] = expf(s[n][2] - mn_b);
      s[n][3] = expf(s[n][3] - mn_b);
      sum_a += s[n][0] + s[n][1];
      sum_b += s[n][2] + s[n][3];
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      sum_a += __shfl_xor_sync(0xffffffffu, sum_a, off);
      sum_b += __shfl_xor_sync(0xffffffffu, sum_b, off);
    }
    const float al_a = expf(m_a - mn_a), al_b = expf(m_b - mn_b);
    l_a = al_a * l_a + sum_a;
    l_b = al_b * l_b + sum_b;
    m_a = mn_a;
    m_b = mn_b;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      acc[n][0] *= al_a;
      acc[n][1] *= al_a;
      acc[n][2] *= al_b;
      acc[n][3] *= al_b;
    }

    // acc += P.V: the S accumulators of tiles 2kk, 2kk+1 are the A
    // fragment of P's keys 16kk..16kk+15
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        const __nv_bfloat16* p = svt + (n * 8 + g) * LDV + kk * 16 + tig * 2;
        mma_bf16(acc[n], pa, ld32(p), ld32(p + 8));
      }
    }
  }

  __nv_bfloat16* ob = o + b * os.b + h * os.h;
  const float den_a = fmaxf(l_a, 1e-30f), den_b = fmaxf(l_b, 1e-30f);
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int c = n * 8 + tig * 2;
    if (row_a < S) {
      ob[(long long)row_a * os.s + c] = __float2bfloat16(acc[n][0] / den_a);
      ob[(long long)row_a * os.s + c + 1] = __float2bfloat16(acc[n][1] / den_a);
    }
    if (row_b < S) {
      ob[(long long)row_b * os.s + c] = __float2bfloat16(acc[n][2] / den_b);
      ob[(long long)row_b * os.s + c + 1] = __float2bfloat16(acc[n][3] / den_b);
    }
  }
}

template <int D>
int launch_mma(const void* q, const void* k, const void* v, void* o, int B,
               int H, int H_kv, int S, int causal, int window, float scale,
               const long long* st, cudaStream_t stream) {
  constexpr size_t shmem =
      sizeof(__nv_bfloat16) * (size_t)((BQ + BK) * (D + 8) + D * (BK + 8));
  static bool attr_set = false;  // once per instantiation and process
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_attention_mma_kernel<D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_attention_mma_kernel<D><<<grid, MMA_THREADS, shmem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      H / H_kv, S, scale, causal, window, Strides{st[0], st[1], st[2]},
      Strides{st[3], st[4], st[5]}, Strides{st[6], st[7], st[8]},
      Strides{st[9], st[10], st[11]});
  return (int)cudaGetLastError();
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o, int B,
               int H, int H_kv, int S, int causal, int window, float scale,
               const long long* st, cudaStream_t stream) {
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
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_attention_kernel<D><<<grid, THREADS, shmem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), H / H_kv, S,
      scale, causal, window, Strides{st[0], st[1], st[2]},
      Strides{st[3], st[4], st[5]}, Strides{st[6], st[7], st[8]},
      Strides{st[9], st[10], st[11]});
  return (int)cudaGetLastError();
}

}  // namespace

// C entry point: launches on `stream` and returns cudaGetLastError().
// is_bf16 selects bfloat16 (1, the tensor-core kernel) or float32 (0, the
// CUDA-core kernel) for q, k, v and o alike.  window: 0 for none, else
// query i sees key j only where i - j < window.  strides: 12 element
// strides, (batch, head, seq) of q, k, v, o in turn.
extern "C" int flash_attention_launch(int is_bf16, int d, const void* q,
                                      const void* k, const void* v, void* o,
                                      int B, int H, int H_kv, int S,
                                      int causal, int window, float scale,
                                      const long long* strides, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FA_ARGS q, k, v, o, B, H, H_kv, S, causal, window, scale, strides, st
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
