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
// the last dimension contiguous and rows 16-byte aligned; the outputs are
// dense.
//
// Design: the forward's chunked (GLA) form (wkv6.cu's note), transposed,
// on mma.sync m16n8k8 in split TF32 (mma_tf32.cuh; bfloat16 operands are
// exact in TF32 and are not split).  One block of 8 warps per (b, h), a
// whole head, so every sum over the head's channels stays in the block:
// 256 blocks at rwkv6-7b's training shape (4 x 64 heads), two waves of one
// block an SM.  A chunk holds C = 32 steps (16 at d = 128); per chunk, cum
// the inclusive and cume the exclusive sums of logw, tot their total and
// theta = tot / 2, all per channel, q_in = r exp(cume - theta), k_in =
// k exp(theta - cum), k_carry = k exp(tot - cum), r_e = r exp(cume):
//   1. a walk forward over the chunks writes the state entering each to
//      a workspace, S <- diag(exp(tot)) S + k_carry^T v on the tensor
//      cores (every factor is at most |k|, so this walk needs no guard);
//   2. a walk back over the chunks, last first, with dS in the registers
//      of the warps as the forward keeps S:
//        A = q_in k_in^T and dA = dy v^T strictly below the diagonal (by
//        select: above it a product can be inf);
//        dr = e^(cume - theta) o (dA k_in) + e^cume o (dy S_c^T) + bonus;
//        dk = e^(theta - cum) o (dA^T q_in) + e^(tot - cum) o (v dS^T)
//             + bonus;
//        dv = A^T dy + k_carry dS + (r . (u o k)) dy;
//        dS <- diag(exp(tot)) dS + r_e^T dy,
//      with dS the chunk's exiting gradient and S_c its entering state
//      (here k_carry = k_in e^theta and r_e = q_in e^theta, as the
//      forward takes k_carry);
//   3. dlogw summed directly, with no difference of sums (the chunked
//      form's own gradient subtracts two sums dominated by adjacent pairs
//      and loses about two digits at logw = -5): for step s and channel i
//        dlogw_s = e^tot P + sum_{s' > s} r_s' o dr^inter_s'
//                  + sum_{s' < s} k_s' o dk^inter_s'
//                  + sum_{a < s < b} q_in[b] o k_in[a] dA[b, a],
//      P = rowsum(S_c o dS); the last term a running sum per channel over
//      a and then over b, on the CUDA cores (C d operations a token).
// A chunk with a channel whose total is below TOTAL_MIN, or with a factor
// q_in or k_in past FACTOR_MAX (the forward's guards), is walked back step
// by step: each step's state recomputed from S_c, row and column sums
// across the warps in a fixed order.  logw -20 takes that path.
//
// Pipeline: one thread has the copy engine (TMA) bring the next job's r,
// k, v, dy and logw (a walk-forward job: k, v and logw) into the other
// slot of a two-slot ring while all the warps work on this one (one
// slot where two do not fit: float32 at d 64 and 128).  Every warp takes
// a share of every product, its factors included, so no warp waits on a
// producer's phase.  Rows in shared memory are padded so that most
// fragment loads are free of bank conflicts.  No atomics: each block's sums run in
// a fixed order, and du's partials over the batch are added batch by batch
// by a second kernel, so the bits do not depend on block timing.
//
// Bound: bytes.  The products are 10 C d + 10 d^2 flops a token and head
// (the walk forward's state update, the two score matrices, dA k_in,
// dA^T q_in, A^T dy, the three inter-chunk products and the dS update),
// tripled by the split: 48.3 GFLOP at rwkv6-7b's training shape (4 x 1024
// tokens, 64 heads of 64), 0.098 ms at the card's TF32 rate, against r, k,
// v, dy read and dr, dk, dv written in bfloat16 and logw read and dlogw
// written in float32, 0.110 ms at the memory rate (the states' workspace,
// 134 MB written and read, is not counted).  The kernel runs at about 8x
// that (PERF.md, with its phase clocks): eight warps between frequent
// barriers leave the latency of each phase exposed, and the split
// operands double the shared memory read a product.  Offsets are 64-bit.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

#include "mma_bf16.cuh"
#include "mma_tf32.cuh"
#include "tma.cuh"

constexpr int NT = 256;  // threads a block
constexpr int NW = NT / 32;
constexpr float TOTAL_MIN = -165.f;
constexpr float FACTOR_MAX = 1e38f;

#ifdef WKV6_BWD_PHASE_CLOCKS
// Cycles each warp of block (0, 0) spends in each phase (the marks below),
// summed over its chunks in registers and written once: built with this
// defined by scripts/recurrence_ab.py --phases, read by
// wkv6_bwd_phase_clocks.  Each phase ends at the barrier that closes it,
// its wait included: the copy's wait; the walk forward's factors and its
// state update; the walk back's sums and factors, scores and dr^inter, dS
// staged, products, dlogw (and du); a chunk walked step by step.
constexpr int N_PHASES = 9;
__device__ unsigned phase_clocks[NW][N_PHASES];
struct PhaseClock {
  unsigned t0, acc[N_PHASES] = {};
  __device__ PhaseClock() {
#ifdef __CUDA_ARCH__
    t0 = (unsigned)clock();  // (the host pass sees the constructor too)
#endif
  }
  __device__ __forceinline__ void mark(int p) {
    const unsigned now = (unsigned)clock();
    acc[p] += now - t0;
    t0 = now;
  }
  __device__ __forceinline__ void flush() {
    if ((threadIdx.x & 31) == 0 && (blockIdx.x | blockIdx.y) == 0)
      for (int p = 0; p < N_PHASES; ++p)
        phase_clocks[threadIdx.x >> 5][p] = acc[p];
  }
};
#else
struct PhaseClock {
  __device__ __forceinline__ void mark(int) {}
  __device__ __forceinline__ void flush() {}
};
#endif

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ float rcp_approx(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// a float32 value from its TF32 parts
__device__ __forceinline__ float joined(uint2 p) {
  return __uint_as_float(p.x) + __uint_as_float(p.y);
}

// v's TF32 parts: v alone where `exact` (a bfloat16 value), else hi + lo
__device__ __forceinline__ void tf32_parts(float v, bool exact, uint32_t& hi,
                                           uint32_t& lo) {
  if (exact) {
    hi = __float_as_uint(v);
    lo = 0u;
  } else {
    split_tf32(v, hi, lo);
  }
}

// d + x += a * b in split TF32 (mma_split's products), with a or b exact
// (one part, one product fewer) where EA / EB
template <bool EA, bool EB>
__device__ __forceinline__ void mma3(float (&d)[4], float (&x)[4],
                                     const FragA& a, const FragB& b) {
  if constexpr (!EA) mma_tf32(x, a.lo, b.hi[0], b.hi[1]);
  if constexpr (!EB) mma_tf32(x, a.hi, b.lo[0], b.lo[1]);
  mma_tf32(d, a.hi, b.hi[0], b.hi[1]);
}

// Fragments from a pointer to the operand's element (m = g, k = tq) (A)
// or (k = tq, n = g) (B); MS / KS are the element strides of m and k.
template <int MS, int KS>
__device__ __forceinline__ void frag_a(FragA& f, const uint2* p) {
  f.load(p[0], p[8 * MS], p[4 * KS], p[8 * MS + 4 * KS]);
}
template <int MS, int KS, bool EXACT, typename T>
__device__ __forceinline__ void frag_a(FragA& f, const T* p) {
  const float v[4] = {to_f(p[0]), to_f(p[8 * MS]), to_f(p[4 * KS]),
                      to_f(p[8 * MS + 4 * KS])};
#pragma unroll
  for (int e = 0; e < 4; ++e) tf32_parts(v[e], EXACT, f.hi[e], f.lo[e]);
}
template <int KS>
__device__ __forceinline__ void frag_b(FragB& f, const uint2* p) {
  f.load(p[0], p[4 * KS]);
}
template <int KS, bool EXACT, typename T>
__device__ __forceinline__ void frag_b(FragB& f, const T* p) {
  tf32_parts(to_f(p[0]), EXACT, f.hi[0], f.lo[0]);
  tf32_parts(to_f(p[4 * KS]), EXACT, f.hi[1], f.lo[1]);
}

// acc[e] + cross[e] += A B_e over the k-steps k0 in [k_lo, k_hi) for a
// warp's TO tiles of one strip: A (the strip's rows) loaded once a k-step
// by load_a(f, k0), B_e (tile e's columns) by load_b(f, e, k0)
template <int TO, int KU, bool EA, bool EB, typename FA, typename FB>
__device__ __forceinline__ void strip_product(float (&acc)[TO][4],
                                              float (&cross)[TO][4],
                                              int k_lo, int k_hi, FA load_a,
                                              FB load_b) {
#pragma unroll KU
  for (int k0 = k_lo; k0 < k_hi; k0 += 8) {
    FragA fa;
    load_a(fa, k0);
#pragma unroll
    for (int e = 0; e < TO; ++e) {
      FragB fb;
      load_b(fb, e, k0);
      mma3<EA, EB>(acc[e], cross[e], fa, fb);
    }
  }
}

// (batch, seq, head) element strides of one (B, S, H, d) input
struct Strides {
  long long b, s, h;
};

// The tensor maps of r, k, v, dy (boxes of PV columns: the head's d and 8
// of zeros, so that rows land with the padded pitch) and logw (d columns),
// C rows each
struct Maps {
  CUtensorMap r, k, v, dy, w;
};

// Shared memory, in bytes from the start: the ring (r, k, v, dy in T with
// row pitch PV, logw float32); the factors q_in, k_in, k_carry and r_e in
// TF32 parts; E1 = exp(cume - theta) and E2 = exp(theta - cum) (float32);
// A and dA in TF32 parts and dA transposed in float32; r o dr^inter and
// k o dk^inter (float32; dr^inter until k o dk^inter replaces it, and the
// step-by-step partials and du's in their place); X, the entering state
// and then the exiting gradient (TF32 parts, or float32 where the parts
// do not fit); u, exp(tot), exp(theta), v . dy and r . (u o k) per step,
// P's partials, the step-by-step flag; the ring's barriers.
template <typename T, int D>
struct Layout {
  static constexpr int C = D <= 64 ? 32 : 16;  // steps a chunk
  // k-steps of a product over d unrolled at once (fewer registers at 128)
  static constexpr int KU = D <= 64 ? D / 8 : 1;
  static constexpr int NM = C / 16;            // strips of 16 steps
  static constexpr int ND = D / 8;             // 8-column tiles of d
  static constexpr int NO = NM * ND;           // tiles of a C x d output
  static constexpr int TO = (NO + NW - 1) / NW;  // of them a warp's (in
                                                 // one strip: TO divides ND)
  static constexpr int NDS = (D / 16) * ND;    // tiles of the d x d state
  static constexpr int TS = NDS >= NW ? NDS / NW : 1;  // of them a warp's
  static constexpr int NWS = NDS / TS;         // warps that hold the state
  static constexpr int WPS = ND / TS;          // of them a strip's
  static constexpr int NSC = NM * (NM + 1);    // score tiles a matrix
  static constexpr int PV = D + 8;   // ring row pitch (elements)
  static constexpr int PF = D + 4;   // factor row pitch (8-byte words)
  static constexpr int PE = D + 8;   // float32 (C, d) arrays' pitch
  static constexpr int PA = C + 4;   // A, dA row pitch (8-byte words)
  static constexpr int PT = C + 4;   // dA^T row pitch (floats)
  static constexpr int PX = D + 4;   // X row pitch (words)
  static constexpr int ROW_B = C * PV * (int)sizeof(T);
  static constexpr int W_B = C * D * 4;
  static constexpr int SLOT = 4 * ROW_B + W_B;
  static constexpr int FACT = 4 * C * PF * 8;
  static constexpr int EB = 2 * C * PE * 4;
  static constexpr int AB = 2 * C * PA * 8 + C * PT * 4;
  static constexpr int RB = 2 * C * PE * 4;
  static constexpr int MISC = 4 * (3 * D + 2 * C + WPS * D + 4);
  static constexpr int REST = FACT + EB + AB + RB + MISC + 16;
  static constexpr int LIMIT = 232448;
  static constexpr bool XSPLIT = 2 * SLOT + REST + D * PX * 8 <= LIMIT;
  static constexpr int XB = D * PX * (XSPLIT ? 8 : 4);
  static constexpr int NSLOT = 2 * SLOT + REST + XB <= LIMIT ? 2 : 1;
  static constexpr int F0 = NSLOT * SLOT;
  static constexpr int E0 = F0 + FACT;
  static constexpr int A0 = E0 + EB;
  static constexpr int R0 = A0 + AB;
  static constexpr int X0 = R0 + RB;
  static constexpr int M0 = X0 + XB;
  static constexpr int BAR = (M0 + MISC + 7) / 8 * 8;
  static constexpr int BYTES = BAR + 16;
  static_assert(BYTES <= LIMIT, "fits a block's shared memory");
  static_assert(ROW_B % 128 == 0 && W_B % 128 == 0,
                "copy-engine boxes land 128-byte aligned");
  static_assert(C * D % NT == 0 && NT % D == 0, "the factor pass's threads");
  static_assert(ND % TO == 0, "a warp's output tiles share a strip");
  static_assert(3 * WPS * D + (D / 16) * D <= 2 * C * PE,
                "the step-by-step partials fit r o dr's space");
};

// Named barrier 0 is __syncthreads: every phase below ends at one.
template <typename T, int D>
__global__ void __launch_bounds__(NT, 1)
wkv6_bwd_kernel(const float* __restrict__ u, const float* __restrict__ s0,
                const float* __restrict__ ds_last, T* __restrict__ dr,
                T* __restrict__ dk, T* __restrict__ dv,
                float* __restrict__ dlogw, float* __restrict__ du_part,
                float* __restrict__ ds0, float* __restrict__ ws, int S,
                int H, const __grid_constant__ Maps maps) {
  using L = Layout<T, D>;
  constexpr int KU = L::KU;
  constexpr int C = L::C, ND = L::ND, NO = L::NO, TO = L::TO, TS = L::TS;
  constexpr int WPS = L::WPS, NSC = L::NSC, NSLOT = L::NSLOT;
  constexpr int PV = L::PV, PF = L::PF, PE = L::PE, PA = L::PA, PT = L::PT;
  constexpr int PX = L::PX;
  constexpr bool EX = sizeof(T) == 2;  // bfloat16 operands: exact in TF32
  constexpr bool XS = L::XSPLIT;
  extern __shared__ __align__(128) unsigned char smem[];
  uint2* fq = reinterpret_cast<uint2*>(smem + L::F0);  // q_in
  uint2* fk = fq + C * PF;                              // k_in
  uint2* fc = fk + C * PF;                              // k_carry
  uint2* fr = fc + C * PF;                              // r_e
  float* e1 = reinterpret_cast<float*>(smem + L::E0);   // exp(cume - theta)
  float* e2 = e1 + C * PE;                              // exp(theta - cum)
  uint2* sA = reinterpret_cast<uint2*>(smem + L::A0);
  uint2* sdA = sA + C * PA;
  float* dAT = reinterpret_cast<float*>(sdA + C * PA);  // dA^T
  float* rdr = reinterpret_cast<float*>(smem + L::R0);  // r o dr^inter
  float* kdk = rdr + C * PE;                            // k o dk^inter
  unsigned char* X = smem + L::X0;
  float* su = reinterpret_cast<float*>(smem + L::M0);
  float* setot = su + D;
  float* seth = setot + D;
  float* svdy = seth + D;
  float* sruk = svdy + C;
  float* ppart = sruk + C;  // (WPS, d)
  int* flag = reinterpret_cast<int*>(ppart + WPS * D);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BAR);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  // the block's head and batch, read where they are used: values held in
  // registers across the walks spill at d 128
  auto blk_h = [] {
    int v;
    asm volatile("mov.u32 %0, %%ctaid.x;" : "=r"(v));
    return v;
  };
  auto blk_b = [] {
    int v;
    asm volatile("mov.u32 %0, %%ctaid.y;" : "=r"(v));
    return v;
  };
  const int n_chunks = (S + C - 1) / C;
  const int n_jobs = 2 * n_chunks - 1;  // n - 1 walking forward, n back
  const int HD = H * D;
  constexpr int TSE = 4 * TS;  // this thread's elements of a state

  for (int i = tid; i < D; i += NT) su[i] = u[(long long)blk_h() * D + i];
  // dA^T[a][b] = dA[b][a] where no score tile writes it (a past the end
  // of b's strip): 0, as every entry with b <= a is
  for (int idx = tid; idx < C * C; idx += NT) {
    const int a = idx / C, b_ = idx % C;
    if (a >= 16 * (b_ / 16 + 1)) dAT[a * PT + b_] = 0.f;
  }
  if (tid == 0) {
    *flag = 0;
    for (int q = 0; q < NSLOT; ++q) mbar_init(full + q, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // job y: walk forward over chunk y (y < n - 1), else back over chunk
  // 2 (n - 1) - y; one thread starts its copies
  auto fetch = [&](int y) {
    const bool fwd = y < n_chunks - 1;
    const int c = fwd ? y : 2 * (n_chunks - 1) - y;
    unsigned char* slot = smem + (y % NSLOT) * L::SLOT;
    uint64_t* bar = full + y % NSLOT;
    mbar_expect(bar, (fwd ? 2 : 4) * L::ROW_B + L::W_B);
    const int t0 = c * C;
    if (!fwd) {
      tma_load(slot, &maps.r, 0, t0, blk_h(), blk_b(), bar);
      tma_load(slot + 3 * L::ROW_B, &maps.dy, 0, t0, blk_h(), blk_b(), bar);
    }
    tma_load(slot + L::ROW_B, &maps.k, 0, t0, blk_h(), blk_b(), bar);
    tma_load(slot + 2 * L::ROW_B, &maps.v, 0, t0, blk_h(), blk_b(), bar);
    tma_load(slot + 4 * L::ROW_B, &maps.w, 0, t0, blk_h(), blk_b(), bar);
  };
  if (tid == 0)
    for (int y = 0; y < NSLOT - 1 && y < n_jobs; ++y) fetch(y);

  // the state tiles of this thread: rows s_i0 + g (+8), columns
  // 8 (s_n0 + nn) + 2 tq (+1); S walking forward, dS walking back
  const bool s_role = warp < L::NWS;
  const int s_i0 = 16 * (warp * TS / ND), s_n0 = (warp * TS) % ND;
  float st[TS][4];
#pragma unroll
  for (int nn = 0; nn < TS; ++nn)
#pragma unroll
    for (int e = 0; e < 4; ++e) st[nn][e] = 0.f;
  auto load_state = [&](const float* src) {
    if (src && s_role)
#pragma unroll
      for (int nn = 0; nn < TS; ++nn)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const float2 x = *reinterpret_cast<const float2*>(
              src + ((long long)blk_b() * H + blk_h()) * D * D +
              (long long)(s_i0 + g + 8 * hh) * D + 8 * (s_n0 + nn) + 2 * tq);
          st[nn][2 * hh] = x.x;
          st[nn][2 * hh + 1] = x.y;
        }
  };
  load_state(s0);
  // st <- diag(exp(tot)) st + fa^T fb: fa a (C, d) factor in TF32 parts,
  // fb a ring operand (k_carry^T v walking forward, r_e^T dy back), in
  // groups of up to 4 tiles (fewer registers at d 128)
  auto state_update = [&](const uint2* fa_m, const T* fb_m) {
    constexpr int G = TS < 4 ? TS : (D == 128 ? 1 : 4);  // (d 128: registers)
#pragma unroll
    for (int n1 = 0; n1 < TS; n1 += G) {
      float acc[G][4] = {}, cross[G][4] = {};
#pragma unroll
      for (int k0 = 0; k0 < C; k0 += 8) {
        FragA fa;
        frag_a<1, PF>(fa, fa_m + (k0 + tq) * PF + s_i0 + g);
#pragma unroll
        for (int nn = 0; nn < G; ++nn) {
          FragB fb;
          frag_b<PV, EX>(fb,
                         fb_m + (k0 + tq) * PV + 8 * (s_n0 + n1 + nn) + g);
          mma3<false, EX>(acc[nn], cross[nn], fa, fb);
        }
      }
#pragma unroll
      for (int nn = 0; nn < G; ++nn)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          st[n1 + nn][e] = fmaf(setot[s_i0 + g + 8 * (e >> 1)],
                                st[n1 + nn][e], acc[nn][e] + cross[nn][e]);
    }
  };

  // B fragments of X: (k = j, n = i) = X[i][j] (row) and (k = i, n = j) =
  // X[i][j] (column), from TF32 parts or split here
  auto x_row = [&](FragB& f, int n0, int k0) {
    if constexpr (XS) {
      frag_b<1>(f, reinterpret_cast<const uint2*>(X) + (n0 + g) * PX + k0 +
                       tq);
    } else {
      frag_b<1, false>(f, reinterpret_cast<const float*>(X) + (n0 + g) * PX +
                              k0 + tq);
    }
  };
  auto x_col = [&](FragB& f, int n0, int k0) {
    if constexpr (XS) {
      frag_b<PX>(f, reinterpret_cast<const uint2*>(X) + (k0 + tq) * PX + n0 +
                        g);
    } else {
      frag_b<PX, false>(f, reinterpret_cast<const float*>(X) +
                               (k0 + tq) * PX + n0 + g);
    }
  };
  // this warp's C x d output tiles TO warp + e, e < TO: one strip (rows
  // m0 ..), columns n00 + 8 e ..
  const int q0 = TO * warp, m0 = 16 * (q0 / ND), n00 = 8 * (q0 % ND);
  const bool t_role = q0 < NO;
  // the factor passes' thread: channel fi, steps [fp SP, fp SP + SP)
  constexpr int SP = C * D / NT;
  const int fi = tid % D, fp = tid / D;
  // the sums of logw over the chunk in step order, each thread its own:
  // cum[0] before its first step, cum[s + 1] through its step s; returns
  // the total (every thread of a channel adds in the same order)
  auto logw_sums = [&](const float* cw, float (&cum)[SP + 1]) {
    const int lo = fp * SP;
    float lw[C];
#pragma unroll
    for (int t = 0; t < C; ++t) lw[t] = cw[t * D + fi];
    float run = 0.f;  // (adding 0 leaves it as it is)
#pragma unroll
    for (int t = 0; t < C; ++t) run += t < lo ? lw[t] : 0.f;
    cum[0] = run;
#pragma unroll
    for (int s_ = 0; s_ < SP; ++s_) {
      run += cw[(lo + s_) * D + fi];
      cum[s_ + 1] = run;
    }
#pragma unroll
    for (int t = 0; t < C; ++t) run += t >= lo + SP ? lw[t] : 0.f;
    return run;
  };
  // the dlogw pass's thread: channel i = tid / TPC, steps [q NB, q NB + NB)
  constexpr int TPC = NT / D, NB = C / TPC;
  float du_acc = 0.f;  // its channel's du over its steps
  auto du_steps = [&](const T* cr, const T* ck) {
    const int i = tid / TPC, b0 = (tid % TPC) * NB;
#pragma unroll
    for (int m = 0; m < NB; ++m)
      du_acc = fmaf(to_f(cr[(b0 + m) * PV + i]) * to_f(ck[(b0 + m) * PV + i]),
                    svdy[b0 + m], du_acc);
  };

  PhaseClock pc;
  for (int x = 0; x < n_jobs; ++x) {
    const bool fwd = x < n_chunks - 1;
    const int c = fwd ? x : 2 * (n_chunks - 1) - x, t0 = c * C;
    if (tid == 0 && x + NSLOT - 1 < n_jobs) fetch(x + NSLOT - 1);
    const unsigned char* slot = smem + (x % NSLOT) * L::SLOT;
    const T* cr = reinterpret_cast<const T*>(slot);
    const T* ck = reinterpret_cast<const T*>(slot + L::ROW_B);
    const T* cv = reinterpret_cast<const T*>(slot + 2 * L::ROW_B);
    const T* cdy = reinterpret_cast<const T*>(slot + 3 * L::ROW_B);
    const float* cw = reinterpret_cast<const float*>(slot + 4 * L::ROW_B);
    // this thread's elements of the state entering chunk c (recomputed
    // each job: no pointer stays live across the walks)
    float* wsc = ws + (((long long)blk_b() * H + blk_h()) * n_chunks + c) * D * D +
                 tid * TSE;
    if (x == n_chunks - 1 && s_role) {
      // the walk turns: the last chunk's entering state, then dS_S
#pragma unroll
      for (int nn = 0; nn < TS; ++nn)
        *reinterpret_cast<float4*>(wsc + 4 * nn) =
            make_float4(st[nn][0], st[nn][1], st[nn][2], st[nn][3]);
#pragma unroll
      for (int nn = 0; nn < TS; ++nn)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[nn][e] = 0.f;
      load_state(ds_last);
    }
    mbar_wait(full + x % NSLOT, (x / NSLOT) & 1);
    pc.mark(0);

    if (fwd) {
      // ====== the walk forward: S_c to the workspace, then S_{c+1} =====
      {
        // k_carry = k exp(tot - cum); loads before stores (the compiler
        // keeps loads behind possibly aliasing stores), the state's too
        float kk[SP], cum[SP + 1];
#pragma unroll
        for (int s_ = 0; s_ < SP; ++s_)
          kk[s_] = to_f(ck[(fp * SP + s_) * PV + fi]);
        const float tot = logw_sums(cw, cum);
        if (s_role)
#pragma unroll
          for (int nn = 0; nn < TS; ++nn)
            *reinterpret_cast<float4*>(wsc + 4 * nn) =
                make_float4(st[nn][0], st[nn][1], st[nn][2], st[nn][3]);
        if (fp == 0) setot[fi] = expf(tot);
#pragma unroll
        for (int s_ = 0; s_ < SP; ++s_)
          fc[(fp * SP + s_) * PF + fi] =
              split_tf32(kk[s_] * expf(tot - cum[s_ + 1]));
      }
      __syncthreads();
      pc.mark(1);
      if (s_role) state_update(fc, cv);
      __syncthreads();  // the slot and k_carry are free
      pc.mark(2);
      continue;
    }

    // ====== the walk back over chunk c; st holds dS_{c+1} ===============
    const int nval = min(C, S - t0);
    if (s_role)  // S_c, read a tile at a time below
      for (int q = 0; q < TSE; q += 32)
        asm volatile("prefetch.global.L1 [%0];" ::"l"(wsc + q));
    // -- sums and factors: a thread a channel and SP steps; v . dy and
    // r . (u o k) a warp a step; P's partials and S_c to X
    {
      float cum[SP + 1], rr[SP], kk[SP];
#pragma unroll
      for (int s_ = 0; s_ < SP; ++s_) {
        rr[s_] = to_f(cr[(fp * SP + s_) * PV + fi]);
        kk[s_] = to_f(ck[(fp * SP + s_) * PV + fi]);
      }
      const float tot = logw_sums(cw, cum), theta = 0.5f * tot;
      if (fp == 0) {
        if (tot < TOTAL_MIN) *flag = 1;
        setot[fi] = expf(tot);
        seth[fi] = expf(theta);
      }
      // k_carry = k_in e^theta and r_e = q_in e^theta: a chunk whose
      // factors these do not keep finite is walked step by step
      const float eth = expf(theta);
      float e_in = expf(cum[0] - theta), big = 0.f;
#pragma unroll
      for (int s_ = 0; s_ < SP; ++s_) {
        const int t = fp * SP + s_;
        const float e_out = expf(cum[s_ + 1] - theta);
        const float e_out_r = rcp_approx(e_out);
        const float q = rr[s_] * e_in, kin = kk[s_] * e_out_r;
        big = fmaxf(big, fmaxf(fabsf(q), fabsf(kin)));
        e1[t * PE + fi] = e_in;
        e2[t * PE + fi] = e_out_r;
        fq[t * PF + fi] = split_tf32(q);
        fk[t * PF + fi] = split_tf32(kin);
        fc[t * PF + fi] = split_tf32(kin * eth);
        fr[t * PF + fi] = split_tf32(q * eth);
        e_in = e_out;
      }
      if (!(big <= FACTOR_MAX)) *flag = 1;
    }
#pragma unroll
    for (int t = warp; t < C; t += NW) {
      float vd = 0.f, rk = 0.f;
      for (int i = lane; i < D; i += 32) {
        vd = fmaf(to_f(cv[t * PV + i]), to_f(cdy[t * PV + i]), vd);
        rk = fmaf(to_f(cr[t * PV + i]) * su[i], to_f(ck[t * PV + i]), rk);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        vd += __shfl_xor_sync(0xffffffffu, vd, off);
        rk += __shfl_xor_sync(0xffffffffu, rk, off);
      }
      if (lane == 0) {
        svdy[t] = vd;
        sruk[t] = rk;
      }
    }
    if (s_role) {
      // S_c, a tile at a time from the workspace
      float pr[2] = {0.f, 0.f};
#pragma unroll
      for (int nn = 0; nn < TS; ++nn) {
        // (at most four tiles' loads in flight: d 128's state takes 64
        // registers a thread)
        if (nn % 4 == 0) asm volatile("" ::: "memory");
        const float4 q = *reinterpret_cast<const float4*>(wsc + 4 * nn);
        const float sc[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          pr[e >> 1] = fmaf(sc[e], st[nn][e], pr[e >> 1]);
          const int i = s_i0 + g + 8 * (e >> 1);
          const int j = 8 * (s_n0 + nn) + 2 * tq + (e & 1);
          if constexpr (XS) {
            reinterpret_cast<uint2*>(X)[i * PX + j] = split_tf32(sc[e]);
          } else {
            reinterpret_cast<float*>(X)[i * PX + j] = sc[e];
          }
        }
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        pr[hh] += __shfl_xor_sync(0xffffffffu, pr[hh], 1);
        pr[hh] += __shfl_xor_sync(0xffffffffu, pr[hh], 2);
        if (tq == 0) ppart[(warp % WPS) * D + s_i0 + g + 8 * hh] = pr[hh];
      }
    }
    __syncthreads();
    const bool step_by_step = *flag != 0;
    pc.mark(3);

    if (!step_by_step) {
      // -- scores A and dA (a warp a tile), and dr^inter = dy S_c^T ------
      for (int it = warp; it < 2 * NSC; it += NW) {
        const bool is_da = it >= NSC;
        int jt = is_da ? it - NSC : it, m = 0;
        while (jt >= 2 * m + 2) jt -= 2 * m + 2, ++m;
        const int r0 = 16 * m, c0 = 8 * jt;
        float acc[4] = {}, cross[4] = {};
        if (is_da) {
#pragma unroll KU
          for (int k0 = 0; k0 < D; k0 += 8) {
            FragA fa;
            frag_a<PV, 1, EX>(fa, cdy + (r0 + g) * PV + k0 + tq);
            FragB fb;
            frag_b<1, EX>(fb, cv + (c0 + g) * PV + k0 + tq);
            mma3<EX, EX>(acc, cross, fa, fb);
          }
        } else {
#pragma unroll KU
          for (int k0 = 0; k0 < D; k0 += 8) {
            FragA fa;
            frag_a<PF, 1>(fa, fq + (r0 + g) * PF + k0 + tq);
            FragB fb;
            frag_b<1>(fb, fk + (c0 + g) * PF + k0 + tq);
            mma3<false, false>(acc, cross, fa, fb);
          }
        }
        uint2* out = is_da ? sdA : sA;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ri = r0 + g + 8 * (e >> 1), cj = c0 + 2 * tq + (e & 1);
          const float val = ri > cj ? acc[e] + cross[e] : 0.f;
          out[ri * PA + cj] = split_tf32(val);
          if (is_da) dAT[cj * PT + ri] = val;
        }
      }
      if (t_role) {
        float acc[TO][4] = {}, cross[TO][4] = {};
        strip_product<TO, KU, EX, false>(
            acc, cross, 0, D,
            [&](FragA& f, int k0) {
              frag_a<PV, 1, EX>(f, cdy + (m0 + g) * PV + k0 + tq);
            },
            [&](FragB& f, int e_, int k0) { x_row(f, n00 + 8 * e_, k0); });
#pragma unroll
        for (int e_ = 0; e_ < TO; ++e_)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int s_ = m0 + g + 8 * (e >> 1);
            const int i = n00 + 8 * e_ + 2 * tq + (e & 1);
            // dr^inter, kept where k o dk^inter goes (this thread's own
            // entries, read back before it writes them)
            const float dri =
                e1[s_ * PE + i] * seth[i] * (acc[e_][e] + cross[e_][e]);
            kdk[s_ * PE + i] = dri;
            rdr[s_ * PE + i] = to_f(cr[s_ * PV + i]) * dri;
          }
      }
      __syncthreads();
      if (tid == 0) *flag = 0;
      pc.mark(4);

      // -- dS_{c+1} to X ----------------------------------------------------
      if (s_role)
#pragma unroll
        for (int nn = 0; nn < TS; ++nn)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = s_i0 + g + 8 * (e >> 1);
            const int j = 8 * (s_n0 + nn) + 2 * tq + (e & 1);
            if constexpr (XS) {
              reinterpret_cast<uint2*>(X)[i * PX + j] =
                  split_tf32(st[nn][e]);
            } else {
              reinterpret_cast<float*>(X)[i * PX + j] = st[nn][e];
            }
          }
      __syncthreads();
      pc.mark(5);

      // -- products: dr, dk, dv of this warp's tiles; the dS update -------
      // (d 128 takes its two tiles one at a time: registers)
      constexpr int TG = D == 128 ? 1 : TO;
#pragma unroll
      for (int g0 = 0; g0 < TO; g0 += TG) {
        if (!t_role) break;
        const int n0g = n00 + 8 * g0;
        {
          // dq_in = dA k_in over steps a < m0 + 16
          float acc[TG][4] = {}, cross[TG][4] = {};
          strip_product<TG, 4, false, false>(
              acc, cross, 0, m0 + 16,
              [&](FragA& f, int k0) {
                frag_a<PA, 1>(f, sdA + (m0 + g) * PA + k0 + tq);
              },
              [&](FragB& f, int e_, int k0) {
                frag_b<PF>(f, fk + (k0 + tq) * PF + n0g + 8 * e_ + g);
              });
#pragma unroll
          for (int e_ = 0; e_ < TG; ++e_)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const int s_ = m0 + g + 8 * hh, i = n0g + 8 * e_ + 2 * tq;
              float o[2];
#pragma unroll
              for (int ee = 0; ee < 2; ++ee) {
                const int e = 2 * hh + ee;
                o[ee] = fmaf(e1[s_ * PE + i + ee], acc[e_][e] + cross[e_][e],
                             fmaf(su[i + ee] * to_f(ck[s_ * PV + i + ee]),
                                  svdy[s_], kdk[s_ * PE + i + ee]));
              }
              if (s_ < nval)
                store2(dr + ((long long)blk_b() * S + t0 + s_) * HD + blk_h() * D + i,
                       o[0], o[1]);
            }
        }
        {
          // dk_in = dA^T q_in over steps b >= m0; dk^inter = v dS^T
          float acc[TG][4] = {}, cross[TG][4] = {};
          float acc2[TG][4] = {}, cross2[TG][4] = {};
          strip_product<TG, 4, false, false>(
              acc, cross, m0, C,
              [&](FragA& f, int k0) {
                frag_a<1, PA>(f, sdA + (k0 + tq) * PA + m0 + g);
              },
              [&](FragB& f, int e_, int k0) {
                frag_b<PF>(f, fq + (k0 + tq) * PF + n0g + 8 * e_ + g);
              });
          strip_product<TG, KU, EX, false>(
              acc2, cross2, 0, D,
              [&](FragA& f, int k0) {
                frag_a<PV, 1, EX>(f, cv + (m0 + g) * PV + k0 + tq);
              },
              [&](FragB& f, int e_, int k0) { x_row(f, n0g + 8 * e_, k0); });
#pragma unroll
          for (int e_ = 0; e_ < TG; ++e_)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const int s_ = m0 + g + 8 * hh, i = n0g + 8 * e_ + 2 * tq;
              float o[2];
#pragma unroll
              for (int ee = 0; ee < 2; ++ee) {
                const int e = 2 * hh + ee;
                const float f2 = e2[s_ * PE + i + ee];
                const float dki =
                    f2 * seth[i + ee] * (acc2[e_][e] + cross2[e_][e]);
                kdk[s_ * PE + i + ee] = to_f(ck[s_ * PV + i + ee]) * dki;
                o[ee] = fmaf(f2, acc[e_][e] + cross[e_][e],
                             fmaf(su[i + ee] * to_f(cr[s_ * PV + i + ee]),
                                  svdy[s_], dki));
              }
              if (s_ < nval)
                store2(dk + ((long long)blk_b() * S + t0 + s_) * HD + blk_h() * D + i,
                       o[0], o[1]);
            }
        }
        {
          // dv = A^T dy over steps b >= m0, + k_carry dS over channels
          float acc[TG][4] = {}, cross[TG][4] = {};
          strip_product<TG, 4, false, EX>(
              acc, cross, m0, C,
              [&](FragA& f, int k0) {
                frag_a<1, PA>(f, sA + (k0 + tq) * PA + m0 + g);
              },
              [&](FragB& f, int e_, int k0) {
                frag_b<PV, EX>(f, cdy + (k0 + tq) * PV + n0g + 8 * e_ + g);
              });
          strip_product<TG, KU, false, false>(
              acc, cross, 0, D,
              [&](FragA& f, int k0) {
                frag_a<PF, 1>(f, fc + (m0 + g) * PF + k0 + tq);
              },
              [&](FragB& f, int e_, int k0) { x_col(f, n0g + 8 * e_, k0); });
#pragma unroll
          for (int e_ = 0; e_ < TG; ++e_)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const int s_ = m0 + g + 8 * hh, j = n0g + 8 * e_ + 2 * tq;
              float o[2];
#pragma unroll
              for (int ee = 0; ee < 2; ++ee) {
                const int e = 2 * hh + ee;
                o[ee] = fmaf(sruk[s_], to_f(cdy[s_ * PV + j + ee]),
                             acc[e_][e] + cross[e_][e]);
              }
              if (s_ < nval)
                store2(dv + ((long long)blk_b() * S + t0 + s_) * HD + blk_h() * D + j,
                       o[0], o[1]);
            }
        }
      }
      if (s_role) state_update(fr, cdy);  // dS_c = e^tot dS + r_e^T dy
      __syncthreads();
      pc.mark(6);

      // -- dlogw and du: TPC threads a channel, NB steps b each ------------
      du_steps(cr, ck);
      {
        const int i = tid / TPC, q = tid % TPC, b0 = q * NB;
        float qv[NB], R[NB], o[NB];
#pragma unroll
        for (int m = 0; m < NB; ++m) {
          qv[m] = joined(fq[(b0 + m) * PF + i]);
          R[m] = 0.f;
        }
        // sum_{s' > s} r o dr^inter, into the steps of this thread
        float run = 0.f;
#pragma unroll
        for (int s = C - 1; s >= 0; --s) {
          if (s / NB == q) o[s % NB] = run;
          run += rdr[s * PE + i];
        }
        run = 0.f;
#pragma unroll
        for (int s = 0; s < C; ++s) {
          if constexpr (D == 128)  // (registers: one step's loads at a time)
            asm volatile("" ::: "memory");
          // sum_{b > s} q_in[b] R[b], R[b] = sum_{a < s} k_in[a] dA[b, a]:
          // q_in[b] is zeroed once s reaches b, and dA^T is 0 for b <= s
          qv[s % NB] = q == s / NB ? 0.f : qv[s % NB];
          float pa = 0.f, pb = 0.f;
#pragma unroll
          for (int m = 0; m < NB; m += 2) {
            pa = fmaf(qv[m], R[m], pa);
            if (m + 1 < NB) pb = fmaf(qv[m + 1], R[m + 1], pb);
          }
          float part = pa + pb;
#pragma unroll
          for (int off = 1; off < TPC; off <<= 1)
            part += __shfl_xor_sync(0xffffffffu, part, off);
          if (s / NB == q) o[s % NB] += run + part;
          run += kdk[s * PE + i];
          const float ks = joined(fk[s * PF + i]);
          float dat[NB];
          if constexpr (NB % 4 == 0) {
#pragma unroll
            for (int m = 0; m < NB; m += 4) {
              const float4 v4 =
                  *reinterpret_cast<const float4*>(dAT + s * PT + b0 + m);
              dat[m] = v4.x;
              dat[m + 1] = v4.y;
              dat[m + 2] = v4.z;
              dat[m + 3] = v4.w;
            }
          } else {
#pragma unroll
            for (int m = 0; m < NB; ++m) dat[m] = dAT[s * PT + b0 + m];
          }
#pragma unroll
          for (int m = 0; m < NB; ++m) R[m] = fmaf(ks, dat[m], R[m]);
        }
        float pp = 0.f;
#pragma unroll
        for (int w = 0; w < WPS; ++w) pp += ppart[w * D + i];
        const float ep = setot[i] * pp;
#pragma unroll
        for (int m = 0; m < NB; ++m)
          if (b0 + m < nval)
            dlogw[((long long)blk_b() * S + t0 + b0 + m) * HD + blk_h() * D + i] =
                ep + o[m];
      }
    } else {
      // ====== a chunk past the guards, step by step ======================
      float* sw = e1;                 // exp(logw), (C, d)
      float* prow = rdr;              // (3, WPS, d): S_t dy, dS v, S_t o dS
      float* pcol = prow + 3 * WPS * D;  // (d / 16, d): dS^T k
      for (int idx = tid; idx < C * D; idx += NT) sw[idx] = expf(cw[idx]);
      du_steps(cr, ck);
      __syncthreads();
      if (tid == 0) *flag = 0;
      for (int t = nval - 1; t >= 0; --t) {
        if (s_role) {
          float ar[2] = {0.f, 0.f}, ak[2] = {0.f, 0.f}, aw[2] = {0.f, 0.f};
          float kt[2];
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
            kt[hh] = to_f(ck[t * PV + s_i0 + g + 8 * hh]);
#pragma unroll
          for (int nn = 0; nn < TS; ++nn) {
            // S_t of this tile: S_c from the workspace advanced t steps
            const float4 q = *reinterpret_cast<const float4*>(wsc + 4 * nn);
            float cur[4] = {q.x, q.y, q.z, q.w};
            const int j0 = 8 * (s_n0 + nn) + 2 * tq;
            for (int s = 0; s < t; ++s) {
              const float v0 = to_f(cv[s * PV + j0]);
              const float v1 = to_f(cv[s * PV + j0 + 1]);
#pragma unroll
              for (int hh = 0; hh < 2; ++hh) {
                const int i = s_i0 + g + 8 * hh;
                const float wi = sw[s * D + i], ki = to_f(ck[s * PV + i]);
                cur[2 * hh] = fmaf(wi, cur[2 * hh], ki * v0);
                cur[2 * hh + 1] = fmaf(wi, cur[2 * hh + 1], ki * v1);
              }
            }
            float col[2];
#pragma unroll
            for (int ee = 0; ee < 2; ++ee) {
              const float dyj = to_f(cdy[t * PV + j0 + ee]);
              const float vj = to_f(cv[t * PV + j0 + ee]);
#pragma unroll
              for (int hh = 0; hh < 2; ++hh) {
                const int e = 2 * hh + ee;
                ar[hh] = fmaf(cur[e], dyj, ar[hh]);
                ak[hh] = fmaf(st[nn][e], vj, ak[hh]);
                aw[hh] = fmaf(cur[e], st[nn][e], aw[hh]);
              }
              col[ee] = fmaf(st[nn][2 + ee], kt[1], st[nn][ee] * kt[0]);
#pragma unroll
              for (int off = 4; off < 32; off <<= 1)
                col[ee] += __shfl_xor_sync(0xffffffffu, col[ee], off);
            }
            if (g == 0)
              store2(pcol + (s_i0 / 16) * D + j0, col[0], col[1]);
          }
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
            for (int off = 1; off < 4; off <<= 1) {
              ar[hh] += __shfl_xor_sync(0xffffffffu, ar[hh], off);
              ak[hh] += __shfl_xor_sync(0xffffffffu, ak[hh], off);
              aw[hh] += __shfl_xor_sync(0xffffffffu, aw[hh], off);
            }
            if (tq == 0) {
              const int row = (warp % WPS) * D + s_i0 + g + 8 * hh;
              prow[row] = ar[hh];
              prow[WPS * D + row] = ak[hh];
              prow[2 * WPS * D + row] = aw[hh];
            }
          }
        }
        __syncthreads();
        const long long at = ((long long)blk_b() * S + t0 + t) * HD + blk_h() * D;
        if (tid < D) {
          const int i = tid;
          float a3[3] = {0.f, 0.f, 0.f};
#pragma unroll
          for (int kd = 0; kd < 3; ++kd)
            for (int w = 0; w < WPS; ++w) a3[kd] += prow[(kd * WPS + w) * D + i];
          const float bonus = su[i] * svdy[t];
          const float o_r = fmaf(bonus, to_f(ck[t * PV + i]), a3[0]);
          const float o_k = fmaf(bonus, to_f(cr[t * PV + i]), a3[1]);
          if constexpr (EX) {
            dr[at + i] = __float2bfloat16(o_r);
            dk[at + i] = __float2bfloat16(o_k);
          } else {
            dr[at + i] = o_r;
            dk[at + i] = o_k;
          }
          dlogw[at + i] = sw[t * D + i] * a3[2];
        } else if (tid < 2 * D) {
          const int j = tid - D;
          float a = 0.f;
          for (int sp = 0; sp < D / 16; ++sp) a += pcol[sp * D + j];
          const float o_v = fmaf(sruk[t], to_f(cdy[t * PV + j]), a);
          if constexpr (EX) {
            dv[at + j] = __float2bfloat16(o_v);
          } else {
            dv[at + j] = o_v;
          }
        }
        if (s_role) {
          // dS_t = diag(w_t) dS_{t+1} + r_t dy_t^T
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int i = s_i0 + g + 8 * hh;
            const float wi = sw[t * D + i], ri = to_f(cr[t * PV + i]);
#pragma unroll
            for (int nn = 0; nn < TS; ++nn)
#pragma unroll
              for (int ee = 0; ee < 2; ++ee)
                st[nn][2 * hh + ee] = fmaf(
                    wi, st[nn][2 * hh + ee],
                    ri * to_f(cdy[t * PV + 8 * (s_n0 + nn) + 2 * tq + ee]));
          }
        }
        __syncthreads();
      }
      pc.mark(8);
    }
    __syncthreads();  // the slot, the factors and X are free
    pc.mark(7);
  }
  pc.flush();

  if (ds0 && s_role)
#pragma unroll
    for (int nn = 0; nn < TS; ++nn)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        *reinterpret_cast<float2*>(
            ds0 + ((long long)blk_b() * H + blk_h()) * D * D +
            (long long)(s_i0 + g + 8 * hh) * D + 8 * (s_n0 + nn) + 2 * tq) =
            make_float2(st[nn][2 * hh], st[nn][2 * hh + 1]);
  // du of (b, h): the TPC parts of each channel added in part order
  float* red = rdr;
  red[tid] = du_acc;  // thread (i, q) at i TPC + q
  __syncthreads();
  if (tid < D) {
    float a = 0.f;
    for (int q = 0; q < TPC; ++q) a += red[tid * TPC + q];
    du_part[((long long)blk_b() * H + blk_h()) * D + tid] = a;
  }
}

// du (H, d): the blocks' partials added batch by batch.
__global__ void wkv6_bwd_du_kernel(const float* __restrict__ du_part, int B,
                                   int hd, float* __restrict__ du) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= hd) return;
  float acc = 0.f;
  for (int b = 0; b < B; ++b) acc += du_part[(long long)b * hd + e];
  du[e] = acc;
}

// The map of a (B, S, H, D) view with element strides st as dims
// (D, S, H, B), boxes of (cols, rows, 1, 1).
bool make_map(CUtensorMap* m, const void* base, bool bf16, int B, int S,
              int H, int D, const Strides& st, int cols, int rows) {
  const unsigned long long dims[4] = {(unsigned long long)D,
                                      (unsigned long long)S,
                                      (unsigned long long)H,
                                      (unsigned long long)B};
  const long long strides[4] = {1, st.s, st.h, st.b};
  const unsigned box[4] = {(unsigned)cols, (unsigned)rows, 1, 1};
  return encode_map(m, base, bf16, 4, dims, strides, box);
}

template <typename T, int D>
int launch_d(const void* r, const void* k, const void* v, const float* logw,
             const float* u, const float* s0, const void* dy,
             const float* ds_last, void* dr, void* dk, void* dv,
             float* dlogw, float* du, float* ds0, float* ws, int B, int S,
             int H, const Strides* st, cudaStream_t stream) {
  using L = Layout<T, D>;
  static bool attr_set = false;  // once per instantiation and process
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        wkv6_bwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        L::BYTES);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  constexpr bool bf16 = sizeof(T) == 2;
  Maps m;
  if (!make_map(&m.r, r, bf16, B, S, H, D, st[0], L::PV, L::C) ||
      !make_map(&m.k, k, bf16, B, S, H, D, st[1], L::PV, L::C) ||
      !make_map(&m.v, v, bf16, B, S, H, D, st[2], L::PV, L::C) ||
      !make_map(&m.w, logw, false, B, S, H, D, st[3], D, L::C) ||
      !make_map(&m.dy, dy, bf16, B, S, H, D, st[4], L::PV, L::C))
    return -2;
  const int n_chunks = (S + L::C - 1) / L::C;
  float* du_part = ws + (long long)n_chunks * B * H * D * D;
  wkv6_bwd_kernel<T, D><<<dim3(H, B), NT, L::BYTES, stream>>>(
      u, s0, ds_last, static_cast<T*>(dr), static_cast<T*>(dk),
      static_cast<T*>(dv), dlogw, du_part, ds0, ws, S, H, m);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  wkv6_bwd_du_kernel<<<(H * D + 255) / 256, 256, 0, stream>>>(du_part, B,
                                                             H * D, du);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(int D, const void* r, const void* k, const void* v,
           const float* logw, const float* u, const float* s0,
           const void* dy, const float* ds_last, void* dr, void* dk,
           void* dv, float* dlogw, float* du, float* ds0, float* ws, int B,
           int S, int H, const Strides* st, cudaStream_t stream) {
  switch (D) {
    case 16: return launch_d<T, 16>(r, k, v, logw, u, s0, dy, ds_last, dr, dk, dv, dlogw, du, ds0, ws, B, S, H, st, stream);
    case 32: return launch_d<T, 32>(r, k, v, logw, u, s0, dy, ds_last, dr, dk, dv, dlogw, du, ds0, ws, B, S, H, st, stream);
    case 64: return launch_d<T, 64>(r, k, v, logw, u, s0, dy, ds_last, dr, dk, dv, dlogw, du, ds0, ws, B, S, H, st, stream);
    case 128: return launch_d<T, 128>(r, k, v, logw, u, s0, dy, ds_last, dr, dk, dv, dlogw, du, ds0, ws, B, S, H, st, stream);
    default: return -1;
  }
}

}  // namespace

// C entry point: launches on `stream` and returns cudaGetLastError(), -2
// if the tensor maps cannot be made (cuTensorMapEncodeTiled is missing
// or refuses the strides), or -1 for a head dim other than 16, 32, 64 and
// 128.  is_bf16 selects bfloat16 (1) or float32 (0) for r, k, v, dy, dr,
// dk and dv.  s0 and ds_last may be null (zero), and ds0 null (not
// wanted); s0 and ds_last are dense.  dr, dk, dv and dlogw are dense
// (B, S, H, d), du (H, d), ds0 (B, H, d, d).  ws holds chunks B H d^2 +
// B H d floats (the states entering each chunk, du's partials; chunks =
// ceil(S / C), C = 32, or 16 at d = 128).  strides: 15 element strides,
// (batch, seq, head) of r, k, v, logw and dy in that order; their rows
// 16-byte aligned.
extern "C" int wkv6_bwd_launch(int is_bf16, int D, const void* r,
                               const void* k, const void* v,
                               const void* logw, const void* u,
                               const void* s0, const void* dy,
                               const void* ds_last, void* dr, void* dk,
                               void* dv, void* dlogw, void* du, void* ds0,
                               void* ws, int B, int S, int H,
                               const long long* strides, void* stream) {
  const long long* q = strides;
  const Strides st[5] = {{q[0], q[1], q[2]},
                         {q[3], q[4], q[5]},
                         {q[6], q[7], q[8]},
                         {q[9], q[10], q[11]},
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
    return launch<__nv_bfloat16>(D, r, k, v, lw, uu, s0f, dy, dsl, dr, dk,
                                 dv, dlw, duf, ds0f, w, B, S, H, st, s);
  return launch<float>(D, r, k, v, lw, uu, s0f, dy, dsl, dr, dk, dv, dlw,
                       duf, ds0f, w, B, S, H, st, s);
}

#ifdef WKV6_BWD_PHASE_CLOCKS
// Copies the phase clocks of the last launch (NW warps x N_PHASES, cycles)
// to `out`; returns the CUDA error.
extern "C" int wkv6_bwd_phase_clocks(unsigned* out) {
  return (int)cudaMemcpyFromSymbol(out, phase_clocks, sizeof(phase_clocks));
}
#endif
