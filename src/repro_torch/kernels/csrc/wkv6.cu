// RWKV-6 WKV recurrence for Hopper (sm_90a).
//
// Replaces the Pallas kernel src/repro/kernels/rwkv6_scan.py:_wkv6_kernel.
// For r, k, v, logw (B, S, H, d) and u (H, d), per (b, h) a d x d float32
// state S (rows i index k, columns j index v) is carried over the sequence:
//   y[t, j] = sum_i r[t, i] (S[i, j] + u[i] k[t, i] v[t, j])
//   S[i, j] <- exp(logw[t, i]) S[i, j] + k[t, i] v[t, j]
// from S = s0 (a float32 (B, H, d, d) state, 0 when none is given); the
// final S is written to s_last.  y comes out in r's type, the carry is
// float32.  r, k and v are float32 or bfloat16 alike, logw (any value
// <= 0) and u float32; d is 16, 32, 64 or 128; any B and any S.  r, k, v
// and logw come as (B, S, H, d) views with their own (batch, seq, head)
// strides, the last dimension contiguous, rows 16-byte aligned (the
// wrapper copies a view that is not); y and s_last are dense.
//
// Bound: memory bytes.  The chunked form below does 4 C d + 4 d^2 flops
// per token and head on the tensor cores (C the chunk: the scores and A v
// over the chunk, q_in S' and the state update), three TF32 products each
// in split precision: 6.4 GFLOP at the 4096-token prefill of 64 heads of
// 64, 0.039 ms at the card's TF32 rate even tripled, against r, k, v
// (bf16), logw (float32) and y read or written once, 0.060 ms at the
// memory rate.  Decode (S = 1) reads s0 and writes s_last, 2 d^2 floats a
// head, for 5 d^2 flops.
//
// Prefill (S > 1): the TPU kernel's chunked (GLA) form, one block of 16
// warps per (b, h, VB value columns): the columns of S are independent, so
// d / VB blocks share a head with no carry between them (VB is 32 at d 32
// and 64, else 16: at batch 1 rwkv6-7b's 64 heads of 64 make 128 blocks,
// one an SM), and each walks the sequence in chunks of C steps (32, or 16
// at d = 128).  Per chunk, with cum the inclusive and cume the exclusive
// sum of logw over the chunk and total its sum, all per channel i, and
// theta = total / 2:
//   * phase A (the producer warps): the sums cum (a thread a channel, in
//     step order), exp(total), exp(theta), the bonus r u k of each step
//     (8 lanes a step), q_in = r exp(cume - theta),
//     k_in = k exp(theta - cum) and k_carry = k exp(total - cum) (a thread
//     a channel and 8 steps);
//   * phase B (the consumer warps, each its items): S' = diag(exp(theta))
//     S from the registers that hold S; the scores A = q_in k_in^T
//     strictly below the diagonal, 0 elsewhere (entries above the
//     diagonal can overflow to inf, so they are set by select, never by a
//     product with 0); q_in S' (= r exp(cume) S, the entering state's part
//     of y); S <- diag(exp(total)) S + k_carry^T v;
//   * phase C (the consumers): y = q_in S' + A v + (r u k) v, out.
// The products run on mma.sync m16n8k8 in split TF32 (mma_tf32.cuh): a
// float32 operand is split once, where it is made, into TF32 parts
// hi + lo kept side by side in shared memory, and hi*hi + hi*lo + lo*hi
// summed in float32; v from bfloat16 is exact in TF32 and is not split.
// hi*hi and the cross terms go to separate accumulators, so a warp has
// independent mma chains in flight.  One TF32 product alone is 15-30x past
// the kernel's tolerance at the model's decays (tests/test_torch_wkv6.py
// pins it).  The recentring bounds q_in and k_in by |r| and |k| times
// exp(|total| / 2), and each product the chunk sums (the scores below the
// diagonal, q_in S', k_carry^T v) by what the serial recurrence sums, so
// nothing overflows where it does not.  exp(|total| / 2) stays within
// float32 while total >= TOTAL_MIN (-165; the model clamps logw at -5, so
// C = 32 steps reach -160).  A chunk with a channel below that, or with a
// factor q_in or k_in past FACTOR_MAX (|r| or |k| in the hundreds near
// TOTAL_MIN), is evaluated step by step by the consumers (phase C'), so
// any logw <= 0 stays finite.
//
// Pipeline: 8 producer warps run phase A a chunk ahead of the 8 consumer
// warps, into the other of two factor buffers, handing them over by named
// barriers (full / empty); one producer thread has the copy engine (TMA)
// bring chunk c + 1's r, k, logw and the block's v columns as four boxes
// into a three-slot ring, counted on an mbarrier (rows past S arrive as
// zeros: logw 0 and k, v 0 leave S as it is); per-thread 16-byte copies
// of the same rows take longer to issue than the chunk's arithmetic.
// S stays in the consumers' registers for the whole launch; factors, A
// and S' in shared memory, rows padded so that the fragment loads (8-byte
// words) are free of bank conflicts; 60-230 KB a block, one block an SM.
// Each thread reads what a step needs before it stores to shared memory:
// the compiler keeps loads behind possibly aliasing stores, and a chain
// of such pairs costs more than the arithmetic around it.  A block's
// arithmetic does not depend on the other blocks, so the bits do not
// depend on block timing.
//
// Decode (S = 1, from s0): wkv6_step_kernel, one block per (b, h, 16
// value columns), every thread 16-byte pieces of rows of s0 read and of
// s_last written (coalesced), y summed over the rows by shuffles and then
// across the warps in a fixed order.  d / 16 blocks a head cover the card
// at batch 1.
// Offsets are 64-bit.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

#include "mma_bf16.cuh"
#include "mma_tf32.cuh"
#include "tma.cuh"

constexpr int CHUNK_THREADS = 512;  // the prefill kernel's 16 warps
constexpr int CONSUMER_WARPS = 8;   // of them phases B and C's
constexpr int THREADS = 128;        // the decode kernel's four
constexpr float TOTAL_MIN = -165.f;
constexpr float FACTOR_MAX = 1e38f;  // its TF32 parts stay finite

#ifdef WKV6_PHASE_CLOCKS
// Cycles each warp of block (0, 0, 0) of a prefill spends in each phase
// (the marks below), summed over its chunks in registers and written
// once: built with this defined by scripts/recurrence_ab.py --phases,
// read by wkv6_phase_clocks.  A producer's phases: waiting for a free
// factor buffer, for the copy, A1, A1's barrier, A2, A2's barrier; a
// consumer's: waiting for the factors, S' (and its barrier), phase B, B's
// barrier, phase C (or C'), C's barrier.
constexpr int N_PHASES = 6;
__device__ unsigned phase_clocks[CHUNK_THREADS / 32][N_PHASES];
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
    if ((threadIdx.x & 31) == 0 && (blockIdx.x | blockIdx.y | blockIdx.z) == 0)
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

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

struct Strides {
  long long b, s, h;
};

struct Args {
  Strides r, k, v, w;
  long long s0_b, s0_h;
};

// Shared memory of the chunked kernel, in bytes from the start: the ring
// (three slots of r, k, v, logw); two factor buffers, each q_in, k_in and
// k_carry in TF32 parts, the bonus per step, exp(total) and exp(theta) per
// channel and the chunk's step-by-step flag (in a chunk evaluated step by
// step, S in float32 and the threads' partial sums in place of the
// factors); the matrix A and S' in TF32 parts; the inclusive sums of
// logw; u; three copy barriers.
template <typename T, int D, int VB>
struct Layout {
  static constexpr int C = D <= 64 ? 32 : 16;  // steps per chunk
  static constexpr int PV = VB + 8;   // ring v row pitch (elements)
  static constexpr int PF = D + 4;    // factor row pitch (8-byte words)
  static constexpr int PA = C + 4;    // A row pitch (8-byte words)
  static constexpr int PS = VB + 4;   // S' row pitch (8-byte words)
  static constexpr int R_B = C * D * (int)sizeof(T);
  static constexpr int V_B = C * PV * (int)sizeof(T);
  static constexpr int W_B = C * D * 4;
  static constexpr int SLOT = 2 * R_B + V_B + W_B;
  static constexpr int FACT_B = 8 * 3 * C * PF;  // q_in, k_in, k_carry
  static constexpr int FB = (FACT_B + 4 * (C + 2 * D + 4) + 127) / 128 * 128;
  static constexpr int FB0 = 3 * SLOT;
  static constexpr int FA = FB0 + 2 * FB;
  static constexpr int SS = FA + 8 * C * PA;
  static constexpr int CUM = SS + 8 * D * PS;
  static constexpr int SU = CUM + 4 * C * D;
  static constexpr int BAR = (SU + 4 * D + 7) / 8 * 8;
  static constexpr int BYTES = BAR + 3 * 8;
  static_assert(BYTES <= 232448, "fits a block's shared memory");
  static_assert(R_B % 128 == 0 && V_B % 128 == 0 && W_B % 128 == 0,
                "copy-engine boxes land 128-byte aligned");
  static_assert(VB * (int)sizeof(T) % 16 == 0, "v rows in 16-byte pieces");
};

// The tensor maps of a prefill's r, k, v and logw: each a (B, S, H, d)
// view described as dims (d, S, H, B), read in boxes of (columns, C, 1, 1)
struct Maps {
  CUtensorMap r, k, v, w;
};

// Start the copies of chunk rows [t0, t0 + C) of head h, batch b into a
// ring slot: four boxes issued by one thread, counted against the slot's
// barrier (v's box is the block's VB columns and 8 more, zeros past d, so
// that its rows land with the padded pitch).
template <typename T, int D, int VB>
__device__ __forceinline__ void load_chunk(unsigned char* slot,
                                           uint64_t* bar, const Maps& m,
                                           int j0, int t0, int h, int b) {
  using L = Layout<T, D, VB>;
  mbar_expect(bar, 2 * L::R_B + L::V_B + L::W_B);
  tma_load(slot, &m.r, 0, t0, h, b, bar);
  tma_load(slot + L::R_B, &m.k, 0, t0, h, b, bar);
  tma_load(slot + 2 * L::R_B, &m.v, j0, t0, h, b, bar);
  tma_load(slot + 2 * L::R_B + L::V_B, &m.w, 0, t0, h, b, bar);
}

// Named barriers (0 is __syncthreads): a factor buffer full and empty,
// the consumers', the producers'.
constexpr int BAR_FULL = 1, BAR_EMPTY = 3, BAR_CONS = 5, BAR_PROD = 6;

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// B fragment of v (rows k0 + tq, k0 + tq + 4, column n): exact from
// bfloat16, split from float32
template <typename T>
__device__ __forceinline__ void v_frag(FragB& f, const T* v0, int pitch) {
  if constexpr (sizeof(T) == 2) {
    f.set_exact(to_f(v0[0]), to_f(v0[4 * pitch]));
  } else {
    f.set(to_f(v0[0]), to_f(v0[4 * pitch]));
  }
}

// A fragment of rows m0.. and columns k0.. of a row-major matrix of TF32
// parts with row pitch P, from its element (m0, k0)
template <int P>
__device__ __forceinline__ void a_frag(FragA& f, const uint2* m, int g,
                                       int tq) {
  const uint2* a0 = m + g * P + tq;
  f.load(a0[0], a0[8 * P], a0[4], a0[8 * P + 4]);
}

__device__ __forceinline__ float rcp_approx(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <typename T, int D, int VB>
__global__ void __launch_bounds__(CHUNK_THREADS, 1)
wkv6_chunk_kernel(const float* __restrict__ u, const float* __restrict__ s0,
                  T* __restrict__ y, float* __restrict__ s_last, int S,
                  int H, Args a, const __grid_constant__ Maps maps) {
  using L = Layout<T, D, VB>;
  constexpr int C = L::C;
  constexpr int NT_ = CHUNK_THREADS;
  constexpr int NCW = CONSUMER_WARPS, NCT = 32 * NCW;  // consumers
  constexpr int NPT = NT_ - NCT;                        // producers
  constexpr int NM = C / 16;          // strips of the chunk's steps
  constexpr int NV = VB / 8;          // 8-column tiles of the block
  constexpr int NVS = NV < 4 ? NV : 4;  // tiles of an S item
  constexpr int NSI = (D / 16) * (NV / NVS);  // S items: (strip, group)
  constexpr int YG = NV < 2 ? NV : 2;   // tiles of a y item
  constexpr int NYI = NM * (NV / YG);   // y items: (strip, group)
  constexpr int NAI = NM * (NM + 1) / 2;  // score items: (strip, pair)
  constexpr bool EXACT_V = sizeof(T) == 2;
  static_assert(NSI <= NCW && NYI <= NCW && NAI <= NCW,
                "the items fit the consumer warps");
  static_assert(4 * (D * VB + NCT) <= L::FACT_B, "step-by-step scratch");
  extern __shared__ __align__(128) unsigned char smem[];
  uint2* sA = reinterpret_cast<uint2*>(smem + L::FA);     // A
  uint2* sS = reinterpret_cast<uint2*>(smem + L::SS);     // S', TF32 parts
  float* scum = reinterpret_cast<float*>(smem + L::CUM);  // (C, D)
  float* su = reinterpret_cast<float*>(smem + L::SU);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BAR);
  // factor buffer f: q_in, k_in, k_carry, then the bonus, exp(total),
  // exp(theta) and the flag
  auto fbuf = [&](int f) { return smem + L::FB0 + f * L::FB; };
  auto fq_of = [&](int f) { return reinterpret_cast<uint2*>(fbuf(f)); };
  auto misc_of = [&](int f) {
    return reinterpret_cast<float*>(fbuf(f) + L::FACT_B);
  };

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int j0 = blockIdx.x * VB, h = blockIdx.y, b = blockIdx.z;
  T* yp = y + (long long)b * S * H * D + (long long)h * D + j0;
  const int n_chunks = (S + C - 1) / C;

  for (int i = tid; i < D; i += NT_) su[i] = u[(long long)h * D + i];
  for (int i = tid; i < 2; i += NT_)  // the flags start clear
    reinterpret_cast<int*>(misc_of(i) + C + 2 * D)[0] = 0;
  if (tid == 0) {
    for (int q = 0; q < 3; ++q) mbar_init(full + q, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= NCT) {
    // ====== producers: copies, and phases A1 and A2 a chunk ahead =======
    const int pt = tid - NCT;
    if (pt == 0 && n_chunks > 0)
      load_chunk<T, D, VB>(smem, full, maps, j0, 0, h, b);
    PhaseClock pc;
    for (int x = 0; x < n_chunks; ++x) {
      const int f = x & 1;
      if (x >= 2) bar_sync(BAR_EMPTY + f, NT_);  // consumers left x - 2
      pc.mark(0);
      if (pt == 0 && x + 1 < n_chunks)
        load_chunk<T, D, VB>(smem + ((x + 1) % 3) * L::SLOT,
                             full + (x + 1) % 3, maps, j0, (x + 1) * C, h,
                             b);
      unsigned char* slot = smem + (x % 3) * L::SLOT;
      mbar_wait(full + x % 3, (x / 3) & 1);  // chunk x landed
      pc.mark(1);
      const T* cr = reinterpret_cast<const T*>(slot);
      const T* ck = reinterpret_cast<const T*>(slot + L::R_B);
      const float* cw =
          reinterpret_cast<const float*>(slot + 2 * L::R_B + L::V_B);
      float* sdiag = misc_of(f);
      float* setot = sdiag + C;
      float* seth = setot + D;
      int* flag = reinterpret_cast<int*>(seth + D);

      // -- A1: a thread a channel sums logw in step order (the inclusive
      // sums cum, the total and its decays), the threads of the later
      // warps the bonus r u k of each step.  Loads come before stores, so
      // that stores do not hold the loads back.
      constexpr int PREFIX = (D + 31) / 32 * 32;
      static_assert(NPT - PREFIX >= 32, "a warp for the bonus");
      if (pt < D) {
        const int i = pt;
        float lw[C];
#pragma unroll
        for (int t = 0; t < C; ++t) lw[t] = cw[t * D + i];
        float run = 0.f;
#pragma unroll
        for (int t = 0; t < C; ++t) {
          run += lw[t];
          scum[t * D + i] = run;
        }
        if (run < TOTAL_MIN) *flag = 1;
        setot[i] = expf(run);
        seth[i] = expf(0.5f * run);
      } else if (pt >= PREFIX) {
        // the bonus r u k, LS lanes a step; lane l reads channels l + LS e
        // rotated by LS t, so that the steps of a warp fall on other banks
        constexpr int LS = 8, NG = (NPT - PREFIX) / LS;
        const int grp = (pt - PREFIX) / LS, l = (pt - PREFIX) % LS;
        for (int m = 0; m < (C + NG - 1) / NG; ++m) {
          const int t = grp + m * NG;
          float d = 0.f;
          if (t < C) {
            float rr[D / LS], kk[D / LS], uu[D / LS];
#pragma unroll
            for (int e = 0; e < D / LS; ++e) {
              const int i = (l + LS * e + LS * t) % D;
              rr[e] = to_f(cr[t * D + i]);
              kk[e] = to_f(ck[t * D + i]);
              uu[e] = su[i];
            }
#pragma unroll
            for (int e = 0; e < D / LS; ++e) d = fmaf(rr[e] * uu[e], kk[e], d);
          }
#pragma unroll
          for (int off = LS / 2; off > 0; off >>= 1)
            d += __shfl_xor_sync(0xffffffffu, d, off);
          if (t < C && l == 0) sdiag[t] = d;
        }
      }
      pc.mark(2);
      bar_sync(BAR_PROD, NPT);
      pc.mark(3);

      // -- A2: q_in = r E(t), k_in = k / E(t + 1) with E(t) =
      // exp(cume(t) - theta), cume(t) = cum(t - 1), and k_carry =
      // k_in exp(theta) = k exp(total - cum(t)), in TF32 parts; thread
      // (channel i, part p) of SP steps (a chunk evaluated step by step
      // needs none of them; a factor past FACTOR_MAX sends this one step
      // by step)
      if (!*flag) {
        constexpr int SP = C * D / NPT;
        static_assert(SP >= 1 && C * D % NPT == 0, "A2 covers the chunk");
        uint2* fq = fq_of(f);
        uint2* fk = fq + C * L::PF;
        uint2* fc = fk + C * L::PF;
        const int i = pt % D, p = pt / D;
        const float theta = 0.5f * scum[(C - 1) * D + i];
        const float eth = expf(theta);
        float cum[SP + 1], rr[SP], kk[SP];
        cum[0] = p == 0 ? 0.f : scum[(p * SP - 1) * D + i];
#pragma unroll
        for (int s_ = 0; s_ < SP; ++s_) {
          const int t = p * SP + s_;
          cum[s_ + 1] = scum[t * D + i];
          rr[s_] = to_f(cr[t * D + i]);
          kk[s_] = to_f(ck[t * D + i]);
        }
        float e_in = expf(cum[0] - theta), big = 0.f;
#pragma unroll
        for (int s_ = 0; s_ < SP; ++s_) {
          const int t = p * SP + s_;
          const float e_out = expf(cum[s_ + 1] - theta);
          const float q = rr[s_] * e_in, kin = kk[s_] * rcp_approx(e_out);
          big = fmaxf(big, fmaxf(fabsf(q), fabsf(kin)));
          fq[t * L::PF + i] = split_tf32(q);
          fk[t * L::PF + i] = split_tf32(kin);
          fc[t * L::PF + i] = split_tf32(kin * eth);
          e_in = e_out;
        }
        if (!(big <= FACTOR_MAX)) *flag = 1;
      }
      pc.mark(4);
      bar_sync(BAR_PROD, NPT);  // scum is free for the next chunk
      bar_arrive(BAR_FULL + f, NT_);
      pc.mark(5);
    }
    pc.flush();
    return;
  }

  // ====== consumers: phases B and C, S in registers ======================
  // items.  S item w (rows 16 (w / (NV / NVS)), tiles NVS (w % ..)) is
  // warp w's for the whole launch; y items (step strip m, YG tiles) go to
  // warps 0, 1, ..; the score items (step strip m, tile pair q <= m) to
  // the last warps
  const bool s_role = warp < NSI;
  const int s_i0 = 16 * (warp / (NV / NVS)), s_n0 = NVS * (warp % (NV / NVS));
  int a_m = -1, a_q = 0, y_m = -1, y_n0 = 0;
  if (warp >= NCW - NAI) {
    int m = 0, rest = warp - (NCW - NAI);
    while (rest > m) rest -= ++m;
    a_m = m;
    a_q = rest;
  }
  if (warp < NYI) {
    y_m = warp / (NV / YG);
    y_n0 = YG * (warp % (NV / YG));
  }

  // the S item's tiles: (s_i0 + g (+8), 8 (s_n0 + n) + 2 tq (+1))
  float st[NVS][4];
  if (s_role) {
#pragma unroll
    for (int n = 0; n < NVS; ++n)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float2 x = make_float2(0.f, 0.f);
        if (s0)
          x = *reinterpret_cast<const float2*>(
              s0 + b * a.s0_b + h * a.s0_h +
              (long long)(s_i0 + g + 8 * hh) * D + j0 + 8 * (s_n0 + n) +
              2 * tq);
        st[n][2 * hh] = x.x;
        st[n][2 * hh + 1] = x.y;
      }
  }

  PhaseClock pc;
  for (int x = 0; x < n_chunks; ++x) {
    const int f = x & 1, t0 = x * C, n = min(C, S - t0);
    bar_sync(BAR_FULL + f, NT_);  // chunk x's factors are ready
    mbar_wait(full + x % 3, (x / 3) & 1);  // (long since complete)
    pc.mark(0);
    const unsigned char* slot = smem + (x % 3) * L::SLOT;
    const T* cr = reinterpret_cast<const T*>(slot);
    const T* ck = reinterpret_cast<const T*>(slot + L::R_B);
    const T* cv = reinterpret_cast<const T*>(slot + 2 * L::R_B);
    const float* cw =
        reinterpret_cast<const float*>(slot + 2 * L::R_B + L::V_B);
    const uint2* fq = fq_of(f);
    const uint2* fk = fq + C * L::PF;
    const uint2* fc = fk + C * L::PF;
    float* sdiag = misc_of(f);
    const float* setot = sdiag + C;
    const float* seth = setot + D;
    int* flag = reinterpret_cast<int*>(misc_of(f) + C + 2 * D);
    const bool step_by_step = *flag != 0;

    if (!step_by_step) {
      // S' = diag(exp(theta)) S in TF32 parts, y's B operand
      if (s_role) {
        const float eh[2] = {seth[s_i0 + g], seth[s_i0 + g + 8]};
#pragma unroll
        for (int nn = 0; nn < NVS; ++nn)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            sS[(s_i0 + g + 8 * (e >> 1)) * L::PS + 8 * (s_n0 + nn) +
               2 * tq + (e & 1)] = split_tf32(eh[e >> 1] * st[nn][e]);
      }
      bar_sync(BAR_CONS, NCT);
      pc.mark(1);

      // -- phase B: each warp its items; hi*hi and the cross terms in
      // separate accumulators ------------------------------------------
      float yacc[YG][4] = {}, ycross[YG][4] = {};
      if (s_role) {
        // S <- exp(total) S + k_carry^T v
        float acc[NVS][4] = {}, cross[NVS][4] = {};
#pragma unroll
        for (int k0 = 0; k0 < C; k0 += 8) {
          FragA fa_;
          const uint2* c0 = fc + (k0 + tq) * L::PF + s_i0 + g;
          fa_.load(c0[0], c0[8], c0[4 * L::PF], c0[4 * L::PF + 8]);
#pragma unroll
          for (int nn = 0; nn < NVS; ++nn) {
            FragB fb_;
            v_frag(fb_, cv + (k0 + tq) * L::PV + 8 * (s_n0 + nn) + g, L::PV);
            mma_split<EXACT_V>(acc[nn], cross[nn], fa_, fb_);
          }
        }
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int i = s_i0 + g + 8 * hh;
          const float et = setot[i];
#pragma unroll
          for (int nn = 0; nn < NVS; ++nn)
#pragma unroll
            for (int e = 2 * hh; e < 2 * hh + 2; ++e)
              st[nn][e] = fmaf(et, st[nn][e], acc[nn][e] + cross[nn][e]);
        }
      }
      if (y_m >= 0) {
        // y = q_in S' now (S' is the chunk's entering state), A v after
        // the barrier
        const int m0 = 16 * y_m;
#pragma unroll 4
        for (int k0 = 0; k0 < D; k0 += 8) {
          FragA fa_;
          a_frag<L::PF>(fa_, fq + m0 * L::PF + k0, g, tq);
#pragma unroll
          for (int nn = 0; nn < YG; ++nn) {
            FragB fb_;
            const uint2* s_ = sS + (k0 + tq) * L::PS + 8 * (y_n0 + nn) + g;
            fb_.load(s_[0], s_[4 * L::PS]);
            mma_split<false>(yacc[nn], ycross[nn], fa_, fb_);
          }
        }
      }
      if (a_m >= 0) {
        // tiles 2 a_q, 2 a_q + 1 of step strip a_m of A = q_in k_in^T
        // strictly below the diagonal, 0 elsewhere (by select: above it
        // a product can be inf); the strip's last item writes the zero
        // tiles right of the diagonal
        const int m0 = 16 * a_m;
        float acc[2][4] = {}, cross[2][4] = {};
#pragma unroll 4
        for (int k0 = 0; k0 < D; k0 += 8) {
          FragA fa_;
          a_frag<L::PF>(fa_, fq + m0 * L::PF + k0, g, tq);
#pragma unroll
          for (int nn = 0; nn < 2; ++nn) {
            FragB fb_;
            const uint2* k0p =
                fk + (8 * (2 * a_q + nn) + g) * L::PF + k0 + tq;
            fb_.load(k0p[0], k0p[4]);
            mma_split<false>(acc[nn], cross[nn], fa_, fb_);
          }
        }
#pragma unroll
        for (int nn = 0; nn < 2; ++nn)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int ri = m0 + g + (e >> 1) * 8;
            const int cj = 8 * (2 * a_q + nn) + 2 * tq + (e & 1);
            sA[ri * L::PA + cj] =
                split_tf32(ri > cj ? acc[nn][e] + cross[nn][e] : 0.f);
          }
        if (a_q == a_m)
          for (int cj = m0 + 16 + 2 * tq; cj < C; cj += 8)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              sA[(m0 + g + (e >> 1) * 8) * L::PA + cj + (e & 1)] =
                  make_uint2(0u, 0u);
      }
      pc.mark(2);
      bar_sync(BAR_CONS, NCT);
      pc.mark(3);

      // -- phase C: y += A v + (r u k) v, and out --------------------------
      if (y_m >= 0) {
        const int m0 = 16 * y_m;
#pragma unroll
        for (int k0 = 0; k0 < C; k0 += 8) {
          FragA fa_;
          a_frag<L::PA>(fa_, sA + m0 * L::PA + k0, g, tq);
#pragma unroll
          for (int nn = 0; nn < YG; ++nn) {
            FragB fb_;
            v_frag(fb_, cv + (k0 + tq) * L::PV + 8 * (y_n0 + nn) + g, L::PV);
            mma_split<EXACT_V>(yacc[nn], ycross[nn], fa_, fb_);
          }
        }
        // the bonus and v read before y is stored
        float dt[2], vt[2][YG][2];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int t = m0 + g + 8 * hh;
          dt[hh] = sdiag[t];
#pragma unroll
          for (int nn = 0; nn < YG; ++nn)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              vt[hh][nn][e] =
                  to_f(cv[t * L::PV + 8 * (y_n0 + nn) + 2 * tq + e]);
        }
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int t = m0 + g + 8 * hh;
#pragma unroll
          for (int nn = 0; nn < YG; ++nn) {
            const float o0 = fmaf(dt[hh], vt[hh][nn][0],
                                  yacc[nn][2 * hh] + ycross[nn][2 * hh]);
            const float o1 =
                fmaf(dt[hh], vt[hh][nn][1],
                     yacc[nn][2 * hh + 1] + ycross[nn][2 * hh + 1]);
            if (t < n)
              store2(yp + (long long)(t0 + t) * H * D + 8 * (y_n0 + nn) +
                         2 * tq,
                     o0, o1);
          }
        }
      }
    } else {
      // -- phase C': a chunk past TOTAL_MIN, step by step -----------------
      // S in float32 in this chunk's factor buffer; thread (row group rg,
      // column j) owns rows rg + NG m of column j; y summed over the row
      // groups a step at a time
      float* sF = reinterpret_cast<float*>(fbuf(f));
      float* part = sF + D * VB;
      if (s_role)
#pragma unroll
        for (int nn = 0; nn < NVS; ++nn)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            sF[(s_i0 + g + 8 * (e >> 1)) * VB + 8 * (s_n0 + nn) + 2 * tq +
               (e & 1)] = st[nn][e];
      bar_sync(BAR_CONS, NCT);
      constexpr int NGR = (NCT / VB > D) ? D : NCT / VB;  // row groups
      const int j = tid % VB, rg = tid / VB;
      for (int t = 0; t < n; ++t) {
        float acc = 0.f;
        if (rg < NGR) {
          const float vj = to_f(cv[t * L::PV + j]);
          for (int i = rg; i < D; i += NGR) {
            const float kv = to_f(ck[t * D + i]) * vj;
            float* s_ = sF + i * VB + j;
            acc = fmaf(to_f(cr[t * D + i]), fmaf(su[i], kv, *s_), acc);
            *s_ = fmaf(expf(cw[t * D + i]), *s_, kv);
          }
          part[tid] = acc;
        }
        bar_sync(BAR_CONS, NCT);
        if (tid < VB) {
          float sum = 0.f;
          for (int q = 0; q < NGR; ++q) sum += part[q * VB + tid];
          if constexpr (sizeof(T) == 2) {
            yp[(long long)(t0 + t) * H * D + tid] = __float2bfloat16(sum);
          } else {
            yp[(long long)(t0 + t) * H * D + tid] = sum;
          }
        }
        bar_sync(BAR_CONS, NCT);
      }
      if (s_role) {
#pragma unroll
        for (int nn = 0; nn < NVS; ++nn)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            st[nn][e] = sF[(s_i0 + g + 8 * (e >> 1)) * VB +
                           8 * (s_n0 + nn) + 2 * tq + (e & 1)];
      }
    }
    pc.mark(4);
    bar_sync(BAR_CONS, NCT);  // A, S' and the factor buffer are read
    pc.mark(5);
    if (tid == 0) *flag = 0;
    if (x + 2 < n_chunks) bar_arrive(BAR_EMPTY + f, NT_);
  }
  pc.flush();
  if (s_role) {
#pragma unroll
    for (int nn = 0; nn < NVS; ++nn)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        *reinterpret_cast<float2*>(
            s_last + ((long long)b * H + h) * D * D +
            (long long)(s_i0 + g + 8 * hh) * D + j0 + 8 * (s_n0 + nn) +
            2 * tq) = make_float2(st[nn][2 * hh], st[nn][2 * hh + 1]);
  }
}

// One decode step from s0: block (16 value columns, h, b).
constexpr int STEP_COLS = 16;

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
wkv6_step_kernel(const T* __restrict__ r, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ logw,
                 const float* __restrict__ u, const float* __restrict__ s0,
                 T* __restrict__ y, float* __restrict__ s_last, int H,
                 Args a) {
  constexpr int Q = STEP_COLS / 4;   // float4 pieces of a row
  constexpr int NWS = THREADS / 32;
  constexpr int ITEMS = (D * Q + THREADS - 1) / THREADS;
  __shared__ float4 red[NWS][Q];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int j0 = blockIdx.x * STEP_COLS, h = blockIdx.y, b = blockIdx.z;
  const T* rp = r + b * a.r.b + h * a.r.h;
  const T* kp = k + b * a.k.b + h * a.k.h;
  const T* vp = v + b * a.v.b + h * a.v.h + j0;
  const float* wp = logw + b * a.w.b + h * a.w.h;
  const long long base = ((long long)b * H + h) * D * D + j0;
  // thread tid: column piece c of rows tid / Q + (THREADS / Q) m
  const int c = (tid % Q) * 4;
  const float vv[4] = {to_f(vp[c]), to_f(vp[c + 1]), to_f(vp[c + 2]),
                       to_f(vp[c + 3])};
  float pt[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int m = 0; m < ITEMS; ++m) {
    const int i = tid / Q + (THREADS / Q) * m;
    if (i < D) {
      float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
      if (s0)
        s = *reinterpret_cast<const float4*>(s0 + b * a.s0_b + h * a.s0_h +
                                             (long long)i * D + j0 + c);
      const float ri = to_f(rp[i]), ki = to_f(kp[i]), wi = expf(wp[i]);
      const float ui = u[(long long)h * D + i];
      const float* sp = &s.x;
      float4 o;
      float* op = &o.x;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float kv = ki * vv[e];
        pt[e] = fmaf(ri, fmaf(ui, kv, sp[e]), pt[e]);
        op[e] = fmaf(wi, sp[e], kv);
      }
      *reinterpret_cast<float4*>(s_last + base + (long long)i * D + c) = o;
    }
  }
  // y over the rows: the warp's lanes of a column piece by shuffles, then
  // the warps in order
#pragma unroll
  for (int off = Q; off < 32; off <<= 1)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      pt[e] += __shfl_xor_sync(0xffffffffu, pt[e], off);
  if (lane < Q) red[warp][lane] = make_float4(pt[0], pt[1], pt[2], pt[3]);
  __syncthreads();
  if (tid < STEP_COLS) {
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < NWS; ++w)
      sum += (&red[w][tid / 4].x)[tid % 4];
    T* yp = y + ((long long)b * H + h) * D + j0 + tid;
    if constexpr (sizeof(T) == 2) {
      *yp = __float2bfloat16(sum);
    } else {
      *yp = sum;
    }
  }
}

// The map of a (B, S, H, D) view with element strides st as dims
// (D, S, H, B), boxes of (cols, rows, 1, 1).  A dimension of extent 1
// gets a nominal stride (only index 0 is read).
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

template <typename T, int D, int VB>
int launch_chunks(const void* r, const void* k, const void* v,
                  const float* logw, const float* u, const float* s0,
                  void* y, float* s_last, int B, int S, int H, const Args& a,
                  cudaStream_t stream) {
  using L = Layout<T, D, VB>;
  static bool attr_set = false;  // once per instantiation and process
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        wkv6_chunk_kernel<T, D, VB>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  constexpr bool bf16 = sizeof(T) == 2;
  Maps m;
  if (!make_map(&m.r, r, bf16, B, S, H, D, a.r, D, L::C) ||
      !make_map(&m.k, k, bf16, B, S, H, D, a.k, D, L::C) ||
      !make_map(&m.v, v, bf16, B, S, H, D, a.v, L::PV, L::C) ||
      !make_map(&m.w, logw, false, B, S, H, D, a.w, D, L::C))
    return -2;
  wkv6_chunk_kernel<T, D, VB><<<dim3(D / VB, H, B), CHUNK_THREADS, L::BYTES,
                                stream>>>(
      u, s0, static_cast<T*>(y), s_last, S, H, a, m);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_d(const void* r, const void* k, const void* v, const float* logw,
             const float* u, const float* s0, void* y, float* s_last, int B,
             int S, int H, const Args& a, cudaStream_t st) {
  if (S == 1) {
    wkv6_step_kernel<T, D><<<dim3(D / STEP_COLS, H, B), THREADS, 0, st>>>(
        static_cast<const T*>(r), static_cast<const T*>(k),
        static_cast<const T*>(v), logw, u, s0, static_cast<T*>(y), s_last,
        H, a);
    return (int)cudaGetLastError();
  }
  constexpr int VB = D == 32 || D == 64 ? 32 : 16;
  return launch_chunks<T, D, VB>(r, k, v, logw, u, s0, y, s_last, B, S, H,
                                 a, st);
}

template <typename T>
int launch_t(int D, const void* r, const void* k, const void* v,
             const float* logw, const float* u, const float* s0, void* y,
             float* s_last, int B, int S, int H, const Args& a,
             cudaStream_t st) {
  switch (D) {
    case 16: return launch_d<T, 16>(r, k, v, logw, u, s0, y, s_last, B, S, H, a, st);
    case 32: return launch_d<T, 32>(r, k, v, logw, u, s0, y, s_last, B, S, H, a, st);
    case 64: return launch_d<T, 64>(r, k, v, logw, u, s0, y, s_last, B, S, H, a, st);
    case 128: return launch_d<T, 128>(r, k, v, logw, u, s0, y, s_last, B, S, H, a, st);
    default: return -1;
  }
}

}  // namespace

// C entry point: launches on `stream` and returns cudaGetLastError(), -2
// if a prefill's tensor maps cannot be made (the driver's encoder is
// missing or refuses the strides), or -1 for a head dim other than 16,
// 32, 64 and 128.
// is_bf16 selects bfloat16 (1) or float32 (0) for r, k, v and y.  logw is
// float32 with r's shape, u a dense float32 (H, d), s0 a float32
// (B, H, d, d) state with the last two dimensions dense, or null (start
// from 0).  y is a dense (B, S, H, d) tensor, s_last a dense float32
// (B, H, d, d).  strides: 14 element strides: r, k, v and logw (batch,
// seq, head) each, then s0 (batch, head).  Rows of r, k, v and logw and
// s0 are 16-byte aligned.
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
    return launch_t<__nv_bfloat16>(D, r, k, v, lw, uu, s, y, sl, B, S, H, a,
                                   cs);
  return launch_t<float>(D, r, k, v, lw, uu, s, y, sl, B, S, H, a, cs);
}

#ifdef WKV6_PHASE_CLOCKS
// Copies the phase clocks of the last prefill (CHUNK_THREADS / 32 warps x
// N_PHASES, cycles) to `out`; returns the CUDA error.
extern "C" int wkv6_phase_clocks(unsigned* out) {
  return (int)cudaMemcpyFromSymbol(out, phase_clocks,
                                   sizeof(phase_clocks));
}
#endif
