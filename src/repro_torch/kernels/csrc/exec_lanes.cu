// The batched execution engine's step loop for Hopper (sm_90a).
//
// Replaces no Pallas kernel: it is the body of the reference's lax.scan,
// src/repro/core/batched_execution.py:137 _one_exec_lane, which the
// reference vmaps over (config x seed) lanes and jits into one device call
// (:222 _execute_batch).  It runs steps [i0, i1) of every lane and equals
// the plain version, src/repro_torch/kernels/ref.py:ref_exec_lanes, bit for
// bit: the same completion masks, latencies and final state.
//
// One step, per lane (N clients, K stations plus the parked column K):
//   (a) each client's current op class; the classes of the clients at the
//       head (rank 0) of each station summed into head_cls;
//   (b) per station: the rate of its head's class, busy = q > 0, work -=
//       rate where busy, complete = busy && work <= 0;
//   (c) per client: a client at a completing station at rank 0 moves; a
//       move at the last station finishes its op (fin, and its latency
//       t_end - enter_t is a sample); it enters the next station, or its
//       next op's first, or parks at column K when its budget is drained;
//       its new rank is the destination's queue after departures; every
//       other client at a completing station moves up one; arrivals are
//       summed per destination, the parked column counting every client
//       that did not enter a station;
//   (d) per station: q = q_dep + arrivals; a new head enters service with a
//       fresh draw, plus the completed head's residual on a busy server.
//
// Bound: neither bytes nor operations.  A step writes 5 bytes a client
// (the completion mask and the latency) and does a few float32 operations a
// client and a station; at the Fig. 29 grid (256 lanes x 64 clients) that
// is 82 KB a step, 25 ns at the memory rate.  What takes the time is the
// serial chain: each step needs the one before, and inside a step the
// stations need every client's class and the clients every station's
// completion.  Two kernels keep that chain short.
//
// The warp kernel, for a lane of at most 128 clients and 32 columns (the
// main path's Fig. 29 lanes: 64 clients, 16 columns): one warp a lane,
// several lanes a block, and nothing in the step wider than the warp.
//   * lane s of the warp owns station column s (its queue, work, rates and
//     routing in registers) and clients s, s + 32, s + 64, s + 96;
//   * a client reads the stations by warp votes and shuffles: the step's
//     completions are one ballot, the fixed finishing stations another,
//     its destination and the destination's queue after departures
//     shuffles from the owning lanes;
//   * the head classes and the arrivals are exact integer sums into the
//     warp's own shared tables, by shared reductions ordered by one
//     __syncwarp a step (double-buffered by step parity, so a slot is
//     zeroed a barrier before it is added to again); the parked column's
//     arrivals are the clients less the popcount of a ballot of those that
//     entered a station;
//   * nothing in the step branches by lane: a lane past k runs the
//     stations' arithmetic on an empty queue, a client keeps its station as
//     a bit, its destination and whether a move there finishes, the class a
//     finish moves to is read every step from L1 and taken by a select, and
//     a lane with nothing to add reduces into a slot of its own, so one
//     warp issues few instructions a step and waits on few;
//   * no load the step waits on: (exponential mode) each station's draw is
//     copied by cp.async into the warp's shared memory a chunk of 32 steps
//     ahead; the step itself needs no end time: it sets a bit for each
//     finishing client, and a chunk's masks and latencies (t_end - the
//     entry time, the entry time advancing to t_end at a finish, as the
//     step would have) are written a row a step during the next chunk,
//     coalesced, their stores in the gaps of the step's chain.  Step i's
//     end time is computed, __fmul_rn((float)(i + 1), dt), with dt the
//     lane's t_ends[0]: one rounding of an exact step count times dt, which
//     is the engine's float32 arange(1, n_steps + 1) * dt bit for bit.
// The block kernel, for any wider lane (up to 64 columns, any N): one block
// a lane, one thread a client (CPT clients a thread past 1024), the
// clients' state in registers for the whole launch; past 4096 clients
// (CPT = 0) a thread walks ceil(N / threads) clients and loads each
// client's state from global memory and stores it back every step, so any
// N runs, if slower;
//   * thread s < K+1 owns station s: its queue length, work, busy and
//     complete flags and rates stay in its registers; what the clients
//     read of the stations (complete, the queue after departures, the
//     routing) goes through shared memory;
//   * two barriers a step: the stations settle step i-1 (d) and drain step
//     i (b); barrier; the clients move in step i (c) and add their classes
//     to step i+1's heads (a); barrier.  The state crosses launches
//     through global memory, so a launch recomputes (a) for its first step;
//   * the scatter-adds (head classes, arrivals) are shared-memory integer
//     atomics, exact in any order; the parked column's arrivals are
//     counted a warp at a time by a ballot;
//   * a step's end time, a client's next op class and a station's next
//     draw are loaded a step ahead.
// Float arithmetic is written __fsub_rn / __fadd_rn: nvcc contracts
// nothing into an FMA, and every value rounds as the plain version's
// separate torch ops do.  Offsets into the outputs are 64-bit.
//
// Built with EXEC_LANES_PHASE_CLOCKS defined (scripts/exec_lanes_ab.py
// --phases), each kernel adds the cycles one thread of its first lane spends
// in each phase of a step (clock64 marks, summed in registers) to
// phase_clocks[kernel], read by exec_lanes_phase_clocks.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#ifdef EXEC_LANES_PHASE_CLOCKS
#define LANES_PHASE_CLOCKS
#endif
#include "step_lanes.cuh"

// K + 1 station columns at most (the wrapper checks)
constexpr int MAX_COLS = 64;

// A client's state: its station, rank in the station's queue, op index,
// current and next op class, op budget and the time its op entered.
struct Client {
  int stage, rank, op, cur, nxt, bud;
  float ent;
};

__device__ __forceinline__ void load_client(
    Client& c, long long ci, const long long* __restrict__ row, int n_cls,
    const long long* stage_g, const long long* rank_g, const long long* op_g,
    const float* enter_g, const long long* __restrict__ budget) {
  c.stage = (int)stage_g[ci];
  c.rank = (int)rank_g[ci];
  c.op = (int)op_g[ci];
  c.ent = enter_g[ci];
  c.bud = (int)budget[ci];
  c.cur = (int)row[c.op];
  c.nxt = (int)row[min(c.op + 1, n_cls - 1)];
}

__device__ __forceinline__ void store_client(
    const Client& c, long long ci, long long* stage_g, long long* rank_g,
    long long* op_g, float* enter_g) {
  stage_g[ci] = c.stage;
  rank_g[ci] = c.rank;
  op_g[ci] = c.op;
  enter_g[ci] = c.ent;
}

// CPT > 0: each thread keeps CPT clients in registers for the launch.
// CPT = 0: each thread walks `wide_cpt` clients through global memory.
template <int CPT>
__global__ void __launch_bounds__(1024) exec_lanes_kernel(
    const float* __restrict__ rate_w, const float* __restrict__ rate_r,
    const uint8_t* __restrict__ finishes_at,
    const long long* __restrict__ arrive_at,
    const long long* __restrict__ cls, const long long* __restrict__ budget,
    const float* __restrict__ t_ends, const float* __restrict__ draws,
    long long draw_lane, long long draw_step,
    long long* __restrict__ stage_g, long long* __restrict__ rank_g,
    float* __restrict__ enter_g, long long* __restrict__ op_g,
    long long* __restrict__ q_g, float* __restrict__ work_g,
    uint8_t* __restrict__ fin_all, float* __restrict__ lat_all,
    int n_lanes, int n_clients, int k, int n_cls, long long n_steps, int i0,
    int i1, int wide_cpt) {
  constexpr bool wide = CPT == 0;
  __shared__ int sh_complete[MAX_COLS];
  __shared__ long long sh_qdep[MAX_COLS];
  __shared__ int sh_fin_at[MAX_COLS];
  __shared__ int sh_arrive[MAX_COLS];
  __shared__ int sh_head[MAX_COLS];
  __shared__ int sh_arrivals[MAX_COLS];

  const int l = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const bool station = tid <= k;
  const long long col = (long long)l * (k + 1) + tid;

  // -- the station this thread owns --------------------------------------
  float rw = 0.0f, rr = 0.0f, work = 0.0f;
  float draw = 1.0f;  // the deterministic mode's draw; else loaded a step ahead
  long long q = 0, q_dep = 0;
  bool busy = false, complete = false;
  if (station) {
    rw = rate_w[col];
    rr = rate_r[col];
    work = work_g[col];
    q = q_g[col];
    sh_fin_at[tid] = finishes_at[col];
    sh_arrive[tid] = (int)arrive_at[col];
    sh_head[tid] = 0;
    sh_arrivals[tid] = 0;
  }

  // -- the clients this thread walks -------------------------------------
  const int cpt = wide ? wide_cpt : CPT;
  Client cl[wide ? 1 : CPT];
  const long long* cls_l = cls + (long long)l * n_clients * n_cls;
  const long long lane0 = (long long)l * n_clients;
  // Register clients are loaded before the barrier and waited for before
  // the step loop: loaded after it, ptxas left a wait on their scoreboard
  // inside the loop, which then also waited out each step's end-time load
  // (a global round trip a step, 1.5x the step's time).
#pragma unroll
  for (int j = 0; j < (wide ? 1 : CPT); ++j) {
    Client& c = cl[j];
    c = Client{k, -1, 0, 0, 0, 0, 0.0f};
    const int n = tid + j * nt;
    if (!wide && n < n_clients)
      load_client(c, lane0 + n, cls_l + (long long)n * n_cls, n_cls, stage_g,
                  rank_g, op_g, enter_g, budget);
  }
  __syncthreads();
  // (a) for the launch's first step
#pragma unroll
  for (int j = 0; j < cpt; ++j) {
    Client& c = cl[wide ? 0 : j];
    const int n = tid + j * nt;
    if (n < n_clients) {
      if (wide)
        load_client(c, lane0 + n, cls_l + (long long)n * n_cls, n_cls,
                    stage_g, rank_g, op_g, enter_g, budget);
      if (c.rank == 0 && c.cur != 0) atomicAdd(&sh_head[c.stage], c.cur);
    }
  }
  __syncthreads();

  PHASE_CLOCK;
  PHASE_START(blockIdx.x == 0 && tid == 0);
  float t_next = t_ends[(long long)i0 * n_lanes + l];
  for (int i = i0; i < i1; ++i) {
    const float t_end = t_next;
    PHASE_SINK(t_end);
    PHASE_SINK(draw);
    PHASE_MARK(0);
    if (i + 1 < i1) t_next = t_ends[(long long)(i + 1) * n_lanes + l];
    if (station) {
      if (i > i0) {
        // (d) of step i - 1
        const int arr = sh_arrivals[tid];
        sh_arrivals[tid] = 0;
        q = q_dep + arr;
        const bool fresh = busy ? (complete && q > 0) : arr > 0;
        if (fresh) work = __fadd_rn(draw, complete ? work : 0.0f);
      }
      if (draws != nullptr)  // step i's draw, used at (d) of step i
        draw = tid < k ? draws[l * draw_lane + (i - i0) * draw_step + tid]
                       : INFINITY;
      // (b) of step i
      const int head = sh_head[tid];
      sh_head[tid] = 0;
      const float rate = head > 0 ? rw : rr;
      busy = q > 0;
      if (busy) work = __fsub_rn(work, rate);
      complete = busy && work <= 0.0f;
      q_dep = q - (complete ? 1 : 0);
      sh_complete[tid] = complete;
      sh_qdep[tid] = q_dep;
    }
    PHASE_MARK(1);
    __syncthreads();
    PHASE_MARK(2);
    // (c) of step i, then (a) of step i + 1
    const long long base = ((long long)l * n_steps + i) * n_clients;
#pragma unroll
    for (int j = 0; j < cpt; ++j) {
      Client& c = cl[wide ? 0 : j];
      const int n = tid + j * nt;
      const bool valid = n < n_clients;
      bool enters = false;
      if (valid) {
        const long long* row = cls_l + (long long)n * n_cls;
        if (wide)
          load_client(c, lane0 + n, row, n_cls, stage_g, rank_g, op_g,
                      enter_g, budget);
        const int s = c.stage;
        const bool dep_here = sh_complete[s] != 0;
        const bool moving = dep_here && c.rank == 0;
        const bool fin = moving && sh_fin_at[s] != 0;
        fin_all[base + n] = fin;
        lat_all[base + n] = __fsub_rn(t_end, c.ent);
        if (fin) {
          ++c.op;
          c.ent = t_end;
          c.cur = c.nxt;
          c.nxt = (int)row[min(c.op + 1, n_cls - 1)];
        }
        enters = moving && (!fin || c.op < c.bud);
        if (moving) {
          const int dest = sh_arrive[s];
          c.rank = (int)sh_qdep[dest];
          c.stage = enters ? dest : k;
          if (enters) atomicAdd(&sh_arrivals[dest], 1);
        } else {
          c.rank -= dep_here;
        }
        if (i + 1 < i1 && c.rank == 0 && c.cur != 0)
          atomicAdd(&sh_head[c.stage], c.cur);
        if (wide) store_client(c, lane0 + n, stage_g, rank_g, op_g, enter_g);
      }
      const unsigned parked = __ballot_sync(0xffffffffu, valid && !enters);
      if ((tid & 31) == 0 && parked != 0u)
        atomicAdd(&sh_arrivals[k], __popc(parked));
    }
    PHASE_MARK(3);
    __syncthreads();
    PHASE_MARK(4);
  }
  PHASE_FLUSH(0, i1 - i0);

  if (station) {
    // (d) of the launch's last step
    const int arr = sh_arrivals[tid];
    q = q_dep + arr;
    const bool fresh = busy ? (complete && q > 0) : arr > 0;
    if (fresh) work = __fadd_rn(draw, complete ? work : 0.0f);
    q_g[col] = q;
    work_g[col] = work;
  }
  if (!wide) {
#pragma unroll
    for (int j = 0; j < cpt; ++j) {
      const int n = tid + j * nt;
      if (n < n_clients)
        store_client(cl[j], lane0 + n, stage_g, rank_g, op_g, enter_g);
    }
  }
}

// -- the warp kernel ----------------------------------------------------

// shared[addr] += v, one reduction by every lane of the warp: a lane with
// nothing to add points at a slot of its own, so no branch (and no
// convergence barrier) surrounds it
__device__ __forceinline__ void red_add(unsigned addr, int v) {
  asm volatile("red.shared.add.s32 [%0], %1;\n" ::"r"(addr), "r"(v)
               : "memory");
}

// A warp's own shared memory: the head-class sums and the arrivals by step
// parity, a slot a lane for reductions that add nothing, and two chunks of
// staged draws.  Four-byte slots in lane
// order: a reduction by the warp touches each bank about once.
struct WarpShared {
  int head[2][32];
  int arr[2][32];
  int idle[32];
  float draw[2][CHUNK][32];
};

// One warp a lane; CPT (1, 2 or 4) clients a thread.  The step is written
// without a branch a lane could take alone: every lane runs the stations'
// arithmetic (a lane past k keeps an empty queue), a client's station,
// destination and finishing flag are kept as a bit, a lane and a flag
// (refreshed each step by one shuffle), the class a finish moves to is
// loaded every step from L1 and taken by a select, and the scatter-adds
// are reductions by every lane.  Two steps are unrolled, so a step's
// parity (which head and arrival tables it reads and adds to) is a
// constant.  A chunk's outputs are written a row a step during the next
// chunk, where their stores fill the gaps of the step's chain.
template <int CPT>
__global__ void __launch_bounds__(128) exec_lanes_warp_kernel(
    const float* __restrict__ rate_w, const float* __restrict__ rate_r,
    const uint8_t* __restrict__ finishes_at,
    const long long* __restrict__ arrive_at,
    const long long* __restrict__ cls, const long long* __restrict__ budget,
    const float* __restrict__ t_ends, const float* __restrict__ draws,
    long long draw_lane, long long draw_step,
    long long* __restrict__ stage_g, long long* __restrict__ rank_g,
    float* __restrict__ enter_g, long long* __restrict__ op_g,
    long long* __restrict__ q_g, float* __restrict__ work_g,
    uint8_t* __restrict__ fin_all, float* __restrict__ lat_all,
    int n_lanes, int n_clients, int k, int n_cls, long long n_steps, int i0,
    int i1) {
  extern __shared__ __align__(16) unsigned char sh_raw[];
  const int t = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int l = blockIdx.x * (blockDim.x >> 5) + w;
  if (l >= n_lanes) return;  // the whole warp: no barrier below is wider
  WarpShared& sh = reinterpret_cast<WarpShared*>(sh_raw)[w];
  const unsigned head_at =
      static_cast<unsigned>(__cvta_generic_to_shared(&sh.head[0][0]));
  const unsigned arr_at =
      static_cast<unsigned>(__cvta_generic_to_shared(&sh.arr[0][0]));
  const unsigned idle_at =
      static_cast<unsigned>(__cvta_generic_to_shared(&sh.idle[t]));
  const bool drawn = draws != nullptr;
  const float dt = t_ends[l];  // step 0's end time, 1 * dt

  // -- the station column this lane owns (past k: none, its queue 0) -----
  const bool station = t <= k;
  const bool parked_col = t == k;
  const long long col = (long long)l * (k + 1) + t;
  float rw = 0.0f, rr = 0.0f, work = 0.0f;
  long long qbase = 0;
  int dest_t = 0;
  if (station) {
    rw = rate_w[col];
    rr = rate_r[col];
    work = work_g[col];
    qbase = q_g[col];
    dest_t = (int)arrive_at[col] & 31;
  }
  const unsigned fin_at = __ballot_sync(FULL, station && finishes_at[col]);
  // The queue is qbase + qd.  qd moves by at most n_clients + 1 a step and
  // is folded into qbase every chunk, so q > 0 is qd > thr in 32 bits, and
  // the queue a client reads (its low 32 bits) is qlo + qd.
  int qd = 0, thr = 0, qlo = 0;
  auto fold = [&]() {
    qbase += qd;
    qd = 0;
    thr = -qbase > INT_MAX   ? INT_MAX
          : -qbase < INT_MIN ? INT_MIN
                             : (int)-qbase;
    qlo = (int)qbase;
  };
  fold();
  sh.head[0][t] = 0;
  sh.head[1][t] = 0;
  sh.arr[0][t] = 0;
  sh.arr[1][t] = 0;

  // -- the clients this lane walks: t, t + 32, ... -----------------------
  // stage, rank, op index, current and next class, budget, the entry time
  // as of the next row of outputs to write; the station's bit (0 for a slot
  // past n_clients), its destination and whether a move there finishes; the
  // finishes of this chunk and of the one whose outputs are being written
  int stage[CPT], rank[CPT], op[CPT], cur[CPT], nxt[CPT], bud[CPT];
  int dest[CPT];
  unsigned sbit[CPT], valid[CPT], fbits[CPT], pbits[CPT];
  bool fhere[CPT];
  float ent[CPT];
  const int* row[CPT];  // the low words of the client's int64 classes
  const long long* cls_l = cls + (long long)l * n_clients * n_cls;
  const long long lane0 = (long long)l * n_clients;
#pragma unroll
  for (int j = 0; j < CPT; ++j) {
    const int n = t + 32 * j;
    const bool v = n < n_clients;
    valid[j] = v ? FULL : 0u;
    row[j] = reinterpret_cast<const int*>(cls_l + (long long)(v ? n : 0) *
                                                      n_cls);
    stage[j] = k;
    rank[j] = -1;
    op[j] = cur[j] = nxt[j] = bud[j] = 0;
    ent[j] = 0.0f;
    fbits[j] = pbits[j] = 0u;
    if (v) {
      Client c;
      load_client(c, lane0 + n, cls_l + (long long)n * n_cls, n_cls, stage_g,
                  rank_g, op_g, enter_g, budget);
      stage[j] = c.stage;
      rank[j] = c.rank;
      op[j] = c.op;
      cur[j] = c.cur;
      nxt[j] = c.nxt;
      bud[j] = c.bud;
      ent[j] = c.ent;
    }
  }
  auto locate = [&](int j) {
    dest[j] = __shfl_sync(FULL, dest_t, stage[j] & 31);
    sbit[j] = (1u << (stage[j] & 31)) & valid[j];
    fhere[j] = (fin_at & sbit[j]) != 0u;
  };
#pragma unroll
  for (int j = 0; j < CPT; ++j) locate(j);

  // Stage chunk c (steps [i0 + 32 c, ...)): lane s < k copies station s's
  // draw of every step into draw[c & 1].
  auto stage_chunk = [&](int c) {
    const int s0 = i0 + c * CHUNK;
    if (s0 >= i1) return;
    if (drawn && t < k) {
      const float* src =
          draws + l * draw_lane + (long long)(s0 - i0) * draw_step + t;
      const int rows = min(CHUNK, i1 - s0);
      for (int r = 0; r < rows; ++r)
        cp_async4(&sh.draw[c & 1][r][t], src + (long long)r * draw_step);
    }
    cp_async_commit();
  };
  // Row u of a finished chunk's outputs (its first step s0, its finishes in
  // pbits): each client's latency from the entry time, which moves to the
  // step's end at a finish, and its mask.
  auto write_row = [&](int s0, int u) {
    const float te = __fmul_rn((float)(s0 + u + 1), dt);
    const long long o = ((long long)l * n_steps + s0 + u) * n_clients;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int n = t + 32 * j;
      const bool f = (pbits[j] >> u) & 1u;
      if (n < n_clients) {
        lat_all[o + n] = __fsub_rn(te, ent[j]);
        fin_all[o + n] = f;
      }
      ent[j] = f ? te : ent[j];
    }
  };
  stage_chunk(0);
  __syncwarp();
  // (a) for the launch's first step
#pragma unroll
  for (int j = 0; j < CPT; ++j)
    red_add(rank[j] == 0 && cur[j] != 0 ? head_at + 4 * (stage[j] & 31)
                                        : idle_at,
            cur[j]);
  cp_async_wait_all();
  __syncwarp();

  PHASE_CLOCK;
  PHASE_START(l == 0 && t == 0);
  int buf = 0, prev_s0 = -1;
  // Step r of the chunk in draw[buf]; parity P = r & 1.
  auto step = [&](int r, auto parity) {
    constexpr int p = decltype(parity)::value;
    // the class each client's next op moves to at a finish (an L1 hit
    // but where a finish crossed a line), read early, taken late
    int after[CPT];
#pragma unroll
    for (int j = 0; j < CPT; ++j)
      after[j] = __ldg(row[j] + 2 * min(op[j] + 2, n_cls - 1));
    const float draw =
        drawn ? (t < k ? sh.draw[buf][r][t] : INFINITY) : 1.0f;
    // (b) of step i
    const int head = sh.head[p][t];
    sh.head[p][t] = 0;
    const float rate = head > 0 ? rw : rr;
    const bool busy = qd > thr;
    const float drained = __fsub_rn(work, rate);
    work = busy ? drained : work;
    const bool complete = busy && work <= 0.0f;
    const int qdd = qd - (complete ? 1 : 0);
    const unsigned done = __ballot_sync(FULL, complete);
    const int q_read = qlo + qdd;
    PHASE_MARK(1);
    // row r of the previous chunk's outputs
    if (prev_s0 >= 0) write_row(prev_s0, r);
    // (c) of step i, then (a) of step i + 1
    int entered = 0;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int qdest = __shfl_sync(FULL, q_read, dest[j]);
      const bool dep_here = (done & sbit[j]) != 0u;
      const bool moving = dep_here && rank[j] == 0;
      const bool fin = moving && fhere[j];
      op[j] += fin ? 1 : 0;
      cur[j] = fin ? nxt[j] : cur[j];
      nxt[j] = fin ? after[j] : nxt[j];
      fbits[j] |= (fin ? 1u : 0u) << r;
      const bool enters = moving && (!fin || op[j] < bud[j]);
      rank[j] = moving ? qdest : rank[j] - (dep_here ? 1 : 0);
      stage[j] = moving ? (enters ? dest[j] : k) : stage[j];
      red_add(enters ? arr_at + 4 * (32 * p + dest[j]) : idle_at, 1);
      red_add(rank[j] == 0 && cur[j] != 0
                  ? head_at + 4 * (32 * (p ^ 1) + (stage[j] & 31))
                  : idle_at,
              cur[j]);
      entered += __popc(__ballot_sync(FULL, enters));
      locate(j);
    }
    PHASE_MARK(2);
    __syncwarp();
    PHASE_MARK(3);
    // (d) of step i: every client that entered no station parks at k
    const int arr = sh.arr[p][t] + (parked_col ? n_clients - entered : 0);
    sh.arr[p][t] = 0;
    qd = qdd + arr;
    const bool fresh = busy ? (complete && qd > thr) : arr > 0;
    const float started = __fadd_rn(draw, complete ? work : 0.0f);
    work = fresh ? started : work;
    PHASE_MARK(4);
  };

  int c = 0;
  for (int s0 = i0; s0 < i1; ++c, s0 += CHUNK) {
    const int rows = min(CHUNK, i1 - s0);
    buf = c & 1;
    if (c > 0) {
      // chunk c was copied a chunk ago; copy chunk c + 1 into the buffer
      // chunk c - 1 has finished with
      cp_async_wait_all();
      __syncwarp();
    }
    stage_chunk(c + 1);
    PHASE_MARK(0);
    int r = 0;
    for (; r + 2 <= rows; r += 2) {
      step(r, Parity<0>());
      step(r + 1, Parity<1>());
    }
    if (r < rows) step(r, Parity<0>());
    // the rows of the previous chunk a short last chunk left
    if (prev_s0 >= 0)
      for (int u = rows; u < CHUNK; ++u) write_row(prev_s0, u);
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      pbits[j] = fbits[j];
      fbits[j] = 0u;
    }
    prev_s0 = s0;
    fold();
    PHASE_MARK(5);
  }
  // the last chunk's outputs
  if (prev_s0 >= 0)
    for (int u = 0; u < i1 - prev_s0; ++u) write_row(prev_s0, u);
  PHASE_FLUSH(1, i1 - i0);

  if (station) {
    q_g[col] = qbase;
    work_g[col] = work;
  }
#pragma unroll
  for (int j = 0; j < CPT; ++j) {
    const int n = t + 32 * j;
    if (n < n_clients) {
      const Client c{stage[j], rank[j], op[j], cur[j], nxt[j], bud[j], ent[j]};
      store_client(c, lane0 + n, stage_g, rank_g, op_g, enter_g);
    }
  }
}

// C entry point: launches steps [i0, i1) on `stream` (one block a lane of
// `threads` threads, each walking `cpt` clients: 1, 2 or 4 in registers,
// more through global memory) and returns
// cudaGetLastError().  draws is null in the deterministic mode; its lane
// and step strides are in elements.
extern "C" int exec_lanes_launch(
    const void* rate_w, const void* rate_r, const void* finishes_at,
    const void* arrive_at, const void* cls, const void* budget,
    const void* t_ends, const void* draws, long long draw_lane,
    long long draw_step, void* stage, void* rank, void* enter_t, void* op_i,
    void* q, void* work, void* fin_all, void* lat_all, int n_lanes,
    int n_clients, int k, int n_cls, long long n_steps, int i0, int i1,
    int threads, int cpt, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define EXEC_LANES_ARGS                                                      \
  static_cast<const float*>(rate_w), static_cast<const float*>(rate_r),      \
      static_cast<const uint8_t*>(finishes_at),                              \
      static_cast<const long long*>(arrive_at),                              \
      static_cast<const long long*>(cls),                                    \
      static_cast<const long long*>(budget),                                 \
      static_cast<const float*>(t_ends), static_cast<const float*>(draws),   \
      draw_lane, draw_step, static_cast<long long*>(stage),                  \
      static_cast<long long*>(rank), static_cast<float*>(enter_t),           \
      static_cast<long long*>(op_i), static_cast<long long*>(q),             \
      static_cast<float*>(work), static_cast<uint8_t*>(fin_all),             \
      static_cast<float*>(lat_all), n_lanes, n_clients, k, n_cls, n_steps,   \
      i0, i1, cpt
  if (cpt < 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (cpt) {
    case 1:
      exec_lanes_kernel<1><<<n_lanes, threads, 0, st>>>(EXEC_LANES_ARGS);
      break;
    case 2:
      exec_lanes_kernel<2><<<n_lanes, threads, 0, st>>>(EXEC_LANES_ARGS);
      break;
    case 4:
      exec_lanes_kernel<4><<<n_lanes, threads, 0, st>>>(EXEC_LANES_ARGS);
      break;
    default:
      exec_lanes_kernel<0><<<n_lanes, threads, 0, st>>>(EXEC_LANES_ARGS);
  }
#undef EXEC_LANES_ARGS
  return static_cast<int>(cudaGetLastError());
}

// C entry point of the warp kernel: steps [i0, i1) on `stream`, one warp a
// lane and `lanes_per_block` (1 to 4) lanes a block, `cpt` (1, 2 or 4)
// clients a thread: n_clients <= 32 cpt and k + 1 <= 32.  Returns
// cudaGetLastError().  The other arguments are exec_lanes_launch's.
extern "C" int exec_lanes_warp_launch(
    const void* rate_w, const void* rate_r, const void* finishes_at,
    const void* arrive_at, const void* cls, const void* budget,
    const void* t_ends, const void* draws, long long draw_lane,
    long long draw_step, void* stage, void* rank, void* enter_t, void* op_i,
    void* q, void* work, void* fin_all, void* lat_all, int n_lanes,
    int n_clients, int k, int n_cls, long long n_steps, int i0, int i1,
    int lanes_per_block, int cpt, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (lanes_per_block < 1 || lanes_per_block > 4 || k + 1 > 32 ||
      n_clients > 32 * cpt || (cpt != 1 && cpt != 2 && cpt != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (n_lanes + lanes_per_block - 1) / lanes_per_block;
  const int threads = 32 * lanes_per_block;
  const size_t shmem = sizeof(WarpShared) * lanes_per_block;
#define EXEC_LANES_ARGS                                                      \
  static_cast<const float*>(rate_w), static_cast<const float*>(rate_r),      \
      static_cast<const uint8_t*>(finishes_at),                              \
      static_cast<const long long*>(arrive_at),                              \
      static_cast<const long long*>(cls),                                    \
      static_cast<const long long*>(budget),                                 \
      static_cast<const float*>(t_ends), static_cast<const float*>(draws),   \
      draw_lane, draw_step, static_cast<long long*>(stage),                  \
      static_cast<long long*>(rank), static_cast<float*>(enter_t),           \
      static_cast<long long*>(op_i), static_cast<long long*>(q),             \
      static_cast<float*>(work), static_cast<uint8_t*>(fin_all),             \
      static_cast<float*>(lat_all), n_lanes, n_clients, k, n_cls, n_steps,   \
      i0, i1
  switch (cpt) {
    case 1:
      exec_lanes_warp_kernel<1><<<blocks, threads, shmem, st>>>(
          EXEC_LANES_ARGS);
      break;
    case 2:
      exec_lanes_warp_kernel<2><<<blocks, threads, shmem, st>>>(
          EXEC_LANES_ARGS);
      break;
    default:
      exec_lanes_warp_kernel<4><<<blocks, threads, shmem, st>>>(
          EXEC_LANES_ARGS);
  }
#undef EXEC_LANES_ARGS
  return static_cast<int>(cudaGetLastError());
}

#ifdef EXEC_LANES_PHASE_CLOCKS
// Copies the phase clocks (cycles by kernel and phase, then steps) to `out`
// and, if `reset`, zeroes them; returns the CUDA error.
extern "C" int exec_lanes_phase_clocks(unsigned long long* out, int reset) {
  return copy_phase_clocks(out, reset);
}
#endif
