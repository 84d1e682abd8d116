// The transient engine's step loop for Hopper (sm_90a).
//
// Replaces no Pallas kernel: it is the body of the reference's lax.scan,
// src/repro/core/transient.py:482 _one_lane, which the reference vmaps over
// (deployment x seed) lanes and jits into one device call (:565
// _transient_batch).  It runs steps [i0, i1) of every lane and equals the
// plain version, src/repro_torch/kernels/ref.py:ref_transient_lanes, bit for
// bit: the same flows, latencies, final state and queue integrals.
//
// One step, per lane (N clients in a closed token ring over K stations):
//   (b) per station: busy = q > 0; work -= the window's rate where busy;
//       complete = busy && work <= 0; q_dep = q - complete;
//   (c) per client: a client at a completing station at rank 0 moves to the
//       station's destination, at rank q_dep[dest]; a move at the last
//       station finishes a command (its latency t_end - enter_t is the
//       step's sample, and its entry time becomes t_end); every other client
//       at a completing station moves up one.  Per completing station, its
//       destination gets one arrival;
//   (d) per station: q = q_dep + arrivals; qsum[window] += q; a new head
//       enters service with a fresh draw, plus the completed head's residual
//       on a busy server.
//
// Bound: neither bytes nor operations.  A step writes 8 bytes a lane (the
// finish count and the finisher's latency) and reads K draws a seed; at the
// transient grid (256 lanes x 64 clients x 15 stations, 8 seeds) that is
// about 2.5 KB a step, under a nanosecond at the memory rate.  What takes
// the time is the serial chain: each step needs the one before, and inside a
// step the clients need every station's completion.  The stations need
// nothing of the clients: a completing station sends exactly one arrival,
// to its fixed destination.  Two kernels keep the chain short.
//
// The warp kernel, for a lane of at most 128 clients and 32 stations (the
// main path's Fig. 29 lanes: 64 clients, 15 stations): one warp a lane,
// several lanes a block, and nothing in the step wider than the warp.
//   * lane s owns station s (its queue, work, window rate, routing and
//     queue-integral accumulator in registers) and clients s, s + 32, ...;
//   * the step's completions are one ballot; station d's arrivals are the
//     popcount of that ballot masked by the fixed set of stations routed
//     to d, so a station settles (d) right after the ballot, with no
//     exchange with the clients at all;
//   * a client reads its station's completion from the ballot and its
//     destination and the destination's queue after departures by
//     shuffles; the finishers (at most one a step: the engine raises on
//     more) are a ballot, the finisher's latency a shuffle from its lane;
//   * no load the step waits on: each step's window and (exponential mode)
//     each station's draw are copied by cp.async into the warp's shared
//     memory a chunk of 32 steps ahead; the steps of a chunk whose window
//     changes are one ballot when the chunk arrives, and a change loads the
//     new window's rate and flushes the queue integral (once a window);
//   * nothing in the step branches by lane: a lane past k runs the
//     stations' arithmetic on an empty queue, and a client keeps its
//     station as a bit, its destination and whether a move there finishes
//     (found by one shuffle a step);
//   * a step's count and latency are kept by lane (step mod 32) and
//     written 32 steps at a time, one coalesced store of each.
// The block kernel, for any wider lane (up to MAX_STATIONS stations, any
// N): one block a lane, one thread a client (CPT clients a thread past
// 1024), the clients' state in registers for the whole launch; past 4096
// clients (CPT = 0) a thread walks ceil(N / threads) clients and loads
// each client's state from global memory and stores it back every step;
//   * thread s < K owns station s: its queue length, work, busy and complete
//     flags, its window's rate and its queue-integral accumulator stay in
//     its registers; what the clients read of the stations (complete, the
//     queue after departures, the routing) goes through shared memory, sized
//     by K at launch;
//   * two barriers a step: the stations drain (b); barrier; the clients move
//     and the completing stations add their arrivals by shared integer
//     atomics, exact in any order (c); barrier; the stations settle (d);
//   * the finisher leaves its latency in one shared slot and counts
//     itself; thread 0 writes the step's count and that latency (0 where
//     none finished);
//   * the step's window (its index two steps ahead, its rate one), and the
//     station's draw are loaded a step ahead.
// In both the step's end time is (i + 1) * dt, computed; the queue integral
// is flushed to qsum[l, w, :] when the window changes and at the launch's
// end, and the next window's entry reloaded; the state crosses launches
// through global memory.  Float arithmetic is written __fmul_rn / __fsub_rn
// / __fadd_rn: nvcc contracts nothing into an FMA, and every value rounds as
// the plain version's separate torch ops do.  No division: the window rates
// dt / max(d, 1e-30) come precomputed.  Offsets into the outputs are 64-bit.
//
// Built with TRANSIENT_LANES_PHASE_CLOCKS defined (scripts/transient_ab.py
// --phases), each kernel adds the cycles one thread of its first lane spends
// in each phase of a step (clock64 marks, summed in registers) to
// phase_clocks[kernel], read by transient_lanes_phase_clocks.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#ifdef TRANSIENT_LANES_PHASE_CLOCKS
#define LANES_PHASE_CLOCKS
#endif
#include "step_lanes.cuh"

// A client's state: its station, its rank in the station's queue and the
// time its command entered the ring.
struct Client {
  int stage, rank;
  float ent;
};

__device__ __forceinline__ void load_client(Client& c, long long ci,
                                            const long long* stage_g,
                                            const long long* rank_g,
                                            const float* enter_g) {
  c.stage = (int)stage_g[ci];
  c.rank = (int)rank_g[ci];
  c.ent = enter_g[ci];
}

__device__ __forceinline__ void store_client(const Client& c, long long ci,
                                             long long* stage_g,
                                             long long* rank_g,
                                             float* enter_g) {
  stage_g[ci] = c.stage;
  rank_g[ci] = c.rank;
  enter_g[ci] = c.ent;
}

// CPT > 0: each thread keeps CPT clients in registers for the launch.
// CPT = 0: each thread walks `wide_cpt` clients through global memory.
template <int CPT>
__global__ void __launch_bounds__(1024) transient_lanes_kernel(
    const float* __restrict__ rates, const int* __restrict__ window_of,
    const float* __restrict__ dt_g, const uint8_t* __restrict__ finishes_at,
    const long long* __restrict__ arrive_at, const float* __restrict__ draws,
    long long draw_seed, long long draw_step, int n_seeds,
    long long* __restrict__ stage_g, long long* __restrict__ rank_g,
    float* __restrict__ enter_g, long long* __restrict__ q_g,
    float* __restrict__ work_g, float* __restrict__ qsum_g,
    int* __restrict__ flows, float* __restrict__ lat1, int n_lanes,
    int n_clients, int k, int n_windows, long long n_steps, int i0, int i1,
    int wide_cpt) {
  constexpr bool wide = CPT == 0;
  extern __shared__ int sh[];
  int* sh_complete = sh;          // [k] the station completed this step
  int* sh_qdep = sh + k;          // [k] its queue after the departure
  int* sh_arrive = sh + 2 * k;    // [k] where its departures go
  int* sh_fin_at = sh + 3 * k;    // [k] a departure there finishes
  int* sh_arrivals = sh + 4 * k;  // [k] arrivals this step
  __shared__ int sh_nfin;         // commands finished this step
  __shared__ float sh_lat;        // the finisher's latency

  const int l = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const bool station = tid < k;
  const long long col = (long long)l * k + tid;
  const long long lane_rates = (long long)l * k + tid;
  const long long lane_qsum = (long long)l * n_windows * k + tid;
  const float dt = dt_g[l];

  // -- the station this thread owns --------------------------------------
  float work = 0.0f, rate = 0.0f, rate_next = 0.0f, qacc = 0.0f;
  // the deterministic mode's draw; else loaded a step ahead
  float draw = 1.0f, draw_next = 1.0f;
  int q = 0, q_dep = 0, dest_s = 0;
  int w_cur = 0, w_next = 0, w_next2 = 0, wq = 0;
  bool busy = false, complete = false;
  const float* draw_row = nullptr;
  if (station) {
    work = work_g[col];
    q = (int)q_g[col];
    dest_s = (int)arrive_at[col];
    sh_fin_at[tid] = finishes_at[col];
    sh_arrive[tid] = dest_s;
    sh_arrivals[tid] = 0;
    w_next = window_of[i0];
    w_next2 = i0 + 1 < i1 ? window_of[i0 + 1] : w_next;
    rate_next = rates[(long long)w_next * n_lanes * k + lane_rates];
    wq = w_next;
    qacc = qsum_g[lane_qsum + (long long)wq * k];
    if (draws != nullptr) {
      draw_row = draws + (long long)(l % n_seeds) * draw_seed + tid;
      draw_next = draw_row[(long long)(i0 + 1) * draw_step];
    }
  }
  if (tid == 0) sh_nfin = 0;

  // -- the clients this thread walks -------------------------------------
  const int cpt = wide ? wide_cpt : CPT;
  Client cl[wide ? 1 : CPT];
  const long long lane0 = (long long)l * n_clients;
  // loaded before the barrier, so that no wait on their loads lands inside
  // the step loop (see exec_lanes.cu)
#pragma unroll
  for (int j = 0; j < (wide ? 1 : CPT); ++j) {
    cl[j] = Client{0, -1, 0.0f};
    const int n = tid + j * nt;
    if (!wide && n < n_clients)
      load_client(cl[j], lane0 + n, stage_g, rank_g, enter_g);
  }
  __syncthreads();

  PHASE_CLOCK;
  PHASE_START(blockIdx.x == 0 && tid == 0);
  for (int i = i0; i < i1; ++i) {
    const float t_end = __fmul_rn((float)(i + 1), dt);
    if (station) {
      // step i's window, rate and draw, loaded a step ahead; issue step
      // i + 1's
      w_cur = w_next;
      rate = rate_next;
      draw = draw_next;
      w_next = w_next2;
      PHASE_SINK(rate);
      PHASE_SINK(draw);
      PHASE_SINK(__int_as_float(w_cur));
      PHASE_MARK(0);
      if (i + 1 < i1) {
        if (w_next != w_cur)
          rate_next = rates[(long long)w_next * n_lanes * k + lane_rates];
        if (draws != nullptr)
          draw_next = draw_row[(long long)(i + 2) * draw_step];
      }
      if (i + 2 < i1) w_next2 = window_of[i + 2];
      // (b) the stations drain
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
    // (c) the clients move; the completing stations send their arrivals
    if (station && complete) atomicAdd(&sh_arrivals[dest_s], 1);
#pragma unroll
    for (int j = 0; j < cpt; ++j) {
      Client& c = cl[wide ? 0 : j];
      const int n = tid + j * nt;
      if (n < n_clients) {
        if (wide) load_client(c, lane0 + n, stage_g, rank_g, enter_g);
        const int s = c.stage;
        if (sh_complete[s] != 0) {
          if (c.rank == 0) {
            if (sh_fin_at[s] != 0) {
              sh_lat = __fsub_rn(t_end, c.ent);
              atomicAdd(&sh_nfin, 1);
              c.ent = t_end;
            }
            const int dest = sh_arrive[s];
            c.rank = sh_qdep[dest];
            c.stage = dest;
          } else {
            c.rank -= 1;
          }
        }
        if (wide) store_client(c, lane0 + n, stage_g, rank_g, enter_g);
      }
    }
    PHASE_MARK(3);
    __syncthreads();
    PHASE_MARK(4);
    // (d) the stations settle
    if (station) {
      const int arr = sh_arrivals[tid];
      sh_arrivals[tid] = 0;
      q = q_dep + arr;
      if (w_cur != wq) {
        qsum_g[lane_qsum + (long long)wq * k] = qacc;
        wq = w_cur;
        qacc = qsum_g[lane_qsum + (long long)wq * k];
      }
      qacc = __fadd_rn(qacc, (float)q);
      const bool fresh = busy ? (complete && q > 0) : arr > 0;
      if (fresh) work = __fadd_rn(draw, complete ? work : 0.0f);
    }
    if (tid == 0) {
      const int nfin = sh_nfin;
      sh_nfin = 0;
      const long long o = (long long)l * n_steps + i;
      flows[o] = nfin;
      lat1[o] = nfin != 0 ? sh_lat : 0.0f;
    }
    PHASE_MARK(5);
  }
  PHASE_FLUSH(0, i1 - i0);

  if (station) {
    q_g[col] = q;
    work_g[col] = work;
    qsum_g[lane_qsum + (long long)wq * k] = qacc;
  }
  if (!wide) {
#pragma unroll
    for (int j = 0; j < cpt; ++j) {
      const int n = tid + j * nt;
      if (n < n_clients) store_client(cl[j], lane0 + n, stage_g, rank_g,
                                      enter_g);
    }
  }
}

// -- the warp kernel ----------------------------------------------------

// A warp's own shared memory: two chunks of staged windows and draws.
struct WarpShared {
  float draw[2][CHUNK][32];
  int window[2][CHUNK];
};

// One warp a lane; CPT (1, 2 or 4) clients a thread.  The step is written
// without a branch a lane could take alone: every lane runs the stations'
// arithmetic (a lane past k keeps an empty queue), a client's station,
// destination and finishing flag are kept as a bit, a lane and a flag
// (refreshed each step by one shuffle), and the steps of a chunk where the
// window changes are found once, as a ballot, when the chunk's windows
// arrive.
template <int CPT>
__global__ void __launch_bounds__(128) transient_lanes_warp_kernel(
    const float* __restrict__ rates, const int* __restrict__ window_of,
    const float* __restrict__ dt_g, const uint8_t* __restrict__ finishes_at,
    const long long* __restrict__ arrive_at, const float* __restrict__ draws,
    long long draw_seed, long long draw_step, int n_seeds,
    long long* __restrict__ stage_g, long long* __restrict__ rank_g,
    float* __restrict__ enter_g, long long* __restrict__ q_g,
    float* __restrict__ work_g, float* __restrict__ qsum_g,
    int* __restrict__ flows, float* __restrict__ lat1, int n_lanes,
    int n_clients, int k, int n_windows, long long n_steps, int i0, int i1) {
  extern __shared__ __align__(16) unsigned char sh_raw[];
  const int t = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int l = blockIdx.x * (blockDim.x >> 5) + w;
  if (l >= n_lanes) return;  // the whole warp: no barrier below is wider
  WarpShared& sh = reinterpret_cast<WarpShared*>(sh_raw)[w];

  // -- the station this lane owns (past k: none, its queue 0) ------------
  const bool station = t < k;
  const long long col = (long long)l * k + t;
  const long long lane_qsum = (long long)l * n_windows * k + t;
  const float dt = dt_g[l];
  float work = 0.0f, rate = 0.0f, qacc = 0.0f;
  int q = 0, dest_t = 0;
  int wq = window_of[i0];  // the window whose integral qacc holds
  if (station) {
    work = work_g[col];
    q = (int)q_g[col];
    dest_t = (int)arrive_at[col] & 31;
    rate = rates[(long long)wq * n_lanes * k + col];
    qacc = qsum_g[lane_qsum + (long long)wq * k];
  }
  const unsigned fin_at = __ballot_sync(FULL, station && finishes_at[col]);
  // the stations routed to this lane's station: one arrival each when they
  // complete
  unsigned sources = 0u;
  for (int s = 0; s < k; ++s) {
    const unsigned b = __ballot_sync(FULL, station && dest_t == s);
    if (t == s) sources = b;
  }
  const bool drawn = draws != nullptr;
  const float* draw_row =
      drawn ? draws + (long long)(l % n_seeds) * draw_seed + t : nullptr;

  // -- the clients this lane walks: t, t + 32, ... -----------------------
  // stage, rank, entry time; the station's bit (0 for a slot past
  // n_clients), its destination and whether a move there finishes
  int stage[CPT], rank[CPT], dest[CPT];
  unsigned sbit[CPT], valid[CPT];
  bool fhere[CPT];
  float ent[CPT];
  const long long lane0 = (long long)l * n_clients;
#pragma unroll
  for (int j = 0; j < CPT; ++j) {
    const int n = t + 32 * j;
    const bool v = n < n_clients;
    valid[j] = v ? FULL : 0u;
    stage[j] = 0;
    rank[j] = -1;
    ent[j] = 0.0f;
    if (v) {
      Client c;
      load_client(c, lane0 + n, stage_g, rank_g, enter_g);
      stage[j] = c.stage;
      rank[j] = c.rank;
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

  // Stage chunk c (steps [i0 + 32 c, ...)) into buffer c & 1: lane r copies
  // step r's window, lane s < k station s's draw of every step (step i's
  // draw is row i + 1 of its seed's).
  auto stage_chunk = [&](int c) {
    const int s0 = i0 + c * CHUNK;
    if (s0 >= i1) return;
    const int buf = c & 1;
    if (s0 + t < i1) cp_async4(&sh.window[buf][t], window_of + s0 + t);
    if (drawn && station) {
      const int rows = min(CHUNK, i1 - s0);
      for (int r = 0; r < rows; ++r)
        cp_async4(&sh.draw[buf][r][t],
                  draw_row + (long long)(s0 + r + 1) * draw_step);
    }
    cp_async_commit();
  };
  stage_chunk(0);
  cp_async_wait_all();
  __syncwarp();

  PHASE_CLOCK;
  PHASE_START(l == 0 && t == 0);
  for (int c = 0, s0 = i0; s0 < i1; ++c, s0 += CHUNK) {
    const int rows = min(CHUNK, i1 - s0);
    const int buf = c & 1;
    if (c > 0) {
      // chunk c was copied a chunk ago; copy chunk c + 1 into the buffer
      // chunk c - 1 has finished with
      cp_async_wait_all();
      __syncwarp();
    }
    stage_chunk(c + 1);
    // the chunk's windows, lane r step r's; a bit for each step whose
    // window differs from the step before's
    const int w_r = sh.window[buf][t < rows ? t : rows - 1];
    const int w_before = __shfl_up_sync(FULL, w_r, 1);
    const unsigned changes =
        __ballot_sync(FULL, t < rows && w_r != (t == 0 ? wq : w_before));
    int f_keep = 0;  // lane r keeps step r's count and latency
    float l_keep = 0.0f;
    PHASE_MARK(0);
    for (int r = 0; r < rows; ++r) {
      if ((changes >> r) & 1u) {  // the warp takes a window change together
        const int wi = __shfl_sync(FULL, w_r, r);
        if (station) {
          qsum_g[lane_qsum + (long long)wq * k] = qacc;
          qacc = qsum_g[lane_qsum + (long long)wi * k];
          rate = rates[(long long)wi * n_lanes * k + col];
        }
        wq = wi;
      }
      const float draw = drawn && station ? sh.draw[buf][r][t] : 1.0f;
      // (b) the stations drain
      const bool busy = q > 0;
      const float drained = __fsub_rn(work, rate);
      work = busy ? drained : work;
      const bool complete = busy && work <= 0.0f;
      const int q_dep = q - (complete ? 1 : 0);
      const unsigned done = __ballot_sync(FULL, complete);
      PHASE_MARK(1);
      // (d) the stations settle: each completing source sent one arrival
      const int arr = __popc(done & sources);
      q = q_dep + arr;
      qacc = __fadd_rn(qacc, (float)q);
      const bool fresh = busy ? (complete && q > 0) : arr > 0;
      const float started = __fadd_rn(draw, complete ? work : 0.0f);
      work = fresh ? started : work;
      PHASE_MARK(2);
      // (c) the clients move
      const float t_end = __fmul_rn((float)(s0 + r + 1), dt);
      int nfin = 0;
      float lat = 0.0f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int qdest = __shfl_sync(FULL, q_dep, dest[j]);
        const bool dep_here = (done & sbit[j]) != 0u;
        const bool moving = dep_here && rank[j] == 0;
        const bool fin = moving && fhere[j];
        const float lj = __fsub_rn(t_end, ent[j]);
        ent[j] = fin ? t_end : ent[j];
        rank[j] = moving ? qdest : rank[j] - (dep_here ? 1 : 0);
        stage[j] = moving ? dest[j] : stage[j];
        const unsigned finishers = __ballot_sync(FULL, fin);
        const float lf = __shfl_sync(FULL, lj, (__ffs(finishers) - 1) & 31);
        nfin += __popc(finishers);
        lat = finishers != 0u ? lf : lat;
        locate(j);
      }
      PHASE_MARK(3);
      f_keep = t == r ? nfin : f_keep;
      l_keep = t == r ? lat : l_keep;  // 0 where none finished
      PHASE_MARK(4);
    }
    if (t < rows) {
      const long long o = (long long)l * n_steps + s0 + t;
      flows[o] = f_keep;
      lat1[o] = l_keep;
    }
    PHASE_MARK(5);
  }
  PHASE_FLUSH(1, i1 - i0);

  if (station) {
    q_g[col] = q;
    work_g[col] = work;
    qsum_g[lane_qsum + (long long)wq * k] = qacc;
  }
#pragma unroll
  for (int j = 0; j < CPT; ++j) {
    const int n = t + 32 * j;
    if (n < n_clients) {
      const Client c{stage[j], rank[j], ent[j]};
      store_client(c, lane0 + n, stage_g, rank_g, enter_g);
    }
  }
}

// C entry point: launches steps [i0, i1) on `stream` (one block a lane of
// `threads` threads, each walking `cpt` clients: 1, 2 or 4 in registers,
// more through global memory; 5 k ints of dynamic shared memory) and
// returns cudaGetLastError().  draws is null in the deterministic mode; its
// seed and step strides are in elements.
extern "C" int transient_lanes_launch(
    const void* rates, const void* window_of, const void* dt,
    const void* finishes_at, const void* arrive_at, const void* draws,
    long long draw_seed, long long draw_step, int n_seeds, void* stage,
    void* rank, void* enter_t, void* q, void* work, void* qsum, void* flows,
    void* lat1, int n_lanes, int n_clients, int k, int n_windows,
    long long n_steps, int i0, int i1, int threads, int cpt, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t shmem = 5 * sizeof(int) * static_cast<size_t>(k);
#define TRANSIENT_LANES_ARGS                                                 \
  static_cast<const float*>(rates), static_cast<const int*>(window_of),      \
      static_cast<const float*>(dt),                                         \
      static_cast<const uint8_t*>(finishes_at),                              \
      static_cast<const long long*>(arrive_at),                              \
      static_cast<const float*>(draws), draw_seed, draw_step, n_seeds,       \
      static_cast<long long*>(stage), static_cast<long long*>(rank),         \
      static_cast<float*>(enter_t), static_cast<long long*>(q),              \
      static_cast<float*>(work), static_cast<float*>(qsum),                  \
      static_cast<int*>(flows), static_cast<float*>(lat1), n_lanes,          \
      n_clients, k, n_windows, n_steps, i0, i1, cpt
  if (cpt < 1 || k < 1 || k > threads)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (cpt) {
    case 1:
      transient_lanes_kernel<1><<<n_lanes, threads, shmem, st>>>(
          TRANSIENT_LANES_ARGS);
      break;
    case 2:
      transient_lanes_kernel<2><<<n_lanes, threads, shmem, st>>>(
          TRANSIENT_LANES_ARGS);
      break;
    case 4:
      transient_lanes_kernel<4><<<n_lanes, threads, shmem, st>>>(
          TRANSIENT_LANES_ARGS);
      break;
    default:
      transient_lanes_kernel<0><<<n_lanes, threads, shmem, st>>>(
          TRANSIENT_LANES_ARGS);
  }
#undef TRANSIENT_LANES_ARGS
  return static_cast<int>(cudaGetLastError());
}

// C entry point of the warp kernel: steps [i0, i1) on `stream`, one warp a
// lane and `lanes_per_block` (1 to 4) lanes a block, `cpt` (1, 2 or 4)
// clients a thread: n_clients <= 32 cpt and k <= 32.  Returns
// cudaGetLastError().  The other arguments are transient_lanes_launch's.
extern "C" int transient_lanes_warp_launch(
    const void* rates, const void* window_of, const void* dt,
    const void* finishes_at, const void* arrive_at, const void* draws,
    long long draw_seed, long long draw_step, int n_seeds, void* stage,
    void* rank, void* enter_t, void* q, void* work, void* qsum, void* flows,
    void* lat1, int n_lanes, int n_clients, int k, int n_windows,
    long long n_steps, int i0, int i1, int lanes_per_block, int cpt,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (lanes_per_block < 1 || lanes_per_block > 4 || k < 1 || k > 32 ||
      n_clients > 32 * cpt || (cpt != 1 && cpt != 2 && cpt != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (n_lanes + lanes_per_block - 1) / lanes_per_block;
  const int threads = 32 * lanes_per_block;
  const size_t shmem = sizeof(WarpShared) * lanes_per_block;
#define TRANSIENT_LANES_ARGS                                                 \
  static_cast<const float*>(rates), static_cast<const int*>(window_of),      \
      static_cast<const float*>(dt),                                         \
      static_cast<const uint8_t*>(finishes_at),                              \
      static_cast<const long long*>(arrive_at),                              \
      static_cast<const float*>(draws), draw_seed, draw_step, n_seeds,       \
      static_cast<long long*>(stage), static_cast<long long*>(rank),         \
      static_cast<float*>(enter_t), static_cast<long long*>(q),              \
      static_cast<float*>(work), static_cast<float*>(qsum),                  \
      static_cast<int*>(flows), static_cast<float*>(lat1), n_lanes,          \
      n_clients, k, n_windows, n_steps, i0, i1
  switch (cpt) {
    case 1:
      transient_lanes_warp_kernel<1><<<blocks, threads, shmem, st>>>(
          TRANSIENT_LANES_ARGS);
      break;
    case 2:
      transient_lanes_warp_kernel<2><<<blocks, threads, shmem, st>>>(
          TRANSIENT_LANES_ARGS);
      break;
    default:
      transient_lanes_warp_kernel<4><<<blocks, threads, shmem, st>>>(
          TRANSIENT_LANES_ARGS);
  }
#undef TRANSIENT_LANES_ARGS
  return static_cast<int>(cudaGetLastError());
}

#ifdef TRANSIENT_LANES_PHASE_CLOCKS
// Copies the phase clocks (cycles by kernel and phase, then steps) to `out`
// and, if `reset`, zeroes them; returns the CUDA error.
extern "C" int transient_lanes_phase_clocks(unsigned long long* out, int reset) {
  return copy_phase_clocks(out, reset);
}
#endif
