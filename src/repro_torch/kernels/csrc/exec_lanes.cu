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
// completion.  The design keeps that chain short:
//   * one block a lane, one thread a client (CPT clients a thread past
//     1024), the clients' state in registers for the whole launch; past
//     4096 clients (CPT = 0) a thread walks ceil(N / threads) clients and
//     loads each client's state from global memory and stores it back
//     every step, so any N runs, if slower;
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
//     draw are loaded a step ahead, so no global load waits on the chain.
// Float arithmetic is written __fsub_rn / __fadd_rn: nvcc contracts
// nothing into an FMA, and every value rounds as the plain version's
// separate torch ops do.  Offsets into the outputs are 64-bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

  float t_next = t_ends[(long long)i0 * n_lanes + l];
  for (int i = i0; i < i1; ++i) {
    const float t_end = t_next;
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
    __syncthreads();
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
    __syncthreads();
  }

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
