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
// step the clients need every station's completion and the stations every
// client's move.  The design keeps that chain short, as exec_lanes.cu does:
//   * one block a lane, one thread a client (CPT clients a thread past
//     1024), the clients' state in registers for the whole launch; past 4096
//     clients (CPT = 0) a thread walks ceil(N / threads) clients and loads
//     each client's state from global memory and stores it back every step;
//   * thread s < K owns station s: its queue length, work, busy and complete
//     flags, its window's rate and its queue-integral accumulator stay in
//     its registers; what the clients read of the stations (complete, the
//     queue after departures, the routing) goes through shared memory, sized
//     by K at launch;
//   * two barriers a step: the stations drain (b); barrier; the clients move
//     and the completing stations add their arrivals by shared integer
//     atomics, exact in any order (c); barrier; the stations settle (d);
//   * a lane finishes at most one command a step (only the last station
//     finishes, one head at a time), so the finisher leaves its latency in
//     one shared slot and counts itself; thread 0 writes the step's count
//     and that latency (0 where none finished);
//   * the step's window (its index two steps ahead, its rate one), and the
//     station's draw are loaded a step ahead, so no global load waits on the
//     chain; the step's end time is (i + 1) * dt, computed;
//   * the queue integral is flushed to qsum[l, w, :] when the window changes
//     and at the launch's end, and the next window's entry reloaded; the
//     state crosses launches through global memory.
// Float arithmetic is written __fmul_rn / __fsub_rn / __fadd_rn: nvcc
// contracts nothing into an FMA, and every value rounds as the plain
// version's separate torch ops do.  No division: the window rates
// dt / max(d, 1e-30) come precomputed.  Offsets into the outputs are 64-bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

  for (int i = i0; i < i1; ++i) {
    const float t_end = __fmul_rn((float)(i + 1), dt);
    if (station) {
      // step i's window, rate and draw, loaded a step ahead; issue step
      // i + 1's
      w_cur = w_next;
      rate = rate_next;
      draw = draw_next;
      w_next = w_next2;
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
    __syncthreads();
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
    __syncthreads();
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
  }

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
