// Masked per-lane latency histogram for Hopper (sm_90a).
//
// Replaces the Pallas kernel src/repro/kernels/latency_hist.py:_hist_kernel.
// For every lane l and sample i with valid[l, i] (bool true, or float > 0)
// it adds one to bin  #{j : edges[l, j] < samples[l, i]} - 1, clipped to
// [0, B), of out[l, :].  NaN samples compare false against every edge and
// land in bin 0, +inf lands in bin B-1, exactly as the reference counts.
//
// Bound: memory bytes.  With every sample valid the kernel must read
// L*N*5 bytes (4 for the f32 sample, 1 for the bool mask; 8 with an f32
// mask) and does a handful of operations per byte.  A sample is loaded
// only where its mask is set, so on the execution plane's sparse masks
// (one completion per client per several steps) it reads the L*N mask
// bytes plus 4 bytes per valid sample, and that is its bound.
// The TPU kernel built a (samples x bins) one-hot matrix because the TPU
// handles scatters badly; here a scatter into shared memory is cheap.  A
// call is one launch that writes every bin of out once with a plain store
// (no fill before it, no atomic on out), by one of two kernels the
// wrapper's plan picks (src/repro_torch/kernels/latency_hist.py:plan):
//   * hist_lane_kernel, where a lane fits one block's pass (the transient
//     run's [256, 4000]): one block of up to 1024 threads a lane, LANE_U
//     mask entries a thread a pass, every load of a pass issued before
//     any is used; the warp's entries of one bin are added by one shared
//     atomicAdd of their count (__match_any_sync), so the transient run's
//     crowded bins take one atomic a warp, not 32;
//   * hist_chunk_kernel, longer lanes (the execution plane's 7.5 M entries
//     a lane): a grid of lanes x chunks (flattened into blockIdx.x), many
//     chunks a lane so that the blocks fill the card in even waves; the
//     threads stride over the chunk reading the mask 16 bytes at a time
//     (16 bool or 4 float32 entries, 512 contiguous bytes a warp), two
//     such loads in flight a thread before either is tested, a scalar loop
//     taking the unaligned head and the tail; a valid entry adds one with
//     a shared atomicAdd.  The block adds its nonzero bins into the
//     lane's row of an int32 sum kept zero between launches (reductions
//     that nothing waits on; a block of the execution calls holds some
//     9-23 valid entries),
//     and its thread 0, after a barrier and a __threadfence(), takes a
//     ticket from the lane's int32 arrival counter; the block that
//     arrives last stores the row into out and sets the row and the
//     counter back to 0 in the same launch, so a CUDA graph can replay
//     it.  (A block that stored its whole histogram into a workspace
//     for the last block to sum ran 1.02-1.04x the fill-then-add grid
//     this replaces, on an H100; the row's adds ran 0.96-0.97x.)  The
//     wrapper owns the rows and counters (zeroed once,
//     kernels/latency_hist.py), and calls on one device must not overlap
//     on two streams.
// In both, each block stages its lane's B+1 edges and a B-bin int32
// histogram in shared memory, and a valid entry loads its sample and finds
// its bin by a branch-free lower-bound search over the edges (a fixed
// number of steps for the lane's B; edges must be nondecreasing per lane).
// The counts are integers, so the result is exact whatever the order.
// Offsets are 64-bit: a lane may hold billions of samples.

#include <cuda_runtime.h>
#include <stdint.h>

constexpr unsigned FULL = 0xffffffffu;
constexpr int LANE_THREADS = 1024;  // threads of hist_lane_kernel, at most
constexpr int LANE_U = 4;           // its entries a thread a pass
constexpr int CHUNK_THREADS = 256;  // threads of hist_chunk_kernel, at most
constexpr int CHUNK_U = 2;          // its 16-byte mask loads a thread in flight

// Mask entry types: torch.bool (one byte, nonzero = set) and float32
// (set where > 0, so NaN and -0.0 are not).  VEC entries fill 16 bytes.
template <typename ValidT>
struct Mask;

template <>
struct Mask<uint8_t> {
  static constexpr int VEC = 16;
  __device__ __forceinline__ static bool ok(uint8_t v) { return v != 0; }
  __device__ __forceinline__ static bool ok(const uint4& w, int t) {
    const unsigned word = t < 4 ? w.x : t < 8 ? w.y : t < 12 ? w.z : w.w;
    return ((word >> (8 * (t & 3))) & 0xffu) != 0;
  }
};

template <>
struct Mask<float> {
  static constexpr int VEC = 4;
  __device__ __forceinline__ static bool ok(float v) { return v > 0.0f; }
  __device__ __forceinline__ static bool ok(const uint4& w, int t) {
    const unsigned word = t == 0 ? w.x : t == 1 ? w.y : t == 2 ? w.z : w.w;
    return __uint_as_float(word) > 0.0f;
  }
};

// Bin #{j : e[j] < x} - 1, clipped to [0, n_bins): the lower bound of x
// in the n_bins + 1 nondecreasing edges, found in log2(n_bins + 1) + 1
// steps whatever x is.
__device__ __forceinline__ int find_bin(float x, const float* e, int n_bins) {
  const int n = n_bins + 1;
  int step = 1;
  while (step * 2 <= n) step *= 2;
  int pos = 0;  // the edges known to be below x
  for (; step > 0; step >>= 1)
    if (pos + step <= n && e[pos + step - 1] < x) pos += step;
  return min(max(pos - 1, 0), n_bins - 1);
}

// Every thread of the warp calls this together: each thread with `ok`
// set adds one to bin b; the threads of one bin add their count with one
// shared atomic.
__device__ __forceinline__ void add_bin(bool ok, int b, int* h) {
  const unsigned act = __ballot_sync(FULL, ok);
  if (ok) {
    const unsigned peers = __match_any_sync(act, b);
    if ((threadIdx.x & 31) == __ffs(peers) - 1)
      atomicAdd(&h[b], __popc(peers));
  }
}

// Stage lane's edges and zero the block's histogram.
__device__ __forceinline__ void stage(const float* __restrict__ edges,
                                      long long lane, int n_bins, float* e,
                                      int* h) {
  for (int j = threadIdx.x; j <= n_bins; j += blockDim.x)
    e[j] = edges[lane * (n_bins + 1) + j];
  for (int j = threadIdx.x; j < n_bins; j += blockDim.x) h[j] = 0;
}

template <typename ValidT>
__global__ void __launch_bounds__(LANE_THREADS, 2) hist_lane_kernel(
    const float* __restrict__ samples, const ValidT* __restrict__ valid,
    const float* __restrict__ edges, int* __restrict__ out, long long n,
    int n_bins) {
  extern __shared__ unsigned char smem[];
  float* e = reinterpret_cast<float*>(smem);
  int* h = reinterpret_cast<int*>(e + (n_bins + 1));
  const long long lane = blockIdx.x;
  stage(edges, lane, n_bins, e, h);
  __syncthreads();
  const float* s = samples + lane * n;
  const ValidT* v = valid + lane * n;
  const long long pass = (long long)blockDim.x * LANE_U;
  // every thread runs the same passes, so the warp stays converged
  for (long long base = 0; base < n; base += pass) {
    bool ok[LANE_U];
    float x[LANE_U];  // every load of the pass issued before any is used
#pragma unroll
    for (int u = 0; u < LANE_U; ++u) {
      const long long i = base + u * blockDim.x + threadIdx.x;
      ok[u] = i < n && Mask<ValidT>::ok(v[i]);
    }
#pragma unroll
    for (int u = 0; u < LANE_U; ++u)
      x[u] = ok[u] ? s[base + u * blockDim.x + threadIdx.x] : 0.f;
#pragma unroll
    for (int u = 0; u < LANE_U; ++u)
      if (__any_sync(FULL, ok[u]))
        add_bin(ok[u], find_bin(x[u], e, n_bins), h);
  }
  __syncthreads();
  for (int j = threadIdx.x; j < n_bins; j += blockDim.x)
    out[lane * n_bins + j] = h[j];
}

template <typename ValidT>
__global__ void __launch_bounds__(CHUNK_THREADS) hist_chunk_kernel(
    const float* __restrict__ samples, const ValidT* __restrict__ valid,
    const float* __restrict__ edges, int* __restrict__ out,
    int* __restrict__ sums, int* __restrict__ arrivals, long long n,
    int n_bins, long long chunk, int n_chunks) {
  constexpr int VEC = Mask<ValidT>::VEC;
  extern __shared__ unsigned char smem[];
  float* e = reinterpret_cast<float*>(smem);
  int* h = reinterpret_cast<int*>(e + (n_bins + 1));
  __shared__ int ticket;
  const long long lane = blockIdx.x / n_chunks;
  const long long c = blockIdx.x % n_chunks;
  stage(edges, lane, n_bins, e, h);
  __syncthreads();

  const long long begin = c * chunk;
  const long long end = min(begin + chunk, n);
  const float* s = samples + lane * n;
  const ValidT* v = valid + lane * n;
  // [begin, a0) up to the first 16-byte aligned entry, [a0, a1) in whole
  // 16-byte vectors, [a1, end) the rest
  const unsigned mis = reinterpret_cast<uintptr_t>(v + begin) & 15u;
  const long long a0 = min(begin + (long long)((16u - mis) & 15u) /
                                       (long long)sizeof(ValidT), end);
  const long long n_vec = (end - a0) / VEC;
  const long long a1 = a0 + n_vec * VEC;
  for (long long i = begin + threadIdx.x; i < a0; i += blockDim.x)
    if (Mask<ValidT>::ok(v[i])) atomicAdd(&h[find_bin(s[i], e, n_bins)], 1);
  for (long long i = a1 + threadIdx.x; i < end; i += blockDim.x)
    if (Mask<ValidT>::ok(v[i])) atomicAdd(&h[find_bin(s[i], e, n_bins)], 1);
  // the set entries of the 16-byte vector at [a0 + jv VEC, ...)
  auto bin_vector = [&](const uint4& w, long long jv) {
    if ((w.x | w.y | w.z | w.w) == 0u) return;  // nothing set here
#pragma unroll
    for (int t = 0; t < VEC; ++t)
      if (Mask<ValidT>::ok(w, t))
        atomicAdd(&h[find_bin(s[a0 + jv * VEC + t], e, n_bins)], 1);
  };
  const uint4* vv = reinterpret_cast<const uint4*>(v + a0);
  const long long stride = blockDim.x;
  long long j = threadIdx.x;
  // CHUNK_U vectors a thread in flight, then the set entries among them
  for (; j + (CHUNK_U - 1) * stride < n_vec; j += CHUNK_U * stride) {
    uint4 w[CHUNK_U];
#pragma unroll
    for (int u = 0; u < CHUNK_U; ++u) w[u] = vv[j + u * stride];
#pragma unroll
    for (int u = 0; u < CHUNK_U; ++u) bin_vector(w[u], j + u * stride);
  }
  for (; j < n_vec; j += stride) bin_vector(vv[j], j);
  __syncthreads();

  // the block's nonzero bins into the lane's row of sums, then a ticket;
  // the barrier orders the block's adds before thread 0's fence, which
  // makes them visible before its ticket (the pattern of a grid sync);
  // the lane's last block fences again, stores the row into out and
  // leaves it zero for the next launch
  int* row = sums + lane * n_bins;
  for (int b = threadIdx.x; b < n_bins; b += blockDim.x)
    if (h[b] != 0) atomicAdd(&row[b], h[b]);
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    ticket = atomicAdd(&arrivals[lane], 1);
    if (ticket == n_chunks - 1) __threadfence();
  }
  __syncthreads();
  if (ticket != n_chunks - 1) return;
  for (int b = threadIdx.x; b < n_bins; b += blockDim.x) {
    out[lane * n_bins + b] = __ldcg(row + b);
    row[b] = 0;
  }
  if (threadIdx.x == 0) arrivals[lane] = 0;
}

template <typename ValidT>
static int launch(const void* samples, const void* valid, const void* edges,
                  void* out, void* sums, void* arrivals,
                  long long n_lanes, long long n, int n_bins,
                  long long chunk, int n_chunks, int threads,
                  cudaStream_t st) {
  const size_t shmem = sizeof(float) * (n_bins + 1) + sizeof(int) * n_bins;
  const float* s = static_cast<const float*>(samples);
  const ValidT* v = static_cast<const ValidT*>(valid);
  const float* e = static_cast<const float*>(edges);
  int* o = static_cast<int*>(out);
  if (threads <= 0 || threads % 32 != 0 || n_lanes >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  if (n_chunks == 0) {
    if (threads > LANE_THREADS) return (int)cudaErrorInvalidValue;
    hist_lane_kernel<ValidT><<<(unsigned)n_lanes, threads, shmem, st>>>(
        s, v, e, o, n, n_bins);
    return (int)cudaGetLastError();
  }
  if (threads > CHUNK_THREADS || n_chunks < 0 || chunk <= 0 ||
      n_lanes * n_chunks >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  hist_chunk_kernel<ValidT>
      <<<(unsigned)(n_lanes * n_chunks), threads, shmem, st>>>(
          s, v, e, o, static_cast<int*>(sums),
          static_cast<int*>(arrivals), n, n_bins, chunk, n_chunks);
  return (int)cudaGetLastError();
}

// C entry point: launches on `stream` and returns the launch's CUDA error
// (cudaErrorInvalidValue for a plan the source has no kernel for).
// valid_is_f32 = 0 reads the mask as bytes (torch.bool), 1 as float32.
// n_chunks = 0 launches one block of `threads` a lane (hist_lane_kernel);
// n_chunks > 0 that many blocks a lane of `chunk` entries each
// (hist_chunk_kernel), with `sums` L n_bins int32 and `arrivals` L int32
// counters, zero before the call and after.
extern "C" int latency_hist_launch(const void* samples, const void* valid,
                                   int valid_is_f32, const void* edges,
                                   void* out, void* sums, void* arrivals,
                                   long long n_lanes, long long n,
                                   int n_bins, long long chunk, int n_chunks,
                                   int threads, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (valid_is_f32)
    return launch<float>(samples, valid, edges, out, sums, arrivals,
                         n_lanes, n, n_bins, chunk, n_chunks, threads, st);
  return launch<uint8_t>(samples, valid, edges, out, sums, arrivals,
                         n_lanes, n, n_bins, chunk, n_chunks, threads, st);
}
