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
// handles scatters badly; here a scatter into shared memory is cheap, so:
//   * the grid is (lanes x chunks of N), flattened into blockIdx.x, with
//     many chunks per lane so the blocks fill the card in even waves;
//   * each block stages its lane's B+1 edges and a B-bin int32 histogram
//     in shared memory;
//   * threads stride over the chunk reading the mask 16 bytes at a time
//     (16 bool or 4 float32 entries), so each thread keeps a wide load in
//     flight and a warp reads 512 contiguous bytes; a scalar loop takes
//     the unaligned head and the tail of the row;
//   * a valid entry loads its sample, finds its bin by a lower-bound
//     search over the edges (edges must be nondecreasing per lane) and
//     adds one with a shared atomicAdd;
//   * the block flushes its nonzero bins into out with global atomicAdd
//     (out is zeroed by the caller).
// Integer atomics make the result exact whatever the order in which the
// blocks run.  Offsets are 64-bit: a lane may hold billions of samples.

#include <cuda_runtime.h>
#include <stdint.h>

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

// Add sample x to the shared histogram: bin #{j : e[j] < x} - 1, clipped.
__device__ __forceinline__ void bin_one(float x, const float* e, int* h,
                                        int n_bins) {
  int lo = 0, hi = n_bins + 1;  // lower bound: the edges strictly below x
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (e[mid] < x) lo = mid + 1; else hi = mid;
  }
  atomicAdd(&h[min(max(lo - 1, 0), n_bins - 1)], 1);
}

template <typename ValidT>
__global__ void latency_hist_kernel(const float* __restrict__ samples,
                                    const ValidT* __restrict__ valid,
                                    const float* __restrict__ edges,
                                    int* __restrict__ out,
                                    long long n, int n_bins,
                                    long long chunk, int n_chunks) {
  constexpr int VEC = Mask<ValidT>::VEC;
  extern __shared__ unsigned char smem[];
  float* e = reinterpret_cast<float*>(smem);
  int* h = reinterpret_cast<int*>(e + (n_bins + 1));

  const long long lane = blockIdx.x / n_chunks;
  const long long c = blockIdx.x % n_chunks;
  for (int j = threadIdx.x; j <= n_bins; j += blockDim.x)
    e[j] = edges[lane * (n_bins + 1) + j];
  for (int j = threadIdx.x; j < n_bins; j += blockDim.x) h[j] = 0;
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
    if (Mask<ValidT>::ok(v[i])) bin_one(s[i], e, h, n_bins);
  for (long long i = a1 + threadIdx.x; i < end; i += blockDim.x)
    if (Mask<ValidT>::ok(v[i])) bin_one(s[i], e, h, n_bins);
  const uint4* vv = reinterpret_cast<const uint4*>(v + a0);
  for (long long j = threadIdx.x; j < n_vec; j += blockDim.x) {
    const uint4 w = vv[j];
    if ((w.x | w.y | w.z | w.w) == 0u) continue;  // nothing set here
#pragma unroll
    for (int t = 0; t < VEC; ++t)
      if (Mask<ValidT>::ok(w, t)) bin_one(s[a0 + j * VEC + t], e, h, n_bins);
  }
  __syncthreads();
  for (int j = threadIdx.x; j < n_bins; j += blockDim.x)
    if (h[j] != 0) atomicAdd(&out[lane * n_bins + j], h[j]);
}

// C entry point: launches on `stream` and returns cudaGetLastError().
// valid_is_f32 = 0 reads the mask as bytes (torch.bool), 1 as float32.
extern "C" int latency_hist_launch(const void* samples, const void* valid,
                                   int valid_is_f32, const void* edges,
                                   void* out, long long n_lanes, long long n,
                                   int n_bins, long long chunk, int n_chunks,
                                   int threads, void* stream) {
  const long long blocks = n_lanes * n_chunks;
  const size_t shmem = sizeof(float) * (n_bins + 1) + sizeof(int) * n_bins;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (valid_is_f32) {
    latency_hist_kernel<float><<<(unsigned)blocks, threads, shmem, st>>>(
        static_cast<const float*>(samples), static_cast<const float*>(valid),
        static_cast<const float*>(edges), static_cast<int*>(out), n, n_bins,
        chunk, n_chunks);
  } else {
    latency_hist_kernel<uint8_t><<<(unsigned)blocks, threads, shmem, st>>>(
        static_cast<const float*>(samples),
        static_cast<const uint8_t*>(valid),
        static_cast<const float*>(edges), static_cast<int*>(out), n, n_bins,
        chunk, n_chunks);
  }
  return static_cast<int>(cudaGetLastError());
}
