// The copy engine (TMA) for the recurrence kernels and the attention
// backward (sm_90a): mbarriers with transaction counts, tensor-map boxes
// (plain or with the 128-byte swizzle that wgmma reads) and plain bulk
// copies into shared memory, and the host's encoder of tensor maps,
// reached through the runtime so that no library links libcuda.
// Included by wkv6.cu, rglru_scan.cu and flash_attention_bwd.cu inside
// their anonymous namespaces, after mma_bf16.cuh (smem_addr);
// kernels/_build.py hashes it with each source.
#pragma once

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar)) : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT_%=;\n}\n" ::"r"(smem_addr(bar)), "r"(parity)
      : "memory");
}

// mbar_wait that traps (a launch error on the host, not a hung card)
// when the phase has not completed after about 2^32 cycles: a protocol
// fault then ends the process instead of holding the card.
__device__ __forceinline__ void mbar_wait_or_trap(uint64_t* bar,
                                                  int parity) {
  uint32_t done;
  long long t0 = 0;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (t0 == 0) {
      t0 = clock64();
    } else if (clock64() - t0 > (1ll << 32)) {
      asm volatile("trap;");
    }
  }
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from global
// to shared memory by the copy engine, counted against the barrier.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// One box of a 3- or 4-dimensional tensor map (coordinates innermost
// first) into shared memory by the copy engine, counted against the
// barrier; elements past the tensor's ends are filled with zeros
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int c0, int c1, int c2, int c3,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(
          smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int c0, int c1, int c2,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(
          smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(smem_addr(bar))
      : "memory");
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled, through the runtime (no link to
// the driver library)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A tiled map of an n-dimensional view (dims and element strides
// innermost first, the innermost dense) of float32 or bfloat16 elements,
// read in boxes of `box`, with the 128-byte swizzle if `swizzle128` (the
// box's rows then at most 128 bytes; the shared tile 1024-byte aligned).
// A dimension of extent 1 gets a nominal stride (only index 0 is read).
// False if the encoder is missing or refuses.
bool encode_map(CUtensorMap* m, const void* base, bool bf16, int rank,
                const unsigned long long* dims, const long long* strides,
                const unsigned* box, bool swizzle128 = false) {
  const EncodeTiled fn = encode_tiled();
  if (!fn) return false;
  const cuuint64_t es = bf16 ? 2 : 4;
  cuuint64_t d[5], st[4];
  cuuint32_t bx[5], ones[5];
  for (int q = 0; q < rank; ++q) {
    d[q] = dims[q];
    bx[q] = box[q];
    ones[q] = 1;
    if (q > 0) st[q - 1] = dims[q] > 1 ? (cuuint64_t)strides[q] * es : 16;
  }
  return fn(m,
            bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
            rank, const_cast<void*>(base), d, st, bx, ones,
            CU_TENSOR_MAP_INTERLEAVE_NONE,
            swizzle128 ? CU_TENSOR_MAP_SWIZZLE_128B
                       : CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}
