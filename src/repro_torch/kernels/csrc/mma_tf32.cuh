// Building blocks of the split-TF32 tensor-core products (sm_90a):
// mma.sync m16n8k8 with TF32 operands and float32 accumulation, and the
// split of a float32 operand into two TF32 parts, hi = tf32(a) and
// lo = tf32(a - hi), so that hi*hi + hi*lo + lo*hi carries about 21 bits
// of each product where one TF32 product carries 11.  Included by wkv6.cu
// inside its anonymous namespace, after mma_bf16.cuh; kernels/_build.py
// hashes it with each source.
//
// Fragments of m16n8k8 (g = lane / 4, t = lane % 4):
//   A (16 x 8, row-major): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
//                          a3 (g + 8, t + 4);
//   B (8 x 8, column):     b0 (t, g), b1 (t + 4, g);
//   C (16 x 8):            c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t),
//                          c3 (g + 8, 2t + 1).
#pragma once

// a rounded to TF32 (10 mantissa bits, to nearest, ties away from zero,
// as cvt.rna.tf32.f32 rounds a finite a), as the bits of a float32: two
// integer operations where the conversion takes four
__device__ __forceinline__ uint32_t tf32_bits(float a) {
  return (__float_as_uint(a) + 0x1000u) & 0xffffe000u;
}

// a = hi + lo in TF32 parts
__device__ __forceinline__ void split_tf32(float a, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_bits(a);
  lo = tf32_bits(a - __uint_as_float(hi));
}

// a's TF32 parts as one 8-byte word (hi, lo), for operands split once
// and kept in shared memory
__device__ __forceinline__ uint2 split_tf32(float a) {
  uint2 r;
  split_tf32(a, r.x, r.y);
  return r;
}

// d += a * b for one m16n8k8 tile
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// An A fragment of four values in TF32 parts, from their (hi, lo) words.
struct FragA {
  uint32_t hi[4], lo[4];
  __device__ __forceinline__ void load(uint2 a0, uint2 a1, uint2 a2,
                                       uint2 a3) {
    hi[0] = a0.x; lo[0] = a0.y;
    hi[1] = a1.x; lo[1] = a1.y;
    hi[2] = a2.x; lo[2] = a2.y;
    hi[3] = a3.x; lo[3] = a3.y;
  }
};

// A B fragment of two values: in TF32 parts (split here, or from their
// (hi, lo) words), or (exact) one part when the values hold at most 11
// significant bits (bfloat16 inputs).
struct FragB {
  uint32_t hi[2], lo[2];
  __device__ __forceinline__ void set(float b0, float b1) {
    split_tf32(b0, hi[0], lo[0]);
    split_tf32(b1, hi[1], lo[1]);
  }
  __device__ __forceinline__ void load(uint2 b0, uint2 b1) {
    hi[0] = b0.x; lo[0] = b0.y;
    hi[1] = b1.x; lo[1] = b1.y;
  }
  __device__ __forceinline__ void set_exact(float b0, float b1) {
    hi[0] = __float_as_uint(b0);
    hi[1] = __float_as_uint(b1);
  }
};

// d + x += a * b in split TF32: hi * hi into d, the two small cross
// terms into x (two independent chains; the caller adds x to d at the
// end); with `exact_b` b has no lo part (two products, else three).
template <bool exact_b>
__device__ __forceinline__ void mma_split(float (&d)[4], float (&x)[4],
                                          const FragA& a, const FragB& b) {
  mma_tf32(x, a.lo, b.hi[0], b.hi[1]);
  if constexpr (!exact_b) mma_tf32(x, a.hi, b.lo[0], b.lo[1]);
  mma_tf32(d, a.hi, b.hi[0], b.hi[1]);
}
