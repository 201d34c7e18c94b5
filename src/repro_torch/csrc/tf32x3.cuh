// Tensor-core helpers of N1's mma path (spmm_blockell_t.cu): the split of
// an f32 operand into two TF32 parts for error-compensated TF32 products
// (the same arithmetic as K9's f32 path in bsattn.cu, which keeps its own
// copy), mma.sync wrappers for TF32, bf16 and f16 operands with f32 sums,
// and ldmatrix.  Everything here is inline.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace tc3 {

// f32 bits rounded to TF32 (the low 13 mantissa bits 0), to nearest with
// ties away from zero: cvt.rna's rounding for finite x, with an integer
// add and a mask, which issue at the ALU's rate where cvt runs at the
// conversion unit's lower one.
__device__ __forceinline__ uint32_t round_tf32(uint32_t bits) {
  return (bits + 0x1000u) & 0xffffe000u;
}

// x as hi + lo, both TF32: hi is x rounded to TF32 and lo is x - hi (exact
// in f32) rounded to TF32, so x - hi - lo is at most 2^-22 |x|.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = round_tf32(__float_as_uint(x));
  lo = round_tf32(__float_as_uint(x - __uint_as_float(hi)));
}

// d += a (16 x 8, row-major) * b (8 x 8, column-major), TF32 operands, f32
// accumulator
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b with f32 operands split as above: the three products that
// matter (lo lo is below 2^-22 of the product), the small ones first.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4],
                                           const uint32_t (&a_hi)[4],
                                           const uint32_t (&a_lo)[4],
                                           uint32_t b0_hi, uint32_t b1_hi,
                                           uint32_t b0_lo, uint32_t b1_lo) {
  mma_tf32(d, a_lo, b0_hi, b1_hi);
  mma_tf32(d, a_hi, b0_lo, b1_lo);
  mma_tf32(d, a_hi, b0_hi, b1_hi);
}

// d += a (16 x 16, row-major) * b (16 x 8, column-major): bf16 (BF16 true)
// or f16 operands, f32 accumulator
template <bool BF16>
__device__ __forceinline__ void mma_16bit(float (&d)[4],
                                          const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  if constexpr (BF16)
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, "
        "%3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  else
    asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, "
        "%3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8 x 8 matrices of 16-bit elements from shared memory, transposed:
// lanes 8 q .. 8 q + 7 name the rows of matrix q, and lane l receives, of
// each matrix, the elements (row 2 (l % 4), column l / 4) and (row
// 2 (l % 4) + 1, column l / 4) in one register.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* row) {
  const uint32_t addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

}  // namespace tc3
