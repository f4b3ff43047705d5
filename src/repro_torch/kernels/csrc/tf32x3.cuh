// Split TF32 (3xTF32) products on the tensor cores, for the port's float32
// kernels that run their products as mma.sync.m16n8k8 (flash_attention's
// float32 instantiation, ssd_scan).
//
// TF32 keeps 10 bits of mantissa; one TF32 product for each float32 one
// would leave the reference's float32 tolerances. Each operand a is cut
// into a_hi (a rounded to 10 mantissa bits, nearest, ties away from zero,
// by an integer add and mask) and a_lo = a - a_hi (exact in float32; the
// tensor core takes its top 10 mantissa bits, so what is lost is under
// 2^-21 |a|), and a b is taken as a_lo b_hi + a_hi b_lo + a_hi b_hi
// (a_lo b_lo, under 2^-22 |a b|, is dropped), each an exact product summed
// in float32 by the tensor core.
//
// Fragments of m16n8k8 (g = lane / 4, t = lane % 4): A (16 x 8, row-major)
// a0 = A[g][t], a1 = A[g + 8][t], a2 = A[g][t + 4], a3 = A[g + 8][t + 4];
// B (8 x 8) b0 = B[t][g], b1 = B[t + 4][g]; D (16 x 8) d0 = D[g][2t],
// d1 = D[g][2t + 1], d2 = D[g + 8][2t], d3 = D[g + 8][2t + 1].
#pragma once

#include <cstdint>

namespace repro_tf32 {

// a = hi + lo, hi and lo as the tensor core reads them
__device__ __forceinline__ void split(float a, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(a) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(a - __uint_as_float(hi));
}

// d[16 x 8] += a[16 x 8] b[8 x 8], TF32 in, float32 sum (not volatile: the
// compiler may interleave independent products)
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// a split into (hi, lo) A fragments, from a0 .. a3 in fragment order
__device__ __forceinline__ void split_a(float a0, float a1, float a2, float a3, uint32_t (&hi)[4],
                                        uint32_t (&lo)[4]) {
  split(a0, hi[0], lo[0]);
  split(a1, hi[1], lo[1]);
  split(a2, hi[2], lo[2]);
  split(a3, hi[3], lo[3]);
}

}  // namespace repro_tf32
