// split_tf32.cuh: float32 products on the tensor cores (mma.sync m16n8k8
// TF32, float32 accumulation) in split TF32, for the backward kernels of
// mamba2_ssd.cu and wkv6.cu.
//
// Fragments of lane (g, t) = (lane / 4, lane % 4): A (16 x 8, rows m, k)
// a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4); B (8 x 8, k, n)
// b0 (t, g), b1 (t + 4, g); the float32 accumulator c0 (g, 2t), c1 (g, 2t +
// 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1).  Each float32 operand is split in
// registers at fragment load into hi = tf32(v) and lo = tf32(v - hi), and a
// product is lo.hi + hi.lo + hi.hi summed in float32; an operand read from
// bf16 is exact in TF32 (8 significant bits of TF32's 11: its lo is 0), so
// a product with one takes two passes, a product of two one.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32x3 {

// x rounded to TF32 (10 mantissa bits) to nearest, ties away from zero,
// as cvt.rna.tf32.f32 rounds a finite x: sm_90a expands that instruction to
// a test that x is finite, this add and this mask; the operands here are
// finite (an infinity keeps its bits too), so the test is left out.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

struct FragA {
  uint32_t hi[4], lo[4];
};
struct FragB {
  uint32_t hi[2], lo[2];
};

// kExact: the values are exact in TF32 (read from bf16): no lo.
template <bool kExact>
__device__ __forceinline__ FragA split_a(const float (&v)[4]) {
  FragA f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    f.hi[k] = kExact ? __float_as_uint(v[k]) : to_tf32(v[k]);
    f.lo[k] = kExact ? 0u : to_tf32(v[k] - __uint_as_float(f.hi[k]));
  }
  return f;
}

template <bool kExact>
__device__ __forceinline__ FragB split_b(float v0, float v1) {
  FragB f;
  f.hi[0] = kExact ? __float_as_uint(v0) : to_tf32(v0);
  f.hi[1] = kExact ? __float_as_uint(v1) : to_tf32(v1);
  f.lo[0] = kExact ? 0u : to_tf32(v0 - __uint_as_float(f.hi[0]));
  f.lo[1] = kExact ? 0u : to_tf32(v1 - __uint_as_float(f.hi[1]));
  return f;
}

// No side effects beyond d: the compiler may interleave independent ones.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d[q] += a b[q] in split TF32 for the tiles q < n (one A, NT tiles of B),
// each pass over all the tiles before the next, so consecutive mma are
// independent; the small terms first, the pass with an exact operand's lo
// left out.
template <bool kAX, bool kBX, int NT>
__device__ __forceinline__ void mma3_row(float (&d)[NT][4], const FragA& a,
                                         const FragB (&b)[NT], int n) {
  if (!kAX)
#pragma unroll
    for (int q = 0; q < NT; ++q)
      if (q < n) mma(d[q], a.lo, b[q].hi);
  if (!kBX)
#pragma unroll
    for (int q = 0; q < NT; ++q)
      if (q < n) mma(d[q], a.hi, b[q].lo);
#pragma unroll
  for (int q = 0; q < NT; ++q)
    if (q < n) mma(d[q], a.hi, b[q].hi);
}

// d[q] += a[q] b[q] for the q with on[q], passes interleaved as above.
template <bool kAX, bool kBX, int NT>
__device__ __forceinline__ void mma3_each(float (&d)[NT][4],
                                          const FragA (&a)[NT],
                                          const FragB (&b)[NT],
                                          const bool (&on)[NT]) {
  if (!kAX)
#pragma unroll
    for (int q = 0; q < NT; ++q)
      if (on[q]) mma(d[q], a[q].lo, b[q].hi);
  if (!kBX)
#pragma unroll
    for (int q = 0; q < NT; ++q)
      if (on[q]) mma(d[q], a[q].hi, b[q].lo);
#pragma unroll
  for (int q = 0; q < NT; ++q)
    if (on[q]) mma(d[q], a[q].hi, b[q].hi);
}

// d += a b in split TF32 (one tile).
template <bool kAX, bool kBX>
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a,
                                     const FragB& b) {
  if (!kAX) mma(d, a.lo, b.hi);
  if (!kBX) mma(d, a.hi, b.lo);
  mma(d, a.hi, b.hi);
}

}  // namespace tf32x3
