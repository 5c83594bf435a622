// tile4x4.cuh: 4 x 4 register tiles of small float32 matrix products over
// operands in shared memory, for the scan kernels (mamba2_ssd.cu, wkv6.cu).
//
// Every operand is row-major with a row stride that is a multiple of 4
// floats and 16-byte aligned, so each load moves 4 floats.  Each helper
// adds to acc[r][c] a sum over t in ascending order, one fused multiply-add
// per term: the order of a thread's sum is fixed and does not depend on the
// launch.
#pragma once
#include <cuda_runtime.h>

namespace tile4 {

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ float at(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// acc[r][c] += sum_t A[i0 + r][t] * Bt[j0 + c][t], t in [0, kd), kd % 4 == 0.
__device__ __forceinline__ void nt(float (&acc)[4][4], const float* A, int lda,
                                   const float* Bt, int ldb, int i0, int j0,
                                   int kd) {
  for (int t = 0; t < kd; t += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) a[r] = ld4(A + (i0 + r) * lda + t);
#pragma unroll
    for (int c = 0; c < 4; ++c) b[c] = ld4(Bt + (j0 + c) * ldb + t);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        acc[r][c] = fmaf(a[r].x, b[c].x, acc[r][c]);
        acc[r][c] = fmaf(a[r].y, b[c].y, acc[r][c]);
        acc[r][c] = fmaf(a[r].z, b[c].z, acc[r][c]);
        acc[r][c] = fmaf(a[r].w, b[c].w, acc[r][c]);
      }
  }
}

// acc[r][c] += sum_t A[i0 + r][t] * B[t][j0 + c], t in [0, kd), kd % 4 == 0.
__device__ __forceinline__ void nn(float (&acc)[4][4], const float* A, int lda,
                                   const float* B, int ldb, int i0, int j0,
                                   int kd) {
  for (int t = 0; t < kd; t += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) a[r] = ld4(A + (i0 + r) * lda + t);
#pragma unroll
    for (int q = 0; q < 4; ++q) b[q] = ld4(B + (t + q) * ldb + j0);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float aq = at(a[r], q);
        acc[r][0] = fmaf(aq, b[q].x, acc[r][0]);
        acc[r][1] = fmaf(aq, b[q].y, acc[r][1]);
        acc[r][2] = fmaf(aq, b[q].z, acc[r][2]);
        acc[r][3] = fmaf(aq, b[q].w, acc[r][3]);
      }
  }
}

// acc[r][c] += sum_t At[t][i0 + r] * s[t] * B[t][j0 + c], t in [0, kd); the
// product At * s is rounded first.  s == nullptr means s[t] = 1.
__device__ __forceinline__ void tn_scaled(float (&acc)[4][4], const float* At,
                                          int lda, const float* s,
                                          const float* B, int ldb, int i0,
                                          int j0, int kd) {
  for (int t = 0; t < kd; ++t) {
    float4 a = ld4(At + t * lda + i0);
    const float4 b = ld4(B + t * ldb + j0);
    if (s) {
      const float w = s[t];
      a = make_float4(a.x * w, a.y * w, a.z * w, a.w * w);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float ar = at(a, r);
      acc[r][0] = fmaf(ar, b.x, acc[r][0]);
      acc[r][1] = fmaf(ar, b.y, acc[r][1]);
      acc[r][2] = fmaf(ar, b.z, acc[r][2]);
      acc[r][3] = fmaf(ar, b.w, acc[r][3]);
    }
  }
}

// Tile (ti, tj) of the lower triangle ti >= tj of an n x n grid of tiles,
// numbered row by row: t = ti * (ti + 1) / 2 + tj.
__device__ __forceinline__ void lower_tile(int t, int& ti, int& tj) {
  int i = (int)((sqrtf(8.f * (float)t + 1.f) - 1.f) * 0.5f);
  while (i * (i + 1) / 2 > t) --i;
  while ((i + 1) * (i + 2) / 2 <= t) ++i;
  ti = i;
  tj = t - i * (i + 1) / 2;
}

}  // namespace tile4
