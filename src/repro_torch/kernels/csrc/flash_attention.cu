// flash_attention: tiled online-softmax attention forward, causal with an
// optional sliding window, grouped-query heads.
//
// Replaces the TPU kernel repro/kernels/flash_attention/kernel.py
// (flash_attention_pallas / _flash_kernel); computes what the forward of
// repro/models/attention.py:blocked_attention computes.
//
//   q [B, Sq, H, D], k/v [B, Sk, Hk, D] (float32 or bfloat16, contiguous)
//   -> o [B, Sq, H, D] in q's dtype;  query i sits at key position
//   i + q_offset; key j is live iff j < Sk, (causal) j <= i + q_offset and
//   (window > 0) i + q_offset - j < window.
//
// Arithmetic follows the reference tile by tile in float32: q is scaled on
// load, a masked score is -1e30, each k tile updates the running max m,
// the sum l and the accumulator by exp(s - m_new) and exp(m - m_new), and
// the output is acc / max(l, 1e-30).
//
// Bound on the H100 at the serving shape (B=2, S=6000, H=32, Hk=8, D=80,
// window 4096, bf16): 16.19 M live (q, k) pairs per head, 4*D operations
// each, 331 GFLOP per launch, against 154 MB of q/k/v/o; 0.335 ms at the
// bf16 tensor-core peak (989 TFLOP/s) and 0.046 ms at 3.35 TB/s, so the
// function is bound by operations.  This first kernel runs them on the fp32
// FMA pipes (67 TFLOP/s peak), not on the tensor cores, so it sits well
// above that bound; mma/wgmma, TMA and pipelining are later work.
//
// Design: one 128-thread block per (64-query tile, b*h).  The block keeps
// its scaled q tile in shared memory and walks only the live 64-key tiles
// (causally dead and out-of-window tiles are never loaded), staging each K
// and V tile in shared memory as float32.  Each thread owns a 4 x 8 patch
// of the 64 x 64 score tile (rows rg + 16i, keys cg + 8j) and the same 4
// rows of the output over 4-column chunks cg + 8e, so the row max and row
// sum reduce over the 8 lanes of one row group with warp shuffles.  Every
// shared load in the inner loops moves 4 floats (q, k and p along the
// reduced dimension, v along the output columns), which keeps the loops on
// the FMA pipes rather than on shared-memory issue; q/k/v rows have a
// stride of an odd number of 16-byte chunks and p rows 8 mod 32 floats, so
// those loads are free of bank conflicts.  The KV head of query head h is
// h / (H / Hk): GQA reads K/V in place, never a repeated copy.  Ragged
// Sq/Sk are masked at the edges, not padded.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 128;  // 16 row groups x 8 column groups
constexpr int kPStride = kBK + 8;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Four consecutive elements from an address aligned to four of them.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ float4 scale4(float4 x, float s) {
  return make_float4(x.x * s, x.y * s, x.z * s, x.w * s);
}

__device__ __forceinline__ float group8_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
}

__device__ __forceinline__ float group8_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x + __shfl_xor_sync(0xffffffffu, x, 4);
}

// Stage rows [row0, row0 + 64) of up to two [rows, D] operands (row stride
// ``stride`` elements) into shared float32 rows of ``dq`` floats, times
// ``mul``.  Rows at or past ``nrows`` and columns [D, 4 * D4) are zero.
// ``vec``: D is a multiple of 4 and the operands are aligned to 4 elements,
// so each thread moves 4 elements per load.
template <typename T>
__device__ __forceinline__ void stage(const T* a, const T* b, float* sa,
                                      float* sb, long long stride, int row0,
                                      int nrows, int D, int D4, int dq,
                                      bool vec, float mul) {
  if (vec) {
    for (int idx = threadIdx.x; idx < 64 * D4; idx += kThreads) {
      const int r = idx / D4, c = 4 * (idx - r * D4);
      float4 xa = make_float4(0.f, 0.f, 0.f, 0.f), xb = xa;
      if (row0 + r < nrows) {
        const long long off = (row0 + r) * stride + c;
        xa = scale4(load4(a + off), mul);
        if (b) xb = load4(b + off);
      }
      *reinterpret_cast<float4*>(sa + r * dq + c) = xa;
      if (b) *reinterpret_cast<float4*>(sb + r * dq + c) = xb;
    }
    return;
  }
  const int w = 4 * D4;
  for (int idx = threadIdx.x; idx < 64 * w; idx += kThreads) {
    const int r = idx / w, c = idx - r * w;
    float xa = 0.f, xb = 0.f;
    if (row0 + r < nrows && c < D) {
      const long long off = (row0 + r) * stride + c;
      xa = load_f32(a + off) * mul;
      if (b) xb = load_f32(b + off);
    }
    sa[r * dq + c] = xa;
    if (b) sb[r * dq + c] = xb;
  }
}

// DPT4: 4-column output chunks per thread, ceil(D / 32) rounded up to an
// instantiated width; chunks at or past ceil(D / 4) are skipped.
template <typename T, int DPT4>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int Sq, int Sk,
                 int H, int Hk, int D, int causal, int window, int q_offset,
                 float scale, int vec) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int D4 = (D + 3) / 4;
  const int dq = 8 * ((D + 7) / 8) + 4;  // row stride: an odd number of float4
  float* qs = smem;                     // [kBQ][dq], pre-scaled
  float* ks = qs + kBQ * dq;            // [kBK][dq]
  float* vs = ks + kBK * dq;            // [kBK][dq]
  float* ps = vs + kBK * dq;            // [kBQ][kPStride]

  const int tid = threadIdx.x;
  const int rg = tid >> 3;              // row group 0..15
  const int cg = tid & 7;               // column group 0..7
  const int bh = blockIdx.y;
  const int bi = bh / H, hi = bh - bi * H;
  const int kvh = hi / (H / Hk);
  const int q0 = blockIdx.x * kBQ;

  const long long q_row = (long long)H * D;
  const long long kv_row = (long long)Hk * D;
  const T* qb = q + (long long)bi * Sq * q_row + (long long)hi * D;
  const T* kb = k + (long long)bi * Sk * kv_row + (long long)kvh * D;
  const T* vb = v + (long long)bi * Sk * kv_row + (long long)kvh * D;
  T* ob = o + (long long)bi * Sq * q_row + (long long)hi * D;

  stage<T>(qb, nullptr, qs, nullptr, q_row, q0, Sq, D, D4, dq, vec, scale);

  // Live key tiles of this block: [kt_begin, kt_end).
  const int qa0 = q0 + q_offset;
  const int qa1 = min(q0 + kBQ, Sq) - 1 + q_offset;
  int kt_end = (Sk + kBK - 1) / kBK;
  if (causal) kt_end = min(kt_end, qa1 / kBK + 1);
  int kt_begin = 0;
  if (window > 0 && qa0 - window + 1 > 0) kt_begin = (qa0 - window + 1) / kBK;

  float m[4], l[4], acc[4][DPT4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < DPT4; ++e)
#pragma unroll
      for (int t = 0; t < 4; ++t) acc[i][e][t] = 0.f;
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's P.V reads are done
    stage<T>(kb, vb, ks, vs, kv_row, k0, Sk, D, D4, dq, vec, 1.f);
    __syncthreads();

    // S = (q * scale) K^T for rows rg + 16i, keys cg + 8j, summed over the
    // head dimension in ascending order.
    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
    for (int c = 0; c < 4 * D4; c += 4) {
      float4 qv[4], kv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(qs + (rg + 16 * i) * dq + c);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        kv[j] = *reinterpret_cast<const float4*>(ks + (cg + 8 * j) * dq + c);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float x = __fmaf_rn(qv[i].x, kv[j].x, s[i][j]);
          x = __fmaf_rn(qv[i].y, kv[j].y, x);
          x = __fmaf_rn(qv[i].z, kv[j].z, x);
          s[i][j] = __fmaf_rn(qv[i].w, kv[j].w, x);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + rg + 16 * i + q_offset;
      float mt = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kpos = k0 + cg + 8 * j;
        const int rel = qpos - kpos;
        bool ok = kpos < Sk;
        if (causal) ok = ok && rel >= 0;
        if (window > 0) ok = ok && rel < window;
        if (!ok) s[i][j] = kNegInf;
        mt = fmaxf(mt, s[i][j]);
      }
      const float m_new = fmaxf(m[i], group8_max(mt));
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = expf(s[i][j] - m_new);
        rs += p;
        ps[(rg + 16 * i) * kPStride + cg + 8 * j] = p;
      }
      l[i] = l[i] * corr + group8_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int e = 0; e < DPT4; ++e)
#pragma unroll
        for (int t = 0; t < 4; ++t) acc[i][e][t] *= corr;
    }
    __syncthreads();

    // acc += P V for rows rg + 16i, columns 4 (cg + 8e) + t.
    for (int c = 0; c < kBK; c += 4) {
      float pv[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 x =
            *reinterpret_cast<const float4*>(ps + (rg + 16 * i) * kPStride + c);
        pv[i][0] = x.x; pv[i][1] = x.y; pv[i][2] = x.z; pv[i][3] = x.w;
      }
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const float* vrow = vs + (c + cc) * dq;
#pragma unroll
        for (int e = 0; e < DPT4; ++e) {
          const int chunk = cg + 8 * e;
          if (chunk < D4) {
            const float4 vv = *reinterpret_cast<const float4*>(vrow + 4 * chunk);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              acc[i][e][0] = __fmaf_rn(pv[i][cc], vv.x, acc[i][e][0]);
              acc[i][e][1] = __fmaf_rn(pv[i][cc], vv.y, acc[i][e][1]);
              acc[i][e][2] = __fmaf_rn(pv[i][cc], vv.z, acc[i][e][2]);
              acc[i][e][3] = __fmaf_rn(pv[i][cc], vv.w, acc[i][e][3]);
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + rg + 16 * i;
    if (row >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int e = 0; e < DPT4; ++e)
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int col = 4 * (cg + 8 * e) + t;
        if (col < D) store_f32(ob + row * q_row + col, acc[i][e][t] / denom);
      }
  }
}

template <typename T, int DPT4>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int Sq, int Sk, int H, int Hk, int D, int causal,
                   int window, int q_offset, float scale,
                   cudaStream_t stream) {
  const int dq = 8 * ((D + 7) / 8) + 4;
  const size_t smem = sizeof(float) * ((size_t)(kBQ + 2 * kBK) * dq
                                       + (size_t)kBQ * kPStride);
  const size_t align = 4 * sizeof(T);
  const int vec = D % 4 == 0 && (size_t)q % align == 0
                  && (size_t)k % align == 0 && (size_t)v % align == 0;
  auto kernel = flash_fwd_kernel<T, DPT4>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((Sq + kBQ - 1) / kBQ, B * H);
  kernel<<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, Sq, Sk, H, Hk, D, causal,
      window, q_offset, scale, vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o,
                     int B, int Sq, int Sk, int H, int Hk, int D, int causal,
                     int window, int q_offset, float scale,
                     cudaStream_t stream) {
  const int need = (D + 31) / 32;
#define FLASH_CASE(W)                                                        \
  if (need <= W)                                                             \
    return launch<T, W>(q, k, v, o, B, Sq, Sk, H, Hk, D, causal, window,    \
                        q_offset, scale, stream);
  FLASH_CASE(1)
  FLASH_CASE(2)
  FLASH_CASE(3)
  FLASH_CASE(4)
  FLASH_CASE(6)
  FLASH_CASE(8)
#undef FLASH_CASE
  return cudaErrorInvalidValue;  // D > 256
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  Returns a cudaError_t (0 on success).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int Sq,
                                      int Sk, int H, int Hk, int D, int causal,
                                      int window, int q_offset, int dtype,
                                      float scale, void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || Hk < 1 || H % Hk != 0 || D < 1 || D > 256
      || B * H > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)dispatch<float>(q, k, v, o, B, Sq, Sk, H, Hk, D, causal,
                                window, q_offset, scale, st);
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16>(q, k, v, o, B, Sq, Sk, H, Hk, D,
                                        causal, window, q_offset, scale, st);
  return (int)cudaErrorInvalidValue;
}
