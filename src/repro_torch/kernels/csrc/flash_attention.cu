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
// Both kernels walk, for one 64-query tile of one (b, h), only the live
// 64-key tiles (causally dead and out-of-window tiles are never loaded);
// each k tile updates the running max m, the sum l and the accumulator,
// and the output is acc / max(l, 1e-30).  The KV head of query head h is
// h / (H / Hk): GQA reads K/V in place, never a repeated copy.  Ragged
// Sq/Sk are masked at the edges, not padded.  Rows with no live key (a
// window that ends before the first key) take the reference's value from
// dead_rows_kernel, launched after them only when the geometry has them.
//
// Bound on the H100 at the serving shape (B=2, S=6000, H=32, Hk=8, D=80,
// window 4096, bf16): 16.19 M live (q, k) pairs per head, 4*D operations
// each, 331 GFLOP per launch, against 154 MB of q/k/v/o; 0.335 ms at the
// bf16 tensor-core peak (989 TFLOP/s), 0.248 ms for the 1.04 G
// exponentials on the special-function units (16 per clock per SM) and
// 0.046 ms at 3.35 TB/s, so the tensor cores bound the function.
//
// bfloat16 (every serving prefill): flash_bf16_kernel, FlashAttention-2 on
// mma.sync.m16n8k16 (bf16 in, float32 accumulate).  One 128-thread block
// per (b*h, 64-query tile); each warp owns 16 query rows.  K and V tiles
// are staged as bf16 in a ring of two stages by 16-byte cp.async copies,
// the next tile's copy in flight while the current tile's products run;
// rows are padded by 8 elements (an odd number of 16-byte chunks), so the
// ldmatrix reads of 8 rows fall in 8 distinct bank groups.  S = Q K^T
// accumulates in float32 and is masked to -inf; the online softmax runs per
// row in registers (row max and sum over the 4 lanes of a quad) in score
// units, p = 2^(s c - m c) with c = scale * log2(e) applied in float32 (one
// FFMA and one ex2.approx.ftz per score; results below 2^-126 flush to 0,
// invisible beside the row's largest p, 1); P is rounded to bf16 in registers
// and used as the A operand of P V directly (the m16n8 accumulator layout
// is the m16n8k16 A layout), so P never touches shared memory; l sums the
// float32 p.  Rounding P costs ~2^-9 relative per probability, within the
// bf16 tolerance of 2e-2.  The head width is padded with zeros to a
// multiple of 16 (an instantiated width DP), and the store is masked.
// Registers decide the rest: up to DP = 80 the kernel is cut to 128
// registers, so 4 blocks share an SM, and reads its Q fragments from
// shared memory per k-step (on an H100 at danube's serving shape 8.5 %
// faster than 3 blocks with Q in registers: tools/probe_kernel_builds.py,
// edit q_in_registers); for 96 <= DP <= 128 Q sits in
// registers; wider heads read Q from shared memory again, the 16 x DP
// float32 accumulator taking most of a thread's 255 registers.  Heads of a
// width that is not a multiple of 8, or operands not aligned to 16 bytes,
// are staged element by element instead of by cp.async.  Query tiles run
// heaviest first (the last causal tile has the most live keys).  Like
// every source here it is compiled with --fmad=false; the contractions the
// kernel wants (the exponent s c - m c, the running sum l * corr + rowsum)
// are written as __fmaf_rn.
//
// float32 (the card-vs-CPU parity checks): flash_fwd_kernel, on the fp32
// FMA pipes, arithmetic as the reference's tile by tile: q is scaled on
// load, a masked score is -1e30 and the exponentials are expf.  Each thread owns a 4 x 8 patch of
// the 64 x 64 score tile (rows rg + 16i, keys cg + 8j) and the same 4 rows
// of the output over 4-column chunks cg + 8e, so the row max and row sum
// reduce over the 8 lanes of one row group with warp shuffles.  K and V
// tiles are staged in shared memory as float32; every shared load in the
// inner loops moves 4 floats; q/k/v rows have a stride of an odd number of
// 16-byte chunks and p rows 8 mod 32 floats, so those loads are free of
// bank conflicts.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "async_copy.cuh"

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 128;  // 16 row groups x 8 column groups
constexpr int kPStride = kBK + 8;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }

// Four consecutive floats from an address aligned to four of them.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
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
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ m_out, float* __restrict__ l_out, int Sq,
                 int Sk, int H, int Hk, int D, int causal, int window,
                 int q_offset, float scale, int vec) {
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
    if (m_out && cg == 0) {
      m_out[(long long)bh * Sq + row] = m[i];
      l_out[(long long)bh * Sq + row] = l[i];
    }
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
                   float* m, float* l, int B, int Sq, int Sk, int H, int Hk,
                   int D, int causal, int window, int q_offset, float scale,
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
      (const T*)q, (const T*)k, (const T*)v, (T*)o, m, l, Sq, Sk, H, Hk, D,
      causal, window, q_offset, scale, vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o,
                     float* m, float* l, int B, int Sq, int Sk, int H, int Hk,
                     int D, int causal, int window, int q_offset, float scale,
                     cudaStream_t stream) {
  const int need = (D + 31) / 32;
#define FLASH_CASE(W)                                                        \
  if (need <= W)                                                             \
    return launch<T, W>(q, k, v, o, m, l, B, Sq, Sk, H, Hk, D, causal,      \
                        window, q_offset, scale, stream);
  FLASH_CASE(1)
  FLASH_CASE(2)
  FLASH_CASE(3)
  FLASH_CASE(4)
  FLASH_CASE(6)
  FLASH_CASE(8)
#undef FLASH_CASE
  return cudaErrorInvalidValue;  // D > 256
}


// ---- bfloat16 on the tensor cores ----------------------------------------

namespace tc {

constexpr int kRows = 64;      // queries per block, 16 per warp
constexpr int kKeys = 64;      // keys per tile
constexpr int kThreads = 128;  // 4 warps
constexpr float kLog2e = 1.4426950408889634f;

using async_copy::smem_addr;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// d += a b for one m16n8k16 tile: a 16 x 16 bf16 (row), b 16 x 8 bf16
// (col), d 16 x 8 float32.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Stage rows [row0, row0 + ROWS) of a [rows, D] bf16 operand (row stride
// ``stride`` elements) into shared rows of ``ld`` elements.  ``async``: D
// is a multiple of 8 and the operand 16-byte aligned; 16-byte cp.async
// copies, rows at or past ``nrows`` zero-filled, columns [D, DP) left as
// they are (zeroed once at the start).  Otherwise element by element, with
// zeros past ``nrows`` and in columns [D, DP).
template <int DP, int ROWS = kRows>
__device__ __forceinline__ void stage(const __nv_bfloat16* src,
                                      __nv_bfloat16* dst, long long stride,
                                      int row0, int nrows, int D, int ld,
                                      bool async) {
  if (async) {
    const int chunks = D / 8;
    for (int idx = threadIdx.x; idx < ROWS * chunks; idx += kThreads) {
      const int r = idx / chunks, c = 8 * (idx - r * chunks);
      const bool live = row0 + r < nrows;
      const __nv_bfloat16* g = live ? src + (row0 + r) * stride + c : src;
      async_copy::copy16(dst + r * ld + c, g, live ? 16 : 0);
    }
    return;
  }
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
  for (int idx = threadIdx.x; idx < ROWS * DP; idx += kThreads) {
    const int r = idx / DP, c = idx - r * DP;
    dst[r * ld + c] = row0 + r < nrows && c < D
                          ? src[(row0 + r) * stride + c] : zero;
  }
}

// Blocks per SM the register budget is cut for: 4 for heads up to 80 wide
// (their Q fragments then come from shared memory), else what the
// fragments and the accumulator need.
constexpr int min_blocks(int dp) { return dp <= 80 ? 4 : 1; }

// DP: the head width padded to a multiple of 16 (an instantiated width).
template <int DP>
__global__ void __launch_bounds__(kThreads, min_blocks(DP))
flash_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  __nv_bfloat16* __restrict__ o, float* __restrict__ m_out,
                  float* __restrict__ l_out, int Sq, int Sk, int H, int Hk,
                  int D, int causal, int window, int q_offset, float scale,
                  float scale_log2, int async) {
  constexpr int kLd = DP + 8;          // shared row stride, elements
  constexpr int kSteps = DP / 16;      // k-steps of Q K^T
  constexpr int kOut = DP / 8;         // n-tiles of the output
  constexpr bool kQInRegs = DP > 80 && DP <= 128;
  constexpr int kTile = kRows * kLd;   // elements of one staged tile
  extern __shared__ uint4 smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + kTile;      // [2][kKeys][kLd]
  __nv_bfloat16* vs = ks + 2 * kTile;  // [2][kKeys][kLd]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x;
  const int bi = bh / H, hi = bh - bi * H;
  const int kvh = hi / (H / Hk);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;  // heaviest first

  const long long q_row = (long long)H * D;
  const long long kv_row = (long long)Hk * D;
  const __nv_bfloat16* qb = q + (long long)bi * Sq * q_row + (long long)hi * D;
  const __nv_bfloat16* kb =
      k + (long long)bi * Sk * kv_row + (long long)kvh * D;
  const __nv_bfloat16* vb =
      v + (long long)bi * Sk * kv_row + (long long)kvh * D;
  __nv_bfloat16* ob = o + (long long)bi * Sq * q_row + (long long)hi * D;

  // Live key tiles of this block: [kt_begin, kt_end).
  const int qa0 = q0 + q_offset;
  const int qa1 = min(q0 + kRows, Sq) - 1 + q_offset;
  int kt_end = (Sk + kKeys - 1) / kKeys;
  if (causal) kt_end = min(kt_end, qa1 / kKeys + 1);
  int kt_begin = 0;
  if (window > 0 && qa0 - window + 1 > 0)
    kt_begin = (qa0 - window + 1) / kKeys;

  if (async) {  // the pad columns [D, DP) stay zero
    for (int i = threadIdx.x; i < 5 * kTile / 8; i += kThreads)
      smem_raw[i] = make_uint4(0u, 0u, 0u, 0u);
    __syncthreads();
  }
  stage<DP>(qb, qs, q_row, q0, Sq, D, kLd, async);
  if (kt_begin < kt_end) {
    stage<DP>(kb, ks, kv_row, kt_begin * kKeys, Sk, D, kLd, async);
    stage<DP>(vb, vs, kv_row, kt_begin * kKeys, Sk, D, kLd, async);
  }
  async_copy::commit();

  // Rows of this thread: r0 = q0 + 16 warp + g and r0 + 8.
  const int row_lo = q0 + warp * 16 + g;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[kOut][4];
#pragma unroll
  for (int n = 0; n < kOut; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  uint32_t qf[kQInRegs ? kSteps : 1][4];
  // ldmatrix row addresses: A (Q) rows lane & 15, column half lane >> 4; B
  // of K (two key n-tiles) rows (lane & 7) + 8 (lane >> 4), column half
  // (lane >> 3) & 1; B of V (transposed) rows (lane & 7) + 8 ((lane >> 3)
  // & 1), column half lane >> 4.
  const uint32_t q_addr =
      smem_addr(qs + (warp * 16 + (lane & 15)) * kLd + 8 * (lane >> 4));
  const int k_off =
      ((lane & 7) + 8 * (lane >> 4)) * kLd + 8 * ((lane >> 3) & 1);
  const int v_off =
      ((lane & 7) + 8 * ((lane >> 3) & 1)) * kLd + 8 * (lane >> 4);

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int st = (kt - kt_begin) & 1;
    const int k0 = kt * kKeys;
    if (kt + 1 < kt_end) {
      stage<DP>(kb, ks + (st ^ 1) * kTile, kv_row, k0 + kKeys, Sk, D, kLd,
                async);
      stage<DP>(vb, vs + (st ^ 1) * kTile, kv_row, k0 + kKeys, Sk, D, kLd,
                async);
      async_copy::commit();
      async_copy::wait<1>();
    } else {
      async_copy::wait<0>();
    }
    __syncthreads();
    if (kQInRegs && kt == kt_begin) {
#pragma unroll
      for (int s = 0; s < kSteps; ++s)
        ldmatrix_x4(qf[kQInRegs ? s : 0], q_addr + 32 * s);
    }

    // S = Q K^T: 16 rows x 64 keys per warp, 8 n-tiles of 8 keys.
    float sc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
    const uint32_t k_addr = smem_addr(ks + st * kTile + k_off);
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      uint32_t a[4];
      if (kQInRegs) {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = qf[kQInRegs ? s : 0][e];
      } else {
        ldmatrix_x4(a, q_addr + 32 * s);
      }
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b[4];
        ldmatrix_x4(b, k_addr + 2 * (16 * np * kLd + 16 * s));
        mma(sc[2 * np], a, b[0], b[1]);
        mma(sc[2 * np + 1], a, b[2], b[3]);
      }
    }

    // Mask where the tile needs it.
    const bool edge = k0 + kKeys > Sk
                      || (causal && k0 + kKeys - 1 > qa0)
                      || (window > 0 && qa1 - k0 >= window);
    if (edge) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kpos = k0 + 8 * j + 2 * t + (e & 1);
          const int rel = row_lo + 8 * (e >> 1) + q_offset - kpos;
          bool ok = kpos < Sk;
          if (causal) ok = ok && rel >= 0;
          if (window > 0) ok = ok && rel < window;
          if (!ok) sc[j][e] = -INFINITY;
        }
    }

    // Online softmax for rows row_lo (e = 0, 1) and row_lo + 8 (e = 2, 3),
    // in score units; p = 2^(s c - m c) with c = scale * log2(e), one FFMA
    // and one ex2 per score.  A row with no live key yet has m = -inf; it
    // takes 0 for m c, so its p (and correction) are 0, not NaN.
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float mt = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        mt = fmaxf(mt, fmaxf(sc[j][2 * hr], sc[j][2 * hr + 1]));
      const float m_new = fmaxf(m[hr], quad_max(mt));
      const float ms = m_new == -INFINITY ? 0.f : m_new * scale_log2;
      const float corr = ex2(__fmaf_rn(m[hr], scale_log2, -ms));
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 2 * hr; e < 2 * hr + 2; ++e) {
          sc[j][e] = ex2(__fmaf_rn(sc[j][e], scale_log2, -ms));
          rs += sc[j][e];
        }
      l[hr] = __fmaf_rn(l[hr], corr, rs);  // this thread's part of the sum
      m[hr] = m_new;
#pragma unroll
      for (int n = 0; n < kOut; ++n) {
        acc[n][2 * hr] *= corr;
        acc[n][2 * hr + 1] *= corr;
      }
    }

    // acc += P V: P (bf16) as A fragments, 4 k-steps of 16 keys.
    const uint32_t v_addr = smem_addr(vs + st * kTile + v_off);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t a[4] = {pack_bf16(sc[2 * kk][0], sc[2 * kk][1]),
                             pack_bf16(sc[2 * kk][2], sc[2 * kk][3]),
                             pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
                             pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
#pragma unroll
      for (int np = 0; np < kOut / 2; ++np) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, v_addr + 2 * (16 * kk * kLd + 16 * np));
        mma(acc[2 * np], a, b[0], b[1]);
        mma(acc[2 * np + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();  // this stage is refilled two tiles on
  }
  async_copy::wait<0>();  // no copy outlives the block, even with no live tile

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = row_lo + 8 * hr;
    const float lsum = quad_sum(l[hr]);
    const float denom = fmaxf(lsum, 1e-30f);
    if (row >= Sq) continue;
    if (m_out && t == 0) {  // m in units of the scaled score
      m_out[(long long)bh * Sq + row] = m[hr] * scale;
      l_out[(long long)bh * Sq + row] = lsum;
    }
    __nv_bfloat16* orow = ob + row * q_row;
#pragma unroll
    for (int n = 0; n < kOut; ++n) {
      const int col = 8 * n + 2 * t;
      if (col < D) orow[col] = __float2bfloat16_rn(acc[n][2 * hr] / denom);
      if (col + 1 < D)
        orow[col + 1] = __float2bfloat16_rn(acc[n][2 * hr + 1] / denom);
    }
  }
}

template <int DP>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* m, float* l, int B, int Sq, int Sk, int H, int Hk,
                   int D, int causal, int window, int q_offset, float scale,
                   cudaStream_t stream) {
  const size_t smem = sizeof(__nv_bfloat16) * 5 * kRows * (DP + 8);
  const int async = D % 8 == 0 && (size_t)q % 16 == 0 && (size_t)k % 16 == 0
                    && (size_t)v % 16 == 0;
  auto kernel = flash_bf16_kernel<DP>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(B * H, (Sq + kRows - 1) / kRows);
  kernel<<<grid, kThreads, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (__nv_bfloat16*)o, m, l, Sq, Sk, H, Hk, D,
      causal, window, q_offset, scale, scale * kLog2e, async);
  return cudaGetLastError();
}

cudaError_t dispatch(const void* q, const void* k, const void* v, void* o,
                     float* m, float* l, int B, int Sq, int Sk, int H, int Hk,
                     int D, int causal, int window, int q_offset, float scale,
                     cudaStream_t stream) {
  if ((Sq + kRows - 1) / kRows > 65535) return cudaErrorInvalidValue;
#define FLASH_BF16_CASE(DP)                                                  \
  if (D <= DP)                                                               \
    return launch<DP>(q, k, v, o, m, l, B, Sq, Sk, H, Hk, D, causal,        \
                      window, q_offset, scale, stream);
  FLASH_BF16_CASE(16)
  FLASH_BF16_CASE(32)
  FLASH_BF16_CASE(48)
  FLASH_BF16_CASE(64)
  FLASH_BF16_CASE(80)
  FLASH_BF16_CASE(96)
  FLASH_BF16_CASE(128)
  FLASH_BF16_CASE(160)
  FLASH_BF16_CASE(192)
  FLASH_BF16_CASE(256)
#undef FLASH_BF16_CASE
  return cudaErrorInvalidValue;  // D > 256
}

}  // namespace tc

// ---- rows with no live key -----------------------------------------------
//
// Query row i (key position p = i + q_offset) has no live key when
// window > 0 and p - window + 1 >= Sk.  The reference's online softmax
// masks with -1e30, so such a row keeps m = -1e30 and gives every key slot
// of every tile it visits p = 1: it comes out as the sum of V over the Sk
// keys divided by the key slots of the reference's tiles (Sk padded to its
// block_k; the padding's V is zero).  The kernels above walk only live
// tiles (the bf16 kernel leaves such a row 0); this kernel writes the rows
// [first, Sq) after them, on the same stream.  One block per (b, KV head),
// one thread per column; V summed in key order in float32.
__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void narrow(float* p, float x) { *p = x; }
__device__ __forceinline__ void narrow(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <typename T>
__global__ void dead_rows_kernel(const T* __restrict__ v, T* __restrict__ o,
                                 int Sq, int Sk, int H, int Hk, int D,
                                 int first, int slots) {
  const int bi = blockIdx.x / Hk, kvh = blockIdx.x - bi * Hk;
  const int rep = H / Hk;
  const long long kv_row = (long long)Hk * D, q_row = (long long)H * D;
  const T* vb = v + (long long)bi * Sk * kv_row + (long long)kvh * D;
  T* ob = o + (long long)bi * Sq * q_row + (long long)kvh * rep * D;
  for (int c = threadIdx.x; c < D; c += blockDim.x) {
    float sum = 0.f;
    for (int j = 0; j < Sk; ++j) sum += widen(vb[j * kv_row + c]);
    const float mean = sum / (float)slots;
    for (int i = first; i < Sq; ++i)
      for (int hh = 0; hh < rep; ++hh)
        narrow(ob + i * q_row + hh * D + c, mean);
  }
}


// ---- backward ----------------------------------------------------------
//
// Replaces no Pallas kernel: the reference's backward is plain JAX under a
// custom_vjp (repro/models/attention.py:_flash_bwd, :241).  Given q, k, v,
// the forward's output o, its row statistics m (running max of the scaled
// score) and l (sum of exp(s - m)), and dO, it recomputes each live tile's
// probabilities p = exp(s - m) / max(l, 1e-30) and, with
// delta = rowsum(dO o) and ds = p (dO V^T - delta),
//   dQ = scale * ds K,   dK = scale * ds^T Q,   dV = p^T dO,
// without storing any Sq x Sk tile in device memory.  Rows with no live
// key (a window that ends before the first key) are not taken: the wrapper
// refuses them.
//
// Bound at danube's training shape (B = 2, S = 4096, H = 32, Hk = 8,
// D = 80, causal, bf16): 537 M live (q, k) pairs, each 10 D operations
// (S, dP, dV, dK, dQ) ~ 430 GFLOP: 0.43 ms at the bf16 tensor-core peak,
// against 0.13 ms for the 537 M exponentials on the special-function units
// and 0.06 ms for the 210 MB of operands at 3.35 TB/s, so the tensor cores
// bound the function.
//
// bfloat16 (every training step): bwd_tc::dq_kernel, then
// bwd_tc::dkv_kernel, on mma.sync.m16n8k16 (bf16 in, float32 accumulate),
// 128 threads a block, each warp owning 16 of the block's 64 rows:
//
//  * dq_kernel: one block per (b, h, 64-query tile).  It first forms delta
//    for its rows in float32 FMAs (written out for dkv_kernel), then walks
//    the live key tiles: S = Q K^T and dP = dO V^T, p and dS in registers,
//    dQ += dS K.
//  * dkv_kernel: one block per (b, KV head, 64-key tile).  It walks the
//    H / Hk query heads of its group in order and, for each, only the live
//    query tiles (causal, window): S^T = K Q^T and dP^T = V dO^T, then
//    dV += p^T dO and dK += dS^T Q.  The GQA heads are summed inside the
//    block, so no atomics: two runs give the same bits.
//
// S and dP are computed in both kernels: 14 D operations a live pair
// against the function's 10 D.  What the design does about what held the
// FMA kernels below (float32 only now) back:
//  - products on the FMA pipes: all five run on the tensor cores;
//  - operands widened to float32 in shared memory (one 4-warp block an
//    SM): the tiles stay bf16, half the footprint, rows padded by 8
//    elements so the ldmatrix reads of 8 rows fall in 8 distinct bank
//    groups;
//  - synchronous staging: the other side's tiles (K and V in dq_kernel; Q
//    and dO in dkv_kernel, with their rows' m log2(e), 1 / max(l, 1e-30)
//    and delta) come through a ring of two stages filled by 16-byte
//    cp.async copies (the row statistics by loads into registers, stored
//    after the products) while the current tile's products run;
//  - intermediates through shared memory: p and dS are formed in
//    registers in the accumulator layout of S and dP and, rounded to bf16,
//    are the A operand of the next product as they stand (the m16n8
//    accumulator layout is the m16n8k16 A layout), as the forward uses P.
//    Nothing of size tile x tile goes through shared memory; the dQ, dK
//    and dV accumulators stay in float32 registers.
// p = 2^(s c - m log2(e)) / max(l, 1e-30) with c = scale * log2(e), one
// FFMA and one ex2.approx.ftz a score.  Rounding p and dS to bf16 costs
// ~2^-9 relative each, as the forward's P does; Q, K, V and dO are bf16
// already, so S and dP lose only summation order.  The head width is
// padded with zeros to a multiple of 16 (an instantiated DP).  Up to
// DP = 128 the other side's tile is 64 wide and one dkv launch keeps both
// accumulators (DP floats a thread); wider heads take 32-wide tiles and
// two dkv launches, dV's then dK's (S^T computed in each: 16 D a pair in
// all), since two 16 x DP float32 accumulators do not fit a thread's 255
// registers.  Heads of a width that is not a multiple of 8, or operands
// not 16-byte aligned, are staged element by element.  On an H100 up to
// DP = 128 dkv_kernel holds 234-255 registers (2 blocks an SM) and
// dq_kernel 141-168 (2-3), with no spill; at danube's training shape the
// pair took 2.72 ms against 45.65 for the FMA kernels' bf16 build and
// 3.04 with 32-wide tiles everywhere (tools/probe_kernel_builds.py, edit
// bwd_tile_32).
//
// float32 (the card-vs-CPU parity checks): bwd::dq_kernel and
// bwd::dkv_kernel, on the FMA pipes, float32 throughout: each thread owns
// R x 8 of a tile (R = 4, 64-row tiles, up to D = 128; R = 2 above), and
// ds and p go through shared memory.
namespace bwd {

constexpr int kThreads = 128;  // 16 row groups x 8 column groups
constexpr int kCols = 64;      // the other side's tile: keys in dq, queries in dkv
constexpr int kPStride = kCols + 8;

// Stage rows [row0, row0 + rows) of a [*, D] operand (row stride ``stride``
// elements) into shared rows of ``ld`` floats; rows at or past ``nrows``
// and columns [D, 4 D4) are zero.  ``vec``: D is a multiple of 4 and the
// operand aligned to 4 elements.
__device__ __forceinline__ void stage(const float* src, float* dst,
                                      long long stride, int row0, int rows,
                                      int nrows, int D, int D4, int ld,
                                      bool vec) {
  if (vec) {
    for (int idx = threadIdx.x; idx < rows * D4; idx += kThreads) {
      const int r = idx / D4, c = 4 * (idx - r * D4);
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row0 + r < nrows) x = load4(src + (row0 + r) * stride + c);
      *reinterpret_cast<float4*>(dst + r * ld + c) = x;
    }
    return;
  }
  const int w = 4 * D4;
  for (int idx = threadIdx.x; idx < rows * w; idx += kThreads) {
    const int r = idx / w, c = idx - r * w;
    dst[r * ld + c] = row0 + r < nrows && c < D
                          ? src[(row0 + r) * stride + c] : 0.f;
  }
}

__device__ __forceinline__ bool live(int qrow, int kpos, int Sq, int Sk,
                                     int causal, int window, int q_offset) {
  const int rel = qrow + q_offset - kpos;
  return qrow < Sq && kpos < Sk && (!causal || rel >= 0)
         && (window <= 0 || rel < window);
}

// acc[i][e][t] += sum_{c < 64} a[row i][c] * b[c][4 chunk_e + t] for the
// thread's rows rg + 16 i and column chunks cg + 8 e (chunk < D4).
template <int R, int DPT4>
__device__ __forceinline__ void accumulate(float (&acc)[R][DPT4][4],
                                           const float* a, const float* b,
                                           int rg, int cg, int D4, int ld) {
  for (int c = 0; c < kCols; c += 4) {
    float av[R][4];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const float4 x = load4(a + (rg + 16 * i) * kPStride + c);
      av[i][0] = x.x; av[i][1] = x.y; av[i][2] = x.z; av[i][3] = x.w;
    }
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      const float* brow = b + (c + cc) * ld;
#pragma unroll
      for (int e = 0; e < DPT4; ++e) {
        const int chunk = cg + 8 * e;
        if (chunk < D4) {
          const float4 bv = load4(brow + 4 * chunk);
#pragma unroll
          for (int i = 0; i < R; ++i) {
            acc[i][e][0] = __fmaf_rn(av[i][cc], bv.x, acc[i][e][0]);
            acc[i][e][1] = __fmaf_rn(av[i][cc], bv.y, acc[i][e][1]);
            acc[i][e][2] = __fmaf_rn(av[i][cc], bv.z, acc[i][e][2]);
            acc[i][e][3] = __fmaf_rn(av[i][cc], bv.w, acc[i][e][3]);
          }
        }
      }
    }
  }
}

// out[i][j] = sum_d a[row rg + 16 i][d] * b[row cg + 8 j][d], d ascending.
template <int R>
__device__ __forceinline__ void products(float (&out)[R][8], const float* a,
                                         const float* b, int rg, int cg,
                                         int D4, int ld) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) out[i][j] = 0.f;
  for (int c = 0; c < 4 * D4; c += 4) {
    float4 av[R], bv[8];
#pragma unroll
    for (int i = 0; i < R; ++i) av[i] = load4(a + (rg + 16 * i) * ld + c);
#pragma unroll
    for (int j = 0; j < 8; ++j) bv[j] = load4(b + (cg + 8 * j) * ld + c);
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float x = __fmaf_rn(av[i].x, bv[j].x, out[i][j]);
        x = __fmaf_rn(av[i].y, bv[j].y, x);
        x = __fmaf_rn(av[i].z, bv[j].z, x);
        out[i][j] = __fmaf_rn(av[i].w, bv[j].w, x);
      }
  }
}

template <int R, int DPT4>
__device__ __forceinline__ void store_rows(float* base, long long stride,
                                           const float (&acc)[R][DPT4][4],
                                           int row0, int nrows, int rg,
                                           int cg, int D, float mul) {
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = row0 + rg + 16 * i;
    if (row >= nrows) continue;
#pragma unroll
    for (int e = 0; e < DPT4; ++e)
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int col = 4 * (cg + 8 * e) + t;
        if (col < D) base[row * stride + col] = acc[i][e][t] * mul;
      }
  }
}

template <int R, int DPT4>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, const float* __restrict__ o,
          const float* __restrict__ dout, const float* __restrict__ m,
          const float* __restrict__ l, float* __restrict__ delta,
          float* __restrict__ dq, int Sq, int Sk, int H, int Hk, int D,
          int causal, int window, int q_offset, float scale, int vec) {
  constexpr int QT = 16 * R;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int D4 = (D + 3) / 4;
  const int ld = 8 * ((D + 7) / 8) + 4;
  float* qs = smem;                 // [QT][ld]
  float* dos = qs + QT * ld;        // [QT][ld]
  float* ks = dos + QT * ld;        // [64][ld]; o first, for delta
  float* vs = ks + kCols * ld;      // [64][ld]
  float* dss = vs + kCols * ld;     // [QT][kPStride]

  const int tid = threadIdx.x, rg = tid >> 3, cg = tid & 7;
  const int bh = blockIdx.y;
  const int bi = bh / H, hi = bh - bi * H;
  const int kvh = hi / (H / Hk);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * QT;  // heaviest first

  const long long q_row = (long long)H * D, kv_row = (long long)Hk * D;
  const long long q_base = (long long)bi * Sq * q_row + (long long)hi * D;
  const float* kb = k + (long long)bi * Sk * kv_row + (long long)kvh * D;
  const float* vb = v + (long long)bi * Sk * kv_row + (long long)kvh * D;

  stage(q + q_base, qs, q_row, q0, QT, Sq, D, D4, ld, vec);
  stage(dout + q_base, dos, q_row, q0, QT, Sq, D, D4, ld, vec);
  stage(o + q_base, ks, q_row, q0, QT, Sq, D, D4, ld, vec);
  __syncthreads();

  // delta, m and 1 / max(l, 1e-30) of the thread's rows.
  float dl[R], mr[R], il[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = rg + 16 * i, row = q0 + r;
    float part = 0.f;
    for (int chunk = cg; chunk < D4; chunk += 8) {
      const float4 a = load4(dos + r * ld + 4 * chunk);
      const float4 b = load4(ks + r * ld + 4 * chunk);
      part = __fmaf_rn(a.x, b.x, part);
      part = __fmaf_rn(a.y, b.y, part);
      part = __fmaf_rn(a.z, b.z, part);
      part = __fmaf_rn(a.w, b.w, part);
    }
    dl[i] = group8_sum(part);
    const bool in = row < Sq;
    mr[i] = in ? m[(long long)bh * Sq + row] : 0.f;
    il[i] = 1.f / fmaxf(in ? l[(long long)bh * Sq + row] : 1.f, 1e-30f);
    if (in && cg == 0) delta[(long long)bh * Sq + row] = dl[i];
  }

  const int qa0 = q0 + q_offset;
  const int qa1 = min(q0 + QT, Sq) - 1 + q_offset;
  int kt_end = (Sk + kCols - 1) / kCols;
  if (causal) kt_end = min(kt_end, qa1 / kCols + 1);
  int kt_begin = 0;
  if (window > 0 && qa0 - window + 1 > 0) kt_begin = (qa0 - window + 1) / kCols;

  float acc[R][DPT4][4];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int e = 0; e < DPT4; ++e)
#pragma unroll
      for (int t = 0; t < 4; ++t) acc[i][e][t] = 0.f;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kCols;
    __syncthreads();  // the previous tile's reads (and o's) are done
    stage(kb, ks, kv_row, k0, kCols, Sk, D, D4, ld, vec);
    stage(vb, vs, kv_row, k0, kCols, Sk, D, D4, ld, vec);
    __syncthreads();
    float s[R][8], dp[R][8];
    products<R>(s, qs, ks, rg, cg, D4, ld);
    products<R>(dp, dos, vs, rg, cg, D4, ld);
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int row = q0 + rg + 16 * i, kpos = k0 + cg + 8 * j;
        float ds = 0.f;
        if (live(row, kpos, Sq, Sk, causal, window, q_offset)) {
          const float p = expf(s[i][j] * scale - mr[i]) * il[i];
          ds = p * (dp[i][j] - dl[i]);
        }
        dss[(rg + 16 * i) * kPStride + cg + 8 * j] = ds;
      }
    __syncthreads();
    accumulate<R, DPT4>(acc, dss, ks, rg, cg, D4, ld);
  }
  store_rows<R, DPT4>(dq + q_base, q_row, acc, q0, Sq, rg, cg, D, scale);
}

template <int R, int DPT4>
__global__ void __launch_bounds__(kThreads)
dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ dout,
           const float* __restrict__ m, const float* __restrict__ l,
           const float* __restrict__ delta, float* __restrict__ dk,
           float* __restrict__ dv, int Sq, int Sk, int H, int Hk, int D,
           int causal, int window, int q_offset, float scale, int vec) {
  constexpr int KT = 16 * R;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int D4 = (D + 3) / 4;
  const int ld = 8 * ((D + 7) / 8) + 4;
  float* ks = smem;                 // [KT][ld]
  float* vs = ks + KT * ld;         // [KT][ld]
  float* qs = vs + KT * ld;         // [64][ld]
  float* dos = qs + kCols * ld;     // [64][ld]
  float* ps = dos + kCols * ld;     // [KT][kPStride]
  float* dss = ps + KT * kPStride;  // [KT][kPStride]
  float* ms = dss + KT * kPStride;  // [64]
  float* ils = ms + kCols;          // [64]
  float* dls = ils + kCols;         // [64]

  const int tid = threadIdx.x, rg = tid >> 3, cg = tid & 7;
  const int bk = blockIdx.y;
  const int bi = bk / Hk, kvh = bk - bi * Hk;
  const int rep = H / Hk;
  const int k0 = blockIdx.x * KT;  // the first key tiles have the most work

  const long long q_row = (long long)H * D, kv_row = (long long)Hk * D;
  const long long kv_base = (long long)bi * Sk * kv_row + (long long)kvh * D;
  stage(k + kv_base, ks, kv_row, k0, KT, Sk, D, D4, ld, vec);
  stage(v + kv_base, vs, kv_row, k0, KT, Sk, D, D4, ld, vec);

  // Live query tiles of this key tile: [qt_begin, qt_end).
  const int k1 = min(k0 + KT, Sk) - 1;
  const int nqt = (Sq + kCols - 1) / kCols;
  int qt_begin = 0, qt_end = nqt;
  if (causal) qt_begin = max(0, k0 - q_offset) / kCols;
  if (window > 0) {
    const long long last = (long long)k1 + window - 1 - q_offset;
    qt_end = last < 0 ? 0 : (int)min((long long)nqt, last / kCols + 1);
  }

  float adk[R][DPT4][4], adv[R][DPT4][4];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int e = 0; e < DPT4; ++e)
#pragma unroll
      for (int t = 0; t < 4; ++t) adk[i][e][t] = adv[i][e][t] = 0.f;

  for (int g = 0; g < rep; ++g) {
    const int hi = kvh * rep + g;
    const long long q_base = (long long)bi * Sq * q_row + (long long)hi * D;
    const long long stat = ((long long)bi * H + hi) * Sq;
    for (int qt = qt_begin; qt < qt_end; ++qt) {
      const int q0 = qt * kCols;
      __syncthreads();  // the previous tile's reads are done
      stage(q + q_base, qs, q_row, q0, kCols, Sq, D, D4, ld, vec);
      stage(dout + q_base, dos, q_row, q0, kCols, Sq, D, D4, ld, vec);
      if (tid < kCols) {
        const int row = q0 + tid;
        const bool in = row < Sq;
        ms[tid] = in ? m[stat + row] : 0.f;
        ils[tid] = 1.f / fmaxf(in ? l[stat + row] : 1.f, 1e-30f);
        dls[tid] = in ? delta[stat + row] : 0.f;
      }
      __syncthreads();
      float s[R][8], dp[R][8];
      products<R>(s, ks, qs, rg, cg, D4, ld);
      products<R>(dp, vs, dos, rg, cg, D4, ld);
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = cg + 8 * j, kpos = k0 + rg + 16 * i;
          float p = 0.f, ds = 0.f;
          if (live(q0 + c, kpos, Sq, Sk, causal, window, q_offset)) {
            p = expf(s[i][j] * scale - ms[c]) * ils[c];
            ds = p * (dp[i][j] - dls[c]);
          }
          ps[(rg + 16 * i) * kPStride + c] = p;
          dss[(rg + 16 * i) * kPStride + c] = ds;
        }
      __syncthreads();
      accumulate<R, DPT4>(adv, ps, dos, rg, cg, D4, ld);
      accumulate<R, DPT4>(adk, dss, qs, rg, cg, D4, ld);
    }
  }
  store_rows<R, DPT4>(dk + kv_base, kv_row, adk, k0, Sk, rg, cg, D, scale);
  store_rows<R, DPT4>(dv + kv_base, kv_row, adv, k0, Sk, rg, cg, D, 1.f);
}

template <int R>
constexpr size_t dq_smem(int ld) {
  return sizeof(float) * ((size_t)(2 * 16 * R + 2 * kCols) * ld
                          + (size_t)16 * R * kPStride);
}
template <int R>
constexpr size_t dkv_smem(int ld) {
  return sizeof(float) * ((size_t)(2 * 16 * R + 2 * kCols) * ld
                          + (size_t)2 * 16 * R * kPStride + 3 * kCols);
}

// R of a head width of 4 DPT4 floats a column group.  At D = 80 and 128
// the 64-row tiles hold one dkv block an SM against two of 32 rows, yet
// take 6-13 % less time: each staged Q and dO tile serves twice the keys,
// and the shared loads per FMA fall from ~0.6 to ~0.35.
template <int DPT4>
constexpr int kRowGroups = DPT4 <= 4 ? 4 : 2;

template <int DPT4>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* o, const void* dout, const float* m,
                   const float* l, float* delta, void* dq, void* dk, void* dv,
                   int B, int Sq, int Sk, int H, int Hk, int D, int causal,
                   int window, int q_offset, float scale,
                   cudaStream_t stream) {
  constexpr int R = kRowGroups<DPT4>;
  const int ld = 8 * ((D + 7) / 8) + 4;
  const size_t align = 4 * sizeof(float);
  const int vec = D % 4 == 0;
  const bool aligned = (size_t)q % align == 0 && (size_t)k % align == 0
                       && (size_t)v % align == 0 && (size_t)o % align == 0
                       && (size_t)dout % align == 0;
  const int vq = vec && aligned;
  auto kq = dq_kernel<R, DPT4>;
  auto kkv = dkv_kernel<R, DPT4>;
  const size_t sq_bytes = dq_smem<R>(ld), skv_bytes = dkv_smem<R>(ld);
  cudaError_t e = cudaFuncSetAttribute(
      kq, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sq_bytes);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(kkv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)skv_bytes);
  if (e != cudaSuccess) return e;
  const dim3 gq((Sq + 16 * R - 1) / (16 * R), B * H);
  kq<<<gq, kThreads, sq_bytes, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)o,
      (const float*)dout, m, l, delta, (float*)dq, Sq, Sk, H, Hk, D, causal,
      window, q_offset, scale, vq);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const dim3 gkv((Sk + 16 * R - 1) / (16 * R), B * Hk);
  kkv<<<gkv, kThreads, skv_bytes, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout,
      m, l, delta, (float*)dk, (float*)dv, Sq, Sk, H, Hk, D, causal, window,
      q_offset, scale, vq);
  return cudaGetLastError();
}

cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const void* o, const void* dout, const float* m,
                     const float* l, float* delta, void* dq, void* dk,
                     void* dv, int B, int Sq, int Sk, int H, int Hk, int D,
                     int causal, int window, int q_offset, float scale,
                     cudaStream_t stream) {
  const int need = (D + 31) / 32;
#define FLASH_BWD_CASE(W)                                                    \
  if (need <= W)                                                             \
    return launch<W>(q, k, v, o, dout, m, l, delta, dq, dk, dv, B, Sq, Sk,  \
                     H, Hk, D, causal, window, q_offset, scale, stream);
  FLASH_BWD_CASE(1)
  FLASH_BWD_CASE(2)
  FLASH_BWD_CASE(3)
  FLASH_BWD_CASE(4)
  FLASH_BWD_CASE(6)
  FLASH_BWD_CASE(8)
#undef FLASH_BWD_CASE
  return cudaErrorInvalidValue;  // D > 256
}

}  // namespace bwd

// ---- backward, bfloat16 on the tensor cores --------------------------------

namespace bwd_tc {

using tc::kRows;     // rows of the block's own side, 16 a warp
using tc::kThreads;  // 4 warps
using tc::kLog2e;
using async_copy::smem_addr;

// Width of the other side's tile (keys in dq_kernel, queries in
// dkv_kernel): 64 up to DP = 128, 32 above, where the 16 x DP float32
// accumulator takes most of a thread's registers.
__host__ __device__ constexpr int tile_cols(int dp) {
  return dp <= 128 ? 64 : 32;
}

// Elements of the staged bf16 tiles of either kernel: two of 64 rows (Q
// and dO, or K and V) and a ring of two stages of two tiles of
// tile_cols(DP) rows, each row DP + 8 wide.
__host__ __device__ constexpr size_t tile_elems(int dp) {
  return (size_t)(2 * kRows + 4 * tile_cols(dp)) * (dp + 8);
}
// Dynamic shared memory of each kernel: the tiles, and for dkv_kernel the
// two stages' row statistics.
constexpr size_t dq_smem(int dp) { return 2 * tile_elems(dp); }
constexpr size_t dkv_smem(int dp) {
  return 2 * tile_elems(dp) + sizeof(float) * 6 * tile_cols(dp);
}

// ldmatrix lane offsets, in elements, into a tile of row stride ld: the A
// operand of the warp's 16 rows (k halves by lane >> 4); the B operand
// of a row-major [n][k] tile (two n-tiles of 8 rows); the B operand of a
// row-major [k][n] tile, read transposed.
__device__ __forceinline__ int a_off(int lane, int ld) {
  return (lane & 15) * ld + 8 * (lane >> 4);
}
__device__ __forceinline__ int b_off(int lane, int ld) {
  return ((lane & 7) + 8 * (lane >> 4)) * ld + 8 * ((lane >> 3) & 1);
}
__device__ __forceinline__ int bt_off(int lane, int ld) {
  return ((lane & 7) + 8 * ((lane >> 3) & 1)) * ld + 8 * (lane >> 4);
}

// c = A B^T for the warp's 16 rows and NT n-tiles of 8 columns, over DP /
// 16 k-steps: A's fragments at a_addr (32 bytes a k-step), B a row-major
// [n][k] tile at b_addr (b_off lanes).
template <int DP, int NT>
__device__ __forceinline__ void products(float (&c)[NT][4], uint32_t a_addr,
                                         uint32_t b_addr, int ld) {
#pragma unroll
  for (int j = 0; j < NT; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
#pragma unroll
  for (int s = 0; s < DP / 16; ++s) {
    uint32_t a[4];
    tc::ldmatrix_x4(a, a_addr + 32 * s);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t b[4];
      tc::ldmatrix_x4(b, b_addr + 2 * (16 * np * ld + 16 * s));
      tc::mma(c[2 * np], a, b[0], b[1]);
      tc::mma(c[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// acc += P B for the warp's 16 rows: P (16 x 8 NT, p or dS in the
// accumulator layout of ``products``) rounded to bf16 as the A operand,
// B a row-major [k][n] tile of DP columns at bt_addr (bt_off lanes).
template <int DP, int NT>
__device__ __forceinline__ void accumulate(float (&acc)[DP / 8][4],
                                           const float (&p)[NT][4],
                                           uint32_t bt_addr, int ld) {
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
    const uint32_t a[4] = {tc::pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                           tc::pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                           tc::pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                           tc::pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
    for (int np = 0; np < DP / 16; ++np) {
      uint32_t b[4];
      tc::ldmatrix_x4_trans(b, bt_addr + 2 * (16 * kk * ld + 16 * np));
      tc::mma(acc[2 * np], a, b[0], b[1]);
      tc::mma(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
}

template <int DP>
__device__ __forceinline__ void zero(float (&acc)[DP / 8][4]) {
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
}

// Rows row_lo and row_lo + 8 (those below ``nrows``) of a [*, D] bf16
// operand of row stride ``stride``: acc * mul, columns below D.
template <int DP>
__device__ __forceinline__ void store(__nv_bfloat16* base, long long stride,
                                      const float (&acc)[DP / 8][4],
                                      int row_lo, int nrows, int t, int D,
                                      float mul) {
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = row_lo + 8 * hr;
    if (row >= nrows) continue;
    __nv_bfloat16* out = base + row * stride;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const int col = 8 * n + 2 * t;
      if (col < D) out[col] = __float2bfloat16_rn(acc[n][2 * hr] * mul);
      if (col + 1 < D)
        out[col + 1] = __float2bfloat16_rn(acc[n][2 * hr + 1] * mul);
    }
  }
}

// Zeroes the staged tiles when they are filled by cp.async, which leaves
// the pad columns [D, DP) as they are.
template <int DP>
__device__ __forceinline__ void zero_tiles(uint4* smem, bool async) {
  if (!async) return;
  for (int i = threadIdx.x; i < (int)(tile_elems(DP) / 8); i += kThreads)
    smem[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
}

// One block per (b * H + h, 64-query tile), heaviest tile first.
template <int DP>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const __nv_bfloat16* __restrict__ q,
          const __nv_bfloat16* __restrict__ k,
          const __nv_bfloat16* __restrict__ v,
          const __nv_bfloat16* __restrict__ o,
          const __nv_bfloat16* __restrict__ dout, const float* __restrict__ m,
          const float* __restrict__ l, float* __restrict__ delta,
          __nv_bfloat16* __restrict__ dq, int Sq, int Sk, int H, int Hk,
          int D, int causal, int window, int q_offset, float scale,
          float scale_log2, int async) {
  constexpr int kN = tile_cols(DP);    // keys a tile
  constexpr int kNT = kN / 8;          // n-tiles of S and dP
  constexpr int kLd = DP + 8;          // shared row stride, elements
  constexpr int kTile = kN * kLd;      // one staged K or V tile
  extern __shared__ uint4 smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* dos = qs + kRows * kLd;
  // [2 stages][K, V][kN][kLd]; stage 1 holds o first, for delta.
  __nv_bfloat16* kvs = dos + kRows * kLd;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x;
  const int bi = bh / H, hi = bh - bi * H;
  const int kvh = hi / (H / Hk);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;

  const long long q_row = (long long)H * D, kv_row = (long long)Hk * D;
  const long long q_base = (long long)bi * Sq * q_row + (long long)hi * D;
  const __nv_bfloat16* kb =
      k + (long long)bi * Sk * kv_row + (long long)kvh * D;
  const __nv_bfloat16* vb =
      v + (long long)bi * Sk * kv_row + (long long)kvh * D;

  // Live key tiles of this block: [kt_begin, kt_end).
  const int qa0 = q0 + q_offset;
  const int qa1 = min(q0 + kRows, Sq) - 1 + q_offset;
  int kt_end = (Sk + kN - 1) / kN;
  if (causal) kt_end = min(kt_end, qa1 / kN + 1);
  int kt_begin = 0;
  if (window > 0 && qa0 - window + 1 > 0) kt_begin = (qa0 - window + 1) / kN;

  zero_tiles<DP>(smem_raw, async);
  tc::stage<DP>(q + q_base, qs, q_row, q0, Sq, D, kLd, async);
  tc::stage<DP>(dout + q_base, dos, q_row, q0, Sq, D, kLd, async);
  tc::stage<DP>(o + q_base, kvs + 2 * kTile, q_row, q0, Sq, D, kLd, async);
  async_copy::commit();
  if (kt_begin < kt_end) {
    tc::stage<DP, kN>(kb, kvs, kv_row, kt_begin * kN, Sk, D, kLd, async);
    tc::stage<DP, kN>(vb, kvs + kTile, kv_row, kt_begin * kN, Sk, D, kLd,
                      async);
  }
  async_copy::commit();
  async_copy::wait<1>();
  __syncthreads();

  // delta = rowsum(dO o) in float32: lanes 2 r and 2 r + 1 of a warp sum
  // every other column pair of its row r; the thread's rows (g and g + 8
  // of its warp) come from lanes 2 g and 2 g + 16.
  float dl[2];
  {
    const int r = warp * 16 + (lane >> 1);
    const __nv_bfloat16* a = dos + r * kLd;
    const __nv_bfloat16* b = kvs + 2 * kTile + r * kLd;
    float part = 0.f;
    for (int c = 2 * (lane & 1); c < DP; c += 4) {
      const float2 x = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(a + c));
      const float2 y = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(b + c));
      part = __fmaf_rn(x.x, y.x, part);
      part = __fmaf_rn(x.y, y.y, part);
    }
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    if ((lane & 1) == 0 && q0 + r < Sq)
      delta[(long long)bh * Sq + q0 + r] = part;
    dl[0] = __shfl_sync(0xffffffffu, part, 2 * g);
    dl[1] = __shfl_sync(0xffffffffu, part, 2 * g + 16);
  }
  // m in base-2 units and 1 / max(l, 1e-30) of the thread's rows.
  const int row_lo = q0 + warp * 16 + g;
  float mc[2], il[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = row_lo + 8 * hr;
    const bool in = row < Sq;
    mc[hr] = in ? m[(long long)bh * Sq + row] * kLog2e : 0.f;
    il[hr] = 1.f / fmaxf(in ? l[(long long)bh * Sq + row] : 1.f, 1e-30f);
  }
  __syncthreads();  // o's reads are done before stage 1 is refilled

  float acc[DP / 8][4];
  zero<DP>(acc);
  const uint32_t q_addr = smem_addr(qs + warp * 16 * kLd + a_off(lane, kLd));
  const uint32_t do_addr =
      smem_addr(dos + warp * 16 * kLd + a_off(lane, kLd));
  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int st = (kt - kt_begin) & 1;
    const int k0 = kt * kN;
    const __nv_bfloat16* ks = kvs + st * 2 * kTile;
    const __nv_bfloat16* vs = ks + kTile;
    if (kt + 1 < kt_end) {
      __nv_bfloat16* next = kvs + (st ^ 1) * 2 * kTile;
      tc::stage<DP, kN>(kb, next, kv_row, k0 + kN, Sk, D, kLd, async);
      tc::stage<DP, kN>(vb, next + kTile, kv_row, k0 + kN, Sk, D, kLd,
                        async);
      async_copy::commit();
      async_copy::wait<1>();
    } else {
      async_copy::wait<0>();
    }
    __syncthreads();

    float s[kNT][4], dp[kNT][4];
    products<DP, kNT>(s, q_addr, smem_addr(ks + b_off(lane, kLd)), kLd);
    products<DP, kNT>(dp, do_addr, smem_addr(vs + b_off(lane, kLd)), kLd);
    const bool edge = k0 + kN > Sk || q0 + kRows > Sq
                      || (causal && k0 + kN - 1 > qa0)
                      || (window > 0 && q0 + kRows - 1 + q_offset - k0
                                            >= window);
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hr = e >> 1;
        float p = tc::ex2(__fmaf_rn(s[j][e], scale_log2, -mc[hr])) * il[hr];
        if (edge && !bwd::live(row_lo + 8 * hr, k0 + 8 * j + 2 * t + (e & 1),
                               Sq, Sk, causal, window, q_offset))
          p = 0.f;
        s[j][e] = p * (dp[j][e] - dl[hr]);  // dS
      }
    accumulate<DP, kNT>(acc, s, smem_addr(ks + bt_off(lane, kLd)), kLd);
    __syncthreads();  // this stage is refilled two tiles on
  }
  async_copy::wait<0>();  // no copy outlives the block
  store<DP>(dq + q_base, q_row, acc, row_lo, Sq, t, D, scale);
}

// One block per (b * Hk + KV head, 64-key tile), the first key tiles (the
// most live query tiles) first.  kGrads: 3 for dK and dV in one launch
// (DP <= 128), 1 for dV alone, 2 for dK alone (the two launches of a
// wider head).
template <int DP, int kGrads>
__global__ void __launch_bounds__(kThreads)
dkv_kernel(const __nv_bfloat16* __restrict__ q,
           const __nv_bfloat16* __restrict__ k,
           const __nv_bfloat16* __restrict__ v,
           const __nv_bfloat16* __restrict__ dout,
           const float* __restrict__ m, const float* __restrict__ l,
           const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
           __nv_bfloat16* __restrict__ dv, int Sq, int Sk, int H, int Hk,
           int D, int causal, int window, int q_offset, float scale,
           float scale_log2, int async) {
  constexpr bool kDV = kGrads & 1, kDK = kGrads & 2;
  constexpr int kN = tile_cols(DP);    // queries a tile
  constexpr int kNT = kN / 8;          // n-tiles of S^T and dP^T
  constexpr int kLd = DP + 8;
  constexpr int kTile = kN * kLd;      // one staged Q or dO tile
  extern __shared__ uint4 smem_raw[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* vs = ks + kRows * kLd;
  __nv_bfloat16* qds = vs + kRows * kLd;  // [2 stages][Q, dO][kN][kLd]
  // [2 stages][m log2(e), 1 / max(l, 1e-30), delta][kN]
  float* stats = reinterpret_cast<float*>(qds + 4 * kTile);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bk = blockIdx.x;
  const int bi = bk / Hk, kvh = bk - bi * Hk;
  const int rep = H / Hk;
  const int k0 = blockIdx.y * kRows;

  const long long q_row = (long long)H * D, kv_row = (long long)Hk * D;
  const long long kv_base = (long long)bi * Sk * kv_row + (long long)kvh * D;

  // Live query tiles of this key tile: [qt_begin, qt_end), for each of the
  // group's rep heads: iteration it is head it / nlive, tile it % nlive.
  const int k1 = min(k0 + kRows, Sk) - 1;
  const int nqt = (Sq + kN - 1) / kN;
  int qt_begin = 0, qt_end = nqt;
  if (causal) qt_begin = max(0, k0 - q_offset) / kN;
  if (window > 0) {
    const long long last = (long long)k1 + window - 1 - q_offset;
    qt_end = last < 0 ? 0 : (int)min((long long)nqt, last / kN + 1);
  }
  const int nlive = max(0, qt_end - qt_begin);
  const int n_iter = rep * nlive;
  auto head = [&](int it) { return kvh * rep + it / nlive; };
  auto first_row = [&](int it) { return (qt_begin + it % nlive) * kN; };
  auto stage_qdo = [&](int it, int st) {
    const long long q_base =
        (long long)bi * Sq * q_row + (long long)head(it) * D;
    __nv_bfloat16* dst = qds + st * 2 * kTile;
    tc::stage<DP, kN>(q + q_base, dst, q_row, first_row(it), Sq, D, kLd,
                      async);
    tc::stage<DP, kN>(dout + q_base, dst + kTile, q_row, first_row(it), Sq,
                      D, kLd, async);
  };
  // Row statistics of iteration it's tile (threads below kN, one row
  // each; rows past Sq read as m 0, l 1, delta 0).
  auto load_stats = [&](int it, float& rm, float& rl, float& rd) {
    const int row = first_row(it) + threadIdx.x;
    const long long at = ((long long)bi * H + head(it)) * Sq + row;
    const bool in = row < Sq;
    rm = in ? m[at] : 0.f;
    rl = in ? l[at] : 1.f;
    rd = kDK && in ? delta[at] : 0.f;
  };
  auto put_stats = [&](int st, float rm, float rl, float rd) {
    float* sm = stats + st * 3 * kN;
    sm[threadIdx.x] = rm * kLog2e;
    sm[kN + threadIdx.x] = 1.f / fmaxf(rl, 1e-30f);
    sm[2 * kN + threadIdx.x] = rd;
  };

  zero_tiles<DP>(smem_raw, async);
  tc::stage<DP>(k + kv_base, ks, kv_row, k0, Sk, D, kLd, async);
  if (kDK) tc::stage<DP>(v + kv_base, vs, kv_row, k0, Sk, D, kLd, async);
  if (n_iter > 0) {
    stage_qdo(0, 0);
    if (threadIdx.x < kN) {
      float rm, rl, rd;
      load_stats(0, rm, rl, rd);
      put_stats(0, rm, rl, rd);
    }
  }
  async_copy::commit();

  float adv[kDV ? DP / 8 : 1][4], adk[kDK ? DP / 8 : 1][4];
  if constexpr (kDV) zero<DP>(adv);
  if constexpr (kDK) zero<DP>(adk);
  const uint32_t k_addr = smem_addr(ks + warp * 16 * kLd + a_off(lane, kLd));
  const uint32_t v_addr = smem_addr(vs + warp * 16 * kLd + a_off(lane, kLd));
  const int key_lo = k0 + warp * 16 + g;
  for (int it = 0; it < n_iter; ++it) {
    const int st = it & 1;
    const int q0 = first_row(it);
    const bool more = it + 1 < n_iter;
    float rm = 0.f, rl = 1.f, rd = 0.f;
    if (more) {
      stage_qdo(it + 1, st ^ 1);
      async_copy::commit();
      if (threadIdx.x < kN) load_stats(it + 1, rm, rl, rd);
      async_copy::wait<1>();
    } else {
      async_copy::wait<0>();
    }
    __syncthreads();

    const __nv_bfloat16* qs = qds + st * 2 * kTile;
    const __nv_bfloat16* dos = qs + kTile;
    const float* sm = stats + st * 3 * kN;
    float s[kNT][4], dp[kDK ? kNT : 1][4];
    products<DP, kNT>(s, k_addr, smem_addr(qs + b_off(lane, kLd)), kLd);
    if constexpr (kDK)
      products<DP, kNT>(dp, v_addr, smem_addr(dos + b_off(lane, kLd)), kLd);
    const bool edge = q0 + kN > Sq || k0 + kRows > Sk
                      || (causal && q0 + q_offset < k0 + kRows - 1)
                      || (window > 0 && q0 + kN - 1 + q_offset - k0
                                            >= window);
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const int c = 8 * j + 2 * t;  // the thread's query columns c, c + 1
      const float2 mc = *reinterpret_cast<const float2*>(sm + c);
      const float2 il = *reinterpret_cast<const float2*>(sm + kN + c);
      const float2 dl = *reinterpret_cast<const float2*>(sm + 2 * kN + c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool odd = e & 1;
        float p = tc::ex2(__fmaf_rn(s[j][e], scale_log2,
                                    -(odd ? mc.y : mc.x)))
                  * (odd ? il.y : il.x);
        if (edge && !bwd::live(q0 + c + odd, key_lo + 8 * (e >> 1), Sq, Sk,
                               causal, window, q_offset))
          p = 0.f;
        if constexpr (kDK) dp[j][e] = p * (dp[j][e] - (odd ? dl.y : dl.x));
        s[j][e] = p;
      }
    }
    if constexpr (kDV)
      accumulate<DP, kNT>(adv, s, smem_addr(dos + bt_off(lane, kLd)), kLd);
    if constexpr (kDK)
      accumulate<DP, kNT>(adk, dp, smem_addr(qs + bt_off(lane, kLd)), kLd);
    if (more && threadIdx.x < kN) put_stats(st ^ 1, rm, rl, rd);
    __syncthreads();  // this stage is refilled two tiles on
  }
  async_copy::wait<0>();  // no copy outlives the block
  if constexpr (kDK) store<DP>(dk + kv_base, kv_row, adk, key_lo, Sk, t, D,
                               scale);
  if constexpr (kDV) store<DP>(dv + kv_base, kv_row, adv, key_lo, Sk, t, D,
                               1.f);
}

template <int DP>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* o, const void* dout, const float* m,
                   const float* l, float* delta, void* dq, void* dk, void* dv,
                   int B, int Sq, int Sk, int H, int Hk, int D, int causal,
                   int window, int q_offset, float scale,
                   cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  constexpr size_t dq_bytes = dq_smem(DP), dkv_bytes = dkv_smem(DP);
  const int async = D % 8 == 0 && (size_t)q % 16 == 0 && (size_t)k % 16 == 0
                    && (size_t)v % 16 == 0 && (size_t)o % 16 == 0
                    && (size_t)dout % 16 == 0;
  const float scale_log2 = scale * kLog2e;
  auto kq = dq_kernel<DP>;
  cudaError_t e = cudaFuncSetAttribute(
      kq, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dq_bytes);
  if (e != cudaSuccess) return e;
  kq<<<dim3(B * H, (Sq + kRows - 1) / kRows), kThreads, dq_bytes, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)o,
      (const bf16*)dout, m, l, delta, (bf16*)dq, Sq, Sk, H, Hk, D, causal,
      window, q_offset, scale, scale_log2, async);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  auto dkv = [&](auto kernel) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dkv_bytes);
    if (e != cudaSuccess) return e;
    kernel<<<dim3(B * Hk, (Sk + kRows - 1) / kRows), kThreads, dkv_bytes,
             stream>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
        m, l, delta, (bf16*)dk, (bf16*)dv, Sq, Sk, H, Hk, D, causal, window,
        q_offset, scale, scale_log2, async);
    return cudaGetLastError();
  };
  if constexpr (DP <= 128) {
    return dkv(dkv_kernel<DP, 3>);
  } else {  // dV, then dK
    e = dkv(dkv_kernel<DP, 1>);
    return e != cudaSuccess ? e : dkv(dkv_kernel<DP, 2>);
  }
}

cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const void* o, const void* dout, const float* m,
                     const float* l, float* delta, void* dq, void* dk,
                     void* dv, int B, int Sq, int Sk, int H, int Hk, int D,
                     int causal, int window, int q_offset, float scale,
                     cudaStream_t stream) {
  if ((Sq + kRows - 1) / kRows > 65535 || (Sk + kRows - 1) / kRows > 65535)
    return cudaErrorInvalidValue;
#define FLASH_BWD_CASE(DP)                                                   \
  if (D <= DP)                                                               \
    return launch<DP>(q, k, v, o, dout, m, l, delta, dq, dk, dv, B, Sq, Sk, \
                      H, Hk, D, causal, window, q_offset, scale, stream);
  FLASH_BWD_CASE(16)
  FLASH_BWD_CASE(32)
  FLASH_BWD_CASE(48)
  FLASH_BWD_CASE(64)
  FLASH_BWD_CASE(80)
  FLASH_BWD_CASE(96)
  FLASH_BWD_CASE(128)
  FLASH_BWD_CASE(160)
  FLASH_BWD_CASE(192)
  FLASH_BWD_CASE(256)
#undef FLASH_BWD_CASE
  return cudaErrorInvalidValue;  // D > 256
}

}  // namespace bwd_tc

}  // namespace

// dtype: 0 float32 (flash_fwd_kernel), 1 bfloat16 (tc::flash_bf16_kernel).
// m and l (float32 [B, H, Sq], or both null): each row's running max, in
// units of the scaled score, and its sum of exp(s - m), as the backward
// reads them.  Returns a cudaError_t (0 on success).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, void* m,
                                      void* l, int B, int Sq, int Sk, int H,
                                      int Hk, int D, int causal, int window,
                                      int q_offset, int dtype, float scale,
                                      void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || Hk < 1 || H % Hk != 0 || D < 1 || D > 256
      || B * H > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if ((m == nullptr) != (l == nullptr)) return (int)cudaErrorInvalidValue;
  float* mf = (float*)m;
  float* lf = (float*)l;
  if (dtype == 0)
    return (int)dispatch<float>(q, k, v, o, mf, lf, B, Sq, Sk, H, Hk, D,
                                causal, window, q_offset, scale, st);
  if (dtype == 1)
    return (int)tc::dispatch(q, k, v, o, mf, lf, B, Sq, Sk, H, Hk, D, causal,
                             window, q_offset, scale, st);
  return (int)cudaErrorInvalidValue;
}

// The rows with no live key, after flash_attention_launch on the same
// stream: rows [first, Sq) of every head take sum_j V[j] / slots (see
// dead_rows_kernel); slots >= Sk.  Does nothing when no row is dead.
// Returns a cudaError_t (0 on success).
extern "C" int flash_attention_dead_rows_launch(const void* v, void* o, int B,
                                                int Sq, int Sk, int H, int Hk,
                                                int D, int window,
                                                int q_offset, int slots,
                                                int dtype, void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || Hk < 1 || H % Hk != 0 || D < 1
      || slots < Sk || window < 0 || q_offset < 0)
    return (int)cudaErrorInvalidValue;
  const long long first = std::max(0LL, (long long)Sk + window - 1 - q_offset);
  if (window == 0 || first >= Sq) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  const int threads = 32 * ((std::min(D, 256) + 31) / 32);
  if (dtype == 0)
    dead_rows_kernel<float><<<B * Hk, threads, 0, st>>>(
        (const float*)v, (float*)o, Sq, Sk, H, Hk, D, (int)first, slots);
  else if (dtype == 1)
    dead_rows_kernel<__nv_bfloat16><<<B * Hk, threads, 0, st>>>(
        (const __nv_bfloat16*)v, (__nv_bfloat16*)o, Sq, Sk, H, Hk, D,
        (int)first, slots);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// The backward of flash_attention_launch's function: dq [B, Sq, H, D] and
// dk, dv [B, Sk, Hk, D] in the inputs' dtype (0 float32, 1 bfloat16) from
// q, k, v, the forward's o, its row statistics m and l (float32 [B, H, Sq])
// and dout.  ``delta`` is float32 scratch [B, H, Sq].  On ``stream``:
// float32 bwd::dq_kernel (which writes delta), then bwd::dkv_kernel; bf16
// bwd_tc::dq_kernel, then bwd_tc::dkv_kernel (twice, dV then dK, for heads
// wider than 128).
// Rows with no live key are not taken (the caller refuses them).  Returns a
// cudaError_t (0 on success).
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* m, const void* l, void* delta, void* dq,
    void* dk, void* dv, int B, int Sq, int Sk, int H, int Hk, int D,
    int causal, int window, int q_offset, int dtype, float scale,
    void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || Hk < 1 || H % Hk != 0 || D < 1 || D > 256
      || B * H > 65535 || window < 0 || q_offset < 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)bwd::dispatch(
        q, k, v, o, dout, (const float*)m, (const float*)l, (float*)delta, dq,
        dk, dv, B, Sq, Sk, H, Hk, D, causal, window, q_offset, scale, st);
  if (dtype == 1)
    return (int)bwd_tc::dispatch(
        q, k, v, o, dout, (const float*)m, (const float*)l, (float*)delta, dq,
        dk, dv, B, Sq, Sk, H, Hk, D, causal, window, q_offset, scale, st);
  return (int)cudaErrorInvalidValue;
}
