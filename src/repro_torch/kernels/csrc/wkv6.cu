// wkv6: the chunked RWKV-6 WKV recurrence, with its final state.
//
// Replaces the TPU kernel repro/kernels/rwkv6/kernel.py (wkv6_pallas /
// _wkv6_kernel); computes what repro/models/rwkv.py:wkv6_chunked computes,
// including the final state that rwkv6_timemix hands to the decode cache
// and the initial state s0.
//
//   r, k, v [B, S, H, K] float32 or bfloat16, lw [B, S, H, K] float32 log
//   decay (<= 0), u [H, K] float32, s0 [B, H, K, K] float32 or null (zeros)
//   ->  y [B, S, H, K], sf [B, H, K, K] float32 (k-major), all contiguous.
//   S is a multiple of the chunk L.  Per chunk, with cwe = cumsum(lw) - lw
//   (exclusive prefix per channel) and cwl = cwe_{L-1} + lw_{L-1}:
//     y_i = sum_{j<i} [sum_k r_ik k_jk exp(cwe_ik - (cwe_jk + lw_jk))] v_j
//           + (sum_k r_ik u_k k_ik) v_i + (r_i * exp(cwe_i)) . S
//     S  <- exp(cwl) * S + sum_j (exp(cwl - cwe_j - lw_j) * k_j) (x) v_j
//   The intra-chunk exponent is a difference of prefix sums, <= 0 where it
//   is used, and is exponentiated as such: factored into exp(cwe_i) *
//   exp(-cwe_j) it overflows, since lw = -exp(w0 + LoRA) depends on the
//   data.  So the intra-chunk term costs L (L - 1) / 2 * K exponentials.
//
// Bound on the H100 at the serving shape (rwkv6-7b prefill, B=2, S=6016
// after padding, H=64, K=64, L=64): 1.65 G exponentials per launch (almost
// all the intra-chunk pairs), at the 16 per clock per SM of the
// special-function units, 0.40 ms; 20.5 GFLOP on the fp32 FMA pipes, 0.31
// ms; 0.69 GB of inputs and output at 3.35 TB/s, 0.21 ms.  So the
// exponential rate bounds it.
//
// Design: one 256-thread block per (b, h) walks the chunks in order and
// keeps the [K, K] state in shared memory (the Pallas grid carries it
// across its sequential chunk axis); 128 blocks at the serving shape, one
// wave.  Per chunk: stage r, k, v (as float32) and lw; one thread per
// channel forms the prefix sums sequentially; the strictly lower attention
// matrix is built by pairing row i with row L-1-i in each thread group (the
// two rows hold L-1 pairs together, so every thread gets the same share of
// the triangle), each thread carrying 4 columns j of both rows over the
// channel loop with 16-byte loads; then r * exp(cwe) and the carry
// exp(cwl - cwe - lw) * k replace r and k in place, and y and the state
// update run as 4 x 4 register tiles on the FMA pipes (tile4x4.cuh).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tile4x4.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
            const T* __restrict__ v, const float* __restrict__ lw,
            const float* __restrict__ u, const float* __restrict__ s0,
            float* __restrict__ y, float* __restrict__ sf, int S, int H,
            int K, int L) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int lk = K + 4, la = L + 4;
  float* rs = sm;              // [L][lk]  r, then r * exp(cwe)
  float* ks = rs + L * lk;     // [L][lk]  k, then exp(cwl - cwe - lw) * k
  float* vs = ks + L * lk;     // [L][lk]  v
  float* lws = vs + L * lk;    // [L][lk]  lw
  float* cwe = lws + L * lk;   // [L][lk]  exclusive prefix of lw
  float* att = cwe + L * lk;   // [L][la]  strictly lower attention
  float* ss = att + L * la;    // [K][lk]  carried state
  float* bonus = ss + K * lk;  // [L]      sum_k r u k
  float* cwl = bonus + L;      // [K]      total log decay of the chunk
  float* us = cwl + K;         // [K]

  const int tid = threadIdx.x;
  const int bi = blockIdx.x / H, hi = blockIdx.x - bi * H;
  const long long bh = (long long)bi * H + hi;
  for (int idx = tid; idx < K * K; idx += kThreads) {
    const int kk = idx / K, vv = idx - kk * K;
    ss[kk * lk + vv] = s0 ? s0[bh * K * K + idx] : 0.f;
  }
  for (int kk = tid; kk < K; kk += kThreads) us[kk] = u[hi * K + kk];
  const long long row = (long long)H * K;  // elements between tokens
  const long long base = (long long)bi * S * row + (long long)hi * K;
  const int pairs = L / 2, q_n = kThreads / pairs;
  const int rp = tid / q_n, q = tid - rp * q_n;
  const bool att_thread = rp < pairs;
  const int i1 = rp, i2 = L - 1 - rp;
  const int lt = L / 4, kt = K / 4;

  for (int t0 = 0; t0 < S; t0 += L) {
    __syncthreads();  // the previous chunk's state update is done
    for (int idx = tid; idx < L * K; idx += kThreads) {
      const int i = idx / K, kk = idx - i * K;
      const long long g = base + (long long)(t0 + i) * row + kk;
      rs[i * lk + kk] = to_f32(r[g]);
      ks[i * lk + kk] = to_f32(k[g]);
      vs[i * lk + kk] = to_f32(v[g]);
      lws[i * lk + kk] = lw[g];
    }
    __syncthreads();
    for (int kk = tid; kk < K; kk += kThreads) {
      float run = 0.f;
      for (int i = 0; i < L; ++i) {
        const float w = lws[i * lk + kk];
        run += w;
        cwe[i * lk + kk] = run - w;
      }
      cwl[kk] = cwe[(L - 1) * lk + kk] + lws[(L - 1) * lk + kk];
    }
    for (int i = tid; i < L; i += kThreads) {
      float acc = 0.f;
      for (int kk = 0; kk < K; ++kk)
        acc = fmaf(rs[i * lk + kk] * us[kk], ks[i * lk + kk], acc);
      bonus[i] = acc;
    }
    __syncthreads();
    // att[i][j] = sum_k r_ik k_jk exp(cwe_ik - (cwe_jk + lw_jk)), j < i; 0
    // for j >= i.  Thread (rp, q) owns rows i1 = rp and i2 = L-1-rp at the
    // columns j = q + q_n * m, four of them per pass over the channels.
    if (att_thread) {
      for (int mb = 0; mb * q_n < L; mb += 4) {
        float a1[4] = {}, a2[4] = {};
        for (int kk = 0; kk < K; kk += 4) {
          const float4 r1 = tile4::ld4(rs + i1 * lk + kk);
          const float4 c1 = tile4::ld4(cwe + i1 * lk + kk);
          const float4 r2 = tile4::ld4(rs + i2 * lk + kk);
          const float4 c2 = tile4::ld4(cwe + i2 * lk + kk);
#pragma unroll
          for (int mm = 0; mm < 4; ++mm) {
            const int j = q + q_n * (mb + mm);
            if (j >= i2) continue;
            const float4 kj = tile4::ld4(ks + j * lk + kk);
            const float4 cj = tile4::ld4(cwe + j * lk + kk);
            const float4 lj = tile4::ld4(lws + j * lk + kk);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float d = tile4::at(cj, e) + tile4::at(lj, e);
              const float kv = tile4::at(kj, e);
              a2[mm] = fmaf(tile4::at(r2, e) * kv,
                            expf(tile4::at(c2, e) - d), a2[mm]);
              if (j < i1)
                a1[mm] = fmaf(tile4::at(r1, e) * kv,
                              expf(tile4::at(c1, e) - d), a1[mm]);
            }
          }
        }
#pragma unroll
        for (int mm = 0; mm < 4; ++mm) {
          const int j = q + q_n * (mb + mm);
          if (j >= L) continue;
          att[i1 * la + j] = j < i1 ? a1[mm] : 0.f;
          att[i2 * la + j] = j < i2 ? a2[mm] : 0.f;
        }
      }
    }
    __syncthreads();
    for (int idx = tid; idx < L * K; idx += kThreads) {
      const int i = idx / K, kk = idx - i * K;
      const float e = cwe[i * lk + kk];
      rs[i * lk + kk] *= expf(e);
      ks[i * lk + kk] = expf(cwl[kk] - e - lws[i * lk + kk]) * ks[i * lk + kk];
    }
    __syncthreads();
    for (int t = tid; t < lt * kt; t += kThreads) {
      const int i0 = 4 * (t / kt), v0 = 4 * (t - (t / kt) * kt);
      float intra[4][4] = {}, inter[4][4] = {};
      tile4::nn(intra, att, la, vs, lk, i0, v0, i0 + 4);
      tile4::nn(inter, rs, lk, ss, lk, i0, v0, K);
#pragma unroll
      for (int rr = 0; rr < 4; ++rr) {
        const int i = i0 + rr;
        const float b = bonus[i];
        const float4 vi = tile4::ld4(vs + i * lk + v0);
        tile4::st4(y + base + (long long)(t0 + i) * row + v0,
                   make_float4(intra[rr][0] + b * vi.x + inter[rr][0],
                               intra[rr][1] + b * vi.y + inter[rr][1],
                               intra[rr][2] + b * vi.z + inter[rr][2],
                               intra[rr][3] + b * vi.w + inter[rr][3]));
      }
    }
    __syncthreads();  // every y tile has read the old state
    for (int t = tid; t < kt * kt; t += kThreads) {
      const int k0 = 4 * (t / kt), v0 = 4 * (t - (t / kt) * kt);
      float acc[4][4] = {};
      tile4::tn_scaled(acc, ks, lk, nullptr, vs, lk, k0, v0, L);
#pragma unroll
      for (int rr = 0; rr < 4; ++rr) {
        const float wdec = expf(cwl[k0 + rr]);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float* sp = ss + (k0 + rr) * lk + v0 + c;
          *sp = *sp * wdec + acc[rr][c];
        }
      }
    }
  }
  __syncthreads();
  for (int idx = tid; idx < K * K; idx += kThreads) {
    const int kk = idx / K, vv = idx - kk * K;
    sf[bh * K * K + idx] = ss[kk * lk + vv];
  }
}

template <typename T>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const void* lw, const void* u, const void* s0, void* y,
                   void* sf, int B, int S, int H, int K, int L,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) * (5 * (size_t)L * (K + 4)
                                       + (size_t)L * (L + 4)
                                       + (size_t)K * (K + 4) + L + 2 * K);
  auto kernel = wkv6_kernel<T>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kernel<<<B * H, kThreads, smem, stream>>>(
      (const T*)r, (const T*)k, (const T*)v, (const float*)lw,
      (const float*)u, (const float*)s0, (float*)y, (float*)sf, S, H, K, L);
  return cudaGetLastError();
}

}  // namespace

// dtype (of r, k, v): 0 float32, 1 bfloat16.  Returns a cudaError_t (0 on
// success).
extern "C" int wkv6_launch(const void* r, const void* k, const void* v,
                           const void* lw, const void* u, const void* s0,
                           void* y, void* sf, int B, int S, int H, int K,
                           int L, int dtype, void* stream) {
  if (B < 1 || S < 1 || H < 1 || K < 4 || L < 4 || K % 4 || L % 4
      || L > 2 * kThreads || S % L || (long long)B * H > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)launch<float>(r, k, v, lw, u, s0, y, sf, B, S, H, K, L, st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(r, k, v, lw, u, s0, y, sf, B, S, H, K,
                                      L, st);
  return (int)cudaErrorInvalidValue;
}
