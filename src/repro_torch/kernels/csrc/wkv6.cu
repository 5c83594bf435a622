// wkv6: the chunked RWKV-6 WKV recurrence, with its final state, as three
// chunk-parallel passes.
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
// after padding, H=64, K=64, L=64): 1.65 G exponentials per call (almost
// all the intra-chunk pairs), at the 16 per clock per SM of the
// special-function units, 0.40 ms; 20.5 GFLOP on the fp32 FMA pipes, 0.31
// ms; 0.69 GB of inputs and output at 3.35 TB/s, 0.21 ms.  So the
// exponential rate bounds the function.  This design moves more: k, v and
// lw are read by two passes and the states scratch is written, read and
// rewritten, ~1.9 GB in all, an HBM floor of ~0.56 ms.
//
// Design: three launches, parallel over chunks, with the only sequential
// dependence (the state carried from chunk to chunk) in a pass that is
// elementwise and bound by memory.
//   chunk_state  one 256-thread block per (b, chunk, group of heads): per
//                head, k, v and lw staged by cp.async; the exclusive prefix
//                cwe of each channel in XLA CPU's order (one thread per
//                channel) and
//                cwl, written to a [B, nc, H, K] scratch; then the chunk's
//                own state d_c[k][v] = sum_j exp(cwl_k - cwe_jk - lw_jk)
//                k_jk v_jv into a [B, nc, H, K, K] scratch (k-major; 197 MB
//                at the serving shape).
//   state_pass   one thread per (b, h, 4 state elements), sequential over
//                the chunks, its loads issued 8 chunks ahead: writes the
//                state entering each chunk over d_c and carries
//                S <- exp(cwl) S + d_c, from s0 or zeros; the last S is sf.
//   chunk_scan   one 256-thread block per (b, chunk, group of heads), two
//                blocks per SM: per head the prefix sums again (the same
//                code, so the same bits as chunk_state's), the strictly
//                lower matrix att and the bonus, then y = att v + bonus v +
//                (r exp(cwe)) S_in.  The triangle is split so all 256
//                threads share its exponentials evenly and the lanes of a
//                warp never diverge: each off-diagonal 4 x 4 tile goes to
//                two neighbouring lanes, one per half of the channel quads
//                (interleaved, so the two read adjacent 16-byte pieces),
//                summed by a shuffle; each diagonal tile (6 live pairs and
//                the bonus of its rows) to 16 lanes, one channel quad each,
//                summed by shuffles.  The next
//                head's r, k and lw are copied by cp.async while the
//                current head's y is computed, and the current head's v and
//                S_in while its prefix sums and triangle are.
// The group of heads per block is chosen in the launcher so each pass's
// blocks fill whole waves of the card's SMs.  Every exponential is
// ex2.approx.ftz of (the float32 difference the plain version takes) *
// log2(e): one FMUL and one MUFU op; the prefix sums are not prescaled by
// log2(e), which would round values up to |cwe| ~ 1300 under strong decay
// once more.  Every product runs on the fp32 FMA pipes (4 x 4 register
// tiles); TF32 tensor cores would leave the tolerance the plain version is
// held to.  r, k and v stay in their own type in shared memory (rows padded
// by 16 bytes) and are widened to float32 as they are read.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "async_copy.cuh"
#include "ordered_prefix.cuh"
#include "tile4x4.cuh"

namespace {

constexpr int kThreads = 256;  // chunk_state and chunk_scan blocks
constexpr int kPassThreads = 256;
constexpr int kPassAhead = 8;  // chunks whose loads state_pass keeps in flight
constexpr int kScanBlocksPerSm = 2;
constexpr float kLog2e = 1.4426950408889634f;

// exp(x) as 2^(x log2(e)): one FMUL and one ex2.approx.ftz (results below
// 2^-126 flush to 0).
__device__ __forceinline__ float exp_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x * kLog2e));
  return y;
}

// Elements of T per 16-byte copy; staged rows of T are padded by 16 bytes.
template <typename T>
__host__ __device__ constexpr int per16() { return 16 / (int)sizeof(T); }

// Four consecutive staged elements as float32 (the address 4-element
// aligned).
__device__ __forceinline__ float4 ld4(const float* p) { return tile4::ld4(p); }
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(w.x << 16),
                     __uint_as_float(w.x & 0xffff0000u),
                     __uint_as_float(w.y << 16),
                     __uint_as_float(w.y & 0xffff0000u));
}

// rows [0, n) of ``cols`` elements from ``src`` (row stride ``stride``) to
// shared rows of ``ld`` elements, by 16-byte cp.async copies.
template <typename T>
__device__ __forceinline__ void stage(T* dst, int ld, const T* src,
                                      long long stride, int n, int cols) {
  constexpr int per = per16<T>();
  const int pieces = cols / per;
  for (int idx = threadIdx.x; idx < n * pieces; idx += blockDim.x) {
    const int i = idx / pieces, c = per * (idx - i * pieces);
    async_copy::copy16(dst + i * ld + c, src + i * stride + c);
  }
}

// Channel kk's exclusive prefix cwe_i = (lw_0 + ... + lw_i) - lw_i, the
// sum taken in XLA CPU's order (ordered_prefix.cuh, as the plain version
// and the reference take it), into cs; with ``ds`` (may alias lws) also
// d_i = cwe_i + lw_i.  Returns the chunk's total cwl = cwe_{L-1} +
// lw_{L-1}.  Four loads are issued ahead of their sums (L is a multiple of
// 4).
__device__ __forceinline__ float prefix(const float* lws, float* cs, float* ds,
                                        int ld, int L, int kk) {
  ordered::Prefix run;
  float c = 0.f, w = 0.f;
  for (int i0 = 0; i0 < L; i0 += 4) {
    float w4[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) w4[q] = lws[(i0 + q) * ld + kk];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      w = w4[q];
      c = run.add(w) - w;
      cs[(i0 + q) * ld + kk] = c;
      if (ds) ds[(i0 + q) * ld + kk] = c + w;
    }
  }
  return c + w;
}

// Chunk (b, c) of block blockIdx.x and heads [h_lo, h_hi) of blockIdx.y.
struct Block {
  int bi, ci, h_lo, h_hi;
  __device__ Block(int nc, int H, int hpb)
      : bi(blockIdx.x / nc), ci(blockIdx.x - (blockIdx.x / nc) * nc),
        h_lo(blockIdx.y * hpb), h_hi(min(H, (int)(blockIdx.y + 1) * hpb)) {}
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
chunk_state_kernel(const T* __restrict__ k, const T* __restrict__ v,
                   const float* __restrict__ lw, float* __restrict__ cwl,
                   float* __restrict__ st, int S, int H, int K, int L,
                   int hpb) {
  extern __shared__ float4 smem4[];
  const int lt = K + per16<T>(), lk = K + 4, kq = K / 4;
  T* ks = reinterpret_cast<T*>(smem4);                  // [L][lt]  k
  T* vs = ks + L * lt;                                   // [L][lt]  v
  float* lws = reinterpret_cast<float*>(vs + L * lt);   // [L][lk]  lw
  float* cs = lws + L * lk;  // [L][lk]  cwe, then exp(cwl - cwe - lw) * k
  float* tot = cs + L * lk;  // [K]      cwl

  const int tid = threadIdx.x, nc = S / L;
  const Block blk(nc, H, hpb);
  const long long row = (long long)H * K;  // elements between tokens
  for (int h = blk.h_lo; h < blk.h_hi; ++h) {
    const long long g = ((long long)blk.bi * S + (long long)blk.ci * L) * row
                        + (long long)h * K;
    stage(ks, lt, k + g, row, L, K);
    stage(vs, lt, v + g, row, L, K);
    stage(lws, lk, lw + g, row, L, K);
    async_copy::commit();
    async_copy::wait<0>();
    __syncthreads();
    const long long unit = ((long long)blk.bi * nc + blk.ci) * H + h;
    for (int kk = tid; kk < K; kk += kThreads) {
      tot[kk] = prefix(lws, cs, nullptr, lk, L, kk);
      cwl[unit * K + kk] = tot[kk];
    }
    __syncthreads();
    for (int idx = tid; idx < L * kq; idx += kThreads) {  // a quad each
      const int j = idx / kq, c0 = 4 * (idx - j * kq);
      const float4 t = tile4::ld4(tot + c0), c = tile4::ld4(cs + j * lk + c0);
      const float4 w = tile4::ld4(lws + j * lk + c0);
      const float4 kv = ld4(ks + j * lt + c0);
      tile4::st4(cs + j * lk + c0,
                 make_float4(exp_fast(t.x - c.x - w.x) * kv.x,
                             exp_fast(t.y - c.y - w.y) * kv.y,
                             exp_fast(t.z - c.z - w.z) * kv.z,
                             exp_fast(t.w - c.w - w.w) * kv.w));
    }
    __syncthreads();
    // d_c[k0 + r][v0 + c] = sum_j carry[j][k0 + r] v[j][v0 + c], j ascending.
    float* out = st + unit * K * K;
    for (int t = tid; t < kq * kq; t += kThreads) {
      const int k0 = 4 * (t / kq), v0 = 4 * (t - (t / kq) * kq);
      float acc[4][4] = {};
      for (int j = 0; j < L; ++j) {
        const float4 a = tile4::ld4(cs + j * lk + k0);
        const float4 b = ld4(vs + j * lt + v0);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float ar = tile4::at(a, r);
          acc[r][0] = fmaf(ar, b.x, acc[r][0]);
          acc[r][1] = fmaf(ar, b.y, acc[r][1]);
          acc[r][2] = fmaf(ar, b.z, acc[r][2]);
          acc[r][3] = fmaf(ar, b.w, acc[r][3]);
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
        tile4::st4(out + (k0 + r) * K + v0,
                   make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]));
    }
    __syncthreads();  // the next head refills every buffer
  }
}

// Thread (b, h, e): elements e..e+3 of the k-major [K][K] state.
__global__ void __launch_bounds__(kPassThreads)
state_pass_kernel(const float* __restrict__ cwl, float* __restrict__ st,
                  const float* __restrict__ s0, float* __restrict__ sf, int B,
                  int nc, int H, int K) {
  const long long idx = (long long)blockIdx.x * kPassThreads + threadIdx.x;
  const int KK = K * K, kk4 = KK / 4;
  if (idx >= (long long)B * H * kk4) return;
  const long long bh = idx / kk4;
  const int e = 4 * (int)(idx - bh * kk4), kr = e / K;
  const int bi = (int)(bh / H), h = (int)(bh - (long long)bi * H);
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  if (s0) s = tile4::ld4(s0 + bh * KK + e);
  float* base = st + ((long long)bi * nc * H + h) * KK + e;
  const float* wb = cwl + ((long long)bi * nc * H + h) * K + kr;
  const long long step = (long long)H * KK;  // one chunk on
  for (int c0 = 0; c0 < nc; c0 += kPassAhead) {
    float4 own[kPassAhead];
    float tot[kPassAhead];
#pragma unroll
    for (int q = 0; q < kPassAhead; ++q)
      if (c0 + q < nc) {
        own[q] = tile4::ld4(base + (c0 + q) * step);
        tot[q] = wb[(long long)(c0 + q) * H * K];
      }
#pragma unroll
    for (int q = 0; q < kPassAhead; ++q)
      if (c0 + q < nc) {
        tile4::st4(base + (c0 + q) * step, s);  // the state entering chunk
        const float w = exp_fast(tot[q]);
        s = make_float4(s.x * w + own[q].x, s.y * w + own[q].y,
                        s.z * w + own[q].z, s.w * w + own[q].w);
      }
  }
  tile4::st4(sf + bh * KK + e, s);
}

// Lanes of a warp per diagonal tile of the triangle: the channel quads K / 4
// rounded up to a power of two (K <= 128).
__host__ __device__ inline int diag_lanes(int K) {
  int w = 1;
  while (w < K / 4) w *= 2;
  return w;
}

// att[i][j] = sum_k r_ik k_jk exp(cwe_ik - d_jk) (d = cwe + lw) for j < i
// in the lower 4 x 4 tiles, 0 at and above the diagonal of the diagonal
// tiles, and bonus[i] = sum_k r_ik u_k k_ik.  Every thread takes the same
// share of the exponentials, and the lanes of a warp take the same branch:
//   off-diagonal tiles: tasks 2t and 2t + 1 are the two channel halves of
//     tile t (quads q = 2m and 2m + 1, so the two read adjacent 16-byte
//     pieces), on neighbouring lanes, summed by a shuffle;
//   diagonal tiles: each of the nt tiles (6 live pairs and the bonus of its
//     4 rows) is split by channel quad over an aligned group of
//     diag_lanes(K) lanes, summed by shuffles.
// At the serving shape (L = K = 64) that is 240 half tiles (512
// exponentials each) and 256 quads of diagonal tiles (24 each): one round
// of each for 256 threads.  Every thread runs the same rounds, so each
// shuffle finds the whole warp.
template <typename T>
__device__ __forceinline__ void triangle(const T* rs, const T* ks,
                                         const float* cs, const float* ds,
                                         const float* uh, float* att,
                                         float* bonus, int lt, int lk, int la,
                                         int L, int K) {
  const int nt = L / 4, kq = K / 4, n_off = nt * (nt - 1) / 2;
  for (int base = 0; base < 2 * n_off; base += kThreads) {
    const int task = base + threadIdx.x;
    const bool live = task < 2 * n_off;
    int i0 = 0, j0 = 0;
    float acc[4][4] = {};
    if (live) {
      tile4::lower_tile(task >> 1, i0, j0);  // strictly lower: (i0 + 1, j0)
      i0 = 4 * (i0 + 1);
      j0 *= 4;
      for (int q = task & 1; q < kq; q += 2) {
        const int c0 = 4 * q;
        float4 ri[4], ci[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          ri[r] = ld4(rs + (i0 + r) * lt + c0);
          ci[r] = tile4::ld4(cs + (i0 + r) * lk + c0);
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float4 kj = ld4(ks + (j0 + c) * lt + c0);
          const float4 dj = tile4::ld4(ds + (j0 + c) * lk + c0);
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[r][c] = fmaf(tile4::at(ri[r], e) * tile4::at(kj, e),
                               exp_fast(tile4::at(ci[r], e)
                                        - tile4::at(dj, e)),
                               acc[r][c]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        acc[r][c] += __shfl_xor_sync(0xffffffffu, acc[r][c], 1);
    // Each half stores two of the tile's rows.
#pragma unroll
    for (int r = 0; r < 4; ++r)
      if (live && (task & 1) == r / 2)
        tile4::st4(att + (i0 + r) * la + j0,
                   make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]));
  }
  const int w = diag_lanes(K);
  for (int base = 0; base < nt * w; base += kThreads) {
    const int unit = base + threadIdx.x, q = unit & (w - 1);
    const int i0 = 4 * (unit / w), c0 = 4 * q;
    float acc[6] = {}, b[4] = {};  // pairs (1,0) (2,0) (2,1) (3,0) (3,1) (3,2)
    if (i0 < L && q < kq) {
      float4 ri[4], kj[4], ci[4], dj[3];
      const float4 uq = tile4::ld4(uh + c0);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        ri[r] = ld4(rs + (i0 + r) * lt + c0);
        kj[r] = ld4(ks + (i0 + r) * lt + c0);
      }
#pragma unroll
      for (int r = 1; r < 4; ++r) ci[r] = tile4::ld4(cs + (i0 + r) * lk + c0);
#pragma unroll
      for (int c = 0; c < 3; ++c) dj[c] = tile4::ld4(ds + (i0 + c) * lk + c0);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
#pragma unroll
        for (int r = 0; r < 4; ++r)
          b[r] = fmaf(tile4::at(ri[r], e) * tile4::at(uq, e),
                      tile4::at(kj[r], e), b[r]);
        int n = 0;
#pragma unroll
        for (int r = 1; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < r; ++c, ++n)
            acc[n] = fmaf(tile4::at(ri[r], e) * tile4::at(kj[c], e),
                          exp_fast(tile4::at(ci[r], e) - tile4::at(dj[c], e)),
                          acc[n]);
      }
    }
    for (int off = w / 2; off > 0; off /= 2) {
#pragma unroll
      for (int n = 0; n < 6; ++n)
        acc[n] += __shfl_xor_sync(0xffffffffu, acc[n], off);
#pragma unroll
      for (int r = 0; r < 4; ++r)
        b[r] += __shfl_xor_sync(0xffffffffu, b[r], off);
    }
    if (q == 0 && i0 < L) {
      float* a = att + i0 * la + i0;
      tile4::st4(a, make_float4(0.f, 0.f, 0.f, 0.f));
      tile4::st4(a + la, make_float4(acc[0], 0.f, 0.f, 0.f));
      tile4::st4(a + 2 * la, make_float4(acc[1], acc[2], 0.f, 0.f));
      tile4::st4(a + 3 * la, make_float4(acc[3], acc[4], acc[5], 0.f));
      tile4::st4(bonus + i0, make_float4(b[0], b[1], b[2], b[3]));
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kScanBlocksPerSm)
chunk_scan_kernel(const T* __restrict__ r, const T* __restrict__ k,
                  const T* __restrict__ v, const float* __restrict__ lw,
                  const float* __restrict__ u, const float* __restrict__ s_in,
                  float* __restrict__ y, int S, int H, int K, int L, int hpb) {
  extern __shared__ float4 smem4[];
  const int lt = K + per16<T>(), lk = K + 4, la = L + 4, kq = K / 4;
  T* rs = reinterpret_cast<T*>(smem4);                 // [L][lt]  r
  T* ks = rs + L * lt;                                  // [L][lt]  k
  T* vs = ks + L * lt;                                  // [L][lt]  v
  float* ds = reinterpret_cast<float*>(vs + L * lt);   // [L][lk]  lw, then
                                                        //          cwe + lw
  float* cs = ds + L * lk;     // [L][lk]  cwe, then r * exp(cwe)
  float* ss = cs + L * lk;     // [K][lk]  the state entering the chunk
  float* att = ss + K * lk;    // [L][la]  strictly lower attention
  float* bonus = att + L * la; // [L]      sum_k r u k

  const int tid = threadIdx.x, nc = S / L;
  const Block blk(nc, H, hpb);
  const long long row = (long long)H * K;
  const long long g0 = ((long long)blk.bi * S + (long long)blk.ci * L) * row;
  const long long unit0 = ((long long)blk.bi * nc + blk.ci) * H;
  auto stage_rkl = [&](int h) {
    stage(rs, lt, r + g0 + (long long)h * K, row, L, K);
    stage(ks, lt, k + g0 + (long long)h * K, row, L, K);
    stage(ds, lk, lw + g0 + (long long)h * K, row, L, K);
    async_copy::commit();
  };

  stage_rkl(blk.h_lo);
  for (int h = blk.h_lo; h < blk.h_hi; ++h) {
    async_copy::wait<0>();
    __syncthreads();  // r, k, lw are in; the previous head's y is done
    stage(vs, lt, v + g0 + (long long)h * K, row, L, K);
    stage(ss, lk, s_in + (unit0 + h) * K * K, K, K, K);
    async_copy::commit();
    for (int kk = tid; kk < K; kk += kThreads)
      prefix(ds, cs, ds, lk, L, kk);
    __syncthreads();
    triangle(rs, ks, cs, ds, u + h * K, att, bonus, lt, lk, la, L, K);
    __syncthreads();  // cwe is read for the last time below
    for (int idx = tid; idx < L * kq; idx += kThreads) {  // a quad each
      const int i = idx / kq, c0 = 4 * (idx - i * kq);
      const float4 rv = ld4(rs + i * lt + c0), c = tile4::ld4(cs + i * lk + c0);
      tile4::st4(cs + i * lk + c0,
                 make_float4(rv.x * exp_fast(c.x), rv.y * exp_fast(c.y),
                             rv.z * exp_fast(c.z), rv.w * exp_fast(c.w)));
    }
    __syncthreads();  // r, k and d are no longer read
    if (h + 1 < blk.h_hi) {
      stage_rkl(h + 1);
      async_copy::wait<1>();
    } else {
      async_copy::wait<0>();
    }
    __syncthreads();  // v and S_in are in
    float* yb = y + g0 + (long long)h * K;
    for (int t = tid; t < (L / 4) * kq; t += kThreads) {
      const int i0 = 4 * (t / kq), v0 = 4 * (t - (t / kq) * kq);
      float intra[4][4] = {}, inter[4][4] = {};
      // intra[r][c] = sum_{j < i0 + 4} att[i0 + r][j] v[j][v0 + c], ascending.
      for (int j = 0; j < i0 + 4; j += 4) {
        float4 a[4], b[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          a[q] = tile4::ld4(att + (i0 + q) * la + j);
          b[q] = ld4(vs + (j + q) * lt + v0);
        }
#pragma unroll
        for (int rr = 0; rr < 4; ++rr)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float aq = tile4::at(a[rr], q);
            intra[rr][0] = fmaf(aq, b[q].x, intra[rr][0]);
            intra[rr][1] = fmaf(aq, b[q].y, intra[rr][1]);
            intra[rr][2] = fmaf(aq, b[q].z, intra[rr][2]);
            intra[rr][3] = fmaf(aq, b[q].w, intra[rr][3]);
          }
      }
      tile4::nn(inter, cs, lk, ss, lk, i0, v0, K);
#pragma unroll
      for (int rr = 0; rr < 4; ++rr) {
        const int i = i0 + rr;
        const float b = bonus[i];
        const float4 vi = ld4(vs + i * lt + v0);
        tile4::st4(yb + (long long)i * row + v0,
                   make_float4(intra[rr][0] + b * vi.x + inter[rr][0],
                               intra[rr][1] + b * vi.y + inter[rr][1],
                               intra[rr][2] + b * vi.z + inter[rr][2],
                               intra[rr][3] + b * vi.w + inter[rr][3]));
      }
    }
  }
}

template <typename T>
size_t state_smem(int K, int L) {
  return sizeof(T) * 2 * (size_t)L * (K + per16<T>())
         + sizeof(float) * (2 * (size_t)L * (K + 4) + K);
}

template <typename T>
size_t scan_smem(int K, int L) {
  return sizeof(T) * 3 * (size_t)L * (K + per16<T>())
         + sizeof(float) * (2 * (size_t)L * (K + 4) + (size_t)K * (K + 4)
                            + (size_t)L * (L + 4) + L);
}

// Heads per block for a pass whose blocks sit ``per_sm`` to an SM: the
// group (1 to 16 heads) whose blocks fill the card's waves best, a block's
// own set-up counted as ``setup`` heads' worth of work.
int heads_per_block(int B, int nc, int H, int per_sm, double setup) {
  int sms = 132, dev = 0;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  int best = 1;
  double best_cost = 0;
  for (int g = 1; g <= 16 && g <= H; ++g) {
    const long long blocks = (long long)B * nc * ((H + g - 1) / g);
    const long long slots = (long long)sms * per_sm;
    const double cost = (double)((blocks + slots - 1) / slots) * (g + setup);
    if (g == 1 || cost < best_cost) {
      best = g;
      best_cost = cost;
    }
  }
  return best;
}

// Sets the kernel's dynamic shared memory and returns its blocks per SM.
template <typename F>
cudaError_t prepare(F kernel, size_t smem, int* per_sm) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel,
                                                      kThreads, smem);
  if (e == cudaSuccess && *per_sm < 1) e = cudaErrorInvalidConfiguration;
  return e;
}

template <typename T>
cudaError_t chunk_state(const void* k, const void* v, const void* lw,
                        void* cwl, void* st, int B, int S, int H, int K,
                        int L, cudaStream_t stream) {
  auto kernel = chunk_state_kernel<T>;
  const size_t smem = state_smem<T>(K, L);
  int per_sm = 0;
  cudaError_t e = prepare(kernel, smem, &per_sm);
  if (e != cudaSuccess) return e;
  const int hpb = heads_per_block(B, S / L, H, per_sm, 0.0);
  kernel<<<dim3(B * (S / L), (H + hpb - 1) / hpb), kThreads, smem, stream>>>(
      (const T*)k, (const T*)v, (const float*)lw, (float*)cwl, (float*)st, S,
      H, K, L, hpb);
  return cudaGetLastError();
}

template <typename T>
cudaError_t chunk_scan(const void* r, const void* k, const void* v,
                       const void* lw, const void* u, const void* s_in,
                       void* y, int B, int S, int H, int K, int L,
                       cudaStream_t stream) {
  auto kernel = chunk_scan_kernel<T>;
  const size_t smem = scan_smem<T>(K, L);
  int per_sm = 0;
  cudaError_t e = prepare(kernel, smem, &per_sm);
  if (e != cudaSuccess) return e;
  // The first head's r, k and lw are not overlapped: a quarter head.
  const int hpb = heads_per_block(B, S / L, H, per_sm, 0.25);
  kernel<<<dim3(B * (S / L), (H + hpb - 1) / hpb), kThreads, smem, stream>>>(
      (const T*)r, (const T*)k, (const T*)v, (const float*)lw,
      (const float*)u, (const float*)s_in, (float*)y, S, H, K, L, hpb);
  return cudaGetLastError();
}

// K a multiple of 8 (bfloat16) or 4 (float32) so rows copy in 16-byte
// pieces, and at most 128 (a warp's lanes per diagonal tile of the
// triangle); the caller passes 16-byte aligned pointers.
bool shape_ok(int B, int S, int H, int K, int L, int dtype) {
  return B >= 1 && S >= 1 && H >= 1 && K >= 4 && K <= 128 && L >= 4
         && L % 4 == 0 && K % (dtype == 1 ? 8 : 4) == 0 && S % L == 0
         && (long long)B * (S / L) <= 2147483647LL && H <= 65535 * 16;
}

}  // namespace

// The three passes; the wrapper (kernels/rwkv6/ops.py) runs them in order
// with the scratch cwl [B, S/L, H, K] and st [B, S/L, H, K, K] (float32).
// dtype (of r, k and v): 0 float32, 1 bfloat16.  Every tensor is contiguous
// and 16-byte aligned.  Each returns a cudaError_t (0 on success).

// cwl <- each chunk's total log decay; st <- each chunk's own state.
extern "C" int wkv6_chunk_state_launch(const void* k, const void* v,
                                       const void* lw, void* cwl, void* st,
                                       int B, int S, int H, int K, int L,
                                       int dtype, void* stream) {
  if (!shape_ok(B, S, H, K, L, dtype)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st_ = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)chunk_state<float>(k, v, lw, cwl, st, B, S, H, K, L, st_);
  if (dtype == 1)
    return (int)chunk_state<__nv_bfloat16>(k, v, lw, cwl, st, B, S, H, K, L,
                                           st_);
  return (int)cudaErrorInvalidValue;
}

// st <- the state entering each chunk (in place), sf <- the final state
// ([B, H, K, K]); s0 ([B, H, K, K]) null means zeros.
extern "C" int wkv6_state_pass_launch(const void* cwl, void* st,
                                      const void* s0, void* sf, int B, int nc,
                                      int H, int K, void* stream) {
  if (B < 1 || nc < 1 || H < 1 || K < 4 || K % 4)
    return (int)cudaErrorInvalidValue;
  const long long threads = (long long)B * H * (K * K / 4);
  state_pass_kernel<<<(unsigned)((threads + kPassThreads - 1) / kPassThreads),
                      kPassThreads, 0, (cudaStream_t)stream>>>(
      (const float*)cwl, (float*)st, (const float*)s0, (float*)sf, B, nc, H,
      K);
  return (int)cudaGetLastError();
}

// y <- the intra-chunk term, the bonus and the inter-chunk term from the
// state entering each chunk (s_in, as state_pass leaves st).
extern "C" int wkv6_chunk_scan_launch(const void* r, const void* k,
                                      const void* v, const void* lw,
                                      const void* u, const void* s_in, void* y,
                                      int B, int S, int H, int K, int L,
                                      int dtype, void* stream) {
  if (!shape_ok(B, S, H, K, L, dtype)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st_ = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)chunk_scan<float>(r, k, v, lw, u, s_in, y, B, S, H, K, L, st_);
  if (dtype == 1)
    return (int)chunk_scan<__nv_bfloat16>(r, k, v, lw, u, s_in, y, B, S, H, K,
                                          L, st_);
  return (int)cudaErrorInvalidValue;
}
