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
//
// The backward replaces no Pallas kernel: the reference takes jax.grad
// through wkv6_chunked's scan (repro/models/rwkv.py:64-106).  From dy [B, S,
// H, K] float32, the final state's gradient dsf (or zeros) and the forward's
// scratch (cwl, the state entering each chunk S) and final state, with dS'
// the gradient of the state leaving a chunk and S' that state:
//   chunk_dstate    q_c = sum_i (r_i exp(cwe_i)) (x) dy_i, one block per
//                   (b, chunk, group of heads), as chunk_state is laid out.
//   state_pass_bwd  from the last chunk back: writes dS' over q_c and
//                   carries dS <- exp(cwl) dS' + q_c from dsf; the last dS
//                   is ds0.  The mirror of state_pass.
//   chunk_bwd       one 256-thread block per (b, chunk, group of heads), one
//                   block an SM: per head the prefix sums again (prefix(),
//                   the forward's bits), D_ij = dy_i . v_j, then per (row
//                   tile, channel quad) P = sum_{j<i} D_ij k_j G_ij +
//                   exp(cwe_i) (S dy_i) and Q = sum_{i>j} D_ij r_i G_ij +
//                   exp(cwl - cwe_j - lw_j) (dS' v_j), giving dr = P + u k
//                   D_ii, dk = Q + u r D_jj and dlw = <dS', S'> - k Q +
//                   (sum over later rows of r P - k Q); then the forward's
//                   attention (triangle()) for dv = A^T dy + beta dy +
//                   (exp(cwl - cwe - lw) k) dS'; du's partial per chunk.
//   sum_du          du = the partials summed over (b, chunk) in order.
// Every sum is taken by one thread in a fixed order: two runs give the same
// bits.  The gate G_ijk = exp(cwe_ik - cwi_jk) enters three products that
// reduce over different indices (A over k, P over j, Q over i); a tile's P
// and Q take their gates in one item (each gate of the diagonal tile once
// for both), and the attention takes them again in triangle(): 3 L (L - 1)
// / 2 K exponentials a head where the function needs L (L - 1) / 2 K.
// Held once, the gates' partial sums would need L^2 K / 16 floats of shared
// memory to be reduced (139 KB at L = K = 64).  Every exponent is a
// difference of prefix sums <= 0 where it is used; exp(cwl - cwe - lw)
// keeps the forward's (and the reference's) order of the subtractions.
// Shared memory: r, k, v, lw, cwe, the L x L matrix, and, where they still
// fit, dy, dS' and S (else read from device memory; ops.bwd_layout mirrors
// the choice), so the backward takes every geometry the forward takes.
// Bound on the H100 at rwkv6-7b's training shape (B = 2, S = 4096, H = 64,
// K = 64, L = 64; chip_smoke.wkv6_bwd_work): 32.6 GFLOP on the FMA pipes
// (0.49 ms), 1.12 G exponentials (0.27 ms on the SFUs), 0.94 GB read and
// written once (0.28 ms): the FMA pipes bound it.  This design takes the
// gates three times and holds one block an SM (137 KB of shared memory in
// bf16), so it runs well above that bound (PERF.md).
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
// Channels c0..c0 + 3 of d_j = cwe_j + lw_j at offset ``off``: read from
// ds, or, with kLw (ds holds lw), formed from cs and ds as prefix() rounds
// it.
template <bool kLw>
__device__ __forceinline__ float4 ld_d(const float* cs, const float* ds,
                                       int off) {
  const float4 x = tile4::ld4(ds + off);
  if (!kLw) return x;
  const float4 c = tile4::ld4(cs + off);
  return make_float4(c.x + x.x, c.y + x.y, c.z + x.z, c.w + x.w);
}

template <typename T, bool kLw = false>
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
          const float4 dj = ld_d<kLw>(cs, ds, (j0 + c) * lk + c0);
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
      for (int c = 0; c < 3; ++c) dj[c] = ld_d<kLw>(cs, ds, (i0 + c) * lk + c0);
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

// ---------------------------------------------------------------------------
// The backward (see the header).

constexpr size_t kMaxSmem = 232448;  // a block's shared memory on the H100

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Four values to T at p (4-element aligned), rounded to nearest even.
__device__ __forceinline__ void st4t(float* p, float4 x) { tile4::st4(p, x); }
__device__ __forceinline__ void st4t(__nv_bfloat16* p, float4 x) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(x.x, x.y);
  const __nv_bfloat162 b = __floats2bfloat162_rn(x.z, x.w);
  uint2 w;
  w.x = *reinterpret_cast<const uint32_t*>(&a);
  w.y = *reinterpret_cast<const uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = w;
}

// acc[r][c] += sum_t A[i0 + r][t] * B[j0 + c][t], t ascending in [0, kd)
// (kd % 4 == 0); A and B in shared or device memory, float32 or T.
template <typename TA, typename TB>
__device__ __forceinline__ void dot_nt(float (&acc)[4][4], const TA* A,
                                       int lda, const TB* B, int ldb, int i0,
                                       int j0, int kd) {
  for (int t = 0; t < kd; t += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) a[r] = ld4(A + (long long)(i0 + r) * lda + t);
#pragma unroll
    for (int c = 0; c < 4; ++c) b[c] = ld4(B + (long long)(j0 + c) * ldb + t);
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

// q_c[k][v] = sum_i (r_ik exp(cwe_ik)) dy_i[v], k-major, per (b, chunk, h).
template <typename T>
__global__ void __launch_bounds__(kThreads)
wkv_chunk_dstate_kernel(const T* __restrict__ r, const float* __restrict__ lw,
                        const float* __restrict__ dy, float* __restrict__ q,
                        int S, int H, int K, int L, int hpb) {
  extern __shared__ float4 smem4[];
  const int lt = K + per16<T>(), lk = K + 4, kq = K / 4;
  T* rs = reinterpret_cast<T*>(smem4);                  // [L][lt]  r
  float* lws = reinterpret_cast<float*>(rs + L * lt);   // [L][lk]  lw
  float* cs = lws + L * lk;  // [L][lk]  cwe, then r * exp(cwe)
  float* ys = cs + L * lk;   // [L][lk]  dy

  const int tid = threadIdx.x, nc = S / L;
  const Block blk(nc, H, hpb);
  const long long row = (long long)H * K;
  for (int h = blk.h_lo; h < blk.h_hi; ++h) {
    const long long g = ((long long)blk.bi * S + (long long)blk.ci * L) * row
                        + (long long)h * K;
    stage(rs, lt, r + g, row, L, K);
    stage(lws, lk, lw + g, row, L, K);
    stage(ys, lk, dy + g, row, L, K);
    async_copy::commit();
    async_copy::wait<0>();
    __syncthreads();
    for (int kk = tid; kk < K; kk += kThreads)
      prefix(lws, cs, nullptr, lk, L, kk);
    __syncthreads();
    for (int idx = tid; idx < L * kq; idx += kThreads) {  // a quad each
      const int i = idx / kq, c0 = 4 * (idx - i * kq);
      const float4 rv = ld4(rs + i * lt + c0), c = tile4::ld4(cs + i * lk + c0);
      tile4::st4(cs + i * lk + c0,
                 make_float4(rv.x * exp_fast(c.x), rv.y * exp_fast(c.y),
                             rv.z * exp_fast(c.z), rv.w * exp_fast(c.w)));
    }
    __syncthreads();
    const long long unit = ((long long)blk.bi * nc + blk.ci) * H + h;
    float* out = q + unit * K * K;
    for (int t = tid; t < kq * kq; t += kThreads) {
      const int k0 = 4 * (t / kq), v0 = 4 * (t - (t / kq) * kq);
      float acc[4][4] = {};
      tile4::tn_scaled(acc, cs, lk, nullptr, ys, lk, k0, v0, L);
#pragma unroll
      for (int rr = 0; rr < 4; ++rr)
        tile4::st4(out + (k0 + rr) * K + v0,
                   make_float4(acc[rr][0], acc[rr][1], acc[rr][2],
                               acc[rr][3]));
    }
    __syncthreads();  // the next head refills every buffer
  }
}

// Thread (b, h, e): elements e..e+3 of the k-major [K][K] gradient of the
// state, carried from the last chunk back: writes the gradient of the state
// leaving each chunk over q_c and carries dS <- exp(cwl) dS' + q_c, from
// dsf or zeros; the last dS is ds0.
__global__ void __launch_bounds__(kPassThreads)
wkv_state_pass_bwd_kernel(const float* __restrict__ cwl, float* __restrict__ q,
                          const float* __restrict__ dsf,
                          float* __restrict__ ds0, int B, int nc, int H,
                          int K) {
  const long long idx = (long long)blockIdx.x * kPassThreads + threadIdx.x;
  const int KK = K * K, kk4 = KK / 4;
  if (idx >= (long long)B * H * kk4) return;
  const long long bh = idx / kk4;
  const int e = 4 * (int)(idx - bh * kk4), kr = e / K;
  const int bi = (int)(bh / H), h = (int)(bh - (long long)bi * H);
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  if (dsf) s = tile4::ld4(dsf + bh * KK + e);
  float* base = q + ((long long)bi * nc * H + h) * KK + e;
  const float* wb = cwl + ((long long)bi * nc * H + h) * K + kr;
  const long long step = (long long)H * KK;  // one chunk on
  for (int c0 = nc - 1; c0 >= 0; c0 -= kPassAhead) {
    float4 own[kPassAhead];
    float tot[kPassAhead];
#pragma unroll
    for (int p = 0; p < kPassAhead; ++p)
      if (c0 - p >= 0) {
        own[p] = tile4::ld4(base + (c0 - p) * step);
        tot[p] = wb[(long long)(c0 - p) * H * K];
      }
#pragma unroll
    for (int p = 0; p < kPassAhead; ++p)
      if (c0 - p >= 0) {
        tile4::st4(base + (c0 - p) * step, s);  // the gradient leaving it
        const float w = exp_fast(tot[p]);
        s = make_float4(s.x * w + own[p].x, s.y * w + own[p].y,
                        s.z * w + own[p].z, s.w * w + own[p].w);
      }
  }
  tile4::st4(ds0 + bh * KK + e, s);
}

// What chunk_bwd's block stages beyond its fixed buffers: dy, the gradient
// of the state leaving the chunk (gs) and the state entering it (s), each
// where it still fits; the rest it reads from device memory.
struct BwdStage {
  int dy, gs, s;
};

template <typename T>
size_t bwd_smem(int K, int L, BwdStage* st) {
  size_t bytes = sizeof(T) * 3 * (size_t)L * (K + per16<T>())
                 + sizeof(float) * (2 * (size_t)L * (K + 4)
                                    + (size_t)L * (L + 4) + L + 2 * (size_t)K
                                    + (size_t)L * K / 4);
  const size_t dy = sizeof(float) * (size_t)L * (K + 4);
  const size_t sk = sizeof(float) * (size_t)K * (K + 4);
  st->dy = bytes + dy <= kMaxSmem;
  if (st->dy) bytes += dy;
  st->gs = bytes + sk <= kMaxSmem;
  if (st->gs) bytes += sk;
  st->s = bytes + sk <= kMaxSmem;
  if (st->s) bytes += sk;
  return bytes;
}

// The gradients within chunk (b, c) for heads [h_lo, h_hi), per head:
//   1. r, k, v, lw (and dy, dS', S where staged) in; cwe, cwl (prefix()).
//   2. D_ij = dy_i . v_j over the lower tiles (j <= i).
//   3. one item per (row tile, channel quad): P = sum_{j<i} D_ij k_j G_ij
//      + exp(cwe_i) (S dy_i) and Q = sum_{i>j} D_ij r_i G_ij +
//      exp(cwl - cwe_j - lw_j) (dS' v_j) over its 4 rows and channels
//      (each tile's P and Q cost L / 4 + 1 tiles of gates together, so
//      the items are even); dr = P + u k D_ii and dk = Q + u r D_jj out;
//      dlw's terms within the tile out, and the tile's total.
//   4. per channel: the suffix of the tiles' totals, <dS'_k, S'_k> (S' the
//      state leaving the chunk: the next one's s_in, or sf), du's partial.
//   5. dlw += <dS', S'> + the later tiles' totals; the forward's attention
//      and bonus (triangle(), d formed from cwe and lw as prefix() rounds
//      it).
//   6. exp(cwl - cwe - lw) k over cwe.
//   7. one item per (row tile, column quad) of dv: sum_{i>j} A_ij dy_i +
//      beta_j dy_j + sum_k (exp(cwl_k - cwe_jk - lw_jk) k_jk) dS'_k.
// Every output element is summed by one thread in a fixed order.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
wkv_chunk_bwd_kernel(const T* __restrict__ r, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ lw,
                     const float* __restrict__ u, const float* __restrict__ dy,
                     const float* __restrict__ s_in,
                     const float* __restrict__ sf,
                     const float* __restrict__ gs, T* __restrict__ dr,
                     T* __restrict__ dk, T* __restrict__ dv,
                     float* __restrict__ dlw, float* __restrict__ du_part,
                     int S, int H, int K, int L, int hpb, BwdStage st) {
  extern __shared__ float4 smem4[];
  const int lt = K + per16<T>(), lk = K + 4, la = L + 4, kq = K / 4,
            nt = L / 4;
  T* rs = reinterpret_cast<T*>(smem4);                 // [L][lt]  r
  T* ks = rs + L * lt;                                  // [L][lt]  k
  T* vs = ks + L * lt;                                  // [L][lt]  v
  float* ls = reinterpret_cast<float*>(vs + L * lt);   // [L][lk]  lw
  float* cs = ls + L * lk;  // [L][lk]  cwe, then exp(cwl - cwe - lw) k
  float* mat = cs + L * lk;      // [L][la]  dy_i . v_j, then attention
  float* bonus = mat + L * la;   // [L]      sum_k r u k
  float* tot = bonus + L;        // [K]      cwl
  float* gl = tot + K;           // [K]      <dS'_k, S'_k>
  float* tsum = gl + K;          // [L/4][K] the row tiles' dlw totals
  float* next = tsum + nt * K;
  float* ys = next;              // [L][lk]  dy, if staged
  if (st.dy) next += L * lk;
  float* gss = next;             // [K][lk]  dS', if staged
  if (st.gs) next += K * lk;
  float* ss = next;              // [K][lk]  S, if staged

  const int tid = threadIdx.x, nc = S / L;
  const Block blk(nc, H, hpb);
  const long long row = (long long)H * K;
  const long long g0 = ((long long)blk.bi * S + (long long)blk.ci * L) * row;
  for (int h = blk.h_lo; h < blk.h_hi; ++h) {
    const long long g = g0 + (long long)h * K;
    const long long unit = ((long long)blk.bi * nc + blk.ci) * H + h;
    const long long kk_off = unit * K * K;
    stage(rs, lt, r + g, row, L, K);
    stage(ks, lt, k + g, row, L, K);
    stage(vs, lt, v + g, row, L, K);
    stage(ls, lk, lw + g, row, L, K);
    if (st.dy) stage(ys, lk, dy + g, row, L, K);
    if (st.gs) stage(gss, lk, gs + kk_off, K, K, K);
    if (st.s) stage(ss, lk, s_in + kk_off, K, K, K);
    async_copy::commit();
    async_copy::wait<0>();
    __syncthreads();
    const float* yp = st.dy ? ys : dy + g;
    const int ly = st.dy ? lk : (int)row;
    const float* gp = st.gs ? gss : gs + kk_off;
    const int lg = st.gs ? lk : K;
    const float* sp = st.s ? ss : s_in + kk_off;
    const int lsp = st.s ? lk : K;
    const float* uh = u + (long long)h * K;
    for (int kk = tid; kk < K; kk += kThreads)
      tot[kk] = prefix(ls, cs, nullptr, lk, L, kk);
    // 2. D over the lower tiles (the diagonal tile whole).
    for (int t = tid; t < nt * (nt + 1) / 2; t += kThreads) {
      int ti, tj;
      tile4::lower_tile(t, ti, tj);
      float acc[4][4] = {};
      dot_nt(acc, yp, ly, vs, lt, 4 * ti, 4 * tj, K);
#pragma unroll
      for (int rr = 0; rr < 4; ++rr)
        tile4::st4(mat + (4 * ti + rr) * la + 4 * tj,
                   make_float4(acc[rr][0], acc[rr][1], acc[rr][2],
                               acc[rr][3]));
    }
    __syncthreads();
    // 3. P and Q of each (row tile, channel quad).
    for (int item = tid; item < nt * kq; item += kThreads) {
      const int t = item / kq, c0 = 4 * (item - t * kq), i0 = 4 * t;
      float4 cr[4], lr[4], d4[4], rv[4], kv[4];
#pragma unroll
      for (int rr = 0; rr < 4; ++rr) {
        const int o = (i0 + rr) * lk + c0;
        cr[rr] = tile4::ld4(cs + o);
        lr[rr] = tile4::ld4(ls + o);
        d4[rr] = ld_d<true>(cs, ls, o);
        rv[rr] = ld4(rs + (i0 + rr) * lt + c0);
        kv[rr] = ld4(ks + (i0 + rr) * lt + c0);
      }
      float P[4][4] = {}, Q[4][4] = {};
      for (int j0 = 0; j0 < i0; j0 += 4) {  // P: the tiles left of it
        float4 dm[4], kj[4], dj[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          dm[q] = tile4::ld4(mat + (i0 + q) * la + j0);
          kj[q] = ld4(ks + (j0 + q) * lt + c0);
          dj[q] = ld_d<true>(cs, ls, (j0 + q) * lk + c0);
        }
#pragma unroll
        for (int rr = 0; rr < 4; ++rr)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              P[rr][e] = fmaf(tile4::at(dm[rr], jj) * tile4::at(kj[jj], e),
                              exp_fast(tile4::at(cr[rr], e)
                                       - tile4::at(dj[jj], e)),
                              P[rr][e]);
      }
      {  // the diagonal tile, j < i: one gate for P and Q
        float4 dm[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          dm[q] = tile4::ld4(mat + (i0 + q) * la + i0);
#pragma unroll
        for (int rr = 1; rr < 4; ++rr)
#pragma unroll
          for (int jj = 0; jj < rr; ++jj)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float gt = exp_fast(tile4::at(cr[rr], e)
                                        - tile4::at(d4[jj], e));
              const float dij = tile4::at(dm[rr], jj);
              P[rr][e] = fmaf(dij * tile4::at(kv[jj], e), gt, P[rr][e]);
              Q[jj][e] = fmaf(dij * tile4::at(rv[rr], e), gt, Q[jj][e]);
            }
      }
      for (int ib = i0 + 4; ib < L; ib += 4) {  // Q: the tiles below it
        float4 dm[4], ri[4], ci[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          dm[q] = tile4::ld4(mat + (ib + q) * la + i0);
          ri[q] = ld4(rs + (ib + q) * lt + c0);
          ci[q] = tile4::ld4(cs + (ib + q) * lk + c0);
        }
#pragma unroll
        for (int rr = 0; rr < 4; ++rr)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              Q[jj][e] = fmaf(tile4::at(dm[rr], jj) * tile4::at(ri[rr], e),
                              exp_fast(tile4::at(ci[rr], e)
                                       - tile4::at(d4[jj], e)),
                              Q[jj][e]);
      }
      float ps[4][4] = {}, ts[4][4] = {};
      dot_nt(ps, yp, ly, sp, lsp, i0, c0, K);  // S_k . dy_i
      dot_nt(ts, vs, lt, gp, lg, i0, c0, K);   // dS'_k . v_j
      const float4 t4 = tile4::ld4(tot + c0), u4 = tile4::ld4(uh + c0);
      float run[4] = {};
      float wsum[4][4];
#pragma unroll
      for (int rr = 3; rr >= 0; --rr) {
        const int i = i0 + rr;
        const float dd = mat[i * la + i];
        float pr[4], qr[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float c = tile4::at(cr[rr], e);
          const float p = P[rr][e] + exp_fast(c) * ps[rr][e];
          const float qv = Q[rr][e]
                           + exp_fast((tile4::at(t4, e) - c)
                                      - tile4::at(lr[rr], e)) * ts[rr][e];
          const float bo = tile4::at(u4, e) * dd;
          pr[e] = p + bo * tile4::at(kv[rr], e);
          qr[e] = qv + bo * tile4::at(rv[rr], e);
          // dlw's terms: -k Q at m = i, r P at every m < i.
          run[e] += -tile4::at(kv[rr], e) * qv;
          wsum[rr][e] = run[e];
          run[e] += tile4::at(rv[rr], e) * p;
        }
        const long long o = g + (long long)i * row + c0;
        st4t(dr + o, make_float4(pr[0], pr[1], pr[2], pr[3]));
        st4t(dk + o, make_float4(qr[0], qr[1], qr[2], qr[3]));
        tile4::st4(dlw + o, make_float4(wsum[rr][0], wsum[rr][1],
                                        wsum[rr][2], wsum[rr][3]));
      }
      tile4::st4(tsum + t * K + c0, make_float4(run[0], run[1], run[2],
                                                run[3]));
    }
    __syncthreads();
    // 4. per channel: the later tiles' totals, <dS', S'>, du's partial.
    const float* so = blk.ci + 1 < nc
                          ? s_in + kk_off + (long long)H * K * K
                          : sf + ((long long)blk.bi * H + h) * K * K;
    for (int kk = tid; kk < K; kk += kThreads) {
      float later = 0.f;
      for (int t = nt - 1; t >= 0; --t) {
        const float x = tsum[t * K + kk];
        tsum[t * K + kk] = later;
        later += x;
      }
      float acc = 0.f;
      for (int c = 0; c < K; ++c)
        acc = fmaf(gp[kk * lg + c], so[(long long)kk * K + c], acc);
      gl[kk] = acc;
      float d = 0.f;
      for (int i = 0; i < L; ++i)
        d = fmaf(to_f(rs[i * lt + kk]) * to_f(ks[i * lt + kk]),
                 mat[i * la + i], d);
      du_part[unit * K + kk] = d;
    }
    __syncthreads();
    // 5. dlw whole; then the forward's attention over D.
    for (int idx = tid; idx < L * kq; idx += kThreads) {
      const int i = idx / kq, c0 = 4 * (idx - i * kq);
      float* p = dlw + g + (long long)i * row + c0;
      const float4 w = tile4::ld4(p), x = tile4::ld4(tsum + (i / 4) * K + c0),
                   y = tile4::ld4(gl + c0);
      tile4::st4(p, make_float4(w.x + (x.x + y.x), w.y + (x.y + y.y),
                                w.z + (x.z + y.z), w.w + (x.w + y.w)));
    }
    triangle<T, true>(rs, ks, cs, ls, uh, mat, bonus, lt, lk, la, L, K);
    __syncthreads();
    // 6. exp(cwl - cwe - lw) k over cwe.
    for (int idx = tid; idx < L * kq; idx += kThreads) {
      const int i = idx / kq, c0 = 4 * (idx - i * kq);
      const float4 t = tile4::ld4(tot + c0), c = tile4::ld4(cs + i * lk + c0),
                   w = tile4::ld4(ls + i * lk + c0),
                   kx = ld4(ks + i * lt + c0);
      tile4::st4(cs + i * lk + c0,
                 make_float4(exp_fast((t.x - c.x) - w.x) * kx.x,
                             exp_fast((t.y - c.y) - w.y) * kx.y,
                             exp_fast((t.z - c.z) - w.z) * kx.z,
                             exp_fast((t.w - c.w) - w.w) * kx.w));
    }
    __syncthreads();
    // 7. dv of each (row tile, column quad).
    for (int item = tid; item < nt * kq; item += kThreads) {
      const int j0 = 4 * (item / kq), v0 = 4 * (item - (item / kq) * kq);
      float acc[4][4] = {}, sta[4][4] = {};
      for (int i = j0; i < L; ++i) {  // A_ij = 0 for i <= j
        const float4 a = tile4::ld4(mat + i * la + j0);
        const float4 y = tile4::ld4(yp + (long long)i * ly + v0);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const float aj = tile4::at(a, jj);
          acc[jj][0] = fmaf(aj, y.x, acc[jj][0]);
          acc[jj][1] = fmaf(aj, y.y, acc[jj][1]);
          acc[jj][2] = fmaf(aj, y.z, acc[jj][2]);
          acc[jj][3] = fmaf(aj, y.w, acc[jj][3]);
        }
      }
      tile4::nn(sta, cs, lk, gp, lg, j0, v0, K);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = j0 + jj;
        const float b = bonus[j];
        const float4 y = tile4::ld4(yp + (long long)j * ly + v0);
        st4t(dv + g + (long long)j * row + v0,
             make_float4((acc[jj][0] + b * y.x) + sta[jj][0],
                         (acc[jj][1] + b * y.y) + sta[jj][1],
                         (acc[jj][2] + b * y.z) + sta[jj][2],
                         (acc[jj][3] + b * y.w) + sta[jj][3]));
      }
    }
    __syncthreads();  // the next head refills every buffer
  }
}

// du[h][k] = sum over (b, chunk) ascending of the chunks' partials.
__global__ void __launch_bounds__(kPassThreads)
wkv_sum_du_kernel(const float* __restrict__ part, float* __restrict__ du,
                  int n, int hk) {
  const int idx = blockIdx.x * kPassThreads + threadIdx.x;
  if (idx >= hk) return;
  float acc = 0.f;
  for (int i = 0; i < n; ++i) acc += part[(long long)i * hk + idx];
  du[idx] = acc;
}

template <typename T>
cudaError_t chunk_dstate(const void* r, const void* lw, const void* dy,
                         void* q, int B, int S, int H, int K, int L,
                         cudaStream_t stream) {
  auto kernel = wkv_chunk_dstate_kernel<T>;
  const size_t smem = sizeof(T) * (size_t)L * (K + per16<T>())
                      + sizeof(float) * 3 * (size_t)L * (K + 4);
  int per_sm = 0;
  cudaError_t e = prepare(kernel, smem, &per_sm);
  if (e != cudaSuccess) return e;
  const int hpb = heads_per_block(B, S / L, H, per_sm, 0.0);
  kernel<<<dim3(B * (S / L), (H + hpb - 1) / hpb), kThreads, smem, stream>>>(
      (const T*)r, (const float*)lw, (const float*)dy, (float*)q, S, H, K, L,
      hpb);
  return cudaGetLastError();
}

template <typename T>
cudaError_t chunk_bwd(const void* r, const void* k, const void* v,
                      const void* lw, const void* u, const void* dy,
                      const void* s_in, const void* sf, const void* gs,
                      void* dr, void* dk, void* dv, void* dlw, void* du_part,
                      int B, int S, int H, int K, int L, cudaStream_t stream) {
  auto kernel = wkv_chunk_bwd_kernel<T>;
  BwdStage st;
  const size_t smem = bwd_smem<T>(K, L, &st);
  if (smem > kMaxSmem) return cudaErrorInvalidConfiguration;
  int per_sm = 0;
  cudaError_t e = prepare(kernel, smem, &per_sm);
  if (e != cudaSuccess) return e;
  const int hpb = heads_per_block(B, S / L, H, per_sm, 0.0);
  kernel<<<dim3(B * (S / L), (H + hpb - 1) / hpb), kThreads, smem, stream>>>(
      (const T*)r, (const T*)k, (const T*)v, (const float*)lw,
      (const float*)u, (const float*)dy, (const float*)s_in, (const float*)sf,
      (const float*)gs, (T*)dr, (T*)dk, (T*)dv, (float*)dlw, (float*)du_part,
      S, H, K, L, hpb, st);
  return cudaGetLastError();
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

// The backward's four passes; the wrapper (kernels/rwkv6/ops.py wkv6_bwd)
// runs them in order with the forward's scratch cwl and s_in (the state
// entering each chunk), its final state sf, and q [B, S/L, H, K, K]
// (float32).

// q <- each chunk's sum_i (r_i exp(cwe_i)) (x) dy_i.
extern "C" int wkv6_chunk_dstate_launch(const void* r, const void* lw,
                                        const void* dy, void* q, int B, int S,
                                        int H, int K, int L, int dtype,
                                        void* stream) {
  if (!shape_ok(B, S, H, K, L, dtype)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st_ = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)chunk_dstate<float>(r, lw, dy, q, B, S, H, K, L, st_);
  if (dtype == 1)
    return (int)chunk_dstate<__nv_bfloat16>(r, lw, dy, q, B, S, H, K, L, st_);
  return (int)cudaErrorInvalidValue;
}

// q <- the gradient of the state leaving each chunk (in place), ds0 <- the
// initial state's gradient ([B, H, K, K]); dsf ([B, H, K, K]) null means
// zeros.
extern "C" int wkv6_state_pass_bwd_launch(const void* cwl, void* q,
                                          const void* dsf, void* ds0, int B,
                                          int nc, int H, int K, void* stream) {
  if (B < 1 || nc < 1 || H < 1 || K < 4 || K % 4)
    return (int)cudaErrorInvalidValue;
  const long long threads = (long long)B * H * (K * K / 4);
  wkv_state_pass_bwd_kernel<<<
      (unsigned)((threads + kPassThreads - 1) / kPassThreads), kPassThreads,
      0, (cudaStream_t)stream>>>((const float*)cwl, (float*)q,
                                 (const float*)dsf, (float*)ds0, B, nc, H, K);
  return (int)cudaGetLastError();
}

// dr, dk, dv (r's type), dlw and du_part ([B, S/L, H, K], float32) from
// the inputs, dy, s_in, sf and gs (the gradient of the state leaving each
// chunk, as state_pass_bwd leaves q).
extern "C" int wkv6_chunk_bwd_launch(const void* r, const void* k,
                                     const void* v, const void* lw,
                                     const void* u, const void* dy,
                                     const void* s_in, const void* sf,
                                     const void* gs, void* dr, void* dk,
                                     void* dv, void* dlw, void* du_part,
                                     int B, int S, int H, int K, int L,
                                     int dtype, void* stream) {
  if (!shape_ok(B, S, H, K, L, dtype) || (long long)L * H * K > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st_ = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)chunk_bwd<float>(r, k, v, lw, u, dy, s_in, sf, gs, dr, dk, dv,
                                 dlw, du_part, B, S, H, K, L, st_);
  if (dtype == 1)
    return (int)chunk_bwd<__nv_bfloat16>(r, k, v, lw, u, dy, s_in, sf, gs, dr,
                                         dk, dv, dlw, du_part, B, S, H, K, L,
                                         st_);
  return (int)cudaErrorInvalidValue;
}

// du [H, K] <- the sum of du_part over (b, chunk) in ascending order.
extern "C" int wkv6_sum_du_launch(const void* part, void* du, int B, int nc,
                                  int H, int K, void* stream) {
  if (B < 1 || nc < 1 || H < 1 || K < 1) return (int)cudaErrorInvalidValue;
  const int hk = H * K;
  wkv_sum_du_kernel<<<(hk + kPassThreads - 1) / kPassThreads, kPassThreads, 0,
                      (cudaStream_t)stream>>>((const float*)part, (float*)du,
                                              B * nc, hk);
  return (int)cudaGetLastError();
}

// chunk_bwd's shared memory at (K, L) for r, k, v of ``dtype`` (0 float32,
// 1 bfloat16), and in out[0..2] whether it stages dy, dS' and S
// (ops.bwd_layout mirrors it).  Launches nothing.
extern "C" long long wkv6_chunk_bwd_smem(int K, int L, int dtype, int* out) {
  BwdStage st;
  const size_t bytes = dtype == 1 ? bwd_smem<__nv_bfloat16>(K, L, &st)
                                  : bwd_smem<float>(K, L, &st);
  out[0] = st.dy;
  out[1] = st.gs;
  out[2] = st.s;
  return (long long)bytes;
}
