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
// the gradient of the state leaving a chunk, S' that state, G_ijk =
// exp(cwe_ik - cwi_jk) (cwi = cwe + lw) and D_ij = dy_i . v_j:
//   chunk_dstate    q_c = sum_i (r_i exp(cwe_i)) (x) dy_i: a [K, L] x [L, K]
//                   product with a row scale <= 1.
//   state_pass_bwd  from the last chunk back: writes dS' over q_c and
//                   carries dS <- exp(cwl) dS' + q_c from dsf; the last dS
//                   is ds0.  The mirror of state_pass.
//   chunk_bwd       P = sum_{j<i} D_ij k_j G_ij + exp(cwe_i) (S dy_i), Q =
//                   sum_{i>j} D_ij r_i G_ij + exp(cwl - cwe_j - lw_j) (dS'
//                   v_j); dr = P + u k D_ii, dk = Q + u r D_jj, dlw = <dS',
//                   S'> - k Q + (sum over the later rows of r P - k Q), dv =
//                   A^T dy + beta dy + (exp(cwl - cwe - lw) k) dS' (A, beta
//                   the forward's attention and bonus); du's partial.
//   sum_du          du = the partials summed over (b, chunk) in order.
// chunk_dstate and chunk_bwd take their products on the tensor cores
// (mma.sync m16n8k8 TF32, float32 accumulation) in split TF32
// (split_tf32.cuh): three passes, two where one operand is a bf16 r, k or
// v (exact in TF32).  The gate cannot be factored as exp(cwe_i) exp(-cwi_j)
// over a chunk (that overflows, see above), but it can inside one: the
// chunk is cut into blocks of 16 rows, and for a row i at or below the
// first row of a block, whose cwe is the anchor c, and a row j above it,
// G_ij = exp(cwe_i - c) exp(c - cwi_j) with both factors <= 1 (cwe falls,
// lw <= 0; up to the prefix sums' rounding, which the reference's gate
// keeps too).  So nothing overflows, and where a factor underflows the gate
// is smaller still.
// Each exponent is one float32 subtraction, exact where the gate is above
// float32's floor (its operands lie within a factor of 2 there), as the
// reference's one subtraction is.  With c_a the anchor of block a:
//   A^T's block (b, a), b < a  = (k exp(c_a - cwi))_b (r exp(cwe - c_a))_a^T
//   P of block a  += exp(cwe - c_a) o (D_{a, <a} (k exp(c_a - cwi))_{<a})
//   Q of block a  += exp(c_{a+1} - cwi) o (D_{>a, a}^T (r exp(cwe -
//                    c_{a+1}))_{>a})
// on the tensor cores, the scaled operands formed as the fragments load.
// The 16 x 16 diagonal blocks keep the exact per-pair gates (the forward's
// prefix() bits, the reference's order of subtractions) on the FMA pipes:
// A^T's by threads (a 4 x 4 tile and channel quad each, summed by
// shuffles), P's and Q's by the warp that owns their rows (each pair's gate
// once, the term for the other row passed by a shuffle).  Exponentials a
// head: L 15/2 K for A's diagonal blocks and as many for P's and Q's, and
// O(L K) an anchor for the anchored operands and the row scales: 104,448
// at L = K = 64 (chip_smoke.wkv6_bwd_design_exps), where taking every gate
// three times took 3 L (L - 1) / 2 K = 387,072.
// chunk_bwd: one 256-thread block per (b, chunk, group of heads), two an SM
// where r, k, v, lw, cwe, the L x L matrix and dy fit half an SM's shared
// memory (115,200 B in bf16 at L = K = 64, dS' staged and S read from
// device memory), else one, with dS' and S staged where they fit
// (ops.bwd_layout mirrors the choice).  Per head: (1) the prefix again
// (prefix(), the forward's bits); (2) D = dy v^T on the
// lower tiles and A^T in one L x L matrix, D on and below its diagonal, A^T
// above; (3) a warp per 8 channels takes their row blocks from the last to
// the first: P and Q of a block whole in registers (state, anchored and
// diagonal terms), then dr, dk and dlw (the suffix over the block's rows by
// shuffles, the later blocks' totals carried in registers; <dS', S'> from
// the first block's loads of dS', S' read beside them); then a warp per
// (block, 32 value columns) takes dv.  Rows past L and channels past K are
// zero-padded to the tiles.
// Every sum is taken in a fixed order, with no atomics: two runs give the
// same bits.
// Bound on the H100 at rwkv6-7b's training shape (B = 2, S = 4096, H = 64,
// K = 64, L = 64; chip_smoke.wkv6_bwd_work): 0.94 GB read and written once,
// 0.28 ms at 3.35 TB/s, against 32.6 GFLOP, 0.066 ms on the TF32 tensor
// pipe: bytes bound it.  The split's own operations
// (chip_smoke.wkv6_bwd_split_ops) and the times measured: PERF.md.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "async_copy.cuh"
#include "ordered_prefix.cuh"
#include "split_tf32.cuh"
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
constexpr size_t kSmSmem = 233472;   // an SM's, 1 KB of it reserved a block
// chunk_bwd's blocks an SM where its layout fits their share of shared
// memory (so at most 65536 / (256 * 2) = 128 registers a thread).
constexpr int kBwdBlocks = 2;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void set_zero(float* p) { *p = 0.f; }
__device__ __forceinline__ void set_zero(__nv_bfloat16* p) {
  *p = __float2bfloat16(0.f);
}

// Two consecutive staged elements as float32 (2-element aligned).
__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 ld2(const __nv_bfloat16* p) {
  const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
  return make_float2(__uint_as_float(w << 16),
                     __uint_as_float(w & 0xffff0000u));
}

// Two values to T at p (2-element aligned), rounded to nearest even.
__device__ __forceinline__ void st2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void st2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// A gate or anchored factor exp(x): x <= 0 but for the prefix sums' rounding
// (a few ulps of |cwe|, kept as the reference keeps them); the cap only
// keeps the products of zero-padded rows finite (their other factor is 0).
__device__ __forceinline__ float gate(float x) {
  return exp_fast(fminf(x, 64.f));
}

// Zero the elements of [0, rows) x [0, cols) of a buffer with rows of ld
// outside [0, nr) x [0, ncol): the rows and columns that fragments read
// past the data (none where L and K are multiples of 16 and 8).
template <typename E>
__device__ __forceinline__ void zero_pads(E* p, int ld, int rows, int cols,
                                          int nr, int ncol) {
  const int xr = rows - nr, xc = cols - ncol;
  for (int idx = threadIdx.x; idx < xr * cols; idx += blockDim.x)
    set_zero(p + (nr + idx / cols) * ld + idx % cols);
  for (int idx = threadIdx.x; idx < nr * xc; idx += blockDim.x)
    set_zero(p + (idx / xc) * ld + ncol + idx % xc);
}

// A matrix of E read by element as float32: staged in shared memory (its
// rows and columns past the data zero) or in device memory (chk: elements
// past rows x cols read as 0).
template <typename E>
struct MatOf {
  const E* p;
  int ld, rows, cols;
  bool chk;
  __device__ __forceinline__ float at(int i, int c) const {
    if (chk && (i >= rows || c >= cols)) return 0.f;
    return to_f(p[(long long)i * ld + c]);
  }
  // Elements (i, c) and (i, c + 1), c even (cols is even).
  __device__ __forceinline__ float2 at2(int i, int c) const {
    if (chk && (i >= rows || c >= cols)) return make_float2(0.f, 0.f);
    return ld2(p + (long long)i * ld + c);
  }
};
using Mat = MatOf<float>;

// Split-TF32 fragments (split_tf32.cuh) of matrices read by element: A (16
// x 8) at rows m0, columns k0 of A[m][k] = at(m, k); B (8 x 8) at rows k0,
// columns n0 of B[k][n] = at(k, n).  kX: the values are exact in TF32.  A
// product sums over its 8 k of a step in any order, so lane t takes k0 +
// 2t and k0 + 2t + 1 where the fragment layout names t and t + 4, in A and
// B alike: a row's two values are adjacent, read as one pair by the *2
// forms (at2(m, k): the values at k and k + 1 of row m of A, or of column
// m of B).
template <bool kX, typename F>
__device__ __forceinline__ tf32x3::FragA frag_a(const F& at, int m0, int k0) {
  const int g = (threadIdx.x & 31) >> 2, k = k0 + 2 * (threadIdx.x & 3);
  const float x[4] = {at(m0 + g, k), at(m0 + g + 8, k), at(m0 + g, k + 1),
                      at(m0 + g + 8, k + 1)};
  return tf32x3::split_a<kX>(x);
}

template <bool kX, typename F>
__device__ __forceinline__ tf32x3::FragA frag_a2(const F& at2, int m0,
                                                 int k0) {
  const int g = (threadIdx.x & 31) >> 2, k = k0 + 2 * (threadIdx.x & 3);
  const float2 lo = at2(m0 + g, k), hi = at2(m0 + g + 8, k);
  const float x[4] = {lo.x, hi.x, lo.y, hi.y};
  return tf32x3::split_a<kX>(x);
}

template <bool kX, typename F>
__device__ __forceinline__ tf32x3::FragB frag_b(const F& at, int k0, int n0) {
  const int g = (threadIdx.x & 31) >> 2, k = k0 + 2 * (threadIdx.x & 3);
  return tf32x3::split_b<kX>(at(k, n0 + g), at(k + 1, n0 + g));
}

template <bool kX, typename F>
__device__ __forceinline__ tf32x3::FragB frag_b2(const F& at2, int k0,
                                                 int n0) {
  const int g = (threadIdx.x & 31) >> 2, k = k0 + 2 * (threadIdx.x & 3);
  const float2 b = at2(n0 + g, k);
  return tf32x3::split_b<kX>(b.x, b.y);
}

// q_c[k][v] = sum_i (r_ik exp(cwe_ik)) dy_i[v], k-major, per (b, chunk, h):
// per head r, lw and dy staged (rows past L, columns past K zero), cwe
// (prefix()), r exp(cwe) over cwe, then q = (r exp(cwe))^T dy in split TF32,
// a warp per (16 channels, up to 32 value columns).
template <typename T>
__global__ void __launch_bounds__(kThreads)
wkv_chunk_dstate_kernel(const T* __restrict__ r, const float* __restrict__ lw,
                        const float* __restrict__ dy, float* __restrict__ q,
                        int S, int H, int K, int L, int hpb) {
  using namespace tf32x3;
  extern __shared__ float4 smem4[];
  const int lp = (L + 15) / 16 * 16, kp = (K + 7) / 8 * 8,
            km = (K + 15) / 16 * 16;
  const int lt = kp + per16<T>(), lc = km + 8, nk = kp / 8;
  T* rs = reinterpret_cast<T*>(smem4);                  // [lp][lt]  r
  float* ls = reinterpret_cast<float*>(rs + lp * lt);   // [lp][lc]  lw
  float* cs = ls + lp * lc;  // [lp][lc]  cwe, then r * exp(cwe)
  float* ys = cs + lp * lc;  // [lp][lc]  dy

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int nc = S / L;
  const Block blk(nc, H, hpb);
  const long long row = (long long)H * K;
  zero_pads(cs, lc, lp, km, L, K);
  zero_pads(ys, lc, lp, kp, L, K);
  const int nq4 = (nk + 3) / 4, n_tasks = (km / 16) * nq4;
  for (int h = blk.h_lo; h < blk.h_hi; ++h) {
    const long long gh = ((long long)blk.bi * S + (long long)blk.ci * L) * row
                         + (long long)h * K;
    __syncthreads();  // the previous head is done with every buffer
    stage(rs, lt, r + gh, row, L, K);
    stage(ls, lc, lw + gh, row, L, K);
    stage(ys, lc, dy + gh, row, L, K);
    async_copy::commit();
    async_copy::wait<0>();
    __syncthreads();
    for (int kk = tid; kk < K; kk += kThreads)
      prefix(ls, cs, nullptr, lc, L, kk);
    __syncthreads();
    for (int idx = tid; idx < L * (K / 4); idx += kThreads) {  // a quad each
      const int i = idx / (K / 4), c0 = 4 * (idx - i * (K / 4));
      const float4 rv = ld4(rs + i * lt + c0), c = tile4::ld4(cs + i * lc + c0);
      tile4::st4(cs + i * lc + c0,
                 make_float4(rv.x * exp_fast(c.x), rv.y * exp_fast(c.y),
                             rv.z * exp_fast(c.z), rv.w * exp_fast(c.w)));
    }
    __syncthreads();
    const long long unit = ((long long)blk.bi * nc + blk.ci) * H + h;
    float* out = q + unit * K * K;
    for (int task = warp; task < n_tasks; task += kWarps) {
      const int m0 = 16 * (task / nq4), q0 = 4 * (task % nq4);
      const int nt = min(4, nk - q0);
      float acc[4][4] = {};
      for (int k0 = 0; k0 < lp; k0 += 8) {
        const FragA fa = frag_a<false>(
            [&](int m, int i) { return cs[i * lc + m]; }, m0, k0);
        FragB fb[4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (u < nt)
            fb[u] = frag_b<false>(
                [&](int i, int c) { return ys[i * lc + c]; }, k0,
                8 * (q0 + u));
        mma3_row<false, false, 4>(acc, fa, fb, nt);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int kk = m0 + g + 8 * hr, c = 8 * (q0 + u) + 2 * t4;
          if (u < nt && kk < K && c < K)
            st2(out + kk * K + c, acc[u][2 * hr], acc[u][2 * hr + 1]);
        }
    }
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

// chunk_bwd's shared memory, in the kernel's order: r, k and v (v where
// staged) [lp][kp (+ 16 bytes)] in T; lw and cwe [lp][kp (+ 4)]; the lp x
// (lp (+ 4)) matrix (D = dy v^T on and below its diagonal, A^T above it);
// the forward's bonus [lp]; cwl [kp]; then, each where it still fits the
// layout's budget, dy [lp][kp (+ 4)], dS' and S [kp][kp (+ 4)] (else read
// from device memory).  lp is L rounded up to 16, kp K up to 8; rows and
// columns past L and K are zero.  The rows are padded (the parenthesised
// terms, so a warp's fragment loads fall on distinct banks) and v staged
// where that fits, else the rows are padded and v read from device memory,
// else neither.  The budget is an SM's shared memory shared by kBwdBlocks
// blocks where the fixed buffers and dy fit that share, else a whole
// block's; bytes past kMaxSmem: no layout fits (no geometry the forward
// takes).
struct BwdLayout {
  int lp, kp, blocks, pad, vs, dy, gs, s;
  long long bytes;
};

template <typename T>
BwdLayout bwd_layout(int K, int L) {
  BwdLayout y{};
  y.lp = (L + 15) / 16 * 16;
  y.kp = (K + 7) / 8 * 8;
  const size_t lp = y.lp, kp = y.kp;
  for (int pad = 1; pad >= 0; --pad)
    for (int vs = 1; vs >= 0; --vs) {
      const size_t lk = kp + 4 * pad, la = lp + 4 * pad,
                   lt = kp + per16<T>() * pad;
      const size_t base =
          sizeof(T) * (2 + vs) * lp * lt
          + sizeof(float) * (2 * lp * lk + lp * la + lp + kp);
      const size_t dy = sizeof(float) * lp * lk, sk = sizeof(float) * kp * lk;
      y.bytes = (long long)base;
      for (int b = kBwdBlocks; b >= 1; --b) {
        const size_t budget = kSmSmem / b - 1024;
        if (b > 1 && base + dy > budget) continue;
        if (base > budget) break;
        size_t bytes = base;
        y.blocks = b;
        y.pad = pad;
        y.vs = vs;
        y.dy = bytes + dy <= budget;
        if (y.dy) bytes += dy;
        y.gs = bytes + sk <= budget;
        if (y.gs) bytes += sk;
        y.s = bytes + sk <= budget;
        if (y.s) bytes += sk;
        y.bytes = (long long)bytes;
        return y;
      }
    }
  return y;
}

// The gradients within chunk (b, c) for heads [h_lo, h_hi); per head (the
// header's design):
//   1. r, k, v, lw (and dy, dS', S where staged) in; cwe and cwl
//      (prefix()).
//   2. warps: D = dy v^T on the lower 16 x 8 tiles (a band's segment of up
//      to four tiles a task), A^T's off-diagonal 16 x 16 blocks from the
//      anchored operands; threads: A^T's diagonal blocks with the exact
//      gates and the bonus.
//   3. per 8 channels a warp takes the row blocks from the last to the
//      first: P and Q (state, anchored and diagonal terms; in the first
//      block also <dS'_k, S'_k>), dr, dk and dlw out, the block's dlw and
//      du totals added to its running sums, exp(cwl - cwe - lw) k over lw;
//      then dv per (block, up to 32 value columns).
template <typename T>
__global__ void __launch_bounds__(kThreads, kBwdBlocks)
wkv_chunk_bwd_kernel(const T* __restrict__ r, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ lw,
                     const float* __restrict__ u, const float* __restrict__ dy,
                     const float* __restrict__ s_in,
                     const float* __restrict__ sf,
                     const float* __restrict__ gs, T* __restrict__ dr,
                     T* __restrict__ dk, T* __restrict__ dv,
                     float* __restrict__ dlw, float* __restrict__ du_part,
                     int S, int H, int K, int L, int hpb, BwdLayout ly) {
  using namespace tf32x3;
  constexpr bool kBF = !std::is_same<T, float>::value;
  extern __shared__ float4 smem4[];
  const int lp = ly.lp, kp = ly.kp, nb = lp / 16, nk = kp / 8;
  const int lt = kp + per16<T>() * ly.pad, lk = kp + 4 * ly.pad,
            la = lp + 4 * ly.pad;
  T* rs = reinterpret_cast<T*>(smem4);                 // [lp][lt]  r
  T* ks = rs + lp * lt;                                 // [lp][lt]  k
  T* vs = ks + lp * lt;                                 // [lp][lt]  v, if staged
  float* ls = reinterpret_cast<float*>(vs + (ly.vs ? lp * lt : 0));  // lw
  float* cs = ls + lp * lk;      // [lp][lk]  cwe
  float* mat = cs + lp * lk;     // [lp][la]  D (lower), A^T (upper)
  float* bonus = mat + lp * la;  // [lp]      sum_k r u k
  float* tot = bonus + lp;       // [kp]      cwl
  float* next = tot + kp;
  float* ys = next;              // [lp][lk]  dy, if staged
  if (ly.dy) next += lp * lk;
  float* gss = next;             // [kp][lk]  dS', if staged
  if (ly.gs) next += kp * lk;
  float* ss = next;              // [kp][lk]  S, if staged

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int nc = S / L;
  const Block blk(nc, H, hpb);
  const long long row = (long long)H * K;
  const long long g0 = ((long long)blk.bi * S + (long long)blk.ci * L) * row;
  zero_pads(rs, lt, lp, kp, L, K);
  zero_pads(ks, lt, lp, kp, L, K);
  if (ly.vs) zero_pads(vs, lt, lp, kp, L, K);
  zero_pads(ls, lk, lp, kp, L, K);
  zero_pads(cs, lk, lp, kp, L, K);
  if (ly.dy) zero_pads(ys, lk, lp, kp, L, K);
  if (ly.gs) zero_pads(gss, lk, kp, kp, K, K);
  if (ly.s) zero_pads(ss, lk, kp, kp, K, K);

  // cwi = cwe + lw as prefix() rounds it; the anchored operands at the
  // anchor row a0 (its cwe the anchor): k_j exp(c - cwi_j) for rows above
  // it and r_i exp(cwe_i - c) for rows at or below it (gate()).
  auto cwi_at = [&](int i, int c) { return cs[i * lk + c] + ls[i * lk + c]; };
  auto khat = [&](int a0, int j, int c) {
    return to_f(ks[j * lt + c])
           * gate(cs[a0 * lk + c] - cwi_at(j, c));
  };
  auto rhat = [&](int a0, int i, int c) {
    return to_f(rs[i * lt + c])
           * gate(cs[i * lk + c] - cs[a0 * lk + c]);
  };
  // The same at channels c and c + 1 (c even).
  auto khat2 = [&](int a0, int j, int c) {
    const float2 kv = ld2(ks + j * lt + c), ca = ld2(cs + a0 * lk + c),
                 cj = ld2(cs + j * lk + c), wj = ld2(ls + j * lk + c);
    return make_float2(kv.x * gate(ca.x - (cj.x + wj.x)),
                       kv.y * gate(ca.y - (cj.y + wj.y)));
  };
  auto rhat2 = [&](int a0, int i, int c) {
    const float2 rv = ld2(rs + i * lt + c), ca = ld2(cs + a0 * lk + c),
                 ci = ld2(cs + i * lk + c);
    return make_float2(rv.x * gate(ci.x - ca.x), rv.y * gate(ci.y - ca.y));
  };

  for (int h = blk.h_lo; h < blk.h_hi; ++h) {
    const long long gh = g0 + (long long)h * K;
    const long long unit = ((long long)blk.bi * nc + blk.ci) * H + h;
    const long long kk_off = unit * K * K;
    __syncthreads();  // the previous head is done with every buffer
    stage(rs, lt, r + gh, row, L, K);
    stage(ks, lt, k + gh, row, L, K);
    if (ly.vs) stage(vs, lt, v + gh, row, L, K);
    stage(ls, lk, lw + gh, row, L, K);
    if (ly.dy) stage(ys, lk, dy + gh, row, L, K);
    if (ly.gs) stage(gss, lk, gs + kk_off, K, K, K);
    if (ly.s) stage(ss, lk, s_in + kk_off, K, K, K);
    async_copy::commit();
    async_copy::wait<0>();
    __syncthreads();
    const MatOf<T> V = ly.vs ? MatOf<T>{vs, lt, L, K, false}
                             : MatOf<T>{v + gh, (int)row, L, K, true};
    const Mat Y = ly.dy ? Mat{ys, lk, L, K, false}
                        : Mat{dy + gh, (int)row, L, K, true};
    const Mat GS = ly.gs ? Mat{gss, lk, K, K, false}
                         : Mat{gs + kk_off, K, K, K, true};
    const Mat SS = ly.s ? Mat{ss, lk, K, K, false}
                        : Mat{s_in + kk_off, K, K, K, true};
    const float* uh = u + (long long)h * K;

    // 1. cwe and cwl.
    if (tid < K) tot[tid] = prefix(ls, cs, nullptr, lk, L, tid);
    for (int kk = K + tid; kk < kp; kk += kThreads) tot[kk] = 0.f;
    __syncthreads();

    // 2a. warps: D's lower tiles, then A^T's anchored blocks.
    {
      int task = 0;
      for (int a = 0; a < nb; ++a)
        for (int q0 = 0; q0 < 2 * a + 2; q0 += 4, ++task) {
          if (task % kWarps != warp) continue;
          const int nt = min(4, 2 * a + 2 - q0);
          float acc[4][4] = {};
          for (int k0 = 0; k0 < kp; k0 += 8) {
            const FragA fa = frag_a2<false>(
                [&](int i, int c) { return Y.at2(i, c); }, 16 * a, k0);
            FragB fb[4];
#pragma unroll
            for (int q = 0; q < 4; ++q)
              if (q < nt)
                fb[q] = frag_b2<kBF>(
                    [&](int j, int c) { return V.at2(j, c); }, k0,
                    8 * (q0 + q));
            mma3_row<false, kBF, 4>(acc, fa, fb, nt);
          }
#pragma unroll
          for (int q = 0; q < 4; ++q)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int i = 16 * a + g + 8 * (e >> 1);
              const int j = 8 * (q0 + q) + 2 * t4 + (e & 1);
              if (q < nt && j <= i) mat[i * la + j] = acc[q][e];
            }
        }
      // A^T rows j in block jb, columns i in block a (> jb): k^(a) r^(a)^T.
      for (int a = 1; a < nb; ++a)
        for (int jb = 0; jb < a; ++jb, ++task) {
          if (task % kWarps != warp) continue;
          float acc[2][4] = {};
          for (int k0 = 0; k0 < kp; k0 += 8) {
            const FragA fa = frag_a2<false>(
                [&](int j, int c) { return khat2(16 * a, j, c); }, 16 * jb,
                k0);
            const FragB fb[2] = {
                frag_b2<false>(
                    [&](int i, int c) { return rhat2(16 * a, i, c); }, k0,
                    16 * a),
                frag_b2<false>(
                    [&](int i, int c) { return rhat2(16 * a, i, c); }, k0,
                    16 * a + 8)};
            mma3_row<false, false, 2>(acc, fa, fb, 2);
          }
#pragma unroll
          for (int q = 0; q < 2; ++q)
#pragma unroll
            for (int hr = 0; hr < 2; ++hr) {
              const int j = 16 * jb + g + 8 * hr, i = 16 * a + 8 * q + 2 * t4;
              *reinterpret_cast<float2*>(mat + j * la + i) =
                  make_float2(acc[q][2 * hr], acc[q][2 * hr + 1]);
            }
        }
    }
    // 2b. threads: A^T on the diagonal blocks (i, j in one block, j < i)
    // with the exact gates exp(cwe_i - cwi_j), and the bonus; a tile's
    // channel quads split over the lanes of an aligned group, summed by
    // shuffles.  First the six 4 x 4 tiles below the diagonal tiles of each
    // block (wo lanes a tile, every wo-th quad a lane), then the four
    // diagonal tiles (w lanes, a quad each: six live pairs and the bonus of
    // their rows).  Every thread runs every round, so each shuffle finds
    // the whole warp.
    {
      const int w = diag_lanes(kp), kq = kp / 4, n_off = 6 * nb;
      const int wo = w > 1 ? w / 2 : 1;
      for (int base = 0; base < n_off * wo; base += kThreads) {
        const int ux = base + tid, q = ux & (wo - 1), tt = ux / wo;
        const bool live = tt < n_off;
        int i0 = 0, j0 = 0;
        float acc[4][4] = {};
        if (live) {
          int ti, tj;
          tile4::lower_tile(tt % 6, ti, tj);  // strictly lower: (ti + 1, tj)
          i0 = 16 * (tt / 6) + 4 * (ti + 1);
          j0 = 16 * (tt / 6) + 4 * tj;
          for (int c0 = 4 * q; c0 < kp; c0 += 4 * wo) {
            float4 ri[4], ci[4];
#pragma unroll
            for (int rr = 0; rr < 4; ++rr) {
              ri[rr] = ld4(rs + (i0 + rr) * lt + c0);
              ci[rr] = tile4::ld4(cs + (i0 + rr) * lk + c0);
            }
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const float4 kj = ld4(ks + (j0 + c) * lt + c0);
              const float4 dj = ld_d<true>(cs, ls, (j0 + c) * lk + c0);
#pragma unroll
              for (int rr = 0; rr < 4; ++rr)
#pragma unroll
                for (int e = 0; e < 4; ++e)
                  acc[rr][c] = fmaf(
                      tile4::at(ri[rr], e) * tile4::at(kj, e),
                      gate(tile4::at(ci[rr], e) - tile4::at(dj, e)),
                      acc[rr][c]);
            }
          }
        }
        for (int off = wo / 2; off > 0; off /= 2)
#pragma unroll
          for (int rr = 0; rr < 4; ++rr)
#pragma unroll
            for (int c = 0; c < 4; ++c)
              acc[rr][c] += __shfl_xor_sync(0xffffffffu, acc[rr][c], off);
#pragma unroll
        for (int c = 0; c < 4; ++c)  // A^T row j0 + c, by one lane each
          if (live && (c & (wo - 1)) == q)
            tile4::st4(mat + (j0 + c) * la + i0,
                       make_float4(acc[0][c], acc[1][c], acc[2][c],
                                   acc[3][c]));
      }
      for (int base = 0; base < 4 * nb * w; base += kThreads) {
        const int ux = base + tid, q = ux & (w - 1), tt = ux / w;
        const bool live = tt < 4 * nb && q < kq;
        const int c0 = 4 * q, i0 = 4 * tt;
        // pairs (1,0) (2,0) (2,1) (3,0) (3,1) (3,2)
        float acc[6] = {}, b[4] = {};
        if (live) {
          float4 ri[4], kj[4], ci[4], dj[3];
          const float4 uq = c0 < K ? tile4::ld4(uh + c0)
                                   : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
          for (int rr = 0; rr < 4; ++rr) {
            ri[rr] = ld4(rs + (i0 + rr) * lt + c0);
            kj[rr] = ld4(ks + (i0 + rr) * lt + c0);
          }
#pragma unroll
          for (int rr = 1; rr < 4; ++rr)
            ci[rr] = tile4::ld4(cs + (i0 + rr) * lk + c0);
#pragma unroll
          for (int c = 0; c < 3; ++c)
            dj[c] = ld_d<true>(cs, ls, (i0 + c) * lk + c0);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
#pragma unroll
            for (int rr = 0; rr < 4; ++rr)
              b[rr] = fmaf(tile4::at(ri[rr], e) * tile4::at(uq, e),
                           tile4::at(kj[rr], e), b[rr]);
            int n = 0;
#pragma unroll
            for (int rr = 1; rr < 4; ++rr)
#pragma unroll
              for (int c = 0; c < rr; ++c, ++n)
                acc[n] = fmaf(
                    tile4::at(ri[rr], e) * tile4::at(kj[c], e),
                    gate(tile4::at(ci[rr], e) - tile4::at(dj[c], e)),
                    acc[n]);
          }
        }
        for (int off = w / 2; off > 0; off /= 2) {
#pragma unroll
          for (int n = 0; n < 6; ++n)
            acc[n] += __shfl_xor_sync(0xffffffffu, acc[n], off);
#pragma unroll
          for (int rr = 0; rr < 4; ++rr)
            b[rr] += __shfl_xor_sync(0xffffffffu, b[rr], off);
        }
        if (live && q == 0) {  // A^T above the tile's diagonal: (j, i), j < i
          float* m = mat + i0 * la + i0;
          m[1] = acc[0];
          m[2] = acc[1];
          m[3] = acc[3];
          m[la + 2] = acc[2];
          m[la + 3] = acc[4];
          m[2 * la + 3] = acc[5];
          tile4::st4(bonus + i0, make_float4(b[0], b[1], b[2], b[3]));
        }
      }
    }
    __syncthreads();

    // 3. P and Q of rows [m0, m0 + 16) and channels [c0, c0 + 8); dr, dk and
    // dlw out; the block's sums of r P - k Q and of r k D_ii added to the
    // lane's running sums of its channels (lat, dua: the later blocks'
    // sums, du's partial).
    // S', the state leaving the chunk: the next one's s_in, or sf.
    const Mat SO{blk.ci + 1 < nc ? s_in + kk_off + (long long)H * K * K
                                 : sf + ((long long)blk.bi * H + h) * K * K,
                 K, K, K, true};
    auto pq_unit = [&](int a, int c0, float (&lat)[2], float (&dua)[2],
                       float (&glc)[2]) {
      const int m0 = 16 * a, an = m0 + 16, cc = c0 + 2 * t4;
      const bool first = a == nb - 1;  // the tile's first block: <dS', S'>
      float pst[4] = {}, qst[4] = {}, pan[4] = {}, qan[4] = {}, glp = 0.f;
      // The state terms, S dy_i (P) and dS' v_j (Q), in kp / 8 steps, and
      // the anchored ones, sum_{j < m0} D_ij k^(m0)_j (P) then sum_{i >= an}
      // D_ij r^(an)_i (Q), in nb - 1 steps of 16: interleaved, so a step's
      // chains of products overlap; S (in device memory where not staged)
      // is read two steps ahead.  In the tile's first block the same loads
      // of dS' give <dS'_k, S'_k> (S' read ahead too): lane (g, t)
      // sums channel c0 + g's products at its columns, then the lanes of
      // the channel are summed by shuffles.
      const int n_st = kp / 8, n_pa = m0 / 8, n_an = (lp - 16) / 8;
      const float2 zero2 = make_float2(0.f, 0.f);
      float2 s_n1 = SS.at2(c0 + g, 2 * t4), o_n1 = zero2;
      float2 s_n2 = n_st > 1 ? SS.at2(c0 + g, 8 + 2 * t4) : zero2, o_n2 = zero2;
      if (first) {
        o_n1 = SO.at2(c0 + g, 2 * t4);
        if (n_st > 1) o_n2 = SO.at2(c0 + g, 8 + 2 * t4);
      }
      for (int s = 0; s < n_st || s < n_an; ++s) {
        if (s < n_st) {  // S (and S') two steps ahead
          const int k0 = 8 * s;
          const float2 s_cur = s_n1, o_cur = o_n1;
          s_n1 = s_n2;
          o_n1 = o_n2;
          if (s + 2 < n_st) {
            s_n2 = SS.at2(c0 + g, k0 + 16 + 2 * t4);
            if (first) o_n2 = SO.at2(c0 + g, k0 + 16 + 2 * t4);
          }
          const FragA fy = frag_a2<false>(
              [&](int i, int c) { return Y.at2(i, c); }, m0, k0);
          const FragA fv = frag_a2<kBF>(
              [&](int j, int c) { return V.at2(j, c); }, m0, k0);
          const float2 g2 = GS.at2(c0 + g, k0 + 2 * t4);
          const FragB fs = split_b<false>(s_cur.x, s_cur.y);
          const FragB fg = split_b<false>(g2.x, g2.y);
          mma3<false, false>(pst, fy, fs);
          mma3<kBF, false>(qst, fv, fg);
          if (first) glp = fmaf(g2.y, o_cur.y, fmaf(g2.x, o_cur.x, glp));
        }
        if (s < n_pa) {
          const int k0 = 8 * s;
          const FragA fd = frag_a2<false>(
              [&](int i, int j) { return ld2(mat + i * la + j); }, m0, k0);
          const FragB fk = frag_b<false>(
              [&](int j, int c) { return khat(m0, j, c); }, k0, c0);
          mma3<false, false>(pan, fd, fk);
        } else if (s < n_an) {
          const int k0 = an + 8 * (s - n_pa);
          const FragA fd = frag_a<false>(
              [&](int j, int i) { return mat[i * la + j]; }, m0, k0);
          const FragB fr = frag_b<false>(
              [&](int i, int c) { return rhat(an, i, c); }, k0, c0);
          mma3<false, false>(qan, fd, fr);
        }
      }
      if (first) {  // channel c0 + g's sum, then channels cc and cc + 1's
        glp += __shfl_xor_sync(0xffffffffu, glp, 1);
        glp += __shfl_xor_sync(0xffffffffu, glp, 2);
        glc[0] = __shfl_sync(0xffffffffu, glp, 8 * t4);
        glc[1] = __shfl_sync(0xffffffffu, glp, 8 * t4 + 4);
      }
      // The diagonal block with the exact gates, each pair's gate taken
      // once.  The lane owns rows o = g and g + 8 of the block.  For d = 1
      // ... 7 row o meets row x = (o - d) mod 16: x < o gives P_o += D_ox k_x
      // G_ox here and Q_x += D_ox r_o G_ox at x's lane, x > o (wrapped) Q_o
      // += D_xo r_x G_xo here and P_x += D_xo k_o G_xo at x's lane; x's lane
      // is lane g - d (mod 8) of the same channels either way, so one
      // shuffle a row and channel carries it.  d = 8 pairs the lane's own
      // rows.  Each lane takes 15 pairs a row and channel.
      float pd[4] = {}, qd[4] = {};
      float oc[2][2], ow[2][2], od[2][2], ok[2][2], orv[2][2];
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int o = m0 + g + 8 * hr;
        const float2 c2 = ld2(cs + o * lk + cc), w2 = ld2(ls + o * lk + cc);
        const float2 k2 = ld2(ks + o * lt + cc), r2 = ld2(rs + o * lt + cc);
        oc[hr][0] = c2.x, oc[hr][1] = c2.y, ow[hr][0] = w2.x, ow[hr][1] = w2.y;
        od[hr][0] = c2.x + w2.x, od[hr][1] = c2.y + w2.y;
        ok[hr][0] = k2.x, ok[hr][1] = k2.y, orv[hr][0] = r2.x, orv[hr][1] = r2.y;
      }
#pragma unroll
      for (int d = 1; d < 8; ++d) {
        float send[2][2];
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int o = g + 8 * hr;
          const bool wrap = o < d;
          const int xr = m0 + (wrap ? o - d + 16 : o - d);
          const float2 c2 = ld2(cs + xr * lk + cc),
                       w2 = ld2(ls + xr * lk + cc);
          const float2 k2 = ld2(ks + xr * lt + cc),
                       r2 = ld2(rs + xr * lt + cc);
          const float dx = wrap ? mat[xr * la + m0 + o]
                                : mat[(m0 + o) * la + xr];
          const float xc[2] = {c2.x, c2.y},
                      xd[2] = {c2.x + w2.x, c2.y + w2.y},
                      xk[2] = {k2.x, k2.y}, xv[2] = {r2.x, r2.y};
#pragma unroll
          for (int s = 0; s < 2; ++s) {
            const float gt =
                gate(wrap ? xc[s] - od[hr][s] : oc[hr][s] - xd[s]);
            if (wrap)
              qd[2 * hr + s] = fmaf(dx * xv[s], gt, qd[2 * hr + s]);
            else
              pd[2 * hr + s] = fmaf(dx * xk[s], gt, pd[2 * hr + s]);
            send[hr][s] = dx * gt * (wrap ? ok[hr][s] : orv[hr][s]);
          }
        }
        // From lane g + d (mod 8): its row g + d goes to this lane's row g
        // (a Q term) or, wrapped, to row g + 8 (a P term); its row g + d + 8
        // to row g + 8 or, wrapped, to row g (Q terms).
        const int src = 4 * ((g + d) & 7) + t4;
        const bool flat = g + d < 8;
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          const float v0 = __shfl_sync(0xffffffffu, send[0][s], src);
          const float v1 = __shfl_sync(0xffffffffu, send[1][s], src);
          if (flat) {
            qd[s] += v0;
            qd[2 + s] += v1;
          } else {
            pd[2 + s] += v0;
            qd[s] += v1;
          }
        }
      }
      {  // d = 8: rows g + 8 and g
        const float dx = mat[(m0 + g + 8) * la + m0 + g];
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          const float gt = gate(oc[1][s] - od[0][s]);
          pd[2 + s] = fmaf(dx * ok[0][s], gt, pd[2 + s]);
          qd[s] = fmaf(dx * orv[1][s], gt, qd[s]);
        }
      }
      // P, Q; dr, dk; dlw's terms r P - k Q and du's r k D_ii.
      const float2 tt = ld2(tot + cc), ca = ld2(cs + m0 * lk + cc);
      const float2 cn = an < lp ? ld2(cs + an * lk + cc) : make_float2(0.f, 0.f);
      const float2 rest2 = make_float2(lat[0] + glc[0], lat[1] + glc[1]);
      const float2 uu = cc < K ? make_float2(uh[cc], uh[cc + 1])
                               : make_float2(0.f, 0.f);
      const float tv[2] = {tt.x, tt.y}, cav[2] = {ca.x, ca.y},
                  cnv[2] = {cn.x, cn.y}, uv[2] = {uu.x, uu.y},
                  rest[2] = {rest2.x, rest2.y};
      float pr[4], qr[4], wv[4], fv[4], du[4];
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int i = m0 + g + 8 * hr;
        const float dd = mat[i * la + i];
        float xk[2];
#pragma unroll
        for (int s = 0; s < 2; ++s) {  // the row's values kept from above
          const int e = 2 * hr + s;
          const float cv = oc[hr][s], kv = ok[hr][s], rv = orv[hr][s];
          float p = exp_fast(cv) * pst[e] + pd[e];
          if (m0 > 0) p += gate(cv - cav[s]) * pan[e];
          const float carry = exp_fast((tv[s] - cv) - ow[hr][s]);
          float qv = carry * qst[e] + qd[e];
          if (an < lp) qv += gate(cnv[s] - od[hr][s]) * qan[e];
          xk[s] = carry * kv;
          const float bo = uv[s] * dd;
          pr[e] = p + bo * kv;
          qr[e] = qv + bo * rv;
          fv[e] = -kv * qv;
          wv[e] = rv * p + fv[e];
          du[e] = rv * kv * dd;
        }
        // exp(cwl - cwe - lw) k over lw, for dv: this warp reads no more
        // of lw's rows of this block at these channels, no other warp any.
        __syncwarp();
        st2(ls + i * lk + cc, xk[0], xk[1]);
      }
      // dlw_m = <dS', S'> + f_m + sum over the later rows of w: the lanes of
      // a channel are g = 0..7, each with rows g and g + 8; suffix sums by
      // shuffles, then the later blocks' total.
      float dl[4], blk_w[2], blk_du[2];
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        float lo = wv[s], hi = wv[2 + s];
#pragma unroll
        for (int d = 1; d < 8; d *= 2) {
          const float ylo = __shfl_down_sync(0xffffffffu, lo, 4 * d);
          const float yhi = __shfl_down_sync(0xffffffffu, hi, 4 * d);
          if (g + d < 8) {
            lo += ylo;
            hi += yhi;
          }
        }
        const float hi_all = __shfl_sync(0xffffffffu, hi, t4);
        const float lo_all = __shfl_sync(0xffffffffu, lo, t4);
        float ex_lo = __shfl_down_sync(0xffffffffu, lo, 4);
        float ex_hi = __shfl_down_sync(0xffffffffu, hi, 4);
        if (g == 7) ex_lo = ex_hi = 0.f;
        dl[s] = (fv[s] + (ex_lo + hi_all)) + rest[s];
        dl[2 + s] = (fv[2 + s] + ex_hi) + rest[s];
        blk_w[s] = lo_all + hi_all;
        float x = du[s] + du[2 + s];
#pragma unroll
        for (int off = 4; off < 32; off *= 2)
          x += __shfl_xor_sync(0xffffffffu, x, off);
        blk_du[s] = x;
      }
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int i = m0 + g + 8 * hr;
        if (i < L && cc < K) {
          const long long o = gh + (long long)i * row + cc;
          st2(dr + o, pr[2 * hr], pr[2 * hr + 1]);
          st2(dk + o, qr[2 * hr], qr[2 * hr + 1]);
          st2(dlw + o, dl[2 * hr], dl[2 * hr + 1]);
        }
      }
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        lat[s] += blk_w[s];
        dua[s] += blk_du[s];
      }
    };
    // dv of rows [m0, m0 + 16), value columns [8 q0, 8 q0 + 8 nt):
    // (exp(cwl - cwe - lw) k) dS' + A^T dy + bonus dy.
    auto dv_unit = [&](int m0, int q0, int nt) {
      float acc[4][4] = {};
      for (int k0 = 0; k0 < kp; k0 += 8) {
        const FragA fx = frag_a2<false>(
            [&](int j, int c) { return ld2(ls + j * lk + c); }, m0, k0);
        FragB fb[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (q < nt)
            fb[q] = frag_b<false>([&](int c, int n) { return GS.at(c, n); },
                                  k0, 8 * (q0 + q));
        mma3_row<false, false, 4>(acc, fx, fb, nt);
      }
      for (int k0 = m0; k0 < lp; k0 += 8) {
        const FragA fa = frag_a2<false>(
            [&](int j, int i) {
              const float2 m2 = ld2(mat + j * la + i);
              return make_float2(i > j ? m2.x : 0.f, i + 1 > j ? m2.y : 0.f);
            },
            m0, k0);
        FragB fb[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (q < nt)
            fb[q] = frag_b<false>([&](int i, int n) { return Y.at(i, n); },
                                  k0, 8 * (q0 + q));
        mma3_row<false, false, 4>(acc, fa, fb, nt);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int j = m0 + g + 8 * hr, c = 8 * (q0 + q) + 2 * t4;
          if (q < nt && j < L && c < K) {
            const float b = bonus[j];
            const float2 y2 = Y.at2(j, c);
            st2(dv + gh + (long long)j * row + c, acc[q][2 * hr] + b * y2.x,
                acc[q][2 * hr + 1] + b * y2.y);
          }
        }
    };
    // A warp takes a channel tile's row blocks from the last to the first
    // (nothing is shared between channel tiles), then dv, the blocks with
    // the longest A^T dy first.
    for (int task = warp; task < nk; task += kWarps) {
      float lat[2] = {}, dua[2] = {}, glc[2];
      for (int a = nb - 1; a >= 0; --a) pq_unit(a, 8 * task, lat, dua, glc);
      const int cc = 8 * task + 2 * t4;
      if (g == 0 && cc < K) {  // du's partial of the chunk
        du_part[unit * K + cc] = dua[0];
        du_part[unit * K + cc + 1] = dua[1];
      }
    }
    __syncthreads();  // lw's buffer holds exp(cwl - cwe - lw) k
    const int nq4 = (nk + 3) / 4;
    for (int d = warp; d < nb * nq4; d += kWarps) {
      const int q0 = 4 * (d % nq4);
      dv_unit(16 * (d / nq4), q0, min(4, nk - q0));
    }
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
size_t dstate_smem(int K, int L) {
  const size_t lp = (L + 15) / 16 * 16, kp = (K + 7) / 8 * 8,
               km = (K + 15) / 16 * 16;
  return sizeof(T) * lp * (kp + per16<T>()) + sizeof(float) * 3 * lp * (km + 8);
}

template <typename T>
cudaError_t chunk_dstate(const void* r, const void* lw, const void* dy,
                         void* q, int B, int S, int H, int K, int L,
                         cudaStream_t stream) {
  auto kernel = wkv_chunk_dstate_kernel<T>;
  const size_t smem = dstate_smem<T>(K, L);
  if (smem > kMaxSmem) return cudaErrorInvalidConfiguration;
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
  const BwdLayout ly = bwd_layout<T>(K, L);
  if (ly.bytes > (long long)kMaxSmem) return cudaErrorInvalidConfiguration;
  int per_sm = 0;
  cudaError_t e = prepare(kernel, (size_t)ly.bytes, &per_sm);
  if (e != cudaSuccess) return e;
  const int hpb = heads_per_block(B, S / L, H, per_sm, 0.0);
  kernel<<<dim3(B * (S / L), (H + hpb - 1) / hpb), kThreads, (size_t)ly.bytes,
           stream>>>(
      (const T*)r, (const T*)k, (const T*)v, (const float*)lw,
      (const float*)u, (const float*)dy, (const float*)s_in, (const float*)sf,
      (const float*)gs, (T*)dr, (T*)dk, (T*)dv, (float*)dlw, (float*)du_part,
      S, H, K, L, hpb, ly);
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
// 1 bfloat16), and in out[0..5] whether it stages dy, dS' and S, the
// blocks an SM its budget is for, whether its rows are padded and whether
// it stages v (ops.bwd_layout mirrors it).  Launches nothing.
extern "C" long long wkv6_chunk_bwd_smem(int K, int L, int dtype, int* out) {
  const BwdLayout ly = dtype == 1 ? bwd_layout<__nv_bfloat16>(K, L)
                                  : bwd_layout<float>(K, L);
  out[0] = ly.dy;
  out[1] = ly.gs;
  out[2] = ly.s;
  out[3] = ly.blocks;
  out[4] = ly.pad;
  out[5] = ly.vs;
  return ly.bytes;
}
