// tick_step: the whole W-worker phase of one engine tick, for every server.
//
// Replaces the TPU kernel repro/kernels/tick_step/kernel.py
// (tick_step_pallas / _tick_step_kernel / _themis_draw).
//
//   shares f32[S, J], qcount i32[S, J], window f32[S, J, W], free u8[S, W],
//   u f32[S, W]  ->  sel i32[S, W], valid u8[S, W], demand_any u8[S, W],
//                    qcount_out i32[S, J], pops i32[S, J]
//
// For w = 0..W-1 in order, each server draws one job on its live queue
// counts, and a free worker pops it:
//   themis  the statistical-token draw of draw.cuh (the same code as
//           token_select, so the fused and per-worker engine paths pick
//           identically);
//   fifo    the earliest stamp window[s, j, pops[j]] over demanded j, ties
//           to the lowest j (jnp.argmin's first-index rule).
//
// Bound on the H100 at S=128, J=1024, W=4: it must read qcount (0.5 MiB)
// and free, write qcount_out and pops (1 MiB) and the [S, W] outputs, and
// in themis mode read the shares of the demanded slots (at most 0.5 MiB)
// and u, in fifo mode one stamp per demanded slot and pop (never the whole
// 2 MiB window): ~2 MiB, ~0.6 us at 3.35 TB/s.  The draws' arithmetic is
// far below the fp32 peak, so the kernel is bound by memory and by the
// latency of W sequential rounds of block-wide reductions.  Design: one 256-thread block per server makes a single pass
// over its row; qcount and pops live in shared memory (2*J*4 B = 8 KiB at
// J = 1024) across the W draws, beside the J prefix sums of the draw, and
// only the final counts go back to device memory.
#include "draw.cuh"

namespace {

constexpr int kThemis = 0;

__global__ void __launch_bounds__(rt::kThreads)
tick_step_kernel(const float* __restrict__ shares,
                 const int* __restrict__ qcount,
                 const float* __restrict__ window,
                 const unsigned char* __restrict__ free_,
                 const float* __restrict__ u, int* __restrict__ sel,
                 unsigned char* __restrict__ valid,
                 unsigned char* __restrict__ demand_any,
                 int* __restrict__ qcount_out, int* __restrict__ pops_out,
                 int J, int W, int mode) {
  extern __shared__ int smem[];
  int* q = smem;
  int* pops = smem + J;
  float* seg = reinterpret_cast<float*>(smem + 2 * J);
  __shared__ float fscr[rt::kWarps + 1];
  __shared__ int iscr[rt::kWarps + 1];
  const rt::Scratch sc{fscr, iscr};
  const size_t row = blockIdx.x;
  const float* sh = shares + row * J;
  const float* win = window + row * J * W;

  for (int j = threadIdx.x; j < J; j += rt::kThreads) {
    q[j] = qcount[row * J + j];
    pops[j] = 0;
  }
  __syncthreads();

  for (int w = 0; w < W; ++w) {
    const int first = rt::first_demanded(q, J, sc);
    const bool any = first != INT_MAX;
    int pick;
    if (mode == kThemis) {
      const float total = rt::themis_segments(sh, q, J, seg, sc);
      pick = rt::themis_pick(seg, q, J, total, first, u[row * W + w], sc);
    } else {
      float best = CUDART_INF_F;
      int best_j = INT_MAX;
      for (int j = threadIdx.x; j < J; j += rt::kThreads) {
        const float h = q[j] > 0 ? win[(size_t)j * W + pops[j]] : CUDART_INF_F;
        if (rt::argmin_less(h, j, best, best_j)) { best = h; best_j = j; }
      }
      const int j_min = rt::block_argmin(best, best_j, sc);
      pick = any ? j_min : -1;
    }
    const bool ok = free_[row * W + w] != 0 && pick >= 0;
    __syncthreads();  // every thread has read q/pops for this draw
    if (threadIdx.x == 0) {
      sel[row * W + w] = pick;
      valid[row * W + w] = ok;
      demand_any[row * W + w] = any;
      if (ok) {
        q[pick] -= 1;
        pops[pick] += 1;
      }
    }
    __syncthreads();
  }

  for (int j = threadIdx.x; j < J; j += rt::kThreads) {
    qcount_out[row * J + j] = q[j];
    pops_out[row * J + j] = pops[j];
  }
}

}  // namespace

extern "C" int tick_step_launch(const float* shares, const int* qcount,
                                const float* window, const unsigned char* free_,
                                const float* u, int* sel, unsigned char* valid,
                                unsigned char* demand_any, int* qcount_out,
                                int* pops, int S, int J, int W, int mode,
                                void* stream) {
  const size_t smem = (size_t)J * (2 * sizeof(int) + sizeof(float));
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        tick_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  tick_step_kernel<<<S, rt::kThreads, smem, (cudaStream_t)stream>>>(
      shares, qcount, window, free_, u, sel, valid, demand_any, qcount_out,
      pops, J, W, mode);
  return (int)cudaGetLastError();
}
