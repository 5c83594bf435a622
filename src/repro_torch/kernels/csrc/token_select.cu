// token_select: the statistical-token worker draw for every server row.
//
// Replaces the TPU kernel repro/kernels/token_select/kernel.py
// (token_select_pallas / _token_select_kernel).
//
//   shares f32[S, J], qcount i32[S, J], u f32[S, W] -> out i32[S, W]
//
// Per row: mask shares by qcount > 0, renormalise, fall back to uniform over
// demanded slots when massless, inclusive prefix sum, then for each of the W
// draws count the segment ends <= u, clip to J, -1 when the row has no mass,
// and snap an undemanded pick to the first demanded slot (draw.cuh).
//
// Bound on the H100 at S=128, J=1024, W=4: it reads qcount, the shares of
// the demanded slots (at most 1 MiB together) and u, writes 2 KiB; at
// 3.35 TB/s that is at most ~0.3 us, and the
// arithmetic (a few ops per slot per draw) is far below the fp32 peak, so the
// kernel is bound by memory and, at one block per row, by the latency of its
// block-wide reductions.  Design: one 256-thread block per row reads the row
// once, keeps the prefix sums in shared memory and answers all W draws from
// them.
#include "draw.cuh"

namespace {

__global__ void __launch_bounds__(rt::kThreads)
token_select_kernel(const float* __restrict__ shares,
                    const int* __restrict__ qcount,
                    const float* __restrict__ u, int* __restrict__ out,
                    int J, int W) {
  extern __shared__ float seg[];
  __shared__ float fscr[rt::kWarps + 1];
  __shared__ int iscr[rt::kWarps + 1];
  const rt::Scratch sc{fscr, iscr};
  const size_t row = blockIdx.x;
  const float* sh = shares + row * J;
  const int* q = qcount + row * J;

  const int first = rt::first_demanded(q, J, sc);
  const float total = rt::themis_segments(sh, q, J, seg, sc);
  for (int w = 0; w < W; ++w) {
    const int idx = rt::themis_pick(seg, q, J, total, first, u[row * W + w], sc);
    if (threadIdx.x == 0) out[row * W + w] = idx;
  }
}

}  // namespace

extern "C" int token_select_launch(const float* shares, const int* qcount,
                                   const float* u, int* out, int S, int J,
                                   int W, void* stream) {
  const size_t smem = (size_t)J * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        token_select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  token_select_kernel<<<S, rt::kThreads, smem, (cudaStream_t)stream>>>(
      shares, qcount, u, out, J, W);
  return (int)cudaGetLastError();
}
