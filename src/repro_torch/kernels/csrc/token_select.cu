// token_select: the statistical-token worker draw for every server row.
//
// Replaces the TPU kernel repro/kernels/token_select/kernel.py
// (token_select_pallas / _token_select_kernel).
//
//   shares f32 or bf16 [S, J], qcount i32[S, J], u f32[S, W]
//     -> out i32[S, W]
//
// Per row: mask shares by qcount > 0, renormalise, fall back to uniform over
// demanded slots when massless, inclusive prefix sum, then for each of the W
// draws count the segment ends <= u, clip to J, -1 when the row has no mass,
// and snap an undemanded pick to the first demanded slot (draw.cuh; bf16
// shares in the reference's bf16 arithmetic, with a per-warp shared-memory
// scratch of draw.cuh bf16_floats).
//
// Bound on the H100 at S=128, J=1024, W=1: it reads qcount, the shares of
// the demanded slots and u, and writes the picks, ~0.7 MB, 0.216 us at
// 3.35 TB/s; its arithmetic is a few ops per slot.  What holds it is
// latency: one draw is a chain of dependent reductions over the row.
// Design: one warp per row (kRows rows per block), the row's run of slots
// in each lane's registers (J <= 1024, loaded once with 16-byte loads) or in
// a per-warp shared-memory slab, every reduction a warp shuffle or a
// redux.sync, no block barrier.
#include "draw.cuh"

namespace {

// Rows (warps) per block: one measured fastest of 1, 2 and 4
// (tools/probe_kernel_builds.py), as it spreads the 128 rows of the fleet
// over the most SMs.
constexpr int kRows = 1;
constexpr int kSlabArrays = 2;

template <class T>
constexpr bool kBf16 = std::is_same_v<T, __nv_bfloat16>;

// Floats of shared memory per warp: the slab (J > 1024) and the bf16
// scratch.
template <int C, class T>
__host__ __device__ constexpr size_t warp_floats(int J) {
  return (C == 0 ? rt::slab_bytes(J, kSlabArrays) / 4 : 0) +
         (kBf16<T> ? rt::bf16_floats(J, C == 0) : 0);
}

template <class R, class T>
__device__ __forceinline__ void select_row(R& r, const rt::Span& sp,
                                           const T* sh, const int* q,
                                           const float* u, int* out, int W,
                                           const rt::Bf16Scratch& scratch) {
  rt::load_run<R>(sp, q, [&](int k, int l) -> int& { return r.Q(k, l); });
  rt::load_run<R>(sp, sh, [&](int k, int l) -> float& { return r.A(k, l); });
  const rt::PerDraw<float> uw(u, W, sp.lane);
  const bool fast = !kBf16<T> && rt::shares_in_range(r, sp);
  const rt::Table t = rt::build_table_of<T>(r, sp, fast, scratch);
  for (int w = 0; w < W; ++w) {
    const int idx = rt::draw(r, sp, t, uw(w));
    if (sp.lane == 0) out[w] = idx;
  }
}

template <int C, class T>
__global__ void __launch_bounds__(32 * kRows)
token_select_kernel(const T* __restrict__ shares,
                    const int* __restrict__ qcount,
                    const float* __restrict__ u, int* __restrict__ out, int S,
                    int J, int W) {
  const int warp = threadIdx.x >> 5;
  const size_t row = (size_t)blockIdx.x * (blockDim.x >> 5) + warp;
  if (row >= (size_t)S) return;
  const rt::Span sp(J);
  const T* sh = shares + row * J;
  const int* q = qcount + row * J;
  extern __shared__ float4 smem_raw[];
  float* base =
      reinterpret_cast<float*>(smem_raw) + warp * warp_floats<C, T>(J);
  if constexpr (C > 0) {
    rt::Regs<C> r;
    const rt::Bf16Scratch scratch{base, base + 32 * sp.c};
    select_row(r, sp, sh, q, u + row * W, out + row * W, W, scratch);
  } else {
    const size_t len = rt::slab_bytes(J, kSlabArrays) / 4 / kSlabArrays;
    // The segments overwrite the shares slot by slot (read, then written).
    rt::Slab r{base, base, reinterpret_cast<int*>(base + len), nullptr,
               sp.lane};
    const rt::Bf16Scratch scratch{nullptr, base + kSlabArrays * len};
    select_row(r, sp, sh, q, u + row * W, out + row * W, W, scratch);
  }
}

template <int C, class T>
int launch(const T* shares, const int* qcount, const float* u, int* out,
           int S, int J, int W, cudaStream_t stream) {
  int rows = kRows;
  size_t smem = 0;
  const size_t per = warp_floats<C, T>(J) * 4;
  if (per > 0) {
    const size_t fit = (size_t)232448 / per;
    rows = fit < (size_t)kRows ? (int)fit : kRows;
    if (rows < 1) return (int)cudaErrorInvalidValue;
    smem = per * rows;
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(
          token_select_kernel<C, T>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
  }
  token_select_kernel<C, T><<<(S + rows - 1) / rows, 32 * rows, smem,
                              stream>>>(shares, qcount, u, out, S, J, W);
  return (int)cudaGetLastError();
}

template <class T>
int launch_for(const void* shares, const int* qcount, const float* u,
               int* out, int S, int J, int W, cudaStream_t stream) {
  const T* sh = static_cast<const T*>(shares);
  const int c = (J + 31) / 32;
  if (c <= 4) return launch<4>(sh, qcount, u, out, S, J, W, stream);
  if (c <= 8) return launch<8>(sh, qcount, u, out, S, J, W, stream);
  if (c <= 16) return launch<16>(sh, qcount, u, out, S, J, W, stream);
  if (c <= 32) return launch<32>(sh, qcount, u, out, S, J, W, stream);
  return launch<0>(sh, qcount, u, out, S, J, W, stream);
}

}  // namespace

// dtype: 0 float32 shares, 1 bfloat16 shares.
extern "C" int token_select_launch(const void* shares, const int* qcount,
                                   const float* u, int* out, int S, int J,
                                   int W, int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1)
    return launch_for<__nv_bfloat16>(shares, qcount, u, out, S, J, W, st);
  return launch_for<float>(shares, qcount, u, out, S, J, W, st);
}
