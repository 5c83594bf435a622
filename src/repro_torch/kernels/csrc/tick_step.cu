// tick_step: the whole W-worker phase of one engine tick, for every server.
//
// Replaces the TPU kernel repro/kernels/tick_step/kernel.py
// (tick_step_pallas / _tick_step_kernel / _themis_draw).
//
//   shares f32 or bf16 [S, J], qcount i32[S, J], window f32[S, J, W],
//   free u8[S, W], u f32[S, W]
//     ->  sel i32[S, W], valid u8[S, W], demand_any u8[S, W],
//         qcount_out i32[S, J], pops i32[S, J]
//
// For w = 0..W-1 in order, each server draws one job on its live queue
// counts, and a free worker pops it:
//   themis  the statistical-token draw of draw.cuh (the same code as
//           token_select, so the fused and per-worker engine paths pick
//           identically);
//   fifo    the earliest stamp window[s, j, pops[j]] over demanded j, ties
//           to the lowest j (jnp.argmin's first-index rule).
//
// Bound on the H100 at S=128, J=1024, W=4: it must read qcount and free,
// write qcount_out and pops and the [S, W] outputs, and in themis mode read
// the shares of the demanded slots and u, in fifo mode one stamp per
// demanded slot and pop (never the whole window): ~1.8 MB, 0.530 us at
// 3.35 TB/s.  The arithmetic is far below the fp32 peak; what holds it is
// the latency of W dependent draws.  Design: one warp per server row
// (kRows rows per block), no block barrier.  Each lane keeps its run of
// slots (registers for J <= 1024, else a per-warp shared-memory slab) and
// its queue counts across the W draws; only the final counts go back to
// device memory.  The table is built in the reference's order of sums (and
// with bf16 shares its bf16 arithmetic) over a per-warp shared-memory
// scratch (draw.cuh).  themis builds the segment table once per tick and again
// only when a pop empties a queue (the demand mask, so the table, is
// otherwise unchanged: the rebuild would give the same bits).  fifo keeps
// each slot's head stamp in its lane; after a pop only the owner of the
// popped slot loads that slot's next stamp, and the argmin runs again by
// shuffles.
#include "draw.cuh"

namespace {

// Rows (warps) per block: one measured fastest of 1, 2 and 4
// (tools/probe_kernel_builds.py).
constexpr int kRows = 1;
constexpr int kSlabArrays = 3;
constexpr int kThemis = 0;

// (value, index) arg-min with ties to the lowest index: jnp.argmin's rule.
__device__ __forceinline__ bool argmin_less(float a, int ia, float b,
                                            int ib) {
  return a < b || (a == b && ia < ib);
}

// The earliest head stamp over the row (ties to the lowest slot).  The
// (stamp, slot) pairs are totally ordered, so any reduction order finds the
// same minimum: a register run reduces in four interleaved chains (k mod
// 4), which a single warp issues side by side, then combines them.
template <class R>
__device__ __forceinline__ int fifo_argmin(R& r, const rt::Span& sp) {
  float best = CUDART_INF_F;
  int best_j = INT_MAX;
  if constexpr (R::kC > 0) {
    float v[4] = {best, best, best, best};
    int ix[4] = {best_j, best_j, best_j, best_j};
    RT_EACH(R, sp, k) {
      const bool less = argmin_less(r.A(k), sp.index(k), v[k & 3], ix[k & 3]);
      v[k & 3] = less ? r.A(k) : v[k & 3];
      ix[k & 3] = less ? sp.index(k) : ix[k & 3];
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const bool less = argmin_less(v[c], ix[c], best, best_j);
      best = less ? v[c] : best;
      best_j = less ? ix[c] : best_j;
    }
  } else {
    RT_EACH(R, sp, k) {
      const bool less = argmin_less(r.A(k), sp.index(k), best, best_j);
      best = less ? r.A(k) : best;
      best_j = less ? sp.index(k) : best_j;
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(rt::kFull, best, o);
    const int oi = __shfl_xor_sync(rt::kFull, best_j, o);
    if (argmin_less(ov, oi, best, best_j)) {
      best = ov;
      best_j = oi;
    }
  }
  return best_j;
}

// Floats of shared memory per warp: the slab (J > 1024) and, in themis
// mode, the table's scratch.
template <int C, int MODE>
__host__ __device__ constexpr size_t warp_floats(int J) {
  return (C == 0 ? rt::slab_bytes(J, kSlabArrays) / 4 : 0) +
         (MODE == kThemis ? rt::scratch_floats(J, C == 0) : 0);
}

template <int MODE, class R, class T>
__device__ __forceinline__ void tick_row(
    R& r, const rt::Span& sp, const T* sh, const int* q_in, const float* win,
    const unsigned char* free_, const float* u, int* sel,
    unsigned char* valid, unsigned char* dany, int* q_out, int* pops_out,
    int W, const rt::Scratch& scratch) {
  rt::load_run<R>(sp, q_in, [&](int k, int l) -> int& { return r.Q(k, l); });
  const rt::PerDraw<unsigned char> is_free(free_, W, sp.lane);
  const rt::PerDraw<float> uw(u, W, sp.lane);
  rt::Table t{};
  int n_demanded = 0;
  if constexpr (MODE == kThemis) {
    rt::load_run<R>(sp, sh, [&](int k, int l) -> float& { return r.A(k, l); });
    t = rt::build_table_of<T>(r, sp, scratch);
  } else {
    int part = 0;
    RT_EACH(R, sp, k) {
      const bool d = r.Q(k) > 0;
      part += d;
      r.Pops(k) = 0;
      r.A(k) = d ? win[(size_t)(sp.lo + k) * W] : CUDART_INF_F;
    }
    n_demanded = (int)__reduce_add_sync(rt::kFull, part);
  }

  for (int w = 0; w < W; ++w) {
    int pick;
    bool any;
    if constexpr (MODE == kThemis) {
      pick = rt::draw(r, sp, t, uw(w));
      any = t.first != INT_MAX;
    } else {
      any = n_demanded > 0;
      pick = any ? fifo_argmin(r, sp) : -1;
    }
    const bool ok = is_free(w) != 0 && pick >= 0;
    if (sp.lane == 0) {
      sel[w] = pick;
      valid[w] = ok;
      dany[w] = any;
    }
    if (!ok) continue;
    // The owner of the popped slot updates it; `left` and `popped` are its
    // count and pops after this pop (on the owner).
    int left = 0, popped = 0;
    bool mine = false;
    RT_EACH(R, sp, k) {
      const bool at = sp.index(k) == pick;
      mine = mine || at;
      r.Q(k) -= at;
      left = at ? r.Q(k) : left;
      if constexpr (MODE != kThemis) {
        r.Pops(k) += at;
        popped = at ? r.Pops(k) : popped;
      }
    }
    // The popped slot's demand bit went from 1 to 0.
    const bool emptied = mine && left == 0;
    if constexpr (MODE != kThemis) {
      // Its next stamp, only where a later draw reads it.
      if (mine && w + 1 < W) {
        const float h =
            left > 0 ? win[(size_t)pick * W + popped] : CUDART_INF_F;
        RT_EACH(R, sp, k) r.A(k) = sp.index(k) == pick ? h : r.A(k);
      }
    }
    // A later draw sees the new demand mask (the last one has none).
    if (__any_sync(rt::kFull, emptied) && w + 1 < W) {
      if constexpr (MODE == kThemis)
        t = rt::build_table_of<T>(r, sp, scratch);
      else
        n_demanded -= 1;
    }
  }

  rt::store_run<R>(sp, q_out, [&](int k) { return r.Q(k); });
  if constexpr (MODE == kThemis) {
    // pops = the tick's counts minus the final ones; the counts come back
    // from cache into the pops slots, free now that the draws are done.
    rt::load_run<R>(sp, q_in,
                    [&](int k, int l) -> int& { return r.Pops(k, l); });
    rt::store_run<R>(sp, pops_out, [&](int k) { return r.Pops(k) - r.Q(k); });
  } else {
    rt::store_run<R>(sp, pops_out, [&](int k) { return r.Pops(k); });
  }
}

template <int C, int MODE, class T>
__global__ void __launch_bounds__(32 * kRows)
tick_step_kernel(const T* __restrict__ shares, const int* __restrict__ qcount,
                 const float* __restrict__ window,
                 const unsigned char* __restrict__ free_,
                 const float* __restrict__ u, int* __restrict__ sel,
                 unsigned char* __restrict__ valid,
                 unsigned char* __restrict__ demand_any,
                 int* __restrict__ qcount_out, int* __restrict__ pops_out,
                 int S, int J, int W) {
  const int warp = threadIdx.x >> 5;
  const size_t row = (size_t)blockIdx.x * (blockDim.x >> 5) + warp;
  if (row >= (size_t)S) return;
  const rt::Span sp(J);
  const size_t rj = row * J, rw = row * W;
  extern __shared__ float4 smem_raw[];
  float* base = reinterpret_cast<float*>(smem_raw) +
                warp * warp_floats<C, MODE>(J);
  if constexpr (C > 0) {
    rt::Regs<C> r;
    const rt::Scratch scratch{base, base + 32 * sp.c};
    tick_row<MODE>(r, sp, shares + rj, qcount + rj, window + rj * W,
                   free_ + rw, u + rw, sel + rw, valid + rw, demand_any + rw,
                   qcount_out + rj, pops_out + rj, W, scratch);
  } else {
    const size_t len = rt::slab_bytes(J, kSlabArrays) / 4 / kSlabArrays;
    // themis uses the segments, fifo the pops: one array serves both.
    rt::Slab r{base, base + len, reinterpret_cast<int*>(base + 2 * len),
               reinterpret_cast<int*>(base + len), sp.lane};
    const rt::Scratch scratch{nullptr, base + kSlabArrays * len};
    tick_row<MODE>(r, sp, shares + rj, qcount + rj, window + rj * W,
                   free_ + rw, u + rw, sel + rw, valid + rw, demand_any + rw,
                   qcount_out + rj, pops_out + rj, W, scratch);
  }
}

struct Args {
  const void* shares;
  const int* qcount;
  const float* window;
  const unsigned char* free_;
  const float* u;
  int* sel;
  unsigned char* valid;
  unsigned char* demand_any;
  int* qcount_out;
  int* pops;
  int S, J, W;
};

template <int C, int MODE, class T>
int launch(const Args& a, cudaStream_t stream) {
  int rows = kRows;
  size_t smem = 0;
  const size_t per = warp_floats<C, MODE>(a.J) * 4;
  if (per > 0) {
    const size_t fit = (size_t)232448 / per;
    rows = fit < (size_t)kRows ? (int)fit : kRows;
    if (rows < 1) return (int)cudaErrorInvalidValue;
    smem = per * rows;
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(
          tick_step_kernel<C, MODE, T>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
  }
  tick_step_kernel<C, MODE, T><<<(a.S + rows - 1) / rows, 32 * rows, smem,
                                 stream>>>(
      static_cast<const T*>(a.shares), a.qcount, a.window, a.free_, a.u,
      a.sel, a.valid, a.demand_any, a.qcount_out, a.pops, a.S, a.J, a.W);
  return (int)cudaGetLastError();
}

template <int MODE, class T>
int launch_for(const Args& a, cudaStream_t stream) {
  const int c = (a.J + 31) / 32;
  if (c <= 4) return launch<4, MODE, T>(a, stream);
  if (c <= 8) return launch<8, MODE, T>(a, stream);
  if (c <= 16) return launch<16, MODE, T>(a, stream);
  if (c <= 32) return launch<32, MODE, T>(a, stream);
  return launch<0, MODE, T>(a, stream);
}

}  // namespace

// mode: 0 themis, 1 fifo; dtype: 0 float32 shares, 1 bfloat16 shares
// (fifo reads no shares).
extern "C" int tick_step_launch(const void* shares, const int* qcount,
                                const float* window, const unsigned char* free_,
                                const float* u, int* sel, unsigned char* valid,
                                unsigned char* demand_any, int* qcount_out,
                                int* pops, int S, int J, int W, int mode,
                                int dtype, void* stream) {
  const Args a{shares, qcount, window, free_, u, sel, valid, demand_any,
               qcount_out, pops, S, J, W};
  cudaStream_t st = (cudaStream_t)stream;
  if (mode != kThemis) return launch_for<1, float>(a, st);
  if (dtype == 1) return launch_for<kThemis, __nv_bfloat16>(a, st);
  return launch_for<kThemis, float>(a, st);
}
