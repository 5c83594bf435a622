#!/usr/bin/env python3
"""Time builds of the port's kernels side by side, on one card.

    python3 tools/probe_kernel_builds.py [--other DIR ...] [KERNEL ...]

Compiles, with the flags of ``kernels/_build.py``, these builds of each
``csrc/<kernel>.cu`` named (default: every kernel of ``EDITS``) into a
temporary directory, all started together:

  checkout       the sources as they are;
  <edit name>    the sources with one design choice undone by a text edit
                 (``EDITS``), to measure what that choice buys;
  <DIR's name>   the sources under ``DIR/src/repro_torch/kernels/csrc``
                 (another checkout, e.g. the parent commit unpacked with
                 ``git archive``), for each ``--other DIR`` given.

Each build's output is first held to the checkout's plain version (flash:
``chip_smoke.FLASH_TOL``; the scans: ``chip_smoke.prefix_tol``, output and
final state; the draws: ``repro_torch.kernels.parity``, picks exact up to
the float32 edge band), then timed at the shapes of ``chip_smoke.py``
(flash: danube's GQA and zamba2's MHA shape, bf16, then the backward at
danube's and qwen3-moe's training shapes, with each build's backward
occupancy read from the CUDA runtime; mamba2_ssd: zamba2's
layer, bf16 b/c, then the backward (mamba2_ssd_bwd and step_decay_bwd) at
zamba2's training layer with the new chunk_bwd's occupancy readout and
each build's count of HMMA instructions in chunk_bwd (cuobjdump -sass);
wkv6: rwkv6's layer, bf16 r/k/v, then the backward (wkv6_bwd) at
rwkv6's training layer, each pass, each build's occupancy readout of
chunk_dstate and chunk_bwd and its count of HMMA instructions in them
(cuobjdump -sass); token_select and
tick_step: the fleet's S=128, J=1024, W=4, token_select at the scan path's
W=1, float32 shares, then bf16 shares for the builds that take them), the
builds in turns, forward then backward, each time the median of CUDA-event
timings (``chip_smoke.time_ms``).  Prints one line per shape with every
build's best time and the card's nvidia-smi name and power limit.  Exits 2
without a card.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"

#: kernel -> edit name -> [(text in the source, its replacement)].
EDITS = {
    # Two and four rows (warps) per block in place of one; every J in the
    # shared-memory slab, as J > 1024 runs, in place of registers.
    "token_select": {
        "rows_2": [("constexpr int kRows = 1;", "constexpr int kRows = 2;")],
        "rows_4": [("constexpr int kRows = 1;", "constexpr int kRows = 4;")],
        "slab": [("const int c = (J + 31) / 32;", "const int c = 33;")],
    },
    "tick_step": {
        "rows_2": [("constexpr int kRows = 1;", "constexpr int kRows = 2;")],
        "rows_4": [("constexpr int kRows = 1;", "constexpr int kRows = 4;")],
        "slab": [("const int c = (a.J + 31) / 32;", "const int c = 33;")],
    },
    "flash_attention": {
        # 3 blocks per SM with Q's fragments in registers at D <= 80.
        "q_in_registers": [
            ("return dp <= 80 ? 4 : 1;", "return 1;"),
            ("kQInRegs = DP > 80 && DP <= 128;", "kQInRegs = DP <= 128;")],
        # The tensor-core backward's 32-wide tiles of the other side (keys
        # in dq, queries in dkv) at every width, in place of 64 up to
        # DP = 128.
        "bwd_tile_32": [("return dp <= 128 ? 64 : 32;", "return 32;")],
    },
    "mamba2_ssd": {
        # The gating with one whole 4 x 4 tile per thread, element by
        # element (16 threads of a warp on one bank).
        "gate_tile_per_thread": [(
            """    for (int k = tid; k < 4 * n_lower; k += kScanThreads) {
      const int t = k >> 2, i = 4 * (tij[t] & 0xffff) + (k & 3);
      const int j0 = 4 * (tij[t] >> 16);
      const float4 gram = tile4::ld4(cb + 4 * k);
      const float4 cj = tile4::ld4(ch + j0);
      const float ci = ch[i];
      tile4::st4(gs + 4 * k,
                 make_float4(j0 <= i ? gram.x * expf(ci - cj.x) : 0.f,
                             j0 + 1 <= i ? gram.y * expf(ci - cj.y) : 0.f,
                             j0 + 2 <= i ? gram.z * expf(ci - cj.z) : 0.f,
                             j0 + 3 <= i ? gram.w * expf(ci - cj.w) : 0.f));
    }""",
            """    for (int t = tid; t < n_lower; t += kScanThreads) {
      const int ti = tij[t] & 0xffff, tj = tij[t] >> 16;
      for (int r = 0; r < 4; ++r)
        for (int c = 0; c < 4; ++c) {
          const int i = 4 * ti + r, j = 4 * tj + c;
          const float g = j <= i ? expf(ch[i] - ch[j]) : 0.f;
          gs[16 * t + 4 * r + c] = cb[16 * t + 4 * r + c] * g;
        }
    }""")],
        # step_decay: 128-thread blocks; __fdiv_rn in softplus's log1p in
        # place of the reciprocal and one correction.
        "step_threads_128": [("constexpr int kStepThreads = 256;",
                              "constexpr int kStepThreads = 128;")],
        "step_fdiv": [(
            """    float rcp;
    asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(rcp) : "f"(d));
    const float q0 = __fmul_rn(n, rcp);
    const float q = __fmaf_rn(__fmaf_rn(-d, q0, n), rcp, q0);""",
            """    const float q = __fdiv_rn(n, d);""")],
    },
    "wkv6": {
        # Accurate expf for every exponential, in place of ex2.approx.ftz.
        "accurate_expf": [(
            """  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x * kLog2e));
  return y;""", "  return expf(x);")],
        # chunk_bwd sized for one block an SM (dS' and S staged too), in
        # place of two where its layout fits half an SM's shared memory.
        "bwd_one_block": [("constexpr int kBwdBlocks = 2;",
                           "constexpr int kBwdBlocks = 1;")],
        # cwe written by chunk_state to a [B, nc, H, L, K] scratch and read
        # by chunk_scan, in place of chunk_scan's own prefix sums.
        "cwe_scratch": [
            ("constexpr float kLog2e = 1.4426950408889634f;\n",
             """constexpr float kLog2e = 1.4426950408889634f;
__device__ float* g_cwe;
void cwe_buffer(size_t n) {
  static float* buf = nullptr;
  static size_t cap = 0;
  if (n <= cap) return;
  cudaFree(buf);
  cudaMalloc(&buf, n * sizeof(float));
  cap = n;
  cudaMemcpyToSymbol(g_cwe, &buf, sizeof(buf));
}
"""),
            ("""      cwl[unit * K + kk] = tot[kk];
    }
    __syncthreads();
""", """      cwl[unit * K + kk] = tot[kk];
    }
    __syncthreads();
    for (int idx = tid; idx < L * K; idx += kThreads)
      g_cwe[unit * L * K + idx] = cs[(idx / K) * lk + idx % K];
    __syncthreads();
"""),
            ("""    for (int kk = tid; kk < K; kk += kThreads)
      prefix(ds, cs, ds, lk, L, kk);
""", """    for (int idx = tid; idx < L * K; idx += kThreads) {
      const int i = idx / K, kk = idx - i * K;
      const float c = g_cwe[(unit0 + h) * L * K + idx];
      cs[i * lk + kk] = c;
      ds[i * lk + kk] = c + ds[i * lk + kk];
    }
"""),
            ("""  const size_t smem = state_smem<T>(K, L);
  int per_sm = 0;
  cudaError_t e = prepare(kernel, smem, &per_sm);
  if (e != cudaSuccess) return e;
  const int hpb = heads_per_block(B, S / L, H, per_sm, 0.0);
""", """  const size_t smem = state_smem<T>(K, L);
  int per_sm = 0;
  cudaError_t e = prepare(kernel, smem, &per_sm);
  if (e != cudaSuccess) return e;
  const int hpb = heads_per_block(B, S / L, H, per_sm, 0.0);
  cwe_buffer((size_t)B * S * H * K);
""")],
    },
}

#: Appended to every build of flash_attention.cu that has the tensor-core
#: backward: the width of the other side's tile, registers, local (spilled)
#: bytes, dynamic shared memory and resident blocks an SM of bwd_tc's
#: dq_kernel and dkv_kernel (the dK launch above DP = 128) at head width D,
#: read from the CUDA runtime (ncu cannot run on the card's machine).
BWD_OCCUPANCY_SRC = r"""
namespace {
template <int DP>
int bwd_occupancy(int* out) {
  const void* fns[2] = {
      (const void*)bwd_tc::dq_kernel<DP>,
      (const void*)bwd_tc::dkv_kernel<DP, DP <= 128 ? 3 : 2>};
  const size_t smem[2] = {bwd_tc::dq_smem(DP), bwd_tc::dkv_smem(DP)};
  for (int i = 0; i < 2; ++i) {
    cudaError_t e = cudaFuncSetAttribute(
        fns[i], cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem[i]);
    if (e != cudaSuccess) return (int)e;
    cudaFuncAttributes a;
    e = cudaFuncGetAttributes(&a, fns[i]);
    if (e != cudaSuccess) return (int)e;
    int blocks = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, fns[i], bwd_tc::kThreads, smem[i]);
    if (e != cudaSuccess) return (int)e;
    out[5 * i] = bwd_tc::tile_cols(DP);
    out[5 * i + 1] = a.numRegs;
    out[5 * i + 2] = (int)a.localSizeBytes;
    out[5 * i + 3] = (int)smem[i];
    out[5 * i + 4] = blocks;
  }
  return 0;
}
}  // namespace

extern "C" int flash_bwd_occupancy(int D, int* out) {
#define OCC_CASE(DP) if (D <= DP) return bwd_occupancy<DP>(out);
  OCC_CASE(16) OCC_CASE(32) OCC_CASE(48) OCC_CASE(64) OCC_CASE(80)
  OCC_CASE(96) OCC_CASE(128) OCC_CASE(160) OCC_CASE(192) OCC_CASE(256)
#undef OCC_CASE
  return (int)cudaErrorInvalidValue;
}
"""
#: Appended to every build of mamba2_ssd.cu whose chunk_bwd runs on the
#: tensor cores: the registers, local (spilled) bytes, dynamic shared
#: memory and resident blocks an SM of the backward's kernels (bf16 b/c) at
#: (P, N, L), chunk_bwd in the build that geometry takes, read from the CUDA
#: runtime.
SSD_BWD_OCCUPANCY_SRC = r"""
namespace {
int kernel_occupancy(const void* fn, int threads, size_t smem, int* out) {
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  cudaFuncAttributes a;
  e = cudaFuncGetAttributes(&a, fn);
  if (e != cudaSuccess) return (int)e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, threads,
                                                    smem);
  if (e != cudaSuccess) return (int)e;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)smem;
  out[3] = blocks;
  return 0;
}
}  // namespace

extern "C" int ssd_bwd_occupancy(int P, int N, int L, int* out) {
  using T = __nv_bfloat16;
  BwdLayout ly;
  if (!bwd_layout(P, N, L, 2, ly)) return (int)cudaErrorInvalidValue;
  const void* fns[5] = {
      (const void*)chunk_dstate_kernel<T>, (const void*)state_pass_bwd_kernel,
      bwd_small(ly.nb, ly.nq)
          ? (const void*)chunk_bwd_kernel<T, kSmallUnits, kSmallLower>
          : (const void*)chunk_bwd_kernel<T, kLargeUnits, kLargeLower>,
      (const void*)sum_groups_kernel<T>,
      (const void*)step_decay_bwd_kernel<T, 4>};
  const int threads[5] = {kStateThreads, kPassThreads, kBwdThreads,
                          kPassThreads, kStepThreads};
  const size_t smem[5] = {
      sizeof(float) * ((size_t)L * (N + 4) + (size_t)L * (P + 4) + L), 0,
      sizeof(float) * ly.floats, 0, 0};
  for (int i = 0; i < 5; ++i) {
    const int rc = kernel_occupancy(fns[i], threads[i], smem[i], out + 4 * i);
    if (rc) return rc;
  }
  return 0;
}
"""
#: Appended to every build of wkv6.cu with a backward: the registers, local
#: (spilled) bytes, dynamic shared memory and resident blocks an SM of its
#: chunk_dstate and chunk_bwd (bf16 r/k/v) at (K, L), read from the CUDA
#: runtime; two forms, for the tensor-core chunk_bwd (a BwdLayout) and for
#: the FMA one before it (a BwdStage).
WKV_BWD_OCCUPANCY_SRC = r"""
namespace {
int wkv_occupancy(const void* fn, size_t smem, int* out) {
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  cudaFuncAttributes a;
  e = cudaFuncGetAttributes(&a, fn);
  if (e != cudaSuccess) return (int)e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, kThreads,
                                                    smem);
  if (e != cudaSuccess) return (int)e;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)smem;
  out[3] = blocks;
  return 0;
}
}  // namespace

extern "C" int wkv_bwd_occupancy(int K, int L, int* out) {
  using T = __nv_bfloat16;
  const int rc = wkv_occupancy((const void*)wkv_chunk_dstate_kernel<T>,
                               DSTATE_SMEM, out);
  if (rc) return rc;
  return wkv_occupancy((const void*)wkv_chunk_bwd_kernel<T>, BWD_SMEM,
                       out + 4);
}
"""
#: (DSTATE_SMEM, BWD_SMEM) in each form of the readout.
WKV_BWD_SMEM = {
    "struct BwdLayout": ("dstate_smem<T>(K, L)",
                         "(size_t)bwd_layout<T>(K, L).bytes"),
    "struct BwdStage": ("sizeof(T) * (size_t)L * (K + per16<T>()) + "
                        "sizeof(float) * 3 * (size_t)L * (K + 4)",
                        "[&] { BwdStage st; return bwd_smem<T>(K, L, &st); }()"),
}
#: (B, S, H, K, chunk) of the WKV backward at rwkv6-7b's training layer
#: (chip_smoke's train_rwkv6: 2 x 4096 tokens), bf16 r/k/v.
WKV_BWD_SHAPE = (2, 4096, 64, 64, 64)

#: The backward kernels the readout covers, in its order.
SSD_BWD_KERNELS = ("chunk_dstate", "state_pass_bwd", "chunk_bwd",
                   "sum_groups", "step_decay_bwd")
#: (B, S, H, P, N, L) of zamba2's Mamba-2 layer in chip_smoke's train_zamba2
#: phase (2 x 4096 tokens), bf16 b/c.
SSD_BWD_SHAPE = (2, 4096, 80, 64, 64, 128)
#: zamba2's projection width and the column of its dt_raw in it.
ZAMBA2_PROJ, ZAMBA2_DT_COL = 10448, 10368

#: (B, S, H, Hk, D) of the flash backward at layer 0 of chip_smoke's train
#: phase (danube) and of its qwen3-moe train_blocks case; causal.
FLASH_BWD_SHAPES = [(2, 4096, 32, 8, 80), (2, 2048, 32, 4, 128)]
#: Head widths whose backward occupancy is printed.
FLASH_BWD_WIDTHS = (64, 80, 96, 128, 256)

#: (B, S, H, Hk, D, window) of the serve phases' first flash call.
FLASH_SHAPES = [(2, 6000, 32, 8, 80, 4096), (2, 6000, 32, 32, 80, 0)]
#: A chip_smoke.MAMBA2_CASES entry at zamba2's layer shape.
MAMBA2_SHAPE = (2, 6016, 80, 64, 64, 128, "bfloat16", False, "normal", True)
#: A chip_smoke.WKV6_CASES entry at rwkv6's layer shape.
WKV6_SHAPE = (2, 6016, 64, 64, 64, "bfloat16", False, "normal")


def sources(kernel, others):
    """{build name: source text} of one kernel; ``others`` {build name:
    root of another checkout} (or None)."""
    text = (CSRC / f"{kernel}.cu").read_text()
    out = {"checkout": text}
    for name, edits in EDITS[kernel].items():
        edited = text
        for old, new in edits:
            if edited.count(old) != 1:
                raise SystemExit(f"probe edit {name!r} of {kernel}.cu no "
                                 f"longer applies: {old[:60]!r}")
            edited = edited.replace(old, new)
        out[name] = edited
    for name, root in (others or {}).items():
        out[name] = (root / "src" / "repro_torch" / "kernels" / "csrc"
                     / f"{kernel}.cu").read_text()
    if kernel == "flash_attention":
        out = {name: t + BWD_OCCUPANCY_SRC if "namespace bwd_tc" in t else t
               for name, t in out.items()}
    if kernel == "mamba2_ssd":
        out = {name: t + SSD_BWD_OCCUPANCY_SRC if "namespace tf32x3" in t
               else t for name, t in out.items()}
    if kernel == "wkv6":
        for name, text in out.items():
            for marker, (dstate, bwd) in WKV_BWD_SMEM.items():
                if marker in text:
                    out[name] = text + WKV_BWD_OCCUPANCY_SRC.replace(
                        "DSTATE_SMEM", dstate).replace("BWD_SMEM", bwd)
    return out


def build_all(kernels, others, tmp: Path) -> dict:
    """{(kernel, build name): ctypes library}; the builds run together.  A
    draw kernel's library carries ``takes_share_dtype``: whether its
    launcher takes the share dtype (builds before bf16 shares do not); a
    flash build's ``takes_stats``: whether its forward launcher takes the
    row statistics' pointers (builds before the backward do not); an SSD
    build's ``takes_done``: whether its step_decay_bwd launcher takes the
    caller's counters (builds with a global counter or two launches do
    not)."""
    from repro_torch.kernels import _build
    procs = {}
    for kernel in kernels:
        builds = sources(kernel, others)
        for name, text in builds.items():
            # Next to the checkout's headers (or the other checkout's).
            inc = (others[name] / "src" / "repro_torch" / "kernels" / "csrc"
                   if name in (others or {}) else CSRC)
            src = tmp / f"{kernel}-{name}.cu"
            src.write_text(text)
            so = tmp / f"{kernel}-{name}.so"
            procs[kernel, name] = (subprocess.Popen(
                [_build.nvcc(), *_build.NVCC_FLAGS, "-I", str(inc), "-o",
                 str(so), str(src)], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True), so, text)
    libs = {}
    for key, (proc, so, text) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {key}:\n{log}")
        libs[key] = ctypes.CDLL(str(so))
        libs[key].path = so
        libs[key].takes_share_dtype = "int dtype" in text
        # A flash build whose forward launcher takes the row statistics.
        libs[key].takes_stats = "(m == nullptr) != (l == nullptr)" in text
        libs[key].takes_done = "void* part, void* done" in text
    return libs


def flash_call(lib, q, k, v, window):
    import torch
    fn = lib.flash_attention_launch
    stats = [None, None] if lib.takes_stats else []
    fn.argtypes = ([ctypes.c_void_p] * (4 + len(stats))
                   + [ctypes.c_int] * 10 + [ctypes.c_float, ctypes.c_void_p])
    b, sq, h, d = q.shape
    out = torch.empty_like(q)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), *stats,
            b, sq, k.shape[1], h, k.shape[2], d, 1, window, 0, 1, d ** -0.5,
            torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"flash launch failed: CUDA error {rc}")
    return out


def mamba2_call(lib, x, a, b, c, chunk):
    """(y, final state) through the three-pass interface, or through the
    one-launch interface of a build that has it."""
    import torch
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    stream = torch.cuda.current_stream().cuda_stream
    y = torch.empty_like(x)
    hf = torch.empty((bsz, h, p, n), dtype=torch.float32, device=x.device)
    strides = [*x.stride()[:3], *a.stride()[:2], *b.stride()[:2],
               *c.stride()[:2]]
    if hasattr(lib, "mamba2_ssd_launch"):
        fn = lib.mamba2_ssd_launch
        fn.argtypes = [P] * 7 + [I] * 6 + [L] * 9 + [I, P]
        rcs = [fn(x.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(),
                  None, y.data_ptr(), hf.data_ptr(), bsz, s, h, p, n, chunk,
                  *strides, 1, stream)]
    else:
        cum = torch.empty((bsz, s // chunk, h, chunk), dtype=torch.float32,
                          device=x.device)
        st = torch.empty((bsz, s // chunk, h, n, p), dtype=torch.float32,
                         device=x.device)
        f1, f2, f3 = (lib.mamba2_chunk_state_launch,
                      lib.mamba2_state_pass_launch,
                      lib.mamba2_chunk_scan_launch)
        f1.argtypes = [P] * 5 + [I] * 6 + [L] * 7 + [I, P]
        f2.argtypes = [P] * 4 + [I] * 6 + [P]
        f3.argtypes = [P] * 6 + [I] * 6 + [L] * 7 + [I, P]
        rcs = [f1(x.data_ptr(), a.data_ptr(), b.data_ptr(), cum.data_ptr(),
                  st.data_ptr(), bsz, s, h, p, n, chunk, *strides[:7], 1,
                  stream),
               f2(cum.data_ptr(), st.data_ptr(), None, hf.data_ptr(), bsz,
                  s // chunk, h, p, n, chunk, stream),
               f3(x.data_ptr(), b.data_ptr(), c.data_ptr(), cum.data_ptr(),
                  st.data_ptr(), y.data_ptr(), bsz, s, h, p, n, chunk,
                  *strides[:3], *strides[5:], 1, stream)]
    if any(rcs):
        raise RuntimeError(f"mamba2_ssd launch failed: CUDA errors {rcs}")
    return y, hf


def wkv6_call(lib, r, k, v, lw, u, chunk):
    """(y, final state) through the three-pass interface, or through the
    one-launch interface of a build that has it."""
    import torch
    P, I = ctypes.c_void_p, ctypes.c_int
    bsz, s, h, kd = r.shape
    stream = torch.cuda.current_stream().cuda_stream
    y = torch.empty(r.shape, dtype=torch.float32, device=r.device)
    sf = torch.empty((bsz, h, kd, kd), dtype=torch.float32, device=r.device)
    dtype = 1 if r.dtype == torch.bfloat16 else 0
    if hasattr(lib, "wkv6_launch"):
        fn = lib.wkv6_launch
        fn.argtypes = [P] * 8 + [I] * 6 + [P]
        rcs = [fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), lw.data_ptr(),
                  u.data_ptr(), None, y.data_ptr(), sf.data_ptr(), bsz, s, h,
                  kd, chunk, dtype, stream)]
    else:
        nc = s // chunk
        cwl = torch.empty((bsz, nc, h, kd), dtype=torch.float32,
                          device=r.device)
        st = torch.empty((bsz, nc, h, kd, kd), dtype=torch.float32,
                         device=r.device)
        f1, f2, f3 = (lib.wkv6_chunk_state_launch, lib.wkv6_state_pass_launch,
                      lib.wkv6_chunk_scan_launch)
        f1.argtypes = [P] * 5 + [I] * 6 + [P]
        f2.argtypes = [P] * 4 + [I] * 4 + [P]
        f3.argtypes = [P] * 7 + [I] * 6 + [P]
        rcs = [f1(k.data_ptr(), v.data_ptr(), lw.data_ptr(), cwl.data_ptr(),
                  st.data_ptr(), bsz, s, h, kd, chunk, dtype, stream),
               f2(cwl.data_ptr(), st.data_ptr(), None, sf.data_ptr(), bsz, nc,
                  h, kd, stream),
               f3(r.data_ptr(), k.data_ptr(), v.data_ptr(), lw.data_ptr(),
                  u.data_ptr(), st.data_ptr(), y.data_ptr(), bsz, s, h, kd,
                  chunk, dtype, stream)]
    if any(rcs):
        raise RuntimeError(f"wkv6 launch failed: CUDA errors {rcs}")
    return y, sf


def draw_call(lib, kernel, shares, qcount, window, free, u, mode):
    """One launch of a token_select or tick_step build on these inputs; a
    build whose launcher takes no share dtype (float32 shares only) is
    called without one."""
    import torch
    P, I = ctypes.c_void_p, ctypes.c_int
    fn = getattr(lib, f"{kernel}_launch")
    n_ptr, n_int = (4, 3) if kernel == "token_select" else (10, 4)
    with_dtype = lib.takes_share_dtype
    fn.argtypes = [P] * n_ptr + [I] * (n_int + with_dtype) + [P]
    stream = torch.cuda.current_stream().cuda_stream
    s, j = qcount.shape
    w = u.shape[1]
    extra = [int(shares.dtype == torch.bfloat16)] if with_dtype else []
    if kernel == "token_select":
        out = torch.empty((s, w), dtype=torch.int32, device=u.device)
        rc = fn(shares.data_ptr(), qcount.data_ptr(), u.data_ptr(),
                out.data_ptr(), s, j, w, *extra, stream)
        outs = (out,)
    else:
        outs = (torch.empty((s, w), dtype=torch.int32, device=u.device),
                torch.empty((s, w), dtype=torch.bool, device=u.device),
                torch.empty((s, w), dtype=torch.bool, device=u.device),
                torch.empty((s, j), dtype=torch.int32, device=u.device),
                torch.empty((s, j), dtype=torch.int32, device=u.device))
        rc = fn(shares.data_ptr(), qcount.data_ptr(), window.data_ptr(),
                free.data_ptr(), u.data_ptr(), *(t.data_ptr() for t in outs),
                s, j, w, ("themis", "fifo").index(mode), *extra, stream)
    if rc:
        raise RuntimeError(f"{kernel} launch failed: CUDA error {rc}")
    return outs


def probe_draws(libs, cs, kernel) -> None:
    import torch
    from repro_torch.kernels import parity
    from repro_torch.kernels.tick_step.ref import tick_step_ref
    from repro_torch.kernels.token_select.ref import token_select_ref
    shares, qcount, window, free, u = cs.kernel_inputs(128, 1024, 4, "cuda",
                                                       seed=99)
    if kernel == "token_select":
        u = u[:, :1].contiguous()
    builds = {name: lib for (k, name), lib in libs.items() if k == kernel}
    for mode in (("themis",) if kernel == "token_select"
                 else ("themis", "fifo")):
        for dtype in (torch.float32, torch.bfloat16):
            sh = shares.to(dtype)
            calls = {}
            for name, lib in builds.items():
                if dtype != torch.float32 and not lib.takes_share_dtype:
                    continue
                got = draw_call(lib, kernel, sh, qcount, window, free, u,
                                mode)
                if kernel == "token_select":
                    parity.compare_token_select(
                        got[0], token_select_ref(sh, qcount, u), sh.float(),
                        qcount, u)
                else:
                    parity.compare_tick_step(
                        got, tick_step_ref(sh, qcount, window, free, u,
                                           mode=mode),
                        sh.float(), qcount, u, mode)
                calls[name] = lambda lib=lib: draw_call(
                    lib, kernel, sh, qcount, window, free, u, mode)
            best = timed_in_turns(calls)
            label = kernel if kernel == "token_select" else f"{kernel}[{mode}]"
            print(f"{label} S=128 J=1024 W={u.shape[1]} shares "
                  f"{str(dtype)[6:]}: " + ", ".join(
                      f"{n} {t * 1e3:.2f} us" for n, t in best.items()),
                  flush=True)


def timed_in_turns(calls: dict) -> dict:
    """{name: best of two medians}, the builds timed forward then back."""
    import chip_smoke as cs
    names = list(calls)
    times = {name: [] for name in names}
    for order in (names, names[::-1]):
        for name in order:
            times[name].append(cs.time_ms(calls[name], reps=10))
    return {name: min(t) for name, t in times.items()}


def probe_flash(libs, cs) -> None:
    import torch
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    for b, s, h, hk, d, window in FLASH_SHAPES:
        q, k, v = cs.flash_inputs((b, s, s, h, hk, d, window, True, 0, 0),
                                  torch.bfloat16, "cuda", seed=1)
        want = flash_attention_ref(q, k, v, window=window).float()
        calls = {}
        for (kernel, name), lib in libs.items():
            if kernel != "flash_attention":
                continue
            got = flash_call(lib, q, k, v, window).float()
            tol = cs.FLASH_TOL["bfloat16"]
            torch.testing.assert_close(got, want, rtol=tol, atol=tol)
            calls[name] = lambda lib=lib: flash_call(lib, q, k, v, window)
        best = timed_in_turns(calls)
        print(f"flash_attention B={b} S={s} H={h} Hk={hk} D={d} window="
              f"{window} bf16: " + ", ".join(
                  f"{n} {t:.3f} ms" for n, t in best.items()), flush=True)


def flash_bwd_call(lib, q, k, v, out, m, l, dout):
    """dq, dk, dv of one causal backward launch of a build."""
    import torch
    fn = lib.flash_attention_bwd_launch
    fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 10
                   + [ctypes.c_float, ctypes.c_void_p])
    b, sq, h, d = q.shape
    grads = (torch.empty_like(q), torch.empty_like(k), torch.empty_like(v))
    delta = torch.empty_like(m)
    rc = fn(*(t.data_ptr() for t in (q, k, v, out, dout, m, l, delta,
                                      *grads)),
            b, sq, k.shape[1], h, k.shape[2], d, 1, 0, 0,
            int(q.dtype == torch.bfloat16), d ** -0.5,
            torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"flash backward launch failed: CUDA error {rc}")
    return grads


def probe_flash_bwd(libs, cs) -> None:
    """Each flash build's backward at FLASH_BWD_SHAPES (bf16, causal), held
    to the checkout's plain chain in float32 (chip_smoke.flash_bwd_check's
    tolerance) and timed in turns; then each build's occupancy readout at
    FLASH_BWD_WIDTHS."""
    import torch
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_bwd_ref, flash_attention_ref)
    builds = {name: lib for (kernel, name), lib in libs.items()
              if kernel == "flash_attention"
              and hasattr(lib, "flash_attention_bwd_launch")}
    tol = cs.FLASH_BWD_TOL["bfloat16"]
    for b, s, h, hk, d in FLASH_BWD_SHAPES:
        case = (b, s, s, h, hk, d, 0, True)
        q, k, v, dout = cs.flash_bwd_inputs(case, torch.bfloat16, "cuda",
                                            seed=1)
        out, m, l = fa_ops.flash_attention(q, k, v, return_stats=True)
        f32 = [t.float() for t in (q, k, v, dout)]
        o32, m32, l32 = flash_attention_ref(*f32[:3], return_stats=True)
        want = flash_attention_bwd_ref(*f32[:3], o32, m32, l32, f32[3])
        calls = {}
        for name, lib in builds.items():
            got = flash_bwd_call(lib, q, k, v, out, m, l, dout)
            for g, w in zip(got, want):
                err = float((g.float() - w).abs().max() / w.abs().max())
                if not err <= tol:
                    raise SystemExit(f"{name} build's flash backward at "
                                     f"{case}: error {err:.3g} over {tol}")
            calls[name] = lambda lib=lib: flash_bwd_call(lib, q, k, v, out,
                                                         m, l, dout)
        best = timed_in_turns(calls)
        print(f"flash_attention_bwd B={b} S={s} H={h} Hk={hk} D={d} causal "
              f"bf16: " + ", ".join(f"{n} {t:.3f} ms"
                                    for n, t in best.items()), flush=True)
    for name, lib in builds.items():
        if not hasattr(lib, "flash_bwd_occupancy"):
            continue
        fn = lib.flash_bwd_occupancy
        fn.argtypes = [ctypes.c_int, ctypes.c_void_p]
        for d in FLASH_BWD_WIDTHS:
            got = (ctypes.c_int * 10)()
            rc = fn(d, got)
            if rc:
                raise SystemExit(f"{name} build's occupancy readout at D={d}:"
                                 f" CUDA error {rc}")
            print(f"flash_attention_bwd {name} D={d} bf16: " + "; ".join(
                f"{kname} {got[5 * i]}-wide tiles, {got[5 * i + 1]} "
                f"registers, {got[5 * i + 2]} spilled bytes, "
                f"{got[5 * i + 3]} B shared, {got[5 * i + 4]} blocks an SM"
                for i, kname in enumerate(("dq", "dkv"))), flush=True)


def probe_mamba2(libs, cs) -> None:
    import torch
    from repro_torch.kernels.mamba2.ref import mamba2_ssd_ref
    x, a, b, c, _ = cs.mamba2_inputs(MAMBA2_SHAPE, "cuda", seed=0)
    chunk = MAMBA2_SHAPE[5]
    want = mamba2_ssd_ref(x, a, b, c, chunk=chunk)
    tol = cs.prefix_tol(cs.chunk_prefix(torch.log(torch.clamp_min(a, 1e-20)),
                                        chunk))
    calls = {}
    for (kernel, name), lib in libs.items():
        if kernel != "mamba2_ssd":
            continue
        for g, w in zip(mamba2_call(lib, x, a, b, c, chunk), want):
            cs.held(f"{name} build", g, w, tol, "mamba2_ssd")
        calls[name] = lambda lib=lib: mamba2_call(lib, x, a, b, c, chunk)
    best = timed_in_turns(calls)
    print(f"mamba2_ssd {tuple(x.shape)} chunk {chunk} b/c bf16: "
          + ", ".join(f"{n} {t:.3f} ms" for n, t in best.items()), flush=True)


def probe_wkv6(libs, cs) -> None:
    from repro_torch.kernels.rwkv6.ref import wkv6_ref
    r, k, v, lw, u, _ = cs.wkv6_inputs(WKV6_SHAPE, "cuda", seed=0)
    chunk = WKV6_SHAPE[4]
    want = wkv6_ref(r, k, v, lw, u, chunk=chunk)
    tol = cs.prefix_tol(cs.chunk_prefix(lw, chunk))
    calls = {}
    for (kernel, name), lib in libs.items():
        if kernel != "wkv6":
            continue
        for g, w in zip(wkv6_call(lib, r, k, v, lw, u, chunk), want):
            cs.held(f"{name} build", g, w, tol, "wkv6")
        calls[name] = lambda lib=lib: wkv6_call(lib, r, k, v, lw, u, chunk)
    best = timed_in_turns(calls)
    print(f"wkv6 {tuple(r.shape)} chunk {chunk} r/k/v bf16: "
          + ", ".join(f"{n} {t:.3f} ms" for n, t in best.items()), flush=True)


def probe_wkv6_bwd(libs, cs) -> None:
    """Every build's WKV backward at WKV_BWD_SHAPE (bf16 r/k/v, the
    forward's scratch given), held to the plain version
    (chip_smoke.grads_held), timed in turns (builds forward, back, forward,
    back) whole and by pass; then each build's occupancy readout and HMMA
    count.  A build whose gradients are off is named, left out of the
    timing, and makes the probe fail after the readouts."""
    from repro_torch.kernels.rwkv6 import ops
    from repro_torch.kernels.rwkv6.ref import wkv6_bwd_ref
    bsz, s, h, kd, chunk = WKV_BWD_SHAPE
    case = (bsz, s, h, kd, chunk, "bfloat16", False, False, "normal", False)
    args, kw = cs.wkv6_bwd_inputs(case, "cuda", seed=0)
    r, k, v, lw, u, dy, dsf = args
    want = wkv6_bwd_ref(*args, **kw)
    calls, passes, wrong = {}, {}, []
    for (kernel, name), lib in libs.items():
        if kernel != "wkv6" or not hasattr(lib, "wkv6_chunk_bwd_launch"):
            continue
        ops._launcher.cache_clear()
        saved = ops._build._LIBS.get("wkv6")
        ops._build._LIBS["wkv6"] = lib
        try:
            try:
                cs.grads_held(f"{name} build", cs.WKV6_GRADS,
                              ops.wkv6_bwd(*args, **kw), want)
            except AssertionError as err:
                print(f"wkv6_bwd {name} build WRONG, not timed: {err}",
                      flush=True)
                wrong.append(name)
                continue
            fns = {fn: ops._launcher(fn) for fn in
                   ("chunk_dstate", "state_pass_bwd", "chunk_bwd", "sum_du")}
        finally:
            ops._launcher.cache_clear()
            if saved is None:
                ops._build._LIBS.pop("wkv6", None)
            else:
                ops._build._LIBS["wkv6"] = saved

        def run(fn, fns=fns):
            real = ops._launcher
            ops._launcher = lambda name: fns[name]
            try:
                fn()
            finally:
                ops._launcher = real
        q = ops.chunk_dstate(r, dy, lw, chunk=chunk)
        calls[name] = lambda run=run: run(lambda: ops.wkv6_bwd(*args, **kw))
        passes[name] = {
            "chunk_dstate": lambda run=run: run(lambda: ops.chunk_dstate(
                r, dy, lw, chunk=chunk)),
            "chunk_bwd + sum_du": lambda run=run, q=q: run(
                lambda: ops.chunk_bwd(r, k, v, lw, u, dy, kw["s_in"],
                                      kw["sf"], q, chunk=chunk))}
    if calls:
        names = list(calls)
        times = {n: [] for n in names}
        pass_times = {n: {p: [] for p in passes[n]} for n in names}
        for order in (names, names[::-1]) * 2:
            for n in order:
                times[n].append(cs.time_ms(calls[n], reps=10))
                for p, fn in passes[n].items():
                    pass_times[n][p].append(cs.time_ms(fn, reps=10))
        print(f"wkv6_bwd {tuple(r.shape)} chunk {chunk} bf16, in turns: "
              + ", ".join(f"{n} {min(t):.3f} ms" for n, t in times.items()),
              flush=True)
        for n in names:
            print(f"wkv6_bwd {n} per pass: " + ", ".join(
                f"{p} {min(t):.3f} ms" for p, t in pass_times[n].items()),
                flush=True)
    for (kernel, name), lib in libs.items():
        if kernel != "wkv6":
            continue
        print(f"wkv6_bwd {name} SASS: " + "; ".join(
            f"{fn} {count} HMMA ({tf32} TF32)" for fn, (count, tf32)
            in sass_hmma(lib.path, ("wkv_chunk_bwd_kernel",
                                    "wkv_chunk_dstate_kernel")).items()),
            flush=True)
        if not hasattr(lib, "wkv_bwd_occupancy"):
            continue
        fn = lib.wkv_bwd_occupancy
        fn.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p]
        got = (ctypes.c_int * 8)()
        rc = fn(kd, chunk, got)
        if rc:
            raise SystemExit(f"{name} build's WKV backward occupancy "
                             f"readout: CUDA error {rc}")
        print(f"wkv6_bwd {name} K={kd} L={chunk} bf16: " + "; ".join(
            f"{kname} {got[4 * i]} registers, {got[4 * i + 1]} spilled "
            f"bytes, {got[4 * i + 2]} B shared, {got[4 * i + 3]} blocks an SM"
            for i, kname in enumerate(("chunk_dstate", "chunk_bwd"))),
            flush=True)
    if wrong:
        raise SystemExit(f"wkv6_bwd: builds {wrong} gave wrong gradients")


def step_decay_call(lib, raw, bias, a_log, dt, a):
    """One launch of a build's step_decay on a [.., H] view ``raw``."""
    import torch
    fn = lib.mamba2_step_decay_launch
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 2
                   + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])
    rows = raw.reshape(-1, raw.shape[-1])
    rc = fn(rows.data_ptr(), bias.data_ptr(), a_log.data_ptr(), dt.data_ptr(),
            a.data_ptr(), rows.shape[0], rows.shape[1], rows.stride(0),
            int(raw.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"step_decay launch failed: CUDA error {rc}")


def probe_step_decay(libs, cs) -> None:
    """Every build's step_decay at zamba2's prefill (dt_raw a bf16 view of
    the projection, [2, 6000, 80]), held to the plain version bit for bit,
    timed in turns with one launch of a one-element add_ (the fixed cost of
    a launch under this timing) and 50 launches a timing."""
    import torch
    from repro_torch.kernels.mamba2.ref import step_and_decay_ref
    gen = torch.Generator().manual_seed(0)
    proj = (torch.randn(2, 6000, ZAMBA2_PROJ, generator=gen) * 3).to(
        torch.bfloat16).cuda()
    raw = proj[..., ZAMBA2_DT_COL:]
    bias = torch.randn(raw.shape[-1], generator=gen).cuda()
    a_log = (torch.rand(raw.shape[-1], generator=gen) * 6 - 3).cuda()
    want = step_and_decay_ref(raw, bias, a_log)
    calls = {}
    for (kernel, name), lib in libs.items():
        if kernel != "mamba2_ssd":
            continue
        dt, a = torch.empty_like(want[0]), torch.empty_like(want[1])
        step_decay_call(lib, raw, bias, a_log, dt, a)
        if not (torch.equal(dt, want[0]) and torch.equal(a, want[1])):
            raise SystemExit(f"{name} build's step_decay differs from the "
                             "plain version")
        calls[name] = lambda lib=lib, dt=dt, a=a: step_decay_call(
            lib, raw, bias, a_log, dt, a)
    for (kernel, name), lib in libs.items():
        if kernel == "mamba2_ssd" and hasattr(
                lib, "mamba2_step_decay_sweep_launch"):
            fn = lib.mamba2_step_decay_sweep_launch
            fn.argtypes = [ctypes.c_void_p] * 3
            counts = torch.zeros(3, dtype=torch.int64, device="cuda")
            first = torch.zeros(3, dtype=torch.int32, device="cuda")
            if fn(counts.data_ptr(), first.data_ptr(),
                  torch.cuda.current_stream().cuda_stream):
                raise SystemExit(f"{name} build's sweep failed to launch")
            print(f"step_decay sweep, {name} build: inputs whose bits differ "
                  f"(exp, log1p, softplus): {counts.tolist()}", flush=True)
    one = torch.zeros(1, device="cuda")
    calls["empty launch"] = lambda: one.add_(1)
    names = list(calls)
    times = {name: [] for name in names}
    for order in (names, names[::-1]) * 2:
        for name in order:
            times[name].append(cs.time_ms(calls[name], reps=50))
    print(f"step_decay {tuple(raw.shape)} bf16 view: " + ", ".join(
        f"{n} {min(t) * 1e3:.2f} us" for n, t in times.items()), flush=True)


def probe_ssd_bwd(libs, cs) -> None:
    """Every build's SSD backward at SSD_BWD_SHAPE (bf16 b/c, the forward's
    scratch given), held to the plain version (chip_smoke.ssd_bwd_held),
    timed in turns; then each build's occupancy readout.  A build whose
    gradients are off is named, left out of the timing, and makes the
    probe fail after the readouts."""
    from repro_torch.kernels.mamba2 import ops
    from repro_torch.kernels.mamba2.ref import mamba2_ssd_bwd_ref
    bsz, s, h, p, n, chunk = SSD_BWD_SHAPE
    case = (bsz, s, h, p, n, chunk, "bfloat16", False, "normal", True)
    args, kw = cs.ssd_bwd_inputs(case, "cuda", seed=0)
    x, a = args[:2]
    want = mamba2_ssd_bwd_ref(*args, **kw)
    calls, wrong = {}, []
    for (kernel, name), lib in libs.items():
        if kernel != "mamba2_ssd" or not hasattr(lib,
                                                 "mamba2_chunk_bwd_launch"):
            continue
        ops._launcher.cache_clear()
        saved = ops._build._LIBS.get("mamba2_ssd")
        ops._build._LIBS["mamba2_ssd"] = lib
        try:
            try:
                cs.ssd_bwd_held(ops.mamba2_ssd_bwd(*args, **kw), want, a,
                                f"{name} build")
            except AssertionError as err:
                print(f"mamba2_ssd_bwd {name} build WRONG, not timed: {err}",
                      flush=True)
                wrong.append(name)
                continue
            fns = {fn: ops._launcher(fn) for fn in
                   ("chunk_dstate", "state_pass_bwd", "chunk_bwd",
                    "chunk_bwd_heads", "sum_groups")}
        finally:
            ops._launcher.cache_clear()
            if saved is None:
                ops._build._LIBS.pop("mamba2_ssd", None)
            else:
                ops._build._LIBS["mamba2_ssd"] = saved

        def call(fns=fns):
            real = ops._launcher
            ops._launcher = lambda name: fns[name]
            try:
                ops.mamba2_ssd_bwd(*args, **kw)
            finally:
                ops._launcher = real
        calls[name] = call
    if calls:
        best = timed_in_turns(calls)
        print(f"mamba2_ssd_bwd {tuple(x.shape)} chunk {chunk} b/c bf16: "
              + ", ".join(f"{n} {t:.3f} ms" for n, t in best.items()),
              flush=True)
    for (kernel, name), lib in libs.items():
        if kernel == "mamba2_ssd":
            print(f"mamba2_ssd_bwd {name} chunk_bwd SASS: "
                  + "; ".join(f"{fn} {count} HMMA ({tf32} TF32)"
                              for fn, (count, tf32)
                              in sass_hmma(lib.path,
                                           ("chunk_bwd_kernel",)).items()),
                  flush=True)
        if kernel != "mamba2_ssd" or not hasattr(lib, "ssd_bwd_occupancy"):
            continue
        fn = lib.ssd_bwd_occupancy
        fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
        got = (ctypes.c_int * 20)()
        rc = fn(p, n, chunk, got)
        if rc:
            raise SystemExit(f"{name} build's backward occupancy readout: "
                             f"CUDA error {rc}")
        print(f"mamba2_ssd_bwd {name} P={p} N={n} L={chunk} bf16: "
              + "; ".join(f"{k} {got[4 * i]} registers, {got[4 * i + 1]} "
                          f"spilled bytes, {got[4 * i + 2]} B shared, "
                          f"{got[4 * i + 3]} blocks an SM"
                          for i, k in enumerate(SSD_BWD_KERNELS)),
              flush=True)
    if wrong:
        raise SystemExit(f"mamba2_ssd_bwd: builds {wrong} gave wrong "
                         f"gradients")


def sass_hmma(so, kernels) -> dict:
    """{instantiation of a kernel named in ``kernels``: (HMMA instructions,
    those on TF32)} in a build's SASS (cuobjdump -sass); an instantiation
    is named by the kernel (where several are asked for), its T and its
    integer template arguments."""
    import re
    sass = subprocess.run(["cuobjdump", "-sass", str(so)],
                          capture_output=True, text=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            hit = [k for k in kernels if k in m.group(1)]
            fn = None
            if hit:
                # <kernel>I<T>Li<KU>ELi<KL>E...: name it by T and slots
                t = "bf16" if "nv_bfloat16" in m.group(1) else "f32"
                slots = re.findall(r"Li(\d+)E", m.group(1))
                fn = (f"{hit[0] + ' ' if len(kernels) > 1 else ''}<{t}"
                      f"{', ' + ', '.join(slots) if slots else ''}>")
                counts[fn] = [0, 0]
            continue
        if fn and "HMMA" in line:
            counts[fn][0] += 1
            counts[fn][1] += "TF32" in line
    return {k: tuple(v) for k, v in counts.items()}


def step_decay_bwd_call(lib, args, part, done, outs):
    """One call of a build's step_decay_bwd launcher on [rows, H] inputs
    (``done``: its counters, where the build takes them)."""
    import torch
    g_dt, g_a, raw, bias, a_log, dt, a = args
    fn = lib.mamba2_step_decay_bwd_launch
    ptrs = [part.data_ptr()] + ([done.data_ptr()] if lib.takes_done else [])
    fn.argtypes = ([ctypes.c_void_p] * (10 + len(ptrs)) + [ctypes.c_int] * 2
                   + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])
    rows = raw.reshape(-1, raw.shape[-1])
    rc = fn(g_dt.data_ptr(), g_a.data_ptr(), rows.data_ptr(), dt.data_ptr(),
            a.data_ptr(), bias.data_ptr(), a_log.data_ptr(),
            outs[0].data_ptr(), *ptrs, outs[1].data_ptr(),
            outs[2].data_ptr(), rows.shape[0], rows.shape[1], rows.stride(0),
            int(raw.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"step_decay_bwd launch failed: CUDA error {rc}")


def probe_step_decay_bwd(libs, cs) -> None:
    """Every build's step_decay_bwd at zamba2's training shape (dt_raw a
    bf16 view of the projection, [2, 4096, 80]), held to the plain version
    (chip_smoke.grads_held) and timed in turns with one launch of a
    one-element add_, 50 launches a timing."""
    import torch
    from repro_torch.kernels.mamba2.ref import (step_and_decay_bwd_ref,
                                                step_and_decay_ref)
    gen = torch.Generator().manual_seed(0)
    proj = (torch.randn(2, 4096, ZAMBA2_PROJ, generator=gen) * 3).to(
        torch.bfloat16).cuda()
    raw = proj[..., ZAMBA2_DT_COL:]
    bias = torch.randn(raw.shape[-1], generator=gen).cuda()
    a_log = (torch.rand(raw.shape[-1], generator=gen) * 6 - 3).cuda()
    dt, a = step_and_decay_ref(raw, bias, a_log)
    g_dt, g_a = (torch.randn(dt.shape, generator=gen).cuda()
                 for _ in range(2))
    args = (g_dt, g_a, raw, bias, a_log, dt, a)
    want = step_and_decay_bwd_ref(*args)
    calls = {}
    for (kernel, name), lib in libs.items():
        if kernel != "mamba2_ssd" or not hasattr(
                lib, "mamba2_step_decay_bwd_launch"):
            continue
        lib.mamba2_step_decay_bwd_tiles.argtypes = [ctypes.c_int]
        tiles = lib.mamba2_step_decay_bwd_tiles(raw.numel() // raw.shape[-1])
        part = torch.empty((tiles, 2, raw.shape[-1]), device="cuda")
        done = torch.zeros(64, dtype=torch.int32, device="cuda")
        outs = (torch.empty(raw.shape, dtype=raw.dtype, device="cuda"),
                torch.empty(raw.shape[-1], device="cuda"),
                torch.empty(raw.shape[-1], device="cuda"))
        step_decay_bwd_call(lib, args, part, done, outs)
        cs.grads_held(f"{name} build's step_decay_bwd", cs.STEP_DECAY_GRADS,
                      outs, want)
        calls[name] = lambda lib=lib, part=part, done=done, outs=outs: (
            step_decay_bwd_call(lib, args, part, done, outs))
    one = torch.zeros(1, device="cuda")
    calls["empty launch"] = lambda: one.add_(1)
    names = list(calls)
    times = {name: [] for name in names}
    for order in (names, names[::-1]) * 2:
        for name in order:
            times[name].append(cs.time_ms(calls[name], reps=50))
    print(f"step_decay_bwd {tuple(raw.shape)} bf16 view: " + ", ".join(
        f"{n} {min(t) * 1e3:.2f} us" for n, t in times.items()), flush=True)


PROBES = {"token_select": lambda libs, cs: probe_draws(libs, cs,
                                                      "token_select"),
          "tick_step": lambda libs, cs: probe_draws(libs, cs, "tick_step"),
          "flash_attention": lambda libs, cs: (probe_flash(libs, cs),
                                               probe_flash_bwd(libs, cs)),
          "mamba2_ssd": lambda libs, cs: (probe_mamba2(libs, cs),
                                          probe_step_decay(libs, cs),
                                          probe_ssd_bwd(libs, cs),
                                          probe_step_decay_bwd(libs, cs)),
          "wkv6": lambda libs, cs: (probe_wkv6(libs, cs),
                                    probe_wkv6_bwd(libs, cs))}


def main(argv=None) -> int:
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", type=Path, action="append", default=[],
                    help="root of another checkout whose kernels to time "
                    "(repeatable; each build is named by its directory)")
    ap.add_argument("kernels", nargs="*", default=list(EDITS),
                    choices=list(EDITS), help="kernels to probe (default: "
                    "all)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_kernel_builds: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as cs
    with tempfile.TemporaryDirectory() as tmp:
        others = {path.resolve().name: path for path in args.other}
        if len(others) != len(args.other) or "checkout" in others:
            raise SystemExit("--other directories need distinct names, "
                             "not 'checkout'")
        libs = build_all(args.kernels, others, Path(tmp))
        for kernel in args.kernels:
            PROBES[kernel](libs, cs)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
