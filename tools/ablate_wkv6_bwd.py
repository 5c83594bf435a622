#!/usr/bin/env python3
"""Where the WKV backward's chunk_bwd spends its time, on one card.

    python3 tools/ablate_wkv6_bwd.py [OTHER ...]

Builds ``csrc/wkv6.cu`` as it is and, beside it, builds that each skip
one part of ``wkv_chunk_bwd_kernel`` (a text edit, as
``tools/probe_kernel_builds.py`` edits a source: their gradients are
wrong and not held) and one that reads ``clock64`` at its phase
boundaries; ``OTHER`` names checkouts under ``build/`` (e.g. the parent
commit unpacked with ``git archive``) built beside them.  Times
chunk_bwd + sum_du and chunk_dstate of every build at rwkv6-7b's training
shape (B = 2, S = 4096, H = 64, K = 64, chunk 64, bf16), in turns, the
best of two medians of CUDA-event timings (``chip_smoke.time_ms``), then
prints the share of thread 0's cycles in each phase (summed over the
blocks).  Exits 2 without a card.
"""
import ctypes
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src"), str(ROOT / "tools")]

#: One of thread 0's readings: the cycles since the last, into g_clk[i].
CLK = ("if (threadIdx.x == 0) { const long long now = clock64(); "
       "atomicAdd(&g_clk[{i}], (unsigned long long)(now - t_prev)); "
       "t_prev = now; }\n")


def clk(i):
    return CLK.replace("{i}", str(i))


#: Build name -> [(text in wkv6.cu, its replacement)].  "clocks" reads
#: thread 0's clock after staging (0), the prefix (1), D and A (2), P and
#: Q (3), dv (4) and the wait for the next head (5); the no_* builds skip
#: a part behind a condition the compiler cannot drop (L < 0 is never
#: true); one_block sizes chunk_bwd for one block an SM.
E = {
    "clocks": [
        ("constexpr int kWarps = kThreads / 32;\n",
         "constexpr int kWarps = kThreads / 32;\n"
         "__device__ unsigned long long g_clk[8];\n"),
        ("  const long long g0 = ((long long)blk.bi * S + (long long)blk.ci * "
         "L) * row;\n  zero_pads(rs, lt, lp, kp, L, K);",
         "  const long long g0 = ((long long)blk.bi * S + (long long)blk.ci * "
         "L) * row;\n  long long t_prev = clock64();\n"
         "  zero_pads(rs, lt, lp, kp, L, K);"),
        ("    __syncthreads();  // the previous head is done with every "
         "buffer\n    stage(rs, lt, r + gh, row, L, K);\n    stage(ks,",
         "    __syncthreads();  // the previous head is done with every "
         "buffer\n" + clk(5) + "    stage(rs, lt, r + gh, row, L, K);\n"
         "    stage(ks,"),
        ("    async_copy::wait<0>();\n    __syncthreads();\n"
         "    const MatOf<T> V",
         "    async_copy::wait<0>();\n    __syncthreads();\n" + clk(0)
         + "    const MatOf<T> V"),
        ("    for (int kk = K + tid; kk < kp; kk += kThreads) tot[kk] = 0.f;\n"
         "    __syncthreads();\n",
         "    for (int kk = K + tid; kk < kp; kk += kThreads) tot[kk] = 0.f;\n"
         "    __syncthreads();\n" + clk(1)),
        ("    }\n    __syncthreads();\n\n    // 3. P and Q of rows",
         "    }\n    __syncthreads();\n" + clk(2)
         + "\n    // 3. P and Q of rows"),
        ("    const int nq4 = (nk + 3) / 4;\n"
         "    for (int d = warp; d < nb * nq4",
         clk(3) + "    const int nq4 = (nk + 3) / 4;\n"
         "    for (int d = warp; d < nb * nq4"),
        ("      dv_unit(16 * (d / nq4), q0, min(4, nk - q0));\n    }\n  }\n}",
         "      dv_unit(16 * (d / nq4), q0, min(4, nk - q0));\n    }\n"
         + clk(4) + "  }\n}"),
        ("// du [H, K] <- the sum of du_part over (b, chunk) in ascending "
         "order.",
         'extern "C" int wkv_bwd_clocks(unsigned long long* out, int reset) '
         "{\n  unsigned long long z[8] = {};\n  if (reset) return (int)"
         "cudaMemcpyToSymbol(g_clk, z, sizeof(z));\n  return (int)"
         "cudaMemcpyFromSymbol(out, g_clk, sizeof(z));\n}\n"
         "// du [H, K] <- the sum of du_part over (b, chunk) in ascending "
         "order."),
    ],
    "no_prefix": [
        ("if (tid < K) tot[tid] = prefix(ls, cs, nullptr, lk, L, tid);",
         "if (tid < K) tot[tid] = 0.f;")],
    "no_2a": [
        ("    // 2a. warps: D's lower tiles, then A^T's anchored blocks.\n"
         "    {",
         "    // 2a. warps: D's lower tiles, then A^T's anchored blocks.\n"
         "    if (L < 0) {")],
    "no_2b": [
        ("    {\n      const int w = diag_lanes(kp), kq = kp / 4, n_off = 6 * "
         "nb;",
         "    if (L < 0) {\n      const int w = diag_lanes(kp), kq = kp / 4, "
         "n_off = 6 * nb;")],
    "no_pq_state": [("        if (s < n_st) {",
                     "        if (s < n_st && L < 0) {")],
    "no_pq_anch": [("        if (s < n_pa) {", "        if (s < n_pa && L < 0) {"),
                   ("        } else if (s < n_an) {",
                    "        } else if (s < n_an && L < 0) {")],
    "no_pq_diag": [("      for (int d = 1; d < 8; ++d) {",
                    "      for (int d = 1; d < 8 && L < 0; ++d) {"),
                   ("      {  // d = 8: rows g + 8 and g",
                    "      if (L < 0) {  // d = 8: rows g + 8 and g")],
    "no_dv": [
        ("      dv_unit(16 * (d / nq4), q0, min(4, nk - q0));\n    }\n  }\n}",
         "      if (L < 0) dv_unit(16 * (d / nq4), q0, min(4, nk - q0));\n"
         "    }\n  }\n}")],
    "no_pq": [
        ("      const bool first = a == nb - 1;  // the tile's first block: "
         "<dS', S'>\n",
         "      const bool first = a == nb - 1;  // the tile's first block: "
         "<dS', S'>\n      if (L >= 0) return;\n")],
    "no_dmma": [
        ("    for (int task = warp; task < n_tasks; task += kWarps) {",
         "    for (int task = warp; task < n_tasks && L < 0; task += "
         "kWarps) {")],
    "one_block": [("constexpr int kBwdBlocks = 2;",
                   "constexpr int kBwdBlocks = 1;")],
}


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        print("ablate_wkv6_bwd: needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    import probe_kernel_builds as pk
    from repro_torch.kernels.rwkv6 import ops
    pk.EDITS["wkv6"] = E
    case = (2, 4096, 64, 64, 64, "bfloat16", False, False, "normal", False)
    args, kw = cs.wkv6_bwd_inputs(case, "cuda", seed=0)
    r, k, v, lw, u, dy, _ = args
    others = {n: ROOT / "build" / n for n in argv}
    with tempfile.TemporaryDirectory() as tmp:
        libs = pk.build_all(["wkv6"], others, Path(tmp))
        calls = {}
        for (_, name), lib in libs.items():
            ops._launcher.cache_clear()
            ops._build._LIBS["wkv6"] = lib
            fns = {fn: ops._launcher(fn) for fn in
                   ("chunk_dstate", "state_pass_bwd", "chunk_bwd", "sum_du")}
            ops._launcher.cache_clear()

            def run(fn, fns=fns):
                real = ops._launcher
                ops._launcher = lambda n: fns[n]
                try:
                    fn()
                finally:
                    ops._launcher = real
            q = ops.chunk_dstate(r, dy, lw, chunk=64)
            calls[name] = {
                "bwd": lambda run=run, q=q: run(lambda: ops.chunk_bwd(
                    r, k, v, lw, u, dy, kw["s_in"], kw["sf"], q, chunk=64)),
                "dstate": lambda run=run: run(lambda: ops.chunk_dstate(
                    r, dy, lw, chunk=64))}
        names = list(calls)
        times = {n: {"bwd": [], "dstate": []} for n in names}
        for order in (names, names[::-1]):
            for n in order:
                for p in ("bwd", "dstate"):
                    times[n][p].append(cs.time_ms(calls[n][p], reps=10))
        for n in names:
            print(f"{n:14s} chunk_bwd+sum_du {min(times[n]['bwd']):.3f} ms  "
                  f"chunk_dstate {min(times[n]['dstate']):.3f} ms",
                  flush=True)
        fn = libs[("wkv6", "clocks")].wkv_bwd_clocks
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int]
        out = (ctypes.c_ulonglong * 8)()
        fn(out, 1)
        calls["clocks"]["bwd"]()
        torch.cuda.synchronize()
        fn(out, 0)
        total = sum(out[i] for i in range(6))
        phases = ("stage", "prefix", "D+A", "PQ", "dv", "wait at next head")
        print("clocks (thread 0 of each block, summed): " + ", ".join(
            f"{phases[i]} {out[i] / total:.3f}" for i in range(6)),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
