#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA card.  Phases,
each printing its lines before the last:

  device        the card (nvidia-smi name and power limit, torch's name)
  build         nvcc builds every kernel from ``src/repro_torch/kernels/csrc``
  kernels       each kernel against its plain PyTorch version on the card, at
                the engine's shapes and at edge shapes, with its time, bound
                and the plain version's time
  engine        the engine at the repo's facility-scale geometry
                (benchmarks/bench_fleet.py: S=128, J=1024, W=4) through
                ``repro_torch.api.Experiment``: themis and fifo on the fused
                path, themis on the per-worker scan path; every kernel launch
                counter is zeroed before and read after
  fused_vs_scan themis at S=8, J=64, W=4 for 2000 ticks on both worker
                paths: integer state bit-identical
  card_vs_cpu   the engine on the card against the engine on the CPU (held
                to the JAX reference by tests/test_torch_engine.py), stepped
                in lockstep at a small geometry on both worker paths: fifo
                counter-exact on every tick; themis counter-exact until its
                first flipped pick, which must be an edge-band draw (its
                tick is printed), then per-job completions within 2 %
  anchor        paper Fig. 8a (size-fair, 224 vs 56 procs): shared-window
                throughput ratio in [3.6, 4.4] (paper: 3.96)
  schedulers    gift, tbf, adaptbf and plan (the schedulers with no kernel
                mode in either package, so they run the per-worker scan) at
                the engine's fleet geometry with a 125-tick μ: conservation,
                plan never idle under demand, ms/tick; tick_step and
                token_select counters read 0 for the four, and themis/fifo
                fused launch tick_step once per tick
  schedulers_card_vs_cpu  each of the four on the card against the CPU in
                lockstep at the card_vs_cpu geometry for 500 ticks (μ = 50
                ticks): counter-exact until a first flipped pick, which
                must be an edge-band draw of the weighted pick
  batch         run_batch at the fleet geometry over 8 seeds for themis
                fused and fifo (8 x 128 = 1024 kernel rows per launch): each
                lane against run() with that seed (integer state exact,
                bytes_bin within the atomic adds' bound), ms per lane-tick
                beside the single run's ms/tick, one tick_step launch per
                batched tick; and tick_step / token_select timed at 1024
                rows beside their bound
  poisson       the fleet job list switched to Poisson arrivals through
                Experiment.arrivals (one job at λ >= 10 per server, so both
                of jax.random.poisson's branches run) on themis fused:
                arrivals within 5 sigma of their expectation, no host sync;
                the first 8 ticks' Poisson counts (131,072 lanes a tick)
                drawn again on the CPU from the same keys and rates: every
                count equal (the mismatch rate and each differing lane
                printed)
  figures       the paper's Fig. 8 a-c rows (themis) and Fig. 12 rows (all
                six schedulers) through repro_torch.bench at 2 s and 8
                seeds, each seed batch one run_batch; every mean held to
                src/repro_torch/bench/fig_reference.json (the JAX
                reference's rows at the same duration and seeds) within
                max(3 sqrt(cov_card^2 + cov_ref^2) |mean| / sqrt(8), 2 %
                of |mean|); the paper's values printed beside; the
                counters are zeroed before and read after each batch:
                one tick_step launch per tick for themis and fifo, none
                for the other four, no token_select launch
  scenarios     the scenario rows of repro_torch.bench.scenarios (the
                reference's benchmarks/bench_scenarios.py: opportunity
                fairness and checkpoint interference, themis against fifo,
                and one aggregate row per preset) at BENCH_SECONDS = 1.6
                (1 server, W = 8, dt 1 ms, one seed per run; cut from the
                reference's 2.4 to keep this phase and the next near
                120 s, above the 1.5 s at which a checkpoint window
                falls under a 0.1 s throughput bin): every row
                within 0.01 of src/repro_torch/bench/scen_reference.json
                (the reference's printed rows); the counters zeroed before
                and read after each run: one tick_step launch per tick, no
                token_select; ms/tick per run
  service       the burst-buffer service (repro_torch.bb) through
                Experiment.serve: the cross-plane ON/OFF case (the engine's
                and the replay's shares within the reference test's
                bounds), then each preset replayed through
                ``Experiment.from_scenario(preset(name)).serve().replay``
                (24 s, 0.25 s rounds, 4 requests per job per round, cut
                from 16 to keep this phase and the last near 120 s) on
                the card and on the CPU for themis and fifo, and for gift,
                tbf, adaptbf and plan on bursty-interferer: counts and
                completion order equal (a themis pick may differ only in
                the edge band, counted), token_select launches = themis
                pops (counted around each replay), pops per second on
                both; token_select at the service's [1, J] shape against
                its plain version on recorded draws, timed beside its bound
  serve         h2o-danube-1.8b at full width and depth in bf16 (random
                weights from a seed): batched prefill of 2 x 6000 tokens
                (past block_q and the 4096 window) through
                ``serve_step.make_prefill_step``, then 16 greedy decode
                steps; 24 flash_attention launches per prefill, finite
                logits, and prefill of the prompt plus k generated tokens
                agrees with k decode steps (k = 1, 8)
  serve_engine  the port's ServeEngine at full width with the set-up of
                ``repro_torch.launch.serve`` (3 tenants, size-fair, 4
                slots, 12 requests of 16 tokens, 8 new each; key seed 1,
                whose draws decide admissions): all complete, every
                token_select draw equals its plain version's, and the
                tenant admission sequence equals the same engine's on the
                CPU at the reduced config (a difference only as an
                edge-band draw)
  flash         the flash_attention kernel against its plain version on the
                card over a case list (float32 on the FMA kernel, bf16 on
                the tensor-core kernel; MHA and GQA, with and without a
                window, ragged S, head_dim 16-256, an offset and a
                non-causal case, the serving shape; every staging path:
                bf16 by cp.async, float32 by float4, and by element for
                head_dim 18, 81 and 250 and unaligned views; rows with no
                live key, written by the second kernel) and on the
                inputs layer 0 of the serve phase gave it; then its time at
                that shape beside its bound (tensor cores, SFU exponentials
                or bytes), the plain version's and
                scaled_dot_product_attention's
  serve_card_vs_cpu  full width cut to 2 layers, float32: one 1100-token
                prompt and 8 decode steps on the card and on the CPU,
                logits within rtol 1e-3 (atol 1e-3), greedy tokens equal
  serve_zamba2  zamba2-2.7b (54 Mamba-2 layers + a shared attention block
                every 6) as the serve phase: full width and depth, bf16,
                2 x 6000 tokens (not a multiple of the 128 SSD chunk, so the
                padded tail runs), 16 decode steps; 54 mamba2_ssd calls
                (each its three passes) and 9 flash_attention launches per
                prefill; prefill + k tokens against k decode steps holds
                the scan's final state, which fills the decode cache
  serve_rwkv6   rwkv6-7b the same way (6000 is not a multiple of the 64 WKV
                chunk); 32 wkv6 launches per prefill
  serve_engine_zamba2  the serve_engine phase on zamba2-2.7b at full width:
                all complete, every draw equals the plain token_select, and
                the admissions equal the CPU's (reduced zamba2)
  mamba2, wkv6  each scan kernel against its plain version on the card,
                output and final state, over a case list (float32 and bf16
                b/c or r/k/v, the reduced and the full widths, chunk 32, 64
                and 128, an initial state, strong decay, strided views) and
                on the inputs layer 0 of the serve phase gave it, and each
                of its three passes (chunk_state, state_pass, chunk_scan)
                against its own plain version; then its time at that shape
                and each pass's beside its bound (bytes, FMA or exponential
                rate; for wkv6 also the HBM floor of the passes' own
                traffic) and the plain version's
  ssm_card_vs_cpu  full width cut in depth, float32 (zamba2: one mamba
                block plus the shared block; rwkv6: 2 layers): one
                1100-token prompt and 8 decode steps on the card and on the
                CPU, logits within rtol 1e-3 (atol 1e-3), tokens equal

then one JSON line describing every kernel, the ``nvidia-smi`` line, and
as the last line ``{"ok": true, "device": {...}}``.  Any failure raises and
the script exits non-zero.  Without a CUDA card, or outside a checkout, it
exits 2 and prints no result.  It imports neither ``jax`` nor ``repro``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

#: Published H100 SXM peaks: HBM bytes/s, fp32 (non-tensor-core) op/s and
#: bf16 dense tensor-core op/s.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12
#: Exponentials per second of the special-function units: 16 results per
#: clock per SM for compute capability 9.0 (CUDA C++ Programming Guide,
#: throughput of native arithmetic instructions), 132 SMs, 1.98 GHz boost.
SFU_OPS_PER_S = 132 * 16 * 1.98e9

#: Facility-scale geometry of benchmarks/bench_fleet.py:41-62,83-86.
FLEET = dict(n_servers=128, max_jobs=1024, n_workers=4, dt=2e-4, wheel=128,
             ring_cap=16, bin_ticks=500)
FLEET_SECONDS = 0.1


def fleet_jobs(n_jobs: int, n_servers: int) -> list[dict]:
    """benchmarks/bench_fleet.py's mixed fleet: 8 users, job sizes 1-4,
    staggered starts."""
    return [dict(user=i % 8, size=min(1 + i % 4, n_servers), procs=2 + i % 6,
                 req_mb=1 + i % 4, start_s=0.002 * (i % 50),
                 think_s=0.004 + 0.001 * (i % 5)) for i in range(n_jobs)]


def striped_jobs(n_jobs: int, n_servers: int) -> list[dict]:
    """A mix whose jobs each span 1-4 explicit servers."""
    return [dict(user=i % 8, size=1 + i % 4,
                 servers=[(i + k) % n_servers for k in range(1 + i % 4)],
                 procs=4 + i % 9, req_mb=1 + i % 4, start_s=0.001 * (i % 20),
                 think_s=0.002 + 0.001 * (i % 3)) for i in range(n_jobs)]


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def time_ms(fn, reps: int = 50) -> float:
    """Median device time of ``fn`` over ``reps`` calls, by CUDA events.

    All calls are queued behind a sleep kernel, so the card runs them back
    to back and the events time the device work, not the host's launch
    overhead (for a call the host issues slower than the card runs it, such
    as a plain version of many small ops, the gaps still count)."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
    torch.cuda._sleep(50_000_000)
    events[0].record()
    for k in range(reps):
        fn()
        events[k + 1].record()
    torch.cuda.synchronize()
    times = sorted(a.elapsed_time(b) for a, b in zip(events, events[1:]))
    return times[len(times) // 2]


def bound_ms(n_bytes: float, n_ops: float,
             ops_per_s: float = FP32_OPS_PER_S) -> tuple[float, str]:
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / ops_per_s
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def needed_bytes(kernel, qcount, u, *, mode="themis", pops=None) -> int:
    """Bytes a kernel's function must move on these inputs: each input it
    needs read once, each output written once.  A draw needs the share of a
    demanded slot (qcount > 0) only; fifo reads neither shares nor u, and of
    the [S, J, W] window only the stamps its pops reach: min(pops + 1,
    qcount) per slot (at most one stamp per row more than it must)."""
    import torch
    s, j = qcount.shape
    w = u.shape[1]
    demanded = int((qcount > 0).sum())
    if kernel == "token_select":
        return s * j * 4 + demanded * 4 + s * w * 4 + s * w * 4
    out = s * w * (4 + 1 + 1) + s * j * 4 * 2
    if mode == "themis":
        return s * j * 4 + demanded * 4 + s * w * (1 + 4) + out
    stamps = int(torch.minimum(pops + 1, qcount).clamp_min(0).sum())
    return s * j * 4 + stamps * 4 + s * w + out


def kernel_inputs(s, j, w, device, seed, *, zero_shares=False,
                  single_live=False, no_demand=False):
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    shares = rng.random((s, j), dtype=np.float32)
    qcount = rng.integers(0, 4, (s, j)).astype(np.int32)
    qcount[rng.random((s, j)) < 0.5] = 0
    if zero_shares:
        shares[:] = 0
    if single_live:
        qcount[:] = 0
        qcount[np.arange(s), rng.integers(0, j, s)] = 3
    if no_demand:
        qcount[:] = 0
    window = np.cumsum(rng.random((s, j, w), dtype=np.float32), axis=-1)
    window = np.floor(window * 4) / 4          # FIFO ties, as ticks stamp
    free = rng.random((s, w)) < 0.9
    u = rng.random((s, w), dtype=np.float32)
    t = lambda a: torch.as_tensor(a, device=device).contiguous()
    return t(shares), t(qcount), t(window.astype(np.float32)), t(free), t(u)


def phase_device():
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    say("device", f"nvidia-smi: {smi}; torch: {torch.cuda.get_device_name(0)} "
        f"x{torch.cuda.device_count()}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    return smi


def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    per = _build.build()
    say("build", f"built {sorted(per)} in {time.perf_counter() - t0:.1f} s "
        f"(each: {', '.join(f'{k} {v:.1f} s' for k, v in per.items())})")


#: Device time per launch at the fleet shape before the warp-per-row
#: redesign (PERF.md section 6, run G of the wkv6 redesign: H100 80GB HBM3
#: at 700 W), microseconds; printed beside this run's times.
EARLIER_US = {"token_select": 9.44, "tick_step[themis]": 20.77,
              "tick_step[fifo]": 10.30}


def fused_equals_scan(shares, qcount, free, u):
    """The fused tick (tick_step themis, one launch) against the scan path
    (one token_select launch per worker on the live queue counts): picks
    and final counts bit-identical.  Returns the scan path's launches."""
    import torch
    from repro_torch.kernels.tick_step import ops as ts_ops
    from repro_torch.kernels.token_select import ops as tk_ops
    window = torch.zeros(qcount.shape + u.shape[1:], device=qcount.device)
    sel, valid, _, qout, _ = ts_ops.tick_step(shares, qcount, window, free,
                                              u, mode="themis")
    q = qcount.clone()
    rows = torch.arange(q.shape[0], device=q.device)
    for w in range(u.shape[1]):
        pick = tk_ops.token_select(shares, q, u[:, w:w + 1].contiguous())[:, 0]
        if not torch.equal(pick, sel[:, w]):
            raise AssertionError(f"fused vs scan draw {w}: picks differ")
        ok = free[:, w] & (pick >= 0)
        q = q.index_put((rows, pick.clamp_min(0).long()), -ok.to(q.dtype),
                        accumulate=True)
    if not torch.equal(q, qout):
        raise AssertionError("fused vs scan: final queue counts differ")
    return u.shape[1]


def phase_kernels(device, s=128, j=1024, w=4):
    """Every kernel against its plain version; returns per-kernel records."""
    import torch
    from repro_torch.kernels import parity
    from repro_torch.kernels.tick_step import ops as ts_ops
    from repro_torch.kernels.tick_step.ref import tick_step_ref
    from repro_torch.kernels.token_select import ops as tk_ops
    from repro_torch.kernels.token_select.ref import token_select_ref

    cases = [("main", s, j, w, {}), ("main-W1", s, j, 1, {}),
             ("J1000", s, 1000, w, {}),
             ("zero-shares", s, j, w, dict(zero_shares=True)),
             ("single-live", s, j, w, dict(single_live=True)),
             ("no-demand", s, j, w, dict(no_demand=True)),
             ("tiny", 3, 5, 2, {}), ("J4096", s, 4096, w, {})]
    names = ("token_select", "tick_step[themis]", "tick_step[fifo]")
    excused = dict.fromkeys(names, 0)
    err = dict.fromkeys(names, 0)
    before = {"token_select": tk_ops.LAUNCHES, "tick_step": ts_ops.LAUNCHES}

    def tally(kernel, case, result):
        lines, e = result
        for line in lines:
            say("kernels", f"edge-band draw excused, {kernel} case {case}: "
                f"{line}")
        excused[kernel] += len(lines)
        err[kernel] = max(err[kernel], e)

    for k, (name, cs, cj, cw, kw) in enumerate(cases):
        inputs = kernel_inputs(cs, cj, cw, device, seed=k, **kw)
        for dtype in (torch.float32, torch.bfloat16):
            # bf16 shares: both sides draw in the reference's bf16
            # arithmetic (its order of sums, bf16 roundings).
            shares, qcount, window, free, u = inputs
            shares = shares.to(dtype)
            wide = shares.float()
            tag = f"{name} {str(dtype)[6:]}"
            got = tk_ops.token_select(shares, qcount, u)
            torch.cuda.synchronize()
            tally("token_select", tag, parity.compare_token_select(
                got, token_select_ref(shares, qcount, u), wide, qcount, u))
            for mode in ("themis", "fifo"):
                got = ts_ops.tick_step(shares, qcount, window, free, u,
                                       mode=mode)
                torch.cuda.synchronize()
                want = tick_step_ref(shares, qcount, window, free, u,
                                     mode=mode)
                tally(f"tick_step[{mode}]", tag, parity.compare_tick_step(
                    got, want, wide, qcount, u, mode))
        say("kernels", f"case {name} (S={cs} J={cj} W={cw}), float32 and "
            "bf16 shares: token_select, tick_step themis+fifo agree with "
            "their plain versions")
    say("kernels", f"edge-band draws excused: {excused} (tolerance: a themis "
        "pick may differ only where u lies within J*2^-24 of a float64 "
        "segment end; fifo and all other outputs exact)")
    shares, qcount, _, free, u = kernel_inputs(s, j, w, device, seed=98)
    for dtype in (torch.float32, torch.bfloat16):
        fused_equals_scan(shares.to(dtype), qcount, free, u)
    say("kernels", f"fused tick_step themis = {w} token_select launches on "
        f"the live counts, bit for bit (S={s} J={j} W={w}, float32 and bf16 "
        "shares)")

    records = {}

    def report(name, ms, plain, b, by, nbytes, bf16_ms):
        say("kernels", f"{name} S={s} J={j}: {ms * 1e3:.2f} us (bf16 shares "
            f"{bf16_ms * 1e3:.2f} us; before the redesign "
            f"{EARLIER_US[name]:.2f} us), bound {b * 1e3:.3f} us ({by}, "
            f"{nbytes} bytes), kernel / bound {ms / b:.1f}, plain "
            f"{plain * 1e3:.1f} us")
        records[name] = dict(ms=ms, plain_ms=plain, bound_ms=b, bound_by=by,
                             max_abs_err=err[name], bf16_ms=bf16_ms)

    # What one launch costs on this card under the same timing, whatever
    # it computes: a one-element add_.
    one = torch.zeros(1, device=device)
    floor_ms = time_ms(lambda: one.add_(1))
    say("kernels", f"one launch of a one-element add_: {floor_ms * 1e3:.2f} "
        "us (the fixed cost of a launch under this timing)")
    # token_select at the scan path's shape (one draw per row per launch).
    shares, qcount, window, free, u = kernel_inputs(s, j, w, device, seed=99)
    half = shares.to(torch.bfloat16)
    u1 = u[:, :1].contiguous()
    ms = time_ms(lambda: tk_ops.token_select(shares, qcount, u1))
    bf16_ms = time_ms(lambda: tk_ops.token_select(half, qcount, u1))
    plain = time_ms(lambda: token_select_ref(shares, qcount, u1))
    nbytes = needed_bytes("token_select", qcount, u1)
    b, by = bound_ms(nbytes, s * j * (8 + 1))
    report("token_select", ms, plain, b, by, nbytes, bf16_ms)
    for mode in ("themis", "fifo"):
        ms = time_ms(lambda: ts_ops.tick_step(shares, qcount, window, free, u,
                                              mode=mode))
        bf16_ms = time_ms(lambda: ts_ops.tick_step(half, qcount, window, free,
                                                   u, mode=mode))
        plain = time_ms(lambda: tick_step_ref(shares, qcount, window, free, u,
                                              mode=mode))
        pops = ts_ops.tick_step(shares, qcount, window, free, u,
                                mode=mode)[4]
        nbytes = needed_bytes("tick_step", qcount, u, mode=mode, pops=pops)
        ops = s * w * j * (9 if mode == "themis" else 2)
        b, by = bound_ms(nbytes, ops)
        report(f"tick_step[{mode}]", ms, plain, b, by, nbytes, bf16_ms)
    launched = {"token_select": tk_ops.LAUNCHES - before["token_select"],
                "tick_step": ts_ops.LAUNCHES - before["tick_step"]}
    say("kernels", f"kernel launches in this phase: {launched}")
    if device != "cpu" and min(launched.values()) == 0:
        raise AssertionError(f"a kernel was never launched: {launched}")
    return records


def run_checked(tag, exp, seconds):
    """One Experiment run plus the engine's conservation checks."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = exp.run(seconds)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st = res.state
    backlog = int(st.qcount.sum())
    if int(res.issued.sum()) - int(res.completed.sum()) != backlog:
        raise AssertionError(f"{tag}: issued - completed != queued backlog")
    if exp.scheduler == "themis" and res.idle_worker_ticks != 0:
        raise AssertionError(f"{tag}: themis idled {res.idle_worker_ticks} "
                             "worker-ticks while demand existed")
    from repro_torch.core import metrics
    agg = metrics.total_gbps(res, 0.0, seconds)
    say("engine", f"{tag}: {res.ticks} ticks, {wall / res.ticks * 1e3:.3f} "
        f"ms/tick wall, aggregate {agg:.2f} GB/s, completed "
        f"{int(res.completed.sum())}, backlog {backlog}, dropped "
        f"{res.dropped}, idle worker-ticks {res.idle_worker_ticks}")
    return res, wall


INT_LEAVES = ("key", "qcount", "head", "wheel", "known", "synced", "issued",
              "completed", "idle_worker_ticks", "dropped")
FLOAT_LEAVES = ("arr_time", "free_at", "seg", "bytes_bin")


def int_leaves_equal(a, b):
    """The first integer leaf in which states ``a`` and ``b`` differ (they
    may lie on different devices), or None."""
    import torch
    for f in INT_LEAVES:
        x, y = getattr(a, f), getattr(b, f)
        if not torch.equal(x.to(y.device), y):
            return f
    if a.t != b.t:
        return "t"
    return None


def check_no_host_sync(exp, ticks=10):
    """Run ``ticks`` ticks with CUDA sync debugging set to raise: the tick
    loop must never wait for the card (no ``.item()``, no copy back, no
    blocking host-to-device copy)."""
    import torch
    from repro_torch.core import engine
    cfg, wl, table = exp.build()
    tick = engine.make_tick(cfg, wl, table, n_bins=1)
    params = engine.get_scheduler(cfg.scheduler).params(cfg)
    state = engine.init_state(cfg, 1)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(ticks):
            state = tick(params, state)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


def phase_engine(device, geometry=FLEET, seconds=FLEET_SECONDS):
    """The main path at fleet geometry; returns the launch counts."""
    from repro_torch.api import Experiment
    from repro_torch.kernels.tick_step import ops as ts_ops
    from repro_torch.kernels.token_select import ops as tk_ops
    jobs = fleet_jobs(geometry["max_jobs"], geometry["n_servers"])

    def exp(scheduler, impl):
        return Experiment(policy="user-fair", scheduler=scheduler,
                          device=device, tick_impl=impl,
                          **geometry).add_jobs(jobs)

    for scheduler, impl in (("themis", "fused"), ("fifo", "fused"),
                            ("themis", "scan")):
        check_no_host_sync(exp(scheduler, impl))
    say("engine", "tick loop ran 10 ticks per path under "
        "torch.cuda.set_sync_debug_mode('error'): no host sync")

    ts_ops.LAUNCHES = 0
    tk_ops.LAUNCHES = 0
    fused, wall_fused = run_checked("themis fused", exp("themis", "fused"),
                                    seconds)
    themis_launches = ts_ops.LAUNCHES
    fifo, wall_fifo = run_checked("fifo fused", exp("fifo", "fused"), seconds)
    scan, wall_scan = run_checked("themis scan", exp("themis", "scan"),
                                  seconds)
    launches = {"tick_step[themis]": themis_launches,
                "tick_step[fifo]": ts_ops.LAUNCHES - themis_launches,
                "token_select": tk_ops.LAUNCHES}
    ticks = fused.ticks
    for mode in ("themis", "fifo"):
        n = launches[f"tick_step[{mode}]"]
        if n != ticks:
            raise AssertionError(f"tick_step launched {n} times in the {mode} "
                                 f"run, expected one per fused tick ({ticks})")
    want = ticks * geometry["n_workers"]
    if launches["token_select"] != want:
        raise AssertionError(f"token_select launched {launches['token_select']}"
                             f" times, expected one per worker per scan tick "
                             f"({want})")
    bad = int_leaves_equal(fused.state, scan.state)
    if bad is not None:
        raise AssertionError(f"fleet themis fused vs scan: {bad} differs")
    say("engine", f"launches over the three runs: {launches}; themis fused "
        "and scan integer state bit-identical")
    return launches, dict(themis_ms_per_tick=wall_fused / ticks * 1e3,
                          fifo_ms_per_tick=wall_fifo / ticks * 1e3,
                          scan_ms_per_tick=wall_scan / ticks * 1e3)


def phase_fused_vs_scan(device, s=8, j=64, w=4, ticks=2000):
    import torch
    from repro_torch.api import Experiment
    from repro_torch.kernels.token_select import ops as tk_ops
    jobs = striped_jobs(j, s)
    dt = 1e-3
    out = {}
    tk_ops.LAUNCHES = 0
    for impl in ("fused", "scan"):
        out[impl] = Experiment(
            policy="user-fair", scheduler="themis", n_servers=s, max_jobs=j,
            n_workers=w, dt=dt, sync_ticks=250, device=device,
            tick_impl=impl).add_jobs(jobs).run(ticks * dt)
    if tk_ops.LAUNCHES != ticks * w:
        raise AssertionError(f"scan path launched token_select "
                             f"{tk_ops.LAUNCHES} times, expected {ticks * w}")
    bad = int_leaves_equal(out["fused"].state, out["scan"].state)
    if bad is not None:
        raise AssertionError(f"fused vs scan: {bad} differs")
    a, b = out["fused"].state.bytes_bin, out["scan"].state.bytes_bin
    if not torch.allclose(a, b, rtol=1e-6, atol=0.0):
        raise AssertionError("fused vs scan: bytes_bin beyond rtol 1e-6")
    say("fused_vs_scan", f"themis S={s} J={j} W={w} {ticks} ticks: integer "
        f"state bit-identical, bytes_bin max rel diff "
        f"{float(((a - b).abs() / b.abs().clamp_min(1)).max()):.2e} "
        f"(rtol 1e-6), completed {int(out['fused'].completed.sum())}, "
        f"token_select launches {tk_ops.LAUNCHES}")


#: The workload tests/test_torch_engine.py holds the CPU engine to the JAX
#: reference with: closed and interval arrivals, a group level, two servers.
LOCKSTEP_JOBS = [
    dict(user=0, size=2, procs=40, req_mb=8, think_s=0.002),
    dict(user=1, size=1, procs=20, req_mb=4, start_s=0.05),
    dict(user=2, group=1, size=1, procs=10, req_mb=16, start_s=0.05,
         think_s=0.001),
    dict(user=1, size=3, procs=7, req_mb=2, servers=[1],
         phases=[dict(start_s=0.0, duration_s=0.1, arrival="interval",
                      interval_s=0.01),
                 dict(start_s=0.15, duration_s=0.2)]),
]
LOCKSTEP_GEOM = dict(n_servers=2, max_jobs=8, n_workers=4, seed=3,
                     sync_ticks=50)


def recording(fn, log):
    """``fn`` (a kernel wrapper) that appends ``(name, inputs, outputs,
    mode)`` of every call, on the CPU, to ``log``."""
    def wrapper(*args, **kw):
        out = fn(*args, **kw)
        outs = out if isinstance(out, tuple) else (out,)
        log.append((fn.__name__, [a.cpu() for a in args],
                    [o.cpu() for o in outs], kw.get("mode", "themis")))
        return out
    return wrapper


def explain_divergence(card_calls, cpu_calls) -> str:
    """Name the edge-band pick that made a card tick differ from the CPU's.

    The tick's kernel calls are paired in order.  Up to the first pair whose
    outputs differ, every input must agree (shares within rtol 1e-5, the
    rest exactly), and that pair may differ only by edge-band picks
    (``repro_torch.kernels.parity``, the band taken around both sides'
    segment ends).  Raises ``AssertionError`` otherwise."""
    import torch
    from repro_torch.kernels import parity
    for (name, a_card, o_card, mode), (_, a_cpu, o_cpu, _) in zip(
            card_calls, cpu_calls):
        torch.testing.assert_close(a_card[0], a_cpu[0], rtol=1e-5, atol=1e-7,
                                   msg=f"{name}: card and CPU shares differ")
        for x, y in zip(a_card[1:], a_cpu[1:]):
            if not torch.equal(x, y):
                raise AssertionError(f"{name}: card and CPU inputs differ "
                                     "before any pick did")
        if all(torch.equal(x, y) for x, y in zip(o_card, o_cpu)):
            continue
        args = (a_cpu[0], a_cpu[1], a_cpu[-1])
        if name == "tick_step":
            lines, _ = parity.compare_tick_step(o_card, o_cpu, *args, mode,
                                                other_shares=a_card[0])
        else:
            lines, _ = parity.compare_token_select(o_card[0], o_cpu[0], *args,
                                                   other_shares=a_card[0])
        return f"{name} {mode}: " + "; ".join(lines)
    raise AssertionError("card and CPU states differ, but every kernel call "
                         "agreed")


def lockstep(scheduler, impl, device, ticks, make=None):
    """Step the engine on ``device`` and on the CPU together from the same
    Experiment: ``make(device)``, or by default ``LOCKSTEP_JOBS`` at
    ``LOCKSTEP_GEOM`` under user-fair with ``tick_impl=impl``.  Returns
    (first tick whose integer state differs or None, the excused pick that
    caused it, final state on ``device``, final CPU state).  fifo must
    never differ."""
    from repro_torch.api import Experiment
    from repro_torch.core import engine, tokens
    from repro_torch.kernels.tick_step import ops as ts_ops
    from repro_torch.kernels.token_select import ops as tk_ops

    def build(dev):
        exp = make(dev) if make is not None else Experiment(
            policy="user-fair", scheduler=scheduler, device=dev,
            tick_impl=impl, **LOCKSTEP_GEOM).add_jobs(LOCKSTEP_JOBS)
        cfg, wl, table = exp.build()
        n_bins = max(1, -(-ticks // cfg.bin_ticks))
        return (engine.make_tick(cfg, wl, table, n_bins),
                engine.get_scheduler(scheduler).params(cfg),
                engine.init_state(cfg, n_bins))

    (tick_d, p_d, st_d), (tick_c, p_c, st_c) = build(device), build("cpu")
    log: list = []
    saved = engine.tick_step, tokens.token_select
    engine.tick_step = recording(ts_ops.tick_step, log)
    tokens.token_select = recording(tk_ops.token_select, log)
    flip, why = None, None
    try:
        for t in range(ticks):
            log.clear()
            st_d = tick_d(p_d, st_d)
            calls_d = list(log)
            log.clear()
            st_c = tick_c(p_c, st_c)
            if flip is None and int_leaves_equal(st_d, st_c) is not None:
                if scheduler == "fifo":
                    raise AssertionError(
                        f"fifo {impl}: card and CPU differ in "
                        f"{int_leaves_equal(st_d, st_c)} at tick {t}")
                flip, why = t, explain_divergence(calls_d, list(log))
    finally:
        engine.tick_step, tokens.token_select = saved
    return flip, why, st_d, st_c


def phase_card_vs_cpu(device, ticks=1000):
    import torch
    for scheduler in ("fifo", "themis"):
        for impl in ("fused", "scan"):
            tag = f"{scheduler} {impl}"
            flip, why, a, b = lockstep(scheduler, impl, device, ticks)
            done_d, done_c = a.completed.cpu(), b.completed
            if flip is None:
                for f in FLOAT_LEAVES:
                    x, y = getattr(a, f).cpu(), getattr(b, f)
                    torch.testing.assert_close(
                        x, y, rtol=1e-5 if f == "seg" else 1e-6, atol=0.0,
                        msg=f"{tag}: {f} beyond tolerance")
                say("card_vs_cpu", f"{tag}: {ticks} ticks counter-exact, "
                    f"float leaves within rtol 1e-6 (seg 1e-5), completed "
                    f"{int(done_c.sum())}")
                continue
            say("card_vs_cpu", f"{tag}: first flipped pick at tick {flip}: "
                f"{why}")
            live = done_c > 0
            torch.testing.assert_close(
                done_d[live].double(), done_c[live].double(), rtol=0.02,
                atol=0.0, msg=f"{tag}: per-job completions beyond 2 %")
            if (done_d[~live] != 0).any():
                raise AssertionError(f"{tag}: a job completed on the card only")
            say("card_vs_cpu", f"{tag}: per-job completions within 2 % after "
                f"{ticks} ticks ({int(done_d.sum())} vs {int(done_c.sum())})")


def phase_anchor(device, seconds=6.0):
    from repro_torch.api import Experiment
    from repro_torch.core import metrics
    i0, i1 = 0.25 * seconds, 0.75 * seconds
    w0, w1 = seconds / 3, 2 * seconds / 3
    jobs = [dict(user=0, size=4, procs=224, req_mb=10, start_s=0,
                 end_s=seconds),
            dict(user=1, size=1, procs=56, req_mb=10, start_s=i0, end_s=i1)]
    res = Experiment(policy="size-fair", scheduler="themis", device=device
                     ).add_jobs(jobs).run(seconds)
    ratio = (metrics.median_gbps(res, 0, w0, w1)
             / max(metrics.median_gbps(res, 1, w0, w1), 1e-9))
    say("anchor", f"fig8a size-fair shared ratio {ratio:.3f} (paper 3.96, "
        "accepted [3.6, 4.4])")
    if not 3.6 <= ratio <= 4.4:
        raise AssertionError(f"fig8a ratio {ratio} outside [3.6, 4.4]")
    return ratio


# -- the paper's scheduler comparison ---------------------------------------

#: The schedulers with no kernel mode in either package: they run the
#: per-worker scan, the only implementation either package has of them.
SCAN_SCHEDULERS = ("gift", "tbf", "adaptbf", "plan")
#: μ of the fleet runs: four boundaries in the 500 ticks of 0.1 s.
FLEET_MU_TICKS = 125


def scheduler_params(name, mu_ticks):
    from repro_torch.core import params
    cls = {"gift": params.GiftParams, "tbf": params.TbfParams,
           "adaptbf": params.AdaptbfParams, "plan": params.PlanParams}[name]
    return cls(mu_ticks=mu_ticks)


def conserved(tag, res):
    """issued - completed equals the queued backlog, on every lane."""
    import numpy as np
    backlog = res.state.qcount.sum(dim=(-2, -1)).cpu().numpy()
    gap = res.issued.sum(axis=-1) - res.completed.sum(axis=-1)
    if not np.array_equal(np.asarray(gap), backlog):
        raise AssertionError(f"{tag}: issued - completed != queued backlog")


def reset_launches():
    from repro_torch.kernels.tick_step import ops as ts_ops
    from repro_torch.kernels.token_select import ops as tk_ops
    ts_ops.LAUNCHES = 0
    tk_ops.LAUNCHES = 0


def read_launches() -> dict:
    from repro_torch.kernels.tick_step import ops as ts_ops
    from repro_torch.kernels.token_select import ops as tk_ops
    return {"tick_step": ts_ops.LAUNCHES, "token_select": tk_ops.LAUNCHES}


def expect_launches(tag, device, got, want) -> None:
    """The kernel launch counts of a path (on the card; the CPU launches
    none, it runs the plain versions)."""
    if device != "cpu" and got != want:
        raise AssertionError(f"{tag}: kernel launches {got}, expected {want}")


def phase_schedulers(device, geometry=FLEET, seconds=FLEET_SECONDS):
    """The four scan schedulers at fleet geometry; returns ms/tick."""
    import torch
    from repro_torch.api import Experiment
    jobs = fleet_jobs(geometry["max_jobs"], geometry["n_servers"])

    def exp(scheduler, **kw):
        return Experiment(policy="user-fair", scheduler=scheduler,
                          device=device, **geometry, **kw).add_jobs(jobs)

    ms = {}
    for name in SCAN_SCHEDULERS:
        params = scheduler_params(name, FLEET_MU_TICKS)
        check_no_host_sync(exp(name, params=params))
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = exp(name, params=params).run(seconds)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = read_launches()
        if any(got.values()):
            raise AssertionError(f"{name}: kernel launches {got}; the scan "
                                 "path of a scheduler without a kernel mode "
                                 "launches neither draw kernel")
        conserved(name, res)
        if name == "plan" and res.idle_worker_ticks != 0:
            raise AssertionError(f"plan idled {res.idle_worker_ticks} "
                                 "worker-ticks while demand existed (it falls "
                                 "back to FIFO)")
        ms[name] = wall / res.ticks * 1e3
        say("schedulers", f"{name}: {res.ticks} ticks, {ms[name]:.3f} ms/tick "
            f"wall, completed {int(res.completed.sum())}, backlog "
            f"{int(res.state.qcount.sum())}, dropped {res.dropped}, idle "
            f"worker-ticks {res.idle_worker_ticks} (no tick_step or "
            "token_select launch); no host sync over 10 ticks")
    ticks = 50
    for name in ("themis", "fifo"):
        reset_launches()
        res = exp(name).run(ticks * geometry["dt"])
        expect_launches(f"{name} fused, {ticks} ticks (one tick_step per "
                        "tick)", device, read_launches(),
                        {"tick_step": ticks, "token_select": 0})
        conserved(name, res)
    say("schedulers", f"themis and fifo fused: one tick_step launch per tick "
        f"over {ticks} ticks, no token_select launch")
    return ms


def recording_picks(log):
    """``baselines._weighted_pick`` that appends ``(w, u, out)`` of every
    call, on the CPU, to ``log``."""
    from repro_torch.core import baselines
    inner = baselines._weighted_pick

    def wrapper(w, u):
        out = inner(w, u)
        log.append((w.cpu(), u.cpu(), out.cpu()))
        return out
    return inner, wrapper


def explain_pick(card_calls, cpu_calls) -> str:
    """The first weighted pick that differs between the card and the CPU
    must have equal inputs and a draw ``u * total`` within ``J`` float32
    roundoffs of a cumulative-weight boundary (computed in float64)."""
    import torch
    for k, ((w_d, u_d, o_d), (w_c, u_c, o_c)) in enumerate(
            zip(card_calls, cpu_calls)):
        if torch.equal(o_d, o_c):
            continue
        if not (torch.equal(w_d, w_c) and torch.equal(u_d, u_c)):
            raise AssertionError("a weighted pick's inputs differ between the "
                                 "card and the CPU before any pick did")
        w = w_c.double()
        total = w.sum(dim=-1)
        x = u_c.double() * total
        dist = (w.cumsum(dim=-1) - x[..., None]).abs().amin(dim=-1)
        band = dist <= w.shape[-1] * 2.0 ** -24 * total
        bad = (o_d != o_c) & ~band
        if bad.any():
            raise AssertionError(f"weighted pick {k}: a pick differs outside "
                                 "the edge band")
        rows = (o_d != o_c).nonzero().tolist()
        return (f"weighted pick {k} of the tick: {len(rows)} row(s) "
                f"{rows[:3]} differ, each draw within J * 2^-24 of a "
                "cumulative-weight boundary (edge band)")
    raise AssertionError("card and CPU states differ, but every weighted "
                         "pick agreed")


def phase_schedulers_card_vs_cpu(device, ticks=500, mu_ticks=50):
    import torch
    from repro_torch.api import Experiment
    from repro_torch.core import baselines, engine

    for name in SCAN_SCHEDULERS:
        def build(dev):
            cfg, wl, table = Experiment(
                policy="user-fair", scheduler=name, device=dev,
                params=scheduler_params(name, mu_ticks), **LOCKSTEP_GEOM
            ).add_jobs(LOCKSTEP_JOBS).build()
            n_bins = max(1, -(-ticks // cfg.bin_ticks))
            return (engine.make_tick(cfg, wl, table, n_bins),
                    engine.get_scheduler(name).params(cfg),
                    engine.init_state(cfg, n_bins))

        (tick_d, p_d, st_d), (tick_c, p_c, st_c) = build(device), build("cpu")
        log: list = []
        inner, baselines._weighted_pick = recording_picks(log)
        flip = why = None
        try:
            for t in range(ticks):
                log.clear()
                st_d = tick_d(p_d, st_d)
                calls_d = list(log)
                log.clear()
                st_c = tick_c(p_c, st_c)
                if flip is None and int_leaves_equal(st_d, st_c) is not None:
                    flip, why = t, explain_pick(calls_d, list(log))
        finally:
            baselines._weighted_pick = inner
        if flip is None:
            for f in FLOAT_LEAVES:
                torch.testing.assert_close(
                    getattr(st_d, f).cpu(), getattr(st_c, f), rtol=1e-6,
                    atol=0.0, msg=f"{name}: {f} beyond rtol 1e-6")
            say("schedulers_card_vs_cpu", f"{name}: {ticks} ticks "
                f"counter-exact, float leaves within rtol 1e-6, completed "
                f"{int(st_c.completed.sum())}")
        else:
            say("schedulers_card_vs_cpu", f"{name}: first flipped pick at "
                f"tick {flip}: {why}")


def lane_bytes_bound(cfg) -> int:
    """Float adds into one throughput bin of one job on the card: at most
    one per worker per tick of the bin.  Two orders of N float32 adds of
    non-negative terms differ by at most N ulps of the total."""
    return cfg.bin_ticks * cfg.n_servers * cfg.n_workers


def phase_batch(device, geometry=FLEET, seconds=0.05, n_seeds=8):
    """run_batch lanes against run(); returns (launches, ms, records)."""
    import numpy as np
    import torch
    from repro_torch.api import Experiment
    jobs = fleet_jobs(geometry["max_jobs"], geometry["n_servers"])
    seeds = tuple(range(n_seeds))
    out, launches = {}, {}
    for name in ("themis", "fifo"):
        def exp(seed):
            return Experiment(policy="user-fair", scheduler=name, seed=seed,
                              device=device, **geometry).add_jobs(jobs)
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batch = exp(0).run_batch(seconds, seeds=seeds)
        torch.cuda.synchronize()
        wall_batch = time.perf_counter() - t0
        got = read_launches()
        expect_launches(f"{name} batch (one tick_step per batched tick)",
                        device, got, {"tick_step": batch.ticks,
                                      "token_select": 0})
        launches[f"tick_step[{name}]"] = got["tick_step"]
        conserved(f"{name} batch", batch)
        cfg = exp(0).engine_config()
        n_adds = lane_bytes_bound(cfg)
        worst, walls = 0.0, []
        for k, seed in enumerate(seeds):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            one = exp(seed).run(seconds)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            for f in INT_LEAVES:
                a = getattr(batch.state, f)[k]
                b = getattr(one.state, f)
                if not torch.equal(a, b):
                    raise AssertionError(f"{name} lane {k}: {f} differs from "
                                         f"run(seed={seed})")
            a = batch.state.bytes_bin[k].cpu().double()
            b = one.state.bytes_bin.cpu().double()
            ulp = np.spacing(b.abs().numpy().astype(np.float32)).astype(float)
            gap = ((a - b).abs().numpy() / np.maximum(ulp, 1e-45)).max()
            if gap > n_adds:
                raise AssertionError(f"{name} lane {k}: bytes_bin {gap:.0f} "
                                     f"ulps from run(), bound {n_adds}")
            worst = max(worst, float(gap))
        per_lane = wall_batch / (batch.ticks * n_seeds) * 1e3
        single = float(np.median(walls)) / batch.ticks * 1e3
        out[name] = dict(ms_per_lane_tick=per_lane, ms_per_batched_tick=
                         wall_batch / batch.ticks * 1e3,
                         single_ms_per_tick=single)
        say("batch", f"{name}: {n_seeds} lanes x {batch.ticks} ticks, every "
            f"lane's integer state equals run() with its seed, bytes_bin "
            f"within {worst:.0f} ulps (bound {n_adds}: the adds per bin); "
            f"{per_lane:.3f} ms per lane-tick ({wall_batch / batch.ticks * 1e3:.3f}"
            f" ms per batched tick) against {single:.3f} ms/tick of one run; "
            f"tick_step launches {got['tick_step']}")
    return launches, out, kernel_rows_records(device, geometry, n_seeds)


def kernel_rows_records(device, geometry, lanes):
    """tick_step and token_select at the batched shape (lanes x S rows)."""
    from repro_torch.kernels.tick_step import ops as ts_ops
    from repro_torch.kernels.token_select import ops as tk_ops
    s = lanes * geometry["n_servers"]
    j, w = geometry["max_jobs"], geometry["n_workers"]
    shares, qcount, window, free, u = kernel_inputs(s, j, w, device, seed=97)
    u1 = u[:, :1].contiguous()
    rec = {}
    ms = time_ms(lambda: tk_ops.token_select(shares, qcount, u1))
    nbytes = needed_bytes("token_select", qcount, u1)
    b, by = bound_ms(nbytes, s * j * (8 + 1))
    rec["token_select"] = dict(ms_rows=ms, bound_ms_rows=b, rows=s)
    say("batch", f"token_select at {s} rows, J={j}: {ms * 1e3:.2f} us, bound "
        f"{b * 1e3:.3f} us ({by}, {nbytes} bytes)")
    for mode in ("themis", "fifo"):
        ms = time_ms(lambda: ts_ops.tick_step(shares, qcount, window, free, u,
                                              mode=mode))
        pops = ts_ops.tick_step(shares, qcount, window, free, u, mode=mode)[4]
        nbytes = needed_bytes("tick_step", qcount, u, mode=mode, pops=pops)
        b, by = bound_ms(nbytes, s * w * j * (9 if mode == "themis" else 2))
        rec[f"tick_step[{mode}]"] = dict(ms_rows=ms, bound_ms_rows=b, rows=s)
        say("batch", f"tick_step[{mode}] at {s} rows, J={j}, W={w}: "
            f"{ms * 1e3:.2f} us, bound {b * 1e3:.3f} us ({by}, {nbytes} bytes)")
    return rec


def expected_arrivals(wl, ticks) -> float:
    """Σ over ticks of every live Poisson phase's rate × procs."""
    import numpy as np
    start, end = wl.phase_start.cpu().numpy(), wl.phase_end.cpu().numpy()
    rate = wl.arrival_rate.cpu().numpy().astype(np.float64)
    from repro_torch.scenario.lowering import ARRIVAL_POISSON
    pois = (wl.arrival_mode.cpu().numpy() == ARRIVAL_POISSON) & (end > start)
    procs = wl.procs.cpu().numpy().sum(axis=0).astype(np.float64)
    t = np.arange(ticks)[:, None, None]
    live = pois[None] & (start[None] <= t) & (end[None] > t)
    return float((np.where(live, rate[None], 0.0).sum(axis=2) * procs).sum())


def poisson_card_vs_cpu(exp, ticks):
    """The engine's Poisson draws over ``ticks`` ticks of ``exp`` on its
    device, drawn again by ``prng.poisson`` on the CPU from the same keys
    and rates.  Returns (lanes drawn, every lane that differs as (tick,
    index, λ, count on the device, count on the CPU))."""
    from repro_torch.core import prng
    calls, inner = [], prng.poisson

    def wrapper(key, lam, **kw):
        out = inner(key, lam, **kw)
        calls.append((key, lam, kw, out[0]))
        return out
    prng.poisson = wrapper
    try:
        exp.run(ticks * exp.engine_config().dt)
    finally:
        prng.poisson = inner
    n, differ = 0, []
    for t, (key, lam, kw, got) in enumerate(calls):
        lam, got = lam.cpu(), got.cpu()
        want, _ = inner(key.cpu(), lam, **kw)
        n += got.numel()
        for idx in map(tuple, (got != want).nonzero().tolist()):
            differ.append((t, idx, float(lam[idx]), int(got[idx]),
                           int(want[idx])))
    return n, differ


def phase_poisson(device, geometry=FLEET, seconds=0.02, draw_ticks=8):
    """Fleet jobs on Poisson arrivals (themis fused); returns launches."""
    import math
    import torch
    from repro_torch.api import Experiment
    n_jobs, n_srv = geometry["max_jobs"], geometry["n_servers"]
    jobs = fleet_jobs(n_jobs, n_srv)

    def exp():
        e = Experiment(policy="user-fair", scheduler="themis",
                       device=device, **geometry).add_jobs(jobs)
        # ~0.1-0.7 arrivals per (server, job) per tick: Knuth's branch.
        e.arrivals(arrival="poisson", rate_hz=500.0)
        # One job per 8 at λ >= 10 per tick: the rejection branch.
        for j in range(0, n_jobs, 8):
            e.arrivals(job=j, rate_hz=1e5)
        return e

    check_no_host_sync(exp())
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = exp().run(seconds)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = read_launches()
    expect_launches("poisson (one tick_step per tick)", device, got,
                    {"tick_step": res.ticks, "token_select": 0})
    conserved("poisson", res)
    cfg, wl, _ = exp().build()
    lam = expected_arrivals(wl, res.ticks)
    arrived = int(res.issued.sum()) + res.dropped
    z = (arrived - lam) / math.sqrt(lam)
    if abs(z) > 5:
        raise AssertionError(f"poisson: {arrived} arrivals against an "
                             f"expectation of {lam:.1f} ({z:+.1f} sigma)")
    say("poisson", f"{res.ticks} ticks, {arrived} arrivals (issued "
        f"{int(res.issued.sum())} + dropped {res.dropped}) against an "
        f"expectation of {lam:.1f} ({z:+.2f} sigma), {wall / res.ticks * 1e3:.3f}"
        f" ms/tick, tick_step launches {got['tick_step']}; no host sync over "
        "10 ticks")
    n, differ = poisson_card_vs_cpu(exp(), draw_ticks)
    say("poisson", f"card against CPU: {len(differ)} of {n} Poisson draws "
        f"differ over {draw_ticks} ticks (rate {len(differ) / n:.3g})")
    for t, idx, rate, card, cpu in differ:
        say("poisson", f"  tick {t} lane {idx}: λ {rate:.6g}, card {card}, "
            f"CPU {cpu}")
    if differ:
        raise AssertionError(f"poisson: {len(differ)} draws differ between "
                             "the card and the CPU")
    return got["tick_step"], wall / res.ticks * 1e3


#: The paper's values for the rows that state one (for information).
PAPER = {"fig8a_size_fair_shared_ratio": "3.96",
         "fig8b_job_fair_ratio": "~1.0",
         "fig8c_user_fair_userA_vs_userB": "10.85/10.80 GB/s",
         "fig12_themis_vs_gift_pct": "+13.5-13.7 %",
         "fig12_themis_vs_tbf_pct": "+13.5-13.7 %",
         "fig12_themis_vs_gift_variation_pct": "19.5-40.4 % lower",
         "fig12_themis_vs_tbf_variation_pct": "19.5-40.4 % lower"}


def figure_tol(mean, cov, ref_mean, ref_cov, n_seeds) -> float:
    """3 standard errors of the difference of two seed means, at least 2 %
    of the reference mean."""
    import math
    se = math.sqrt(cov ** 2 + ref_cov ** 2) * abs(ref_mean) / math.sqrt(n_seeds)
    return max(3 * se, 0.02 * abs(ref_mean))


def recording_batches(log):
    """``Experiment.run_batch`` that zeroes the draw kernels' launch counts
    just before each call and appends ``(scheduler, ticks, launches)`` just
    after it."""
    from repro_torch.api import Experiment
    inner = Experiment.run_batch

    def wrapper(self, *args, **kw):
        reset_launches()
        out = inner(self, *args, **kw)
        log.append((self.scheduler, out.ticks, read_launches()))
        return out
    return inner, wrapper


def phase_figures(device, seconds=2.0, n_seeds=8):
    """Fig. 8 a-c and Fig. 12 on the card against the reference's rows;
    returns the launches of each fused mode and the rows."""
    from repro_torch.api import Experiment
    from repro_torch.bench import common, comparison, policies
    ref = common.load_reference()
    if ref["seconds"] != seconds or len(ref["seeds"]) != n_seeds:
        raise AssertionError(f"fig_reference.json holds {ref['seconds']} s x "
                             f"{len(ref['seeds'])} seeds, not {seconds} x "
                             f"{n_seeds}")
    seeds = tuple(ref["seeds"])
    log: list = []
    inner, Experiment.run_batch = recording_batches(log)
    try:
        rows = policies.run_fig8(seconds, seeds, device=device, table=False)
        n_fig8 = len(log)
        rows += comparison.run_fig12(seconds, seeds, device=device)
    finally:
        Experiment.run_batch = inner
    if [s for s, _, _ in log[:n_fig8]] != ["themis"] * 3:
        raise AssertionError(f"Fig. 8 a-c ran {log[:n_fig8]}, not three "
                             "themis batches")
    # Each batch of a fused scheduler (themis, fifo) launches tick_step once
    # per tick; the other four run the scan path without a draw kernel.
    launches = {"tick_step[themis]": 0, "tick_step[fifo]": 0}
    for k, (sched, ticks, got) in enumerate(log):
        fig = "Fig. 8" if k < n_fig8 else "Fig. 12"
        fused = sched in ("themis", "fifo")
        expect_launches(f"{fig} {sched} batch", device, got,
                        {"tick_step": ticks if fused else 0,
                         "token_select": 0})
        if fused:
            launches[f"tick_step[{sched}]"] += got["tick_step"]
        say("figures", f"{fig} {sched}: {ticks} batched ticks, kernel "
            f"launches {got}")
    failed = []
    for r in rows:
        want = ref["rows"][r.name]
        paper = f", paper {PAPER[r.name]}" if r.name in PAPER else ""
        if not r.covs:
            say("figures", f"{r.name}: {r.means[0]:+.2f} (reference "
                f"{want['means'][0]:+.2f}; a ratio of two gated rows, not "
                f"gated{paper})")
            continue
        for i, (m, c) in enumerate(zip(r.means, r.covs)):
            rm, rc = want["means"][i], want["covs"][i]
            tol = figure_tol(m, c, rm, rc, n_seeds)
            ok = abs(m - rm) <= tol + 1e-12
            say("figures", f"{r.name}{'[%d]' % i if len(r.means) > 1 else ''}"
                f": {m:.4f} cov {c * 100:.2f}% vs reference {rm:.4f} cov "
                f"{rc * 100:.2f}%, |diff| {abs(m - rm):.4f} <= tol {tol:.4f}: "
                f"{'ok' if ok else 'FAIL'} ({r.us_per_call} us per seed"
                f"{paper})")
            if not ok:
                failed.append(r.name)
    if failed:
        raise AssertionError(f"figure rows outside tolerance: {failed}")
    return launches, rows


# -- scenario trees and the burst-buffer service --------------------------------

#: A scenario row is one seed, so the card, the CPU and the reference agree
#: to the two digits the reference prints unless a pick flips; a row may
#: differ from the recorded text by one unit of its last digit (a value on
#: a rounding boundary).
SCEN_TOL = 0.01


def phase_scenarios(device, seconds=None):
    """The scenario rows of repro_torch.bench.scenarios on the card against
    the reference's (scen_reference.json); returns the launches of each
    fused mode and the ms/tick of each run."""
    import torch
    from repro_torch.bench import scenarios
    ref = json.loads((SRC / "repro_torch" / "bench" /
                      "scen_reference.json").read_text())
    seconds = ref["seconds"] if seconds is None else seconds
    if ref["seconds"] != seconds:
        raise AssertionError(f"scen_reference.json holds {ref['seconds']} s, "
                             f"not {seconds}")
    launches = {"tick_step[themis]": 0, "tick_step[fifo]": 0}
    ms = {}

    def counted(label, run):
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        res = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = read_launches()
        # Both scenario schedulers run the fused tick: one tick_step launch
        # per tick, no token_select.
        expect_launches(f"scenarios {label}", device, got,
                        {"tick_step": res.ticks, "token_select": 0})
        sched = "fifo" if label.endswith("fifo") else "themis"
        launches[f"tick_step[{sched}]"] += got["tick_step"]
        ms[label] = round(wall * 1e3 / res.ticks, 3)
        say("scenarios", f"{label} ({sched}): {res.ticks} ticks, "
            f"{ms[label]} ms/tick, kernel launches {got}")
        return res

    rows = scenarios.run_scen(seconds, device=device, wrap=counted)
    failed = []
    for r in rows:
        want = ref["rows"][r.name]
        diff = abs(r.means[0] - want["value"])
        ok = diff <= SCEN_TOL + 1e-9
        say("scenarios", f"{r.name}: {r.derived!r} vs reference "
            f"{want['derived']!r}, |diff| {diff:.4f} <= {SCEN_TOL}: "
            f"{'ok' if ok else 'FAIL'}"
            f"{'' if r.derived == want['derived'] else ' (text differs)'}")
        if not ok:
            failed.append(r.name)
    if failed:
        raise AssertionError(f"scenario rows outside tolerance: {failed}")
    return launches, ms


def recording_selects(log):
    """The themis scheduler's ``select_job`` that appends ``(shares,
    demand, u, pick)`` of every call (the tensors themselves, on their
    device) to ``log``."""
    from repro_torch.core import scheduler
    inner = scheduler.select_job

    def wrapper(shares, demand, u):
        out = inner(shares, demand, u)
        log.append((shares, demand, u, out))
        return out
    return inner, wrapper


def first_flip(card_calls, cpu_calls):
    """The first themis pop whose pick differs between the card and the
    CPU, or None; raises unless it is an edge-band draw."""
    import torch
    from repro_torch.kernels import parity
    for k, ((sh_d, dm_d, u_d, o_d), (sh_c, dm_c, u_c, o_c)) in enumerate(
            zip(card_calls, cpu_calls)):
        if int(o_d) == int(o_c):
            continue
        if not (dm_d.cpu().equal(dm_c) and u_d.cpu().equal(u_c)):
            raise AssertionError(f"pop {k}: the draw's demand or uniform "
                                 "differs between the card and the CPU")
        band = parity.edge_band(sh_c.float(), dm_c.to(torch.int32),
                                u_c.reshape(1, 1),
                                other_shares=sh_d.cpu().float())
        if not bool(band.all()):
            raise AssertionError(f"pop {k}: card and CPU picks differ outside "
                                 "the edge band")
        return k
    if len(card_calls) != len(cpu_calls):
        raise AssertionError("card and CPU made different numbers of themis "
                             "pops, but every pick agreed")
    return None


def replay(name, scheduler, device, seconds, round_s, reqs_per_round):
    """``Experiment.from_scenario(preset(name)).serve().replay(...)`` ->
    (ReplayResult, pops, wall seconds, themis select calls)."""
    import torch
    from repro_torch.api import Experiment
    from repro_torch.core import scheduler as sched_mod
    from repro_torch.scenario import preset
    svc = Experiment.from_scenario(preset(name), policy="job-fair",
                                   scheduler=scheduler,
                                   device=device).serve(autodrain=False)
    log: list = []
    inner, sched_mod.select_job = recording_selects(log)
    try:
        if device != "cpu":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = svc.replay(seconds, round_s=round_s,
                         reqs_per_round=reqs_per_round)
        if device != "cpu":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        sched_mod.select_job = inner
    pops = sum(len(srv.processed) for srv in svc.cluster.servers)
    return res, pops, wall, log


#: The presets every scheduler of ``SERVICE_ALL`` replays, and the one the
#: four interval schedulers replay too.
SERVICE_ALL = ("themis", "fifo")
SERVICE_INTERFERER = ("gift", "tbf", "adaptbf", "plan")


def phase_service(device, *, seconds=None, round_s=0.25, reqs_per_round=4,
                  reps=50):
    """The burst-buffer service on the card: the cross-plane ON/OFF shares,
    the presets replayed on the card and the CPU (counts and completion
    order equal; a themis pick may differ only in the edge band), one
    token_select launch per themis pop, pops per second on both, and
    token_select at the service's [1, J] shape against its plain version.
    Returns (token_select launches, the [1, J] record, pops/s)."""
    import numpy as np
    import torch
    from repro_torch.api import Experiment
    from repro_torch.kernels import parity
    from repro_torch.kernels.token_select import ops as tk_ops
    from repro_torch.kernels.token_select.ref import token_select_ref
    from repro_torch.scenario import PRESET_SECONDS, presets
    seconds = PRESET_SECONDS if seconds is None else seconds

    # (a) tests/test_scenario.py::TestCrossPlaneOnOff on the card.
    def onoff():
        return (Experiment(policy="job-fair", scheduler="themis", n_workers=4,
                           device=device)
                .add_job(user=0, procs=8, req_mb=10, end_s=2.0)
                .add_job(user=1, procs=8, req_mb=10)
                .phase(start_s=0.0, end_s=1.0))
    res = onoff().run(2.0)
    g0, g1 = res.mean_gbps(0, 0.2, 0.9), res.mean_gbps(1, 0.2, 0.9)
    eng_busy = g0 / (g0 + g1)
    off0 = res.mean_gbps(0, 1.3, 1.9)
    eng_idle = off0 / max(off0 + res.mean_gbps(1, 1.3, 1.9), 1e-9)
    rr = onoff().serve(autodrain=False).replay(2.0, round_s=0.125,
                                               reqs_per_round=24)
    bb_busy, bb_idle = rr.window_share(0, 0.125, 1.0), rr.window_share(
        0, 1.25, 2.0)
    ok = (abs(eng_busy - 0.5) <= 0.1 and abs(bb_busy - eng_busy) <= 0.15
          and abs(eng_idle - 1.0) <= 0.05 and abs(bb_idle - eng_idle) <= 0.05)
    say("service", f"ON/OFF: engine busy share {eng_busy:.4f} (0.5 +- 0.1), "
        f"replay {bb_busy:.4f} (engine +- 0.15); idle {eng_idle:.4f} "
        f"(1 +- 0.05), replay {bb_idle:.4f} (engine +- 0.05): "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("ON/OFF shares outside the reference's bounds")

    # (b)-(d) the presets on the card and on the CPU.
    launched, excused, themis_pops = 0, 0, 0
    rates = {"card": [0, 0.0], "cpu": [0, 0.0]}
    sample = None
    for name in presets():
        scheds = SERVICE_ALL + (SERVICE_INTERFERER
                                if name == "bursty-interferer" else ())
        for sched in scheds:
            reset_launches()
            got, pops, wall, calls = replay(name, sched, device, seconds,
                                            round_s, reqs_per_round)
            n = read_launches()
            want, pops_c, wall_c, calls_c = replay(name, sched, "cpu",
                                                   seconds, round_s,
                                                   reqs_per_round)
            # (c) one token_select launch per themis pop, none otherwise.
            expect_launches(f"service {name} {sched}", device, n,
                            {"tick_step": 0,
                             "token_select": pops if sched == "themis" else 0})
            launched += n["token_select"]
            flip = None
            if sched == "themis":
                themis_pops += pops
                flip = first_flip(calls, calls_c)
                if sample is None:
                    sample = calls[:256]
            same = (np.array_equal(got.counts, want.counts)
                    and got.order == want.order)
            if flip is not None:
                excused += 1
                say("service", f"{name} {sched}: edge-band draw excused at "
                    f"themis pop {flip}; the orders after it are not held")
            elif not same:
                raise AssertionError(f"service {name} {sched}: counts or "
                                     "order differ between card and CPU")
            rates["card"][0] += pops
            rates["card"][1] += wall
            rates["cpu"][0] += pops_c
            rates["cpu"][1] += wall_c
            say("service", f"{name} {sched}: {pops} pops, "
                f"{int(got.counts.sum())} writes in {got.n_rounds} rounds, "
                f"counts and order equal to the CPU's: "
                f"{'yes' if same else 'until the excused draw'}; "
                f"{pops / wall:.0f} pops/s on the card, "
                f"{pops_c / wall_c:.0f} on the CPU; token_select launches "
                f"{n['token_select']}")
    pops_s = {k: round(p / w, 1) for k, (p, w) in rates.items()}
    say("service", f"themis pops {themis_pops}, token_select launches "
        f"{launched}; edge-band draws excused: {excused}; pops/s "
        f"{json.dumps(pops_s)}")

    # token_select at the service's shape: one [1, J] row, one draw.
    errs = 0
    for sh, dm, u, _ in sample:
        q = dm.to(torch.int32)
        u1 = u.reshape(1, 1).contiguous()
        got = tk_ops.token_select(sh.contiguous(), q, u1)
        torch.cuda.synchronize()
        lines, _ = parity.compare_token_select(
            got, token_select_ref(sh, q, u1), sh, q, u1)
        errs += len(lines)
    if errs:
        raise AssertionError(f"token_select [1, J]: {errs} draws apart from "
                             "the plain version")
    sh, dm, u, _ = sample[-1]
    sh, q, u1 = sh.contiguous(), dm.to(torch.int32), u.reshape(1, 1)
    j = sh.shape[-1]
    ms = time_ms(lambda: tk_ops.token_select(sh, q, u1), reps)
    plain = time_ms(lambda: token_select_ref(sh, q, u1), reps)
    nbytes = needed_bytes("token_select", q, u1)
    b, by = bound_ms(nbytes, j * (8 + 1))
    say("service", f"token_select [1, {j}] (the service's shape): "
        f"{len(sample)} recorded draws equal the plain version's; "
        f"{ms * 1e3:.2f} us, plain {plain * 1e3:.1f} us, bound "
        f"{b * 1e3:.5f} us ({by}, {nbytes} bytes)")
    record = dict(service_shape=[1, j], service_ms=ms, service_plain_ms=plain,
                  service_bound_ms=b, service_bound_by=by,
                  service_launches=launched)
    return launched, record, pops_s


# -- the dense serving path (h2o-danube-1.8b) -----------------------------------

SERVE_ARCH = "h2o-danube-1.8b"
#: Logits of the bf16 model through two paths (one prefill against k decode
#: steps) round their bf16 intermediates at different places: the GEMMs of
#: 12,000 rows and of 2 rows sum in other orders, and decode rounds q*scale
#: and the probabilities to bf16 where the flash kernel keeps float32.  Each
#: rounding is 2^-9 relative; compounded over the ~100 rounded tensors of 24
#: layers the logits (of unit scale in this random model) differ by noise
#: of ~2 % RMS, whose largest value over 2 x 32,000 logits is ~5 sigma.  So
#: the RMS of the difference may be 2^-5 of the logits' RMS and its largest
#: value 2^-3.  (A first bound of 2^-4 on the largest value alone was
#: exceeded by 28 of 64,000 logits, at most 0.086, on an H100.)
BF16_LOGIT_TOL = dict(rms=2.0 ** -5, max=2.0 ** -3)
#: float32 on the card against float32 on the CPU: sums in another order.
F32_LOGIT_TOL = dict(atol=1e-3, rtol=1e-3)
#: The recurrent models (zamba2, rwkv6) in float32 arithmetic at full width
#: and depth, prefill of the prompt plus k tokens against k decode steps:
#: measured on an H100 at RMS 1.7e-4 and max 8.2e-4 (zamba2, k = 8, the
#: same with the kernels or their plain versions), the drift of 63 layers
#: of float32 sums in two orders.  A fault in the state a scan hands to the
#: decode cache moves the logits by their own scale.
F32_DEPTH_TOL = dict(rms=2.0 ** -10, max=2.0 ** -7)


def logit_gap(got, want) -> tuple[float, float]:
    """(max |got - want|, RMS(got - want) / RMS(want)) in float32."""
    diff = (got - want).float()
    return (float(diff.abs().max()),
            float(diff.square().mean().sqrt()
                  / want.float().square().mean().sqrt()))


def serve_config(reduced=False, arch=SERVE_ARCH, **overrides):
    import dataclasses
    from repro_torch.configs.base import get_config
    return dataclasses.replace(get_config(arch, reduced=reduced),
                               **overrides)


def kernel_ops() -> dict:
    """The serving path's kernel wrapper modules, by kernel name."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.mamba2 import ops as ssd_ops
    from repro_torch.kernels.rwkv6 import ops as wkv_ops
    return {"flash_attention": fa_ops, "mamba2_ssd": ssd_ops, "wkv6": wkv_ops}


def launches_per_prefill(cfg) -> dict:
    """Kernel launches one prefill longer than ``block_q`` makes on the
    card: flash_attention per attention block (the shared block at each of
    its invocations), mamba2_ssd per mamba block, wkv6 per rwkv block."""
    kinds = [k for rep, ks in cfg.pattern for _ in range(rep) for k in ks]
    return {"flash_attention": sum(k in ("attn", "local", "global",
                                         "shared_attn") for k in kinds),
            "mamba2_ssd": kinds.count("mamba"), "wkv6": kinds.count("rwkv")}


def top2_gap(logits):
    """Gap between the two largest entries of each row (float32)."""
    import torch
    top = torch.topk(logits.float(), 2, dim=-1).values
    return top[..., 0] - top[..., 1]


def check_argmax(tag, want_logits, got_logits, vocab, atol, phase="serve"):
    """Greedy tokens equal, except where the top-2 gap of ``want_logits``
    is under ``2 * atol`` (two logits that each moved by at most ``atol``
    may swap): such a row is reported.  Returns the number of those rows."""
    import torch
    a = torch.argmax(want_logits[..., :vocab].float().cpu(), dim=-1)
    b = torch.argmax(got_logits[..., :vocab].float().cpu(), dim=-1)
    gap = top2_gap(want_logits[..., :vocab].cpu())
    bad = (a != b) & (gap >= 2 * atol)
    if bad.any():
        raise AssertionError(f"{tag}: greedy tokens differ at a top-2 gap "
                             f"of {float(gap[bad].min())} (tolerance "
                             f"{2 * atol})")
    swapped = int((a != b).sum())
    if swapped:
        say(phase, f"{tag}: {swapped} greedy token(s) swapped at a top-2 "
            f"gap under {2 * atol}: {gap[a != b].tolist()}")
    return swapped


def record_first_calls(store):
    """Patch the model modules' kernel wrappers so that the first call of
    each keeps a copy of its inputs in ``store[kernel]`` (``args``, a list
    of tensors or None, and ``kw``); returns the undo."""
    from repro_torch.models import attention, rwkv, ssm
    saved = []
    for module, name in ((attention, "flash_attention"), (ssm, "mamba2_ssd"),
                         (rwkv, "wkv6")):
        real = getattr(module, name)

        def wrapper(*args, _real=real, _name=name, **kw):
            if _name not in store:
                store[_name] = dict(
                    args=[a if a is None else a.clone() for a in args],
                    kw={k: v.clone() if hasattr(v, "clone") else v
                        for k, v in kw.items()})
            return _real(*args, **kw)

        setattr(module, name, wrapper)
        saved.append((module, name, real))

    def undo():
        for module, name, real in saved:
            setattr(module, name, real)
    return undo


def synced(device):
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return time.perf_counter()


def phase_serve(device, arch=SERVE_ARCH, *, tag="serve", reduced=False,
                seq=6000, steps=16):
    """A serving path at full width; returns (params, kernel launches in
    the phase by kernel, the inputs each kernel's first call got, metrics).
    Every launch counter is zeroed before the path runs and read after.

    Prefill of the prompt plus k generated tokens must agree with k decode
    steps.  For the dense model the bf16 bounds are BF16_LOGIT_TOL.  For a
    model with a recurrent scan (zamba2, rwkv6) the same weights also run
    in float32 arithmetic, where the two paths must agree within
    F32_DEPTH_TOL: that holds the final state each scan hands to the decode
    cache.  Their bf16 paths must then agree within BF16_LOGIT_TOL or within
    the bf16 prefill's own distance from the float32 one, whichever is
    larger: at full depth these random models' bf16 rounding noise (RMS
    0.22 for rwkv6, 0.64 for zamba2 against float32, on an H100) is far
    above the dense model's 0.02 that BF16_LOGIT_TOL was set for."""
    import copy
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.models import model as M
    from repro_torch.serve.serve_step import make_decode_step, make_prefill_step
    cfg = serve_config(reduced, arch)
    ops = kernel_ops()
    batch, check_ks = 2, (1, 8)
    t0 = synced(device)
    params = M.init_params(cfg, seed=0, device=device)
    say(tag, f"{cfg.name} d={cfg.d_model} layers={cfg.layer_count()} "
        f"pattern={cfg.pattern} heads={cfg.n_heads}/{cfg.n_kv_heads}x"
        f"{cfg.head_dim} window={cfg.window} {cfg.param_dtype}: "
        f"{cfg.param_count() / 1e9:.3f} B params initialised in "
        f"{synced(device) - t0:.1f} s")
    rng = np.random.default_rng(0)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab, (batch, seq)),
                             dtype=torch.int32, device=device)
    max_len = seq + steps
    prefill = make_prefill_step(cfg, max_len)
    decode = make_decode_step(cfg)
    per_prefill = launches_per_prefill(cfg)
    has_scan = per_prefill["mamba2_ssd"] + per_prefill["wkv6"] > 0
    if torch.device(device).type != "cuda":
        per_prefill = dict.fromkeys(per_prefill, 0)
    layer0: dict = {}

    def run_prefill(tokens, step=prefill, weights=params):
        before = {name: op.LAUNCHES for name, op in ops.items()}
        passes = dict(ssd_ops.PASS_LAUNCHES)
        t = synced(device)
        logits, caches = step(weights, {"tokens": tokens})
        wall = synced(device) - t
        n = {name: op.LAUNCHES - before[name] for name, op in ops.items()}
        if n != per_prefill:
            raise AssertionError(f"prefill of {tuple(tokens.shape)} launched "
                                 f"{n}, expected {per_prefill}")
        n_passes = {k: v - passes[k] for k, v in ssd_ops.PASS_LAUNCHES.items()}
        if set(n_passes.values()) != {n["mamba2_ssd"]}:
            raise AssertionError(f"prefill launched the mamba2_ssd passes "
                                 f"{n_passes} times, expected each once per "
                                 f"call ({n['mamba2_ssd']})")
        if not torch.isfinite(logits).all():
            raise AssertionError("prefill logits are not finite")
        return logits, caches, wall

    ssd_ops = ops["mamba2_ssd"]
    for op in ops.values():
        op.LAUNCHES = 0
    ssd_ops.PASS_LAUNCHES.update(dict.fromkeys(ssd_ops.PASS_LAUNCHES, 0))
    undo = record_first_calls(layer0)
    try:
        run_prefill(prompt)                                  # warm-up
    finally:
        undo()
    logits, caches, prefill_s = run_prefill(prompt)
    gen, step_logits, step_s = [], [], []
    tok = torch.argmax(logits[..., :cfg.vocab], dim=-1).to(torch.int32)
    for i in range(steps):
        gen.append(tok)
        pos = torch.full((batch,), seq + i, dtype=torch.int32, device=device)
        t = synced(device)
        logits, nxt, caches = decode(params, caches, {"tokens": tok}, pos)
        step_s.append(synced(device) - t)
        if not torch.isfinite(logits).all():
            raise AssertionError(f"decode step {i} logits are not finite")
        step_logits.append(logits)
        tok = torch.argmax(logits[..., :cfg.vocab], dim=-1).to(torch.int32)
    pf = {k: run_prefill(torch.cat([prompt] + gen[:k], dim=1))[0]
          for k in check_ks}
    tol = {k: dict(BF16_LOGIT_TOL) for k in check_ks}
    n_prefills = 2 + len(check_ks)
    if has_scan:
        del caches
        cfg32 = dataclasses.replace(cfg, dtype="float32",
                                    param_dtype="float32")
        params32 = copy.deepcopy(params).float()
        prefill32 = make_prefill_step(cfg32, max_len)
        decode32 = make_decode_step(cfg32)
        _, caches32, _ = run_prefill(prompt, prefill32, params32)
        dec32 = []
        for i in range(max(check_ks)):
            pos = torch.full((batch,), seq + i, dtype=torch.int32,
                             device=device)
            logits32, _, caches32 = decode32(params32, caches32,
                                             {"tokens": gen[i]}, pos)
            dec32.append(logits32)
        for k in check_ks:
            pf32 = run_prefill(torch.cat([prompt] + gen[:k], dim=1),
                               prefill32, params32)[0]
            err, rms = logit_gap(pf32, dec32[k - 1])
            say(tag, f"float32 arithmetic: prefill of prompt + {k} token(s) "
                f"vs decode step {k}: max |logit diff| {err:.4g}, RMS "
                f"{rms:.4g} (tolerance {F32_DEPTH_TOL})")
            if err > F32_DEPTH_TOL["max"] or rms > F32_DEPTH_TOL["rms"]:
                raise AssertionError(f"float32 prefill+{k} vs decode: "
                                     f"logits beyond {F32_DEPTH_TOL}")
            noise_max, noise_rms = logit_gap(pf[k], pf32)
            tol[k] = dict(rms=max(tol[k]["rms"], noise_rms),
                          max=max(tol[k]["max"], noise_max))
            say(tag, f"bf16 prefill of prompt + {k} vs float32: max "
                f"{noise_max:.4g}, RMS {noise_rms:.4g} (the bf16 noise)")
        del params32, caches32
        n_prefills += 1 + len(check_ks)
    worst = 0.0
    for k in check_ks:
        want = step_logits[k - 1]
        err, rms = logit_gap(pf[k], want)
        worst = max(worst, err)
        say(tag, f"prefill of prompt + {k} generated token(s) vs decode "
            f"step {k}: max |logit diff| {err:.4g}, RMS diff / RMS logit "
            f"{rms:.4g} (tolerance {tol[k]})")
        if err > tol[k]["max"] or rms > tol[k]["rms"]:
            raise AssertionError(f"prefill+{k} vs decode: logits beyond "
                                 f"{tol[k]}")
        # A swap is excused only where this measured difference explains it.
        check_argmax(f"prefill+{k} vs decode", want, pf[k], cfg.vocab,
                     err, phase=tag)
    launches = {name: op.LAUNCHES for name, op in ops.items()}
    decode_ms = sorted(step_s)[len(step_s) // 2] * 1e3
    metrics = dict(prefill_ms=prefill_s * 1e3,
                   prefill_tokens_per_s=batch * seq / prefill_s,
                   decode_ms_per_step=decode_ms,
                   decode_tokens_per_s=batch / (decode_ms / 1e3),
                   prefill_vs_decode_max_abs=worst)
    say(tag, f"prefill B={batch} S={seq}: {metrics['prefill_ms']:.1f} ms "
        f"({metrics['prefill_tokens_per_s']:.0f} tokens/s); decode at B="
        f"{batch}: {decode_ms:.2f} ms/step median of {steps} (one token per "
        f"sequence, {metrics['decode_tokens_per_s']:.1f} tokens/s); "
        f"kernel launches {launches} ({per_prefill} per prefill x "
        f"{n_prefills} prefills)")
    return params, launches, layer0, metrics


#: Key seed of the serve_engine phase's engine.  With seed 0 each of the
#: first 12 draws falls below 0.5, so every admission is the lowest tenant
#: with demand and the draws decide nothing; this seed's draws do (the phase
#: checks that some admission differs from that order).
SERVE_ENGINE_SEED = 1


def run_engine(cfg, params, device, seed=SERVE_ENGINE_SEED):
    """The launch/serve set-up on one device: (admitted tenant ids, the
    token_select calls made, requests, wall seconds)."""
    from repro_torch.core import tokens
    from repro_torch.kernels.token_select import ops as tk_ops
    from repro_torch.launch.serve import submit_tenant_requests
    from repro_torch.serve.engine import ServeEngine
    eng = ServeEngine(cfg, params, batch_slots=4, max_len=96,
                      policy="size-fair", seed=seed, device=device)
    reqs = submit_tenant_requests(eng, 12, prompt_len=16)
    admitted, calls = [], []
    start = eng._start

    def recorded_start(slot, req):
        admitted.append(req.tenant.tenant_id)
        start(slot, req)

    eng._start = recorded_start
    saved = tokens.token_select
    tokens.token_select = recording(tk_ops.token_select, calls)
    try:
        t0 = synced(device)
        eng.drain()
        wall = synced(device) - t0
    finally:
        tokens.token_select = saved
    return admitted, calls, reqs, wall


def draws_off_lowest(calls) -> int:
    """Recorded token_select calls (one draw each) whose pick is not the
    lowest slot with demand: the draws a kernel that ignored u would miss."""
    return sum(int(out[0][0, 0]) != int((args[1][0] > 0).int().argmax())
               for _, args, out, _ in calls)


def phase_serve_engine(device, params, *, arch=SERVE_ARCH, tag="serve_engine",
                       reduced=False):
    """ServeEngine on the card against the CPU (the arch's reduced config);
    returns (token_select launches, requests/s)."""
    from repro_torch.kernels import parity
    from repro_torch.kernels.token_select import ops as tk_ops
    from repro_torch.kernels.token_select.ref import token_select_ref
    from repro_torch.models import model as M
    cfg = serve_config(reduced, arch)
    tk_ops.LAUNCHES = 0
    admitted, calls, reqs, wall = run_engine(cfg, params, device)
    launches = tk_ops.LAUNCHES
    undone = [r.rid for r in reqs if r.finished_at is None
              or len(r.out_tokens) != r.max_new]
    if undone:
        raise AssertionError(f"requests {undone} did not complete")
    if device != "cpu" and launches != len(calls):
        raise AssertionError(f"token_select launched {launches} times for "
                             f"{len(calls)} admission draws")
    # Every draw the engine made, at the shape it made it, against the
    # plain version on the same inputs.
    excused = []
    for _, (shares, qcount, u), (got,), _ in calls:
        lines, _ = parity.compare_token_select(
            got, token_select_ref(shares, qcount, u), shares, qcount, u)
        excused += lines
    for line in excused:
        say(tag, f"excused edge-band draw: {line}")
    cpu_cfg = serve_config(True, arch)
    cpu_adm, cpu_calls, _, _ = run_engine(
        cpu_cfg, M.init_params(cpu_cfg, seed=0, device="cpu"), "cpu")
    off = draws_off_lowest(cpu_calls)
    if not off:
        raise AssertionError("every admission took the lowest tenant with "
                             "demand, so the draws decided nothing and the "
                             "comparison could not fail")
    if admitted != cpu_adm:
        first = next((i for i, (a, b) in enumerate(zip(admitted, cpu_adm))
                      if a != b), min(len(admitted), len(cpu_adm)))
        say(tag, f"admissions diverge from the CPU's at draw "
            f"{first}: {explain_divergence(calls, cpu_calls)}")
    rps = len(reqs) / wall
    say(tag, f"{cfg.name}: {len(reqs)} requests x 8 tokens over 3 tenants "
        f"(size-fair, 4 slots, key seed {SERVE_ENGINE_SEED}) in {wall:.2f} s: "
        f"{rps:.2f} requests/s; token_select launches {launches}, each "
        f"draw equal to the plain version's ({len(excused)} excused); "
        f"admissions {'equal to' if admitted == cpu_adm else 'excused against'}"
        f" the CPU engine's at the reduced config, {off} of {len(cpu_calls)} "
        f"not the lowest tenant with demand: {admitted}")
    return launches, rps


#: (B, Sq, Sk, H, Hk, D, window, causal, q_offset, storage_offset): MHA
#: and GQA 4:1, with and without a window, ragged S, every head_dim the
#: configs use and more (40 and 200 pad to the bf16 kernel's widths 48 and
#: 256 with cp.async staging), the serving shape itself, inputs the
#: kernels stage one element at a time (head_dim 18, 81 or 250, or views
#: ``storage_offset`` elements into their buffers, so not 16-byte aligned),
#: and continuations whose last rows have no live key (the window ends
#: before the first key: Sq + q_offset >= Sk + window), causal and not,
#: with Sk above and below the plain version's 512-key tile.
FLASH_CASES = [
    (1, 200, 200, 4, 4, 16, 0, True, 0, 0),
    (2, 200, 200, 8, 2, 32, 64, True, 0, 0),
    (1, 200, 200, 8, 2, 64, 0, True, 0, 0),
    (2, 200, 200, 32, 8, 80, 64, True, 0, 0),
    (1, 200, 200, 4, 1, 128, 0, True, 0, 0),
    (1, 200, 200, 8, 4, 256, 64, True, 0, 0),
    (1, 6000, 6000, 8, 2, 80, 0, True, 0, 0),
    (1, 6000, 6000, 4, 4, 80, 4096, True, 0, 0),
    (2, 6000, 6000, 32, 8, 80, 4096, True, 0, 0),
    (1, 136, 700, 8, 2, 80, 256, True, 564, 0),
    (1, 150, 300, 4, 2, 80, 0, False, 0, 0),
    (1, 200, 200, 8, 2, 18, 64, True, 0, 0),
    (2, 300, 300, 4, 4, 81, 0, True, 0, 0),
    (1, 200, 200, 8, 2, 80, 64, True, 0, 2),
    (1, 136, 700, 4, 1, 250, 256, True, 564, 2),
    (1, 200, 200, 4, 2, 40, 0, True, 0, 0),
    (1, 136, 700, 4, 1, 200, 256, True, 564, 0),
    (1, 300, 700, 8, 2, 80, 128, True, 600, 0),
    (1, 100, 60, 4, 4, 64, 16, False, 50, 0),
]
#: tests/test_kernels.py:129: 2e-5 in float32, 2e-2 in bf16 (in float32).
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def live_pairs(sq, sk, causal, window, q_offset) -> int:
    """(q, k) pairs the mask keeps, per (batch, head)."""
    import numpy as np
    qpos = np.arange(sq, dtype=np.int64) + q_offset
    lo = np.maximum(0, qpos - window + 1) if window > 0 else np.zeros_like(qpos)
    hi = np.minimum(sk - 1, qpos) if causal else np.full_like(qpos, sk - 1)
    return int(np.maximum(0, hi - lo + 1).sum())


def flash_inputs(case, dtype, device, seed):
    """q, k, v of a FLASH_CASES entry, normal from ``seed``, each a
    contiguous view ``storage_offset`` elements into its own buffer."""
    import numpy as np
    import torch
    b, sq, sk, h, hk, d = case[:6]
    off = case[9]
    rng = np.random.default_rng(seed)
    out = []
    for shape in ((b, sq, h, d), (b, sk, hk, d), (b, sk, hk, d)):
        x = torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32,
                            device=device).to(dtype)
        buf = torch.empty(off + x.numel(), dtype=dtype, device=device)
        out.append(buf[off:].view(shape).copy_(x))
    return out


#: The staging paths of ``csrc/flash_attention.cu``, each reached by some
#: FLASH_CASES entry.
FLASH_PATHS = ("bf16 by cp.async", "bf16 by element", "float32 by float4",
               "float32 by element")


def flash_path(q, k, v) -> str:
    """How the kernel stages these inputs, as its launcher decides: bf16 by
    16-byte cp.async copies when head_dim is a multiple of 8 and every
    operand is 16-byte aligned; float32 four elements per load when
    head_dim is a multiple of 4 and every operand is aligned to 4 elements;
    else element by element."""
    if q.element_size() == 2:                      # bfloat16
        fast = q.shape[-1] % 8 == 0 and all(t.data_ptr() % 16 == 0
                                            for t in (q, k, v))
        return FLASH_PATHS[0] if fast else FLASH_PATHS[1]
    fast = q.shape[-1] % 4 == 0 and all(t.data_ptr() % 16 == 0
                                        for t in (q, k, v))
    return FLASH_PATHS[2] if fast else FLASH_PATHS[3]


def flash_check(q, k, v, kw, tag):
    """Kernel against plain version on the same inputs; max abs err."""
    import torch
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    got = fa_ops.flash_attention(q, k, v, **kw)
    if q.is_cuda:
        torch.cuda.synchronize()
    want = flash_attention_ref(q, k, v, **kw)
    tol = FLASH_TOL[str(q.dtype).split(".")[-1]]
    err = float((got.float() - want.float()).abs().max())
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol,
                               msg=lambda m: f"flash {tag}: {m}")
    return err


def phase_flash(device, layer0, *, cases=FLASH_CASES, reps=10):
    """Returns the flash_attention record for the kernels line; ``layer0``
    is the first call the serve phase made (``record_first_calls``)."""
    import torch
    worst = 0.0
    staging = set()
    for dtype in (torch.float32, torch.bfloat16):
        for n, case in enumerate(cases):
            b, sq, sk, h, hk, d, win, causal, off, store = case
            q, k, v = flash_inputs(case, dtype, device, seed=n)
            kw = dict(causal=causal, window=win, q_offset=off)
            path = flash_path(q, k, v)
            staging.add(path)
            tag = (f"{str(dtype)[6:]} B={b} Sq={sq} Sk={sk} H={h} Hk={hk} "
                   f"D={d} window={win} causal={causal} q_offset={off} "
                   f"storage_offset={store} staged {path}")
            err = flash_check(q, k, v, kw, tag)
            worst = max(worst, err)
            say("flash", f"{tag}: max abs err {err:.3g}")
    if staging != set(FLASH_PATHS):
        raise AssertionError("the case list left a staging path of the "
                             f"kernel unchecked: {set(FLASH_PATHS) - staging}")
    record = flash_at_shape(layer0, "flash", "serve layer 0", reps=reps)
    record["max_abs_err"] = max(worst, record["max_abs_err"])
    return record


def flash_at_shape(layer0, phase, tag, *, reps=10):
    """The flash kernel on the inputs a serve phase's first attention call
    got: against its plain version, then its time beside its bound, the
    plain version's and scaled_dot_product_attention's."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    (q, k, v), kw = layer0["args"], layer0["kw"]
    err = flash_check(q, k, v, kw, tag)
    b, sq, h, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    say(phase, f"{tag} inputs {tuple(q.shape)} / {tuple(k.shape)} "
        f"{q.dtype} {kw}, staged {flash_path(q, k, v)}: max abs err "
        f"{err:.3g}")

    ms = time_ms(lambda: fa_ops.flash_attention(q, k, v, **kw), reps=reps)
    plain = time_ms(lambda: flash_attention_ref(q, k, v, **kw), reps=3)
    rep = h // hk
    qt = q.transpose(1, 2).contiguous()
    kt = k.repeat_interleave(rep, dim=2).transpose(1, 2).contiguous()
    vt = v.repeat_interleave(rep, dim=2).transpose(1, 2).contiguous()
    rel = (torch.arange(sq, device=q.device)[:, None] + kw["q_offset"]
           - torch.arange(sk, device=q.device)[None, :])
    mask = (rel >= 0) & (rel < kw["window"]) if kw["window"] else rel >= 0
    lib = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask), reps=reps)
    lib_err = float((F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
                     .transpose(1, 2).float()
                     - fa_ops.flash_attention(q, k, v, **kw).float())
                    .abs().max())
    pairs = live_pairs(sq, sk, kw["causal"], kw["window"], kw["q_offset"])
    nbytes = (q.numel() * 2 + k.numel() + v.numel()) * q.element_size()
    ops, exps = 4 * d * pairs * b * h, pairs * b * h
    if q.dtype == torch.bfloat16:
        bound, by, pipe = pipe_bound(nbytes, ops, exps, BF16_OPS_PER_S,
                                     "tensor cores")
    else:
        bound, by, pipe = pipe_bound(nbytes, ops, exps)
    say(phase, f"B={b} S={sq} H={h} Hk={hk} D={d} window={kw['window']} "
        f"{q.dtype}: kernel {ms:.3f} ms, bound {bound:.4f} ms ({by}, "
        f"{pipe}: {ops / 1e9:.1f} GFLOP and {exps / 1e9:.3f} G "
        f"exponentials over {pairs} live pairs per head, "
        f"{nbytes / 1e6:.1f} MB), plain {plain:.3f} ms, "
        f"scaled_dot_product_attention {lib:.3f} ms (max abs diff from the "
        f"kernel {lib_err:.3g}); kernel / bound {ms / bound:.1f}, kernel / "
        f"scaled_dot_product_attention {ms / lib:.2f}")
    return dict(ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by,
                bound_pipe=pipe, library_ms=lib, max_abs_err=err)


# -- the recurrent scans (mamba2_ssd, wkv6) ---------------------------------------

#: (B, S, H, P, N, chunk, b/c dtype, h0, decay, b/c as views): the reduced
#: (P=32, N=16) and full (P=N=64) widths, tests/test_kernels.py's shape,
#: chunk 32/64/128, an initial state, decay near the 1e-20 clamp
#: ("strong"), and b/c read in place as column slices of a wider tensor.
MAMBA2_CASES = [
    (2, 128, 2, 8, 16, 32, "float32", False, "normal", False),
    (2, 256, 4, 32, 16, 32, "float32", False, "normal", False),
    (2, 256, 4, 32, 16, 64, "bfloat16", True, "normal", False),
    (1, 512, 8, 64, 64, 128, "float32", False, "normal", False),
    (1, 256, 8, 64, 64, 64, "float32", True, "normal", True),
    (2, 384, 80, 64, 64, 128, "bfloat16", True, "normal", False),
    (1, 256, 4, 64, 64, 128, "float32", True, "strong", False),
    (1, 256, 4, 32, 16, 64, "bfloat16", False, "strong", True),
]
#: (B, S, H, K, chunk, r/k/v dtype, s0, decay): the reduced (K=32) and full
#: (K=64) widths, tests/test_kernels.py's shape, chunk 32/64/128 (128 with
#: K=64 only in bf16: the block's shared memory limits chunk x K, and r, k,
#: v stay in their own type there), an initial state, and lw down to -20
#: per step ("strong").
WKV6_CASES = [
    (2, 128, 3, 16, 32, "float32", False, "normal"),
    (2, 256, 4, 32, 32, "float32", False, "normal"),
    (2, 256, 4, 32, 64, "bfloat16", True, "normal"),
    (1, 256, 2, 32, 128, "float32", True, "normal"),
    (1, 512, 8, 64, 64, "float32", False, "normal"),
    (2, 320, 64, 64, 64, "bfloat16", True, "normal"),
    (1, 256, 4, 64, 32, "float32", True, "strong"),
    (1, 256, 4, 64, 64, "bfloat16", False, "strong"),
    (1, 256, 4, 64, 128, "bfloat16", True, "normal"),
]


#: Geometry the scan wrappers bring into the kernels' layout before they
#: launch (``kernel_layout``): (kernel, a case of the lists above, view).
#: wkv6 with K not a multiple of its 16-byte quantum (60 in bf16, 30 in
#: float32) and a strided v; mamba2_ssd with P and N not multiples of 4
#: and an x misaligned by one float.
LAYOUT_CASES = [
    ("wkv6", (2, 128, 2, 60, 32, "bfloat16", True, "normal"), None),
    ("wkv6", (1, 128, 2, 30, 64, "float32", True, "normal"), None),
    ("wkv6", (1, 128, 2, 32, 32, "float32", False, "normal"), "strided v"),
    ("mamba2_ssd", (2, 128, 2, 30, 18, 32, "float32", True, "normal", False),
     None),
    ("mamba2_ssd", (1, 128, 2, 32, 16, 64, "bfloat16", False, "normal",
                    True), "misaligned x"),
]


def layout_inputs(kernel, case, view, device, seed):
    """(args, kw) of a LAYOUT_CASES entry, the view applied."""
    import torch

    def shifted(t):
        """``t`` as a view one element into a wider tensor."""
        wide = torch.zeros(t.shape[:-1] + (t.shape[-1] + 1,), dtype=t.dtype,
                           device=t.device)
        wide[..., 1:] = t
        return wide[..., 1:]

    if kernel == "wkv6":
        r, k, v, lw, u, s0 = wkv6_inputs(case, device, seed)
        if view == "strided v":
            v = shifted(v)
        return (r, k, v, lw, u), dict(chunk=case[4], s0=s0)
    x, a, b, c, h0 = mamba2_inputs(case, device, seed)
    if view == "misaligned x":
        x = shifted(x)
    return (x, a, b, c), dict(chunk=case[5], h0=h0)


def prefix_tol(prefix) -> float:
    """Tolerance (atol and rtol) of a scan kernel against its plain version:
    max(2e-5, 4 * max|prefix| * 2**-24).  Both sum the log decay of a chunk
    into prefix sums (the kernel in order, the plain version's cumsum in
    another), and the rounding of a prefix sum of that size enters each
    gate's exponent; 2e-5 covers the rest of the float32 arithmetic, as
    tests/test_kernels.py's float32 tolerance does."""
    return max(2e-5, 4 * float(prefix.abs().max()) * 2.0 ** -24)


def chunk_prefix(log_decay, chunk):
    """In-chunk inclusive prefix sums of ``log_decay`` [B, S, ...]."""
    b, s = log_decay.shape[:2]
    return log_decay.reshape(b, s // chunk, chunk, -1).cumsum(dim=2)


def mamba2_inputs(case, device, seed):
    """x, a, b, c, h0 of a MAMBA2_CASES entry from ``seed`` (b and c
    column slices of one wider tensor where the case asks)."""
    import numpy as np
    import torch
    bsz, s, h, p, n, chunk, dtype, with_h0, decay, views = case
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    x = t(rng.standard_normal((bsz, s, h, p)) * 0.5)
    if decay == "strong":
        a = np.exp(-rng.uniform(2.0, 46.0, (bsz, s, h)))
        a[:, ::7] = 1e-30                    # below the 1e-20 clamp
    else:
        a = 1 / (1 + np.exp(-rng.standard_normal((bsz, s, h)))) * 0.5 + 0.45
    bc = t(rng.standard_normal((bsz, s, 2 * n + (8 if views else 0))) * 0.3)
    bc = bc.to(getattr(torch, dtype))
    b, c = bc[..., :n], bc[..., n:2 * n]
    if not views:
        b, c = b.contiguous(), c.contiguous()
    h0 = t(rng.standard_normal((bsz, h, p, n))) if with_h0 else None
    return x, t(a), b, c, h0


def wkv6_inputs(case, device, seed):
    """r, k, v, lw, u, s0 of a WKV6_CASES entry from ``seed``."""
    import numpy as np
    import torch
    bsz, s, h, kd, chunk, dtype, with_s0, decay = case
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    r, k, v = (t(rng.standard_normal((bsz, s, h, kd)) * 0.5)
               .to(getattr(torch, dtype)) for _ in range(3))
    if decay == "strong":
        lw = -np.exp(rng.uniform(np.log(2.0), np.log(20.0), (bsz, s, h, kd)))
    else:
        lw = -np.exp(rng.standard_normal((bsz, s, h, kd)) * 0.5 - 1.5)
    u = t(rng.standard_normal((h, kd)) * 0.1)
    s0 = t(rng.standard_normal((bsz, h, kd, kd))) if with_s0 else None
    return r, k, v, t(lw), u, s0


def scan_check(kernel, args, kw, tag, phase):
    """A scan kernel against its plain version on the same inputs: output
    and final state within ``prefix_tol`` (atol scaled by the output's
    RMS where that exceeds 1).  Returns the max abs error over both."""
    import torch
    from repro_torch.kernels.mamba2 import ops as ssd_ops
    from repro_torch.kernels.mamba2.ref import mamba2_ssd_ref
    from repro_torch.kernels.rwkv6 import ops as wkv_ops
    from repro_torch.kernels.rwkv6.ref import wkv6_ref
    if kernel == "mamba2_ssd":
        fn, ref = ssd_ops.mamba2_ssd, mamba2_ssd_ref
        la = torch.log(torch.clamp_min(args[1], 1e-20))
    else:
        fn, ref = wkv_ops.wkv6, wkv6_ref
        la = args[3]
    tol = prefix_tol(chunk_prefix(la, kw["chunk"]))
    got = fn(*args, **kw)
    if args[0].is_cuda:
        torch.cuda.synchronize()
    want = ref(*args, **kw)
    err = max(held(name, g, w, tol, f"{kernel} {tag}")
              for name, g, w in zip(("output", "final state"), got, want))
    say(phase, f"{tag}: max abs err {err:.3g} (tolerance {tol:.3g})")
    return err


def held(name, got, want, tol, tag):
    """``got`` within ``tol`` of ``want`` (atol scaled by ``want``'s RMS
    where that exceeds 1), finite; returns the max abs error."""
    import torch
    if not torch.isfinite(got).all():
        raise AssertionError(f"{tag} {name}: not finite")
    scale = max(1.0, float(want.square().mean().sqrt()))
    torch.testing.assert_close(got, want, rtol=tol, atol=tol * scale,
                               msg=lambda m: f"{tag} {name}: {m}")
    return float((got - want).abs().max())


def ssd_pass_check(args, kw, tag, phase):
    """Each pass of the mamba2_ssd kernel against its plain version, on the
    plain version's outputs of the passes before it: chunk_state (cum and
    the chunks' own states), state_pass (the states entering each chunk
    and the final state) and chunk_scan (y), within ``prefix_tol``.
    Returns the max abs error over the three."""
    import torch
    from repro_torch.kernels.mamba2 import ops as ssd_ops
    from repro_torch.kernels.mamba2 import ref as ssd_ref
    x, a, b, c = args
    chunk, h0 = kw["chunk"], kw["h0"]
    tol = prefix_tol(chunk_prefix(torch.log(torch.clamp_min(a, 1e-20)),
                                  chunk))
    cum, states = ssd_ref.chunk_state_ref(x, a, b, chunk=chunk)
    got = ssd_ops.chunk_state(x, a, b, chunk=chunk)
    errs = [held(f"chunk_state {n}", g, w, tol, tag)
            for n, g, w in zip(("cum", "states"), got, (cum, states))]
    h_in, hf = ssd_ref.state_pass_ref(states.clone(), cum, h0=h0)
    got = ssd_ops.state_pass(states.clone(), cum, h0=h0)
    errs += [held(f"state_pass {n}", g, w, tol, tag)
             for n, g, w in zip(("states", "final state"), got, (h_in, hf))]
    y = ssd_ref.chunk_scan_ref(x, b, c, cum, h_in, chunk=chunk)
    errs.append(held("chunk_scan y", ssd_ops.chunk_scan(x, b, c, cum, h_in,
                                                        chunk=chunk),
                     y, tol, tag))
    say(phase, f"{tag}: passes max abs err chunk_state "
        f"{max(errs[:2]):.3g}, state_pass {max(errs[2:4]):.3g}, chunk_scan "
        f"{errs[4]:.3g} (tolerance {tol:.3g})")
    return max(errs)


def wkv6_pass_check(args, kw, tag, phase):
    """Each pass of the wkv6 kernel against its plain version, on the plain
    version's outputs of the passes before it: chunk_state (cwl and the
    chunks' own states), state_pass (the states entering each chunk and
    the final state) and chunk_scan (y), within ``prefix_tol``.  Returns
    the max abs error over the three."""
    from repro_torch.kernels.rwkv6 import ops as wkv_ops
    from repro_torch.kernels.rwkv6 import ref as wkv_ref
    r, k, v, lw, u = args
    chunk, s0 = kw["chunk"], kw["s0"]
    tol = prefix_tol(chunk_prefix(lw, chunk))
    cwl, states = wkv_ref.chunk_state_ref(k, v, lw, chunk=chunk)
    got = wkv_ops.chunk_state(k, v, lw, chunk=chunk)
    errs = [held(f"chunk_state {n}", g, w, tol, tag)
            for n, g, w in zip(("cwl", "states"), got, (cwl, states))]
    s_in, sf = wkv_ref.state_pass_ref(states.clone(), cwl, s0=s0)
    got = wkv_ops.state_pass(states.clone(), cwl, s0=s0)
    errs += [held(f"state_pass {n}", g, w, tol, tag)
             for n, g, w in zip(("states", "final state"), got, (s_in, sf))]
    y = wkv_ref.chunk_scan_ref(r, k, v, lw, u, s_in, chunk=chunk)
    errs.append(held("chunk_scan y", wkv_ops.chunk_scan(
        r, k, v, lw, u, s_in, chunk=chunk), y, tol, tag))
    say(phase, f"{tag}: passes max abs err chunk_state "
        f"{max(errs[:2]):.3g}, state_pass {max(errs[2:4]):.3g}, chunk_scan "
        f"{errs[4]:.3g} (tolerance {tol:.3g})")
    return max(errs)


def wkv6_pass_times(args, kw, reps) -> dict:
    """Device ms of each pass of the wkv6 kernel on these inputs."""
    from repro_torch.kernels.rwkv6 import ops as wkv_ops
    r, k, v, lw, u = args
    chunk = kw["chunk"]
    cwl, states = wkv_ops.chunk_state(k, v, lw, chunk=chunk)
    return {"chunk_state": time_ms(lambda: wkv_ops.chunk_state(
                k, v, lw, chunk=chunk), reps=reps),
            "state_pass": time_ms(lambda: wkv_ops.state_pass(
                states, cwl, s0=kw["s0"]), reps=reps),
            "chunk_scan": time_ms(lambda: wkv_ops.chunk_scan(
                r, k, v, lw, u, states, chunk=chunk), reps=reps)}


def wkv6_design_bytes(r, chunk) -> int:
    """Bytes the three-pass design moves on these inputs, its scratch
    included: r once, k, v and lw twice (chunk_state and chunk_scan), u, y,
    the final state, cwl written and read once, and the states scratch
    written by chunk_state, read and rewritten by state_pass and read by
    chunk_scan."""
    bsz, s, h, kd = r.shape
    n, e = r.numel(), r.element_size()
    scratch = bsz * (s // chunk) * h * kd * kd * 4
    cwl = bsz * (s // chunk) * h * kd * 4
    return (n * e + 2 * n * (2 * e + 4) + h * kd * 4 + n * 4
            + bsz * h * kd * kd * 4 + 4 * scratch + 2 * cwl)


def ssd_pass_times(args, kw, reps) -> dict:
    """Device ms of each pass of the mamba2_ssd kernel on these inputs."""
    from repro_torch.kernels.mamba2 import ops as ssd_ops
    x, a, b, c = args
    chunk = kw["chunk"]
    cum, states = ssd_ops.chunk_state(x, a, b, chunk=chunk)
    return {"chunk_state": time_ms(lambda: ssd_ops.chunk_state(
                x, a, b, chunk=chunk), reps=reps),
            "state_pass": time_ms(lambda: ssd_ops.state_pass(
                states, cum, h0=kw["h0"]), reps=reps),
            "chunk_scan": time_ms(lambda: ssd_ops.chunk_scan(
                x, b, c, cum, states, chunk=chunk), reps=reps)}


def mamba2_work(x, b, chunk):
    """(bytes, fp32 operations, exponentials) the SSD scan needs on these
    inputs: x, a, b, c read and y, the final state written once; per (b, h,
    chunk) the gated intra-chunk product over j <= i, the inter-chunk
    product and the state update, and the C . B^T Gram once per (b, chunk)
    (shared across heads)."""
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    nc, tri = s // chunk, chunk * (chunk + 1) // 2
    nbytes = (2 * x.numel() * 4 + bsz * s * h * 4 + 2 * bsz * s * n
              * b.element_size() + bsz * h * p * n * 4)
    fma = bsz * nc * (h * (tri * (p + 1) + 2 * chunk * p * n) + tri * n)
    exps = bsz * nc * h * (tri + 2 * chunk)
    return nbytes, 2 * fma, exps


def wkv6_work(r, chunk):
    """(bytes, fp32 operations, exponentials) the WKV recurrence needs on
    these inputs: r, k, v, lw read and y, the final state written once; per
    (b, h, chunk) the strictly lower pairs over K (an exponential and three
    operations each), their product with v, the bonus, the inter-chunk
    product and the state update."""
    bsz, s, h, kd = r.shape
    nc, tri = s // chunk, chunk * (chunk - 1) // 2
    nbytes = (3 * r.numel() * r.element_size() + 2 * r.numel() * 4
              + h * kd * 4 + bsz * h * kd * kd * 4)
    ops = bsz * nc * h * (3 * tri * kd + 2 * tri * kd + 3 * chunk * kd
                          + 4 * chunk * kd * kd)
    exps = bsz * nc * h * (tri * kd + 2 * chunk * kd + kd)
    return nbytes, ops, exps


def pipe_bound(nbytes, ops, exps, ops_per_s=FP32_OPS_PER_S,
               ops_pipe="FMA") -> tuple[float, str, str]:
    """(bound ms, "bytes" or "operations", the pipe that bounds: HBM, the
    operations' pipe (``ops_pipe`` at ``ops_per_s``) or the SFUs'
    exponentials)."""
    times = {"HBM": nbytes / HBM_BYTES_PER_S, ops_pipe: ops / ops_per_s,
             "SFU": exps / SFU_OPS_PER_S}
    pipe = max(times, key=times.get)
    return times[pipe] * 1e3, "bytes" if pipe == "HBM" else "operations", pipe


def phase_scan(device, kernel, layer0, *, reps=10):
    """One scan kernel against its plain version over its case list and on
    the serve phase's layer-0 inputs, then its time at that shape; returns
    its record for the kernels line."""
    from repro_torch.kernels.mamba2 import ops as ssd_ops
    from repro_torch.kernels.mamba2.ref import mamba2_ssd_ref
    from repro_torch.kernels.rwkv6 import ops as wkv_ops
    from repro_torch.kernels.rwkv6.ref import wkv6_ref
    phase = "mamba2" if kernel == "mamba2_ssd" else "wkv6"
    worst = 0.0
    if kernel == "mamba2_ssd":
        for n, case in enumerate(MAMBA2_CASES):
            x, a, b, c, h0 = mamba2_inputs(case, device, seed=n)
            tag = ("B={} S={} H={} P={} N={} chunk={} b/c {} h0={} decay={} "
                   "views={}".format(*case))
            kw = dict(chunk=case[5], h0=h0)
            worst = max(worst, scan_check(kernel, (x, a, b, c), kw, tag,
                                          phase),
                        ssd_pass_check((x, a, b, c), kw, tag, phase))
    else:
        for n, case in enumerate(WKV6_CASES):
            r, k, v, lw, u, s0 = wkv6_inputs(case, device, seed=n)
            tag = ("B={} S={} H={} K={} chunk={} r/k/v {} s0={} "
                   "decay={}".format(*case))
            kw = dict(chunk=case[4], s0=s0)
            worst = max(worst, scan_check(kernel, (r, k, v, lw, u), kw, tag,
                                          phase),
                        wkv6_pass_check((r, k, v, lw, u), kw, tag, phase))
    for n, (name, case, view) in enumerate(LAYOUT_CASES):
        if name == kernel:
            args, kw = layout_inputs(name, case, view, device, seed=n)
            tag = (f"{[tuple(t.shape) for t in args]} {view or 'contiguous'}"
                   f" {args[0].dtype} in the kernel's layout")
            worst = max(worst, scan_check(kernel, args, kw, tag, phase))
    args, kw = layer0["args"], layer0["kw"]
    shapes = [tuple(t.shape) for t in args if t is not None]
    tag = f"serve layer 0 inputs {shapes} {kw}"
    worst = max(worst, scan_check(kernel, args, kw, tag, phase))
    if kernel == "mamba2_ssd":
        fn, ref = ssd_ops.mamba2_ssd, mamba2_ssd_ref
        work = mamba2_work(args[0], args[2], kw["chunk"])
        worst = max(worst, ssd_pass_check(args, kw, tag, phase))
        passes = ssd_pass_times(args, kw, reps)
    else:
        fn, ref = wkv_ops.wkv6, wkv6_ref
        work = wkv6_work(args[0], kw["chunk"])
        worst = max(worst, wkv6_pass_check(args, kw, tag, phase))
        passes = wkv6_pass_times(args, kw, reps)
        design = wkv6_design_bytes(args[0], kw["chunk"])
        say(phase, f"{shapes} {kw}: the three passes move "
            f"{design / 1e6:.1f} MB, an HBM floor of "
            f"{design / HBM_BYTES_PER_S * 1e3:.4f} ms (the design's; the "
            "bound below counts the function's)")
    say(phase, f"{shapes} {kw}: device ms per pass "
        + ", ".join(f"{k} {v:.3f}" for k, v in passes.items()))
    ms = time_ms(lambda: fn(*args, **kw), reps=reps)
    plain = time_ms(lambda: ref(*args, **kw), reps=3)
    bound, by, pipe = pipe_bound(*work)
    nbytes, ops, exps = work
    say(phase, f"{shapes} {kw}: kernel {ms:.3f} ms, bound {bound:.4f} ms "
        f"({by}, {pipe}: {nbytes / 1e6:.1f} MB, {ops / 1e9:.2f} GFLOP fp32, "
        f"{exps / 1e9:.3f} G exponentials), plain {plain:.3f} ms; kernel / "
        f"bound {ms / bound:.1f}; no PyTorch call computes this function")
    return dict(ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by,
                bound_pipe=pipe, library_ms=None, max_abs_err=worst,
                pass_ms=passes)


def model_card_vs_cpu(device, cfg, *, phase, seq, steps):
    """``cfg`` (float32) on the card and on the CPU from the same
    parameters: one ``seq``-token prompt and ``steps`` decode steps, logits
    within F32_LOGIT_TOL, greedy tokens equal.  The card's prefill must
    launch each kernel of ``cfg`` once per block (``launches_per_prefill``).
    The card's prefill of the prompt plus the first and the last k
    generated tokens must also agree with its k-th decode step within
    F32_LOGIT_TOL: in float32 this holds the caches the prefill hands to
    decode (a scan kernel's final state among them) far more tightly than
    the bf16 serve phases can.  Returns the largest logit difference."""
    import copy
    import numpy as np
    import torch
    from repro_torch.models import model as M
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmuls are on; float32 parity needs "
                             "them off")
    cpu_params = M.init_params(cfg, seed=1, device="cpu")
    card_params = copy.deepcopy(cpu_params).to(device)
    prompt = np.random.default_rng(1).integers(0, cfg.vocab, (1, seq))
    ops = kernel_ops()
    before = {name: op.LAUNCHES for name, op in ops.items()}
    sides = {}
    for name, dev, params in (("card", device, card_params),
                              ("cpu", "cpu", cpu_params)):
        sides[name] = M.prefill(params, cfg, {"tokens": torch.as_tensor(
            prompt, dtype=torch.int32, device=dev)}, max_len=seq + steps)
    launched = {name: op.LAUNCHES - before[name] for name, op in ops.items()}
    if device != "cpu" and launched != launches_per_prefill(cfg):
        raise AssertionError(f"the card's prefill launched {launched}, "
                             f"expected {launches_per_prefill(cfg)}")
    worst, swapped = 0.0, 0
    gen, card_steps = [], []
    for i in range(steps + 1):
        card_logits, cpu_logits = sides["card"][0], sides["cpu"][0]
        if i:
            card_steps.append(card_logits)
        err = float((card_logits.cpu() - cpu_logits).abs().max())
        worst = max(worst, err)
        torch.testing.assert_close(card_logits.cpu(), cpu_logits,
                                   **F32_LOGIT_TOL,
                                   msg=lambda m: f"step {i}: {m}")
        swapped += check_argmax(f"card vs CPU step {i}", cpu_logits,
                                card_logits, cfg.vocab,
                                F32_LOGIT_TOL["atol"], phase=phase)
        if i == steps:
            break
        tok = torch.argmax(cpu_logits[..., :cfg.vocab], dim=-1).to(torch.int32)
        gen.append(tok)
        for name, dev, params in (("card", device, card_params),
                                  ("cpu", "cpu", cpu_params)):
            pos = torch.full((1,), seq + i, dtype=torch.int32, device=dev)
            sides[name] = M.decode_step(params, cfg, sides[name][1],
                                        {"tokens": tok.to(dev)}, pos)
    say(phase, f"{cfg.name} at full width, pattern {cfg.pattern}, float32, "
        f"prompt {seq}, {steps} decode steps: logits max abs diff "
        f"{worst:.3g} ({F32_LOGIT_TOL}), greedy tokens equal"
        f"{f' except {swapped} swapped at a gap under tolerance' if swapped else ''}")
    for k in sorted({1, steps}):
        tokens = torch.cat([torch.as_tensor(prompt, dtype=torch.int32)]
                           + gen[:k], dim=1).to(device)
        pf, _ = M.prefill(card_params, cfg, {"tokens": tokens},
                          max_len=seq + steps)
        err = float((pf - card_steps[k - 1]).abs().max())
        torch.testing.assert_close(
            pf, card_steps[k - 1], **F32_LOGIT_TOL,
            msg=lambda m: f"card prefill + {k} vs decode step {k}: {m}")
        say(phase, f"{cfg.name}: the card's prefill of prompt + {k} token(s) "
            f"vs its decode step {k}: max abs diff {err:.3g} "
            f"({F32_LOGIT_TOL})")
    return worst


def phase_serve_card_vs_cpu(device, *, reduced=False, n_layers=2, seq=1100,
                            steps=8):
    """Full width cut to ``n_layers``, float32, on the card and the CPU."""
    cfg = serve_config(reduced, n_layers=n_layers,
                       pattern=((n_layers, ("attn",)),), dtype="float32",
                       param_dtype="float32")
    return model_card_vs_cpu(device, cfg, phase="serve_card_vs_cpu", seq=seq,
                             steps=steps)


#: The depth cuts of the ssm_card_vs_cpu phase: one mamba block and the
#: shared attention block for zamba2, 2 layers for rwkv6.
SSM_CUTS = {"zamba2-2.7b": dict(n_layers=2,
                                pattern=((1, ("mamba", "shared_attn")),)),
            "rwkv6-7b": dict(n_layers=2, pattern=((2, ("rwkv",)),))}


def phase_ssm_card_vs_cpu(device, *, reduced=False, seq=1100, steps=8):
    """zamba2 and rwkv6 at full width cut in depth, float32, on the card and
    the CPU (the prompt is not a multiple of either scan's chunk)."""
    return {arch: model_card_vs_cpu(
        device, serve_config(reduced, arch, dtype="float32",
                             param_dtype="float32", **cut),
        phase="ssm_card_vs_cpu", seq=seq, steps=steps)
        for arch, cut in SSM_CUTS.items()}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs a CUDA card", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: run it from the root of a checkout (src/repro_torch "
              "not found)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    device = "cuda"
    t_start = time.perf_counter()
    seconds = {}

    def timed(name, fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        seconds[name] = round(time.perf_counter() - t0, 1)
        return out

    smi = timed("device", phase_device)
    timed("build", phase_build)
    records = timed("kernels", phase_kernels, device)
    launches, engine_ms = timed("engine", phase_engine, device)
    say("engine", "ms/tick " + json.dumps(engine_ms))
    timed("fused_vs_scan", phase_fused_vs_scan, device)
    timed("card_vs_cpu", phase_card_vs_cpu, device)
    timed("anchor", phase_anchor, device)
    sched_ms = timed("schedulers", phase_schedulers, device)
    say("schedulers", "ms/tick " + json.dumps(sched_ms))
    timed("schedulers_card_vs_cpu", phase_schedulers_card_vs_cpu, device)
    batch_launches, batch_ms, row_records = timed("batch", phase_batch, device)
    say("batch", "ms " + json.dumps(batch_ms))
    pois_launches, _ = timed("poisson", phase_poisson, device)
    fig_launches, _ = timed("figures", phase_figures, device)
    scen_launches, scen_ms = timed("scenarios", phase_scenarios, device)
    say("scenarios", "ms/tick " + json.dumps(scen_ms))
    for name in ("tick_step[themis]", "tick_step[fifo]"):
        launches[name] += (batch_launches[name] + fig_launches[name]
                           + scen_launches[name])
    service_draws, service_record, _ = timed("service", phase_service, device)
    launches["token_select"] += service_draws
    records["token_select"].update(service_record)
    launches["tick_step[themis]"] += pois_launches
    params, served, layer0, serve = timed("serve", phase_serve, device)
    launches["flash_attention"] = served["flash_attention"]
    say("serve", "metrics " + json.dumps(serve))
    engine_draws, rps = timed("serve_engine", phase_serve_engine, device,
                              params)
    launches["token_select"] += engine_draws
    del params
    records["flash_attention"] = timed("flash", phase_flash, device,
                                       layer0["flash_attention"])
    del layer0
    timed("serve_card_vs_cpu", phase_serve_card_vs_cpu, device)
    # The recurrent serving paths: zamba2 (mamba2_ssd and flash_attention)
    # and rwkv6 (wkv6), each with every counter zeroed before it.
    scan_inputs = {}
    for arch, phase, kernel in (("zamba2-2.7b", "serve_zamba2", "mamba2_ssd"),
                                ("rwkv6-7b", "serve_rwkv6", "wkv6")):
        params, served, layer0, metrics = timed(
            phase, phase_serve, device, arch, tag=phase)
        say(phase, "metrics " + json.dumps(metrics))
        launches["flash_attention"] += served["flash_attention"]
        launches[kernel] = served[kernel]
        scan_inputs[kernel] = layer0[kernel]
        if "flash_attention" in layer0:
            # zamba2's shared block: MHA 32/32 without a window.
            timed(f"flash_{arch}", flash_at_shape, layer0["flash_attention"],
                  phase, f"{arch} layer 0 attention")
        if arch == "zamba2-2.7b":
            engine_draws, _ = timed("serve_engine_zamba2", phase_serve_engine,
                                    device, params, arch=arch,
                                    tag="serve_engine_zamba2")
            launches["token_select"] += engine_draws
        del params, layer0
    for kernel, phase in (("mamba2_ssd", "mamba2"), ("wkv6", "wkv6")):
        records[kernel] = timed(phase, phase_scan, device, kernel,
                                scan_inputs.pop(kernel))
    timed("ssm_card_vs_cpu", phase_ssm_card_vs_cpu, device)
    say("done", f"phase seconds {json.dumps(seconds)}; total "
        f"{time.perf_counter() - t_start:.1f} s")

    replaces = {"token_select": "src/repro/kernels/token_select/kernel.py:65",
                "tick_step": "src/repro/kernels/tick_step/kernel.py:95",
                "flash_attention":
                    "src/repro/kernels/flash_attention/kernel.py:77",
                "mamba2_ssd": "src/repro/kernels/mamba2/kernel.py:54",
                "wkv6": "src/repro/kernels/rwkv6/kernel.py:67"}
    kernels = []
    for name in ("tick_step[themis]", "tick_step[fifo]", "token_select",
                 "flash_attention", "mamba2_ssd", "wkv6"):
        r = records[name]
        base = name.split("[")[0]
        kernels.append(dict(
            name=name, route="cuda",
            source=f"src/repro_torch/kernels/csrc/{base}.cu",
            replaces=replaces[base], launches=launches[name],
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r.get("library_ms"),
            **({"pass_ms": r["pass_ms"]} if "pass_ms" in r else {}),
            **{k: v for k, v in r.items() if k.startswith("service_")},
            **row_records.get(name, {})))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
