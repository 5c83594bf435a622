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
                card over a case list (float32 and bf16, MHA and GQA, with
                and without a window, ragged S, head_dim 16-256, an offset
                and a non-causal case, the serving shape, and inputs staged
                by element: head_dim 18, 81 and 250, unaligned views) and
                on the inputs layer 0 of the serve phase gave it; then its time at that shape beside its
                bound, the plain version's and scaled_dot_product_attention's
  serve_card_vs_cpu  full width cut to 2 layers, float32: one 1100-token
                prompt and 8 decode steps on the card and on the CPU,
                logits within rtol 1e-3 (atol 1e-3), greedy tokens equal

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
             ("tiny", 3, 5, 2, {})]
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
        shares, qcount, window, free, u = kernel_inputs(cs, cj, cw, device,
                                                        seed=k, **kw)
        got = tk_ops.token_select(shares, qcount, u)
        torch.cuda.synchronize()
        tally("token_select", name, parity.compare_token_select(
            got, token_select_ref(shares, qcount, u), shares, qcount, u))
        for mode in ("themis", "fifo"):
            got = ts_ops.tick_step(shares, qcount, window, free, u, mode=mode)
            torch.cuda.synchronize()
            want = tick_step_ref(shares, qcount, window, free, u, mode=mode)
            tally(f"tick_step[{mode}]", name, parity.compare_tick_step(
                got, want, shares, qcount, u, mode))
        say("kernels", f"case {name} (S={cs} J={cj} W={cw}): token_select, "
            "tick_step themis+fifo agree with their plain versions")
    say("kernels", f"edge-band draws excused: {excused} (tolerance: a themis "
        "pick may differ only where u lies within J*2^-24 of a float64 "
        "segment end; fifo and all other outputs exact)")

    records = {}
    # token_select at the scan path's shape (one draw per row per launch).
    shares, qcount, window, free, u = kernel_inputs(s, j, w, device, seed=99)
    u1 = u[:, :1].contiguous()
    ms = time_ms(lambda: tk_ops.token_select(shares, qcount, u1))
    plain = time_ms(lambda: token_select_ref(shares, qcount, u1))
    nbytes = needed_bytes("token_select", qcount, u1)
    b, by = bound_ms(nbytes, s * j * (8 + 1))
    records["token_select"] = dict(ms=ms, plain_ms=plain, bound_ms=b,
                                   bound_by=by, max_abs_err=err["token_select"])
    say("kernels", f"token_select S={s} J={j} W=1: {ms * 1e3:.1f} us, bound "
        f"{b * 1e3:.3f} us ({by}, {nbytes} bytes), plain "
        f"{plain * 1e3:.1f} us")
    for mode in ("themis", "fifo"):
        ms = time_ms(lambda: ts_ops.tick_step(shares, qcount, window, free, u,
                                              mode=mode))
        plain = time_ms(lambda: tick_step_ref(shares, qcount, window, free, u,
                                              mode=mode))
        pops = ts_ops.tick_step(shares, qcount, window, free, u,
                                mode=mode)[4]
        nbytes = needed_bytes("tick_step", qcount, u, mode=mode, pops=pops)
        ops = s * w * j * (9 if mode == "themis" else 2)
        b, by = bound_ms(nbytes, ops)
        say("kernels", f"tick_step[{mode}] S={s} J={j} W={w}: "
            f"{ms * 1e3:.1f} us, bound {b * 1e3:.3f} us ({by}, {nbytes} "
            f"bytes), plain {plain * 1e3:.1f} us")
        records[f"tick_step[{mode}]"] = dict(
            ms=ms, plain_ms=plain, bound_ms=b, bound_by=by,
            max_abs_err=err[f"tick_step[{mode}]"])
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


def lockstep(scheduler, impl, device, ticks):
    """Step the engine on ``device`` and on the CPU together from the same
    Experiment.  Returns (first tick whose integer state differs or None,
    the excused pick that caused it, final state on ``device``, final CPU
    state).  fifo must never differ."""
    from repro_torch.api import Experiment
    from repro_torch.core import engine, tokens
    from repro_torch.kernels.tick_step import ops as ts_ops
    from repro_torch.kernels.token_select import ops as tk_ops

    def build(dev):
        cfg, wl, table = Experiment(
            policy="user-fair", scheduler=scheduler, device=dev,
            tick_impl=impl, **LOCKSTEP_GEOM).add_jobs(LOCKSTEP_JOBS).build()
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


def serve_config(reduced=False, **overrides):
    import dataclasses
    from repro_torch.configs.base import get_config
    return dataclasses.replace(get_config(SERVE_ARCH, reduced=reduced),
                               **overrides)


def top2_gap(logits):
    """Gap between the two largest entries of each row (float32)."""
    import torch
    top = torch.topk(logits.float(), 2, dim=-1).values
    return top[..., 0] - top[..., 1]


def check_argmax(tag, want_logits, got_logits, vocab, atol):
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
        say("serve", f"{tag}: {swapped} greedy token(s) swapped at a top-2 "
            f"gap under {2 * atol}: {gap[a != b].tolist()}")
    return swapped


def record_first_flash_call(store):
    """Patch the attention module's flash wrapper so that its first call
    keeps a copy of its inputs in ``store``; returns the undo."""
    from repro_torch.models import attention
    real = attention.flash_attention

    def wrapper(q, k, v, **kw):
        if not store:
            store.update(q=q.clone(), k=k.clone(), v=v.clone(), kw=dict(kw))
        return real(q, k, v, **kw)

    attention.flash_attention = wrapper
    return lambda: setattr(attention, "flash_attention", real)


def synced(device):
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return time.perf_counter()


def phase_serve(device, *, reduced=False, seq=6000, steps=16):
    """The main serving path at full width; returns (params, flash
    launches, the inputs layer 0's attention gave the kernel, metrics)."""
    import numpy as np
    import torch
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models import model as M
    from repro_torch.serve.serve_step import make_decode_step, make_prefill_step
    cfg = serve_config(reduced)
    batch, check_ks = 2, (1, 8)
    t0 = synced(device)
    params = M.init_params(cfg, seed=0, device=device)
    say("serve", f"{cfg.name} d={cfg.d_model} layers={cfg.layer_count()} "
        f"heads={cfg.n_heads}/{cfg.n_kv_heads}x{cfg.head_dim} window="
        f"{cfg.window} {cfg.param_dtype}: {cfg.param_count() / 1e9:.3f} B "
        f"params initialised in {synced(device) - t0:.1f} s")
    rng = np.random.default_rng(0)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab, (batch, seq)),
                             dtype=torch.int32, device=device)
    max_len = seq + steps
    prefill = make_prefill_step(cfg, max_len)
    decode = make_decode_step(cfg)
    per_prefill = cfg.layer_count() if torch.device(device).type == "cuda" \
        else 0
    layer0: dict = {}

    def run_prefill(tokens):
        before = fa_ops.LAUNCHES
        t = synced(device)
        logits, caches = prefill(params, {"tokens": tokens})
        wall = synced(device) - t
        n = fa_ops.LAUNCHES - before
        if n != per_prefill:
            raise AssertionError(f"prefill of {tuple(tokens.shape)} launched "
                                 f"flash_attention {n} times, expected "
                                 f"{per_prefill}")
        if not torch.isfinite(logits).all():
            raise AssertionError("prefill logits are not finite")
        return logits, caches, wall

    fa_ops.LAUNCHES = 0
    undo = record_first_flash_call(layer0)
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
    worst = 0.0
    for k in check_ks:
        tokens = torch.cat([prompt] + gen[:k], dim=1)
        pf_logits, _, _ = run_prefill(tokens)
        want = step_logits[k - 1]
        diff = (pf_logits - want).float()
        err = float(diff.abs().max())
        rms = float(diff.square().mean().sqrt()
                    / want.float().square().mean().sqrt())
        worst = max(worst, err)
        say("serve", f"prefill of prompt + {k} generated token(s) vs decode "
            f"step {k}: max |logit diff| {err:.4g}, RMS diff / RMS logit "
            f"{rms:.4g} (tolerance {BF16_LOGIT_TOL})")
        if err > BF16_LOGIT_TOL["max"] or rms > BF16_LOGIT_TOL["rms"]:
            raise AssertionError(f"prefill+{k} vs decode: logits beyond "
                                 f"{BF16_LOGIT_TOL}")
        # A swap is excused only where this measured difference explains it.
        check_argmax(f"prefill+{k} vs decode", want, pf_logits, cfg.vocab,
                     err)
    launches = fa_ops.LAUNCHES
    decode_ms = sorted(step_s)[len(step_s) // 2] * 1e3
    metrics = dict(prefill_ms=prefill_s * 1e3,
                   prefill_tokens_per_s=batch * seq / prefill_s,
                   decode_ms_per_step=decode_ms,
                   decode_tokens_per_s=batch / (decode_ms / 1e3),
                   prefill_vs_decode_max_abs=worst)
    say("serve", f"prefill B={batch} S={seq}: {metrics['prefill_ms']:.1f} ms "
        f"({metrics['prefill_tokens_per_s']:.0f} tokens/s); decode at B="
        f"{batch}: {decode_ms:.2f} ms/step median of {steps} (one token per "
        f"sequence, {metrics['decode_tokens_per_s']:.1f} tokens/s); "
        f"flash_attention launches {launches} ({per_prefill} per prefill x "
        f"{2 + len(check_ks)} prefills)")
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


def phase_serve_engine(device, params, *, reduced=False):
    """ServeEngine on the card against the CPU; returns (token_select
    launches, requests/s)."""
    from repro_torch.kernels import parity
    from repro_torch.kernels.token_select import ops as tk_ops
    from repro_torch.kernels.token_select.ref import token_select_ref
    from repro_torch.models import model as M
    cfg = serve_config(reduced)
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
        say("serve_engine", f"excused edge-band draw: {line}")
    cpu_cfg = serve_config(True)
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
        say("serve_engine", f"admissions diverge from the CPU's at draw "
            f"{first}: {explain_divergence(calls, cpu_calls)}")
    rps = len(reqs) / wall
    say("serve_engine", f"{len(reqs)} requests x 8 tokens over 3 tenants "
        f"(size-fair, 4 slots, key seed {SERVE_ENGINE_SEED}) in {wall:.2f} s: "
        f"{rps:.2f} requests/s; token_select launches {launches}, each "
        f"draw equal to the plain version's ({len(excused)} excused); "
        f"admissions {'equal to' if admitted == cpu_adm else 'excused against'}"
        f" the CPU engine's at the reduced config, {off} of {len(cpu_calls)} "
        f"not the lowest tenant with demand: {admitted}")
    return launches, rps


#: (B, Sq, Sk, H, Hk, D, window, causal, q_offset, storage_offset): MHA
#: and GQA 4:1, with and without a window, ragged S, every head_dim the
#: configs use and more, the serving shape itself, and inputs the kernel
#: stages one element at a time (head_dim not a multiple of 4, or views
#: ``storage_offset`` elements into their buffers, so not 16-byte aligned).
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


def staged_by_float4(q, k, v) -> bool:
    """Whether the kernel stages these inputs four elements per load
    (head_dim a multiple of 4 and every operand aligned to 4 elements), as
    ``csrc/flash_attention.cu``'s launcher decides."""
    align = 4 * q.element_size()
    return q.shape[-1] % 4 == 0 and all(t.data_ptr() % align == 0
                                        for t in (q, k, v))


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
    """Returns the flash_attention record for the kernels line."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    worst = 0.0
    staging = set()
    for dtype in (torch.float32, torch.bfloat16):
        for n, case in enumerate(cases):
            b, sq, sk, h, hk, d, win, causal, off, store = case
            q, k, v = flash_inputs(case, dtype, device, seed=n)
            kw = dict(causal=causal, window=win, q_offset=off)
            vec = staged_by_float4(q, k, v)
            staging.add(vec)
            tag = (f"{str(dtype)[6:]} B={b} Sq={sq} Sk={sk} H={h} Hk={hk} "
                   f"D={d} window={win} causal={causal} q_offset={off} "
                   f"storage_offset={store} staged "
                   f"{'by float4' if vec else 'by element'}")
            err = flash_check(q, k, v, kw, tag)
            worst = max(worst, err)
            say("flash", f"{tag}: max abs err {err:.3g}")
    if staging != {True, False}:
        raise AssertionError("the case list left a staging path of the "
                             "kernel unchecked")
    q, k, v, kw = layer0["q"], layer0["k"], layer0["v"], layer0["kw"]
    err = flash_check(q, k, v, kw, "serve layer 0")
    worst = max(worst, err)
    b, sq, h, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    say("flash", f"serve layer 0 inputs {tuple(q.shape)} / {tuple(k.shape)} "
        f"{q.dtype} {kw}: max abs err {err:.3g}")

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
    ops = 4 * d * pairs * b * h
    peak = BF16_OPS_PER_S if q.dtype == torch.bfloat16 else FP32_OPS_PER_S
    bound, by = bound_ms(nbytes, ops, peak)
    say("flash", f"B={b} S={sq} H={h} Hk={hk} D={d} window={kw['window']} "
        f"{q.dtype}: kernel {ms:.3f} ms, bound {bound:.4f} ms ({by}: "
        f"{ops / 1e9:.1f} GFLOP over {pairs} live pairs per head, "
        f"{nbytes / 1e6:.1f} MB), plain {plain:.3f} ms, "
        f"scaled_dot_product_attention {lib:.3f} ms (max abs diff from the "
        f"kernel {lib_err:.3g}); kernel / bound {ms / bound:.1f}")
    return dict(ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by,
                library_ms=lib, max_abs_err=worst)


def phase_serve_card_vs_cpu(device, *, reduced=False, n_layers=2, seq=1100,
                            steps=8):
    """Full width cut to ``n_layers``, float32, on the card and the CPU."""
    import copy
    import numpy as np
    import torch
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models import model as M
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmuls are on; float32 parity needs "
                             "them off")
    cfg = serve_config(reduced, n_layers=n_layers,
                       pattern=((n_layers, ("attn",)),), dtype="float32",
                       param_dtype="float32")
    cpu_params = M.init_params(cfg, seed=1, device="cpu")
    card_params = copy.deepcopy(cpu_params).to(device)
    prompt = np.random.default_rng(1).integers(0, cfg.vocab, (1, seq))
    sides = {}
    before = fa_ops.LAUNCHES
    for name, dev, params in (("card", device, card_params),
                              ("cpu", "cpu", cpu_params)):
        sides[name] = M.prefill(params, cfg, {"tokens": torch.as_tensor(
            prompt, dtype=torch.int32, device=dev)}, max_len=seq + steps)
    if device != "cpu" and fa_ops.LAUNCHES - before != n_layers:
        raise AssertionError("the card's prefill did not launch "
                             "flash_attention once per layer")
    worst, swapped = 0.0, 0
    for i in range(steps + 1):
        card_logits, cpu_logits = sides["card"][0], sides["cpu"][0]
        err = float((card_logits.cpu() - cpu_logits).abs().max())
        worst = max(worst, err)
        torch.testing.assert_close(card_logits.cpu(), cpu_logits,
                                   **F32_LOGIT_TOL,
                                   msg=lambda m: f"step {i}: {m}")
        swapped += check_argmax(f"card vs CPU step {i}", cpu_logits,
                                card_logits, cfg.vocab,
                                F32_LOGIT_TOL["atol"])
        if i == steps:
            break
        tok = torch.argmax(cpu_logits[..., :cfg.vocab], dim=-1).to(torch.int32)
        for name, dev, params in (("card", device, card_params),
                                  ("cpu", "cpu", cpu_params)):
            pos = torch.full((1,), seq + i, dtype=torch.int32, device=dev)
            sides[name] = M.decode_step(params, cfg, sides[name][1],
                                        {"tokens": tok.to(dev)}, pos)
    say("serve_card_vs_cpu", f"{cfg.name} at full width, {n_layers} layers, "
        f"float32, prompt {seq}, {steps} decode steps: logits max abs diff "
        f"{worst:.3g} ({F32_LOGIT_TOL}), greedy tokens equal"
        f"{f' except {swapped} swapped at a gap under tolerance' if swapped else ''}")


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
    params, launches["flash_attention"], layer0, serve = timed(
        "serve", phase_serve, device)
    say("serve", "metrics " + json.dumps(serve))
    engine_draws, rps = timed("serve_engine", phase_serve_engine, device,
                              params)
    launches["token_select"] += engine_draws
    del params
    records["flash_attention"] = timed("flash", phase_flash, device, layer0)
    del layer0
    timed("serve_card_vs_cpu", phase_serve_card_vs_cpu, device)
    say("done", f"phase seconds {json.dumps(seconds)}; total "
        f"{time.perf_counter() - t_start:.1f} s")

    replaces = {"token_select": "src/repro/kernels/token_select/kernel.py:65",
                "tick_step": "src/repro/kernels/tick_step/kernel.py:95",
                "flash_attention":
                    "src/repro/kernels/flash_attention/kernel.py:77"}
    kernels = []
    for name in ("tick_step[themis]", "tick_step[fifo]", "token_select",
                 "flash_attention"):
        r = records[name]
        base = name.split("[")[0]
        kernels.append(dict(
            name=name, route="cuda",
            source=f"src/repro_torch/kernels/csrc/{base}.cu",
            replaces=replaces[base], launches=launches[name],
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r.get("library_ms")))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
