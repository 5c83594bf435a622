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

#: Published H100 SXM peaks: HBM bytes/s and fp32 (non-tensor-core) op/s.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

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


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / FP32_OPS_PER_S
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
    smi = phase_device()
    phase_build()
    records = phase_kernels(device)
    launches, engine_ms = phase_engine(device)
    say("engine", "ms/tick " + json.dumps(engine_ms))
    phase_fused_vs_scan(device)
    phase_card_vs_cpu(device)
    phase_anchor(device)

    replaces = {"token_select": "src/repro/kernels/token_select/kernel.py:65",
                "tick_step": "src/repro/kernels/tick_step/kernel.py:95"}
    kernels = []
    for name in ("tick_step[themis]", "tick_step[fifo]", "token_select"):
        r = records[name]
        base = name.split("[")[0]
        kernels.append(dict(
            name=name, route="cuda",
            source=f"src/repro_torch/kernels/csrc/{base}.cu",
            replaces=replaces[base], launches=launches[name],
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=None))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
