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
  fused_vs_scan themis at S=8, J=64, W=4 for 1000 ticks on both worker
                paths: integer state bit-identical
  card_vs_cpu   the engine on the card against the engine on the CPU (held
                to the JAX reference by tests/test_torch_engine.py), stepped
                in lockstep at a small geometry on both worker paths for
                500 ticks: fifo and themis counter-exact on every tick (the
                draws and the λ-sync sum in the reference's order, so no
                pick is excused)
  anchor        paper Fig. 8a (size-fair, 224 vs 56 procs) at 4 s (cut
                from 6 s to make room for the paper's sections; at 3 s the
                ratio read 3.500): shared-window throughput ratio in
                [3.6, 4.4] (paper: 3.96)
  schedulers    gift, tbf, adaptbf and plan (the schedulers with no kernel
                mode in either package, so they run the per-worker scan) at
                the engine's fleet geometry with a 125-tick μ: conservation,
                plan never idle under demand, ms/tick; tick_step and
                token_select counters read 0 for the four, and themis/fifo
                fused launch tick_step once per tick
  schedulers_card_vs_cpu  each of the four on the card against the CPU in
                lockstep at the card_vs_cpu geometry for 250 ticks (μ = 50
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
                six schedulers) through repro_torch.bench at 0.5 s (cut
                from 1 s to make room for the paper's sections) and 8
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
                completion order equal (every themis pick the CPU's),
                token_select launches = themis
                pops (counted around each replay), pops per second on
                both; token_select at the service's [1, J] shape against
                its plain version on recorded draws, timed beside its bound
  batch_plane   the batch plane's rows of repro_torch.bench.batch (the
                reference's benchmarks/bench_batch.py at its own width: the
                bb-heavy, longtail and mixed queues of 24 jobs, seeds 0-3,
                fcfs, easy and the plan annealer at 300 steps x 2
                restarts): every start vector valid, every fcfs, easy and
                plan start and plan order equal to the CPU's bit for bit
                (else the first differing annealing step is printed), every
                row's text equal to src/repro_torch/bench/batch_reference.json;
                the bridge row runs the bb-heavy plan timeline on the engine
                (themis, 2 servers) for 2 s (cut from the timeline's 8 s),
                one tick_step launch per tick; ms per anneal, per
                schedule_order evaluation, launches per anneal, bridge
                ms/tick
  workspace     docs/workspace.md's example (adaptbf, a 2 x 2 grid, seeds
                0 and 1) at 0.5 s (cut from its EXAMPLE_SECONDS = 1 to make
                room for the shard and fleet phases) into a temporary
                workspace: a
                plain sweep, then max_chunks=1 stops after 2 points, the
                resume computes the other 2, a third run reuses all 4, and
                both merged sweeps equal the plain one bit for bit; a 1 s
                themis solo (2 s until the same cut) at the figures'
                geometry cached in the workspace: the
                first call launches tick_step once per tick, the second
                none, with the same result
  shard         tests/test_shard.py's job list (S = 4, J = 8, W = 4, user-
                fair, seed 3, its Poisson phase; 0.2 s) on 4 gloo ranks
                that share the card (repro_torch.launch.mesh.spawn): themis
                and adaptbf run at shard_servers=4 and run_batch at
                mesh_shape=(2, 2) over seeds 1-4, each equal to the
                unsharded card run in every leaf but bytes_bin (held to the
                atomic adds' bound) and in its integer counters to the
                CPU's; every rank's result equal; the backend, ranks per card,
                collectives per tick, ms/tick at x1 and x4 and every rank's
                kernel launches
  fleet         the fleet rows of repro_torch.bench.fleet at the fleet
                geometry, cut from the reference's 0.1 s to 0.02 s (100
                ticks): x1 in process on the fused tick, x2 and x4 each a
                world of gloo ranks on the sharded scan; the reference's
                row names, fleet_gbps_x1's text and x1's integer counters
                equal to src/repro_torch/bench/fleet_reference.json, every
                rung's integer counters
                equal to x1's; ms/tick, world seconds and
                every rank's launches and collectives per tick
  fig7, fig9, fig13, fig14
                the paper's remaining sections (repro_torch.bench.scaling,
                composite, apps, lambda_sync) at the depth of
                src/repro_torch/bench/paper_reference.json's "card" block
                (the reference's durations times 1/25, 1/80, 1/20 and
                1/20; fig7 on its quoted rungs 1, 8 and 128, fig13 on
                wrf): every row's text and every run's scheduler, params
                hash and integer counters equal to the reference's; one
                tick_step launch per tick of each run, no token_select;
                ms/tick per run
  kern          at J = 16, 256, 1024 (S = 8, W = 8) the per-worker scan (W
                token_select launches) and the fused tick (one tick_step)
                on the reference's inputs give equal selections, qcount'
                and pops, and equal the CPU's; the section's rows (the
                reference's names) and the roofline budget at the H100's
                constants
  micro         the token_select draw at [8, 32] x 8 and the 3-level
                policy chain on the card equal the CPU's; the rows
  calibrate     the AdapTBF (20 points) and plan (6) calibration sweeps,
                point x seed lanes of one tick loop, at 0.3 s x 2 seeds:
                every row's text and both chosen points the reference's
  cli           ``repro_torch.bench.run.main(["kern", "micro", "--json",
                ...])`` in process: both sections with rows and a runs
                block, each row named by its ROW_SCHEMAS; the document
                ingested twice into ``repro_torch.bench.trend`` under two
                labels, and the gate passes
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
                token_select draw equals its plain version's (none
                excused), and the tenant admission sequence is compared
                with the same engine's on the CPU at the reduced config
                (a difference named by its edge-band draw)
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
                (each its three passes), 54 step_decay launches (and one
                per mamba layer per decode step) and 9 flash_attention
                launches per prefill; prefill + k tokens against k decode steps holds
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
  step_decay    zamba2's step and decay kernel (softplus and exp in the
                reference's float32 roundings) against its plain version,
                bit for bit on the card and the CPU, on the inputs layer 0
                of serve_zamba2 gave it and on edge values; its time beside
                its bound (bytes) and the plain version's
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

#: Facility-scale S, J and W of benchmarks/bench_fleet.py:41-62; the rest of
#: its geometry and its job list are repro_torch.bench.fleet's.
FLEET_SJW = dict(n_servers=128, max_jobs=1024, n_workers=4)
FLEET_SECONDS = 0.1


def fleet_geometry() -> dict:
    """The fleet geometry as Experiment keywords."""
    from repro_torch.bench import fleet
    return dict(FLEET_SJW, **fleet.ENGINE_KW)


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
    err = dict.fromkeys(names, 0)
    before = {"token_select": tk_ops.LAUNCHES, "tick_step": ts_ops.LAUNCHES}

    def tally(kernel, case, result):
        lines, e = result
        if lines:
            raise AssertionError(f"{kernel} case {case}: picks apart from "
                                 f"the plain version: {lines}")
        err[kernel] = max(err[kernel], e)

    for k, (name, cs, cj, cw, kw) in enumerate(cases):
        inputs = kernel_inputs(cs, cj, cw, device, seed=k, **kw)
        for dtype in (torch.float32, torch.bfloat16):
            # Both sides draw in the reference's order of sums (bf16
            # shares also in its bf16 roundings): every pick equal.
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
    say("kernels", "every pick and every other output equal to the plain "
        "versions' (0 draws excused)")
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


def phase_engine(device, geometry=None, seconds=FLEET_SECONDS):
    """The main path at fleet geometry; returns the launch counts."""
    from repro_torch.api import Experiment
    from repro_torch.kernels.tick_step import ops as ts_ops
    from repro_torch.kernels.token_select import ops as tk_ops
    from repro_torch.bench.fleet import fleet_jobs
    geometry = geometry or fleet_geometry()
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


def phase_fused_vs_scan(device, s=8, j=64, w=4, ticks=1000):
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
    (final state on ``device``, final CPU state).  Raises on the first tick
    whose integer state differs, naming the kernel call that differed:
    every scheduler's picks, themis's included, equal the CPU's."""
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
    try:
        for t in range(ticks):
            log.clear()
            st_d = tick_d(p_d, st_d)
            calls_d = list(log)
            log.clear()
            st_c = tick_c(p_c, st_c)
            leaf = int_leaves_equal(st_d, st_c)
            if leaf is not None:
                try:
                    why = explain_divergence(calls_d, list(log))
                except AssertionError as e:
                    why = str(e)
                raise AssertionError(f"{scheduler} {impl}: card and CPU "
                                     f"differ in {leaf} at tick {t}: {why}")
    finally:
        engine.tick_step, tokens.token_select = saved
    return st_d, st_c


def phase_card_vs_cpu(device, ticks=500):
    """fifo and themis, fused and scan, stepped on the card and on the CPU
    together: every integer leaf equal at every tick (no pick excused),
    the float leaves within rounding of the atomic adds."""
    import torch
    for scheduler in ("fifo", "themis"):
        for impl in ("fused", "scan"):
            tag = f"{scheduler} {impl}"
            a, b = lockstep(scheduler, impl, device, ticks)
            seg = "equal" if torch.equal(a.seg.cpu(), b.seg) else \
                "within rtol 1e-5"
            for f in FLOAT_LEAVES:
                x, y = getattr(a, f).cpu(), getattr(b, f)
                torch.testing.assert_close(
                    x, y, rtol=1e-5 if f == "seg" else 1e-6, atol=0.0,
                    msg=f"{tag}: {f} beyond tolerance")
            say("card_vs_cpu", f"{tag}: {ticks} ticks counter-exact (0 "
                f"draws excused), seg {seg}, float leaves within rtol 1e-6, "
                f"completed {int(b.completed.sum())}")


def phase_anchor(device, seconds=4.0):
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


def phase_schedulers(device, geometry=None, seconds=FLEET_SECONDS):
    """The four scan schedulers at fleet geometry; returns ms/tick."""
    import torch
    from repro_torch.api import Experiment
    from repro_torch.bench.fleet import fleet_jobs
    geometry = geometry or fleet_geometry()
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


def phase_schedulers_card_vs_cpu(device, ticks=250, mu_ticks=50):
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


def ulps_apart(a, b) -> float:
    """The largest gap between float32 tensors ``a`` and ``b``, in ulps of
    ``b``."""
    import numpy as np
    x, y = a.cpu().double(), b.cpu().double()
    ulp = np.spacing(y.abs().numpy().astype(np.float32)).astype(float)
    return float(((x - y).abs().numpy() / np.maximum(ulp, 1e-45)).max())


def phase_batch(device, geometry=None, seconds=0.05, n_seeds=8):
    """run_batch lanes against run(); returns (launches, ms, records)."""
    import numpy as np
    import torch
    from repro_torch.api import Experiment
    from repro_torch.bench.fleet import fleet_jobs
    geometry = geometry or fleet_geometry()
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
            gap = ulps_apart(batch.state.bytes_bin[k], one.state.bytes_bin)
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


def phase_poisson(device, geometry=None, seconds=0.02, draw_ticks=8):
    """Fleet jobs on Poisson arrivals (themis fused); returns launches."""
    import math
    import torch
    from repro_torch.api import Experiment
    from repro_torch.bench.fleet import fleet_jobs
    geometry = geometry or fleet_geometry()
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


def phase_figures(device, seconds=0.5, n_seeds=8):
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


def same_picks(card_calls, cpu_calls) -> None:
    """Raises unless every themis pop drew the same job, from the same
    demand and uniform, on the card and on the CPU."""
    for k, ((_, dm_d, u_d, o_d), (_, dm_c, u_c, o_c)) in enumerate(
            zip(card_calls, cpu_calls)):
        if not (dm_d.cpu().equal(dm_c) and u_d.cpu().equal(u_c)):
            raise AssertionError(f"pop {k}: the draw's demand or uniform "
                                 "differs between the card and the CPU")
        if int(o_d) != int(o_c):
            raise AssertionError(f"pop {k}: the card picked {int(o_d)}, the "
                                 f"CPU {int(o_c)}")
    if len(card_calls) != len(cpu_calls):
        raise AssertionError("card and CPU made different numbers of themis "
                             "pops")


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
    order equal, every themis pick the CPU's), one
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
    launched, themis_pops = 0, 0
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
            if sched == "themis":
                themis_pops += pops
                same_picks(calls, calls_c)
                if sample is None:
                    sample = calls[:256]
            if not (np.array_equal(got.counts, want.counts)
                    and got.order == want.order):
                raise AssertionError(f"service {name} {sched}: counts or "
                                     "order differ between card and CPU")
            rates["card"][0] += pops
            rates["card"][1] += wall
            rates["cpu"][0] += pops_c
            rates["cpu"][1] += wall_c
            say("service", f"{name} {sched}: {pops} pops, "
                f"{int(got.counts.sum())} writes in {got.n_rounds} rounds, "
                f"counts and order equal to the CPU's; "
                f"{pops / wall:.0f} pops/s on the card, "
                f"{pops_c / wall_c:.0f} on the CPU; token_select launches "
                f"{n['token_select']}")
    pops_s = {k: round(p / w, 1) for k, (p, w) in rates.items()}
    say("service", f"themis pops {themis_pops}, token_select launches "
        f"{launched}, every pick the CPU's (0 excused); pops/s "
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


# -- the batch plane and the workspace ------------------------------------------

def count_ops(fn):
    """``(fn(), ops launched, ops captured)``: the torch ops that produced
    CUDA tensors while ``fn`` ran (views and bare allocations not
    counted), about one kernel each, split into those run at once and
    those recorded into a CUDA graph, which launch only when it replays."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    no_launch = {torch.ops.aten.empty.memory_format,
                 torch.ops.aten.empty_strided.default}

    class Counter(TorchDispatchMode):
        n = [0, 0]

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            outs = out if isinstance(out, (tuple, list)) else (out,)
            if (not func.is_view and func not in no_launch
                    and any(torch.is_tensor(o) and o.is_cuda for o in outs)):
                Counter.n[torch.cuda.is_current_stream_capturing()] += 1
            return out

    with Counter():
        out = fn()
    return out, Counter.n[0], Counter.n[1]


def explain_plan(device, preset, seed, n_jobs, params) -> str:
    """The first annealing step whose values differ between ``device`` and
    the CPU, with its c_prop, cost, temp, uniform and exp on both (on the
    card recorded by the same CUDA graph the timed anneal replays)."""
    import torch
    from repro_torch.batch import queue_preset
    from repro_torch.batch.plan import RECORD_FIELDS, anneal, plan_window
    from repro_torch.batch.sim import arrival_order, queue_columns
    q = queue_preset(preset, n_jobs=n_jobs, seed=seed)
    recs = {}
    for dev in (device, "cpu"):
        order0 = torch.from_numpy(arrival_order(q)).to(dev)
        *_, recs[dev] = anneal(order0, queue_columns(q, dev),
                               q.cluster.n_nodes, q.cluster.bb_total, params,
                               seed, plan_window(q, params), record=True)
    for step in range(params.sa_steps):
        for f in RECORD_FIELDS:
            if not torch.equal(recs[device][f][step].cpu(),
                               recs["cpu"][f][step]):
                vals = {dev: {g: recs[dev][g][step].tolist()
                              for g in RECORD_FIELDS} for dev in recs}
                return f"first differing step {step} ({f}): {vals}"
    return "every recorded step equal (the difference is after the anneal)"


def phase_batch_plane(device, seconds=None, seeds=None, n_jobs=None,
                      sa_steps=None, reps=20):
    """bench/batch.py's rows on the card: every start vector valid, every
    fcfs / easy / plan start and plan order equal to the CPU's bit for bit,
    every row's text equal to batch_reference.json, one tick_step launch
    per tick of the bridge run; ms per anneal, per schedule_order
    evaluation, the launches per anneal and the bridge's ms/tick.  Returns
    (the bridge run's tick_step launches, those metrics)."""
    import numpy as np
    import torch
    from repro_torch.batch import BatchExperiment, PlanOptParams
    from repro_torch.batch.bridge import to_experiment as bridge_experiment
    from repro_torch.batch.plan import anneal, plan_window
    from repro_torch.batch.sim import (arrival_order, queue_columns,
                                       schedule_order, validate_schedule)
    from repro_torch.bench import batch as bench
    ref = bench.load_reference()
    seconds = bench.BENCH_SECONDS if seconds is None else seconds
    seeds = bench.BENCH_SEEDS if seeds is None else tuple(seeds)
    n_jobs = bench.BENCH_JOBS if n_jobs is None else n_jobs
    sa_steps = bench.BENCH_STEPS if sa_steps is None else sa_steps
    full = (seconds, list(seeds), n_jobs, sa_steps) == (
        ref["seconds"], ref["seeds"], ref["n_jobs"], ref["sa_steps"])

    card: dict = {}
    synced(device)
    reset_launches()
    rows = bench.run_batch(seconds, seeds, n_jobs=n_jobs, sa_steps=sa_steps,
                           device=device, results=card)
    launches = read_launches()
    # The bridge run is the path's one kernel: one fused themis tick_step
    # launch per tick (fcfs, easy and plan launch no kernel of the port).
    plan0 = card[("bb-heavy", seeds[0], "plan")][0]
    exp, horizon = bridge_experiment(plan0.queue, plan0.start, device=device)
    ticks = int(round(min(horizon, seconds) / exp.engine_config().dt))
    expect_launches("batch_plane bridge", device, launches,
                    {"tick_step": ticks, "token_select": 0})
    params = PlanOptParams(sa_steps=sa_steps)
    failed = []
    for (preset, seed, pol), (res, _) in card.items():
        validate_schedule(res.queue, res.start)
    for preset in bench.PRESETS:
        for seed in seeds:
            cpu = BatchExperiment(preset, n_jobs=n_jobs, seed=seed,
                                  params=params, device="cpu")
            for pol in bench.POLICIES:
                want, got = cpu.run(pol, seed=seed), card[(preset, seed,
                                                           pol)][0]
                same = (got.start.tobytes() == want.start.tobytes() and (
                    pol != "plan" or got.order.tolist() == want.order.tolist()))
                if not same:
                    why = (explain_plan(device, preset, seed, n_jobs, params)
                           if pol == "plan" else "list schedule")
                    say("batch_plane", f"{preset} seed {seed} {pol}: card "
                        f"differs from the CPU: {why}")
                    failed.append((preset, seed, pol))
    say("batch_plane", f"{len(card)} start vectors valid; fcfs, easy and plan "
        f"starts and plan orders equal to the CPU's bit for bit: "
        f"{'yes' if not failed else failed}")
    if failed:
        raise AssertionError(f"batch plans differ between card and CPU: "
                             f"{failed}")
    bad = []
    for r in rows:
        want = ref["rows"][r.name]["derived"] if full else None
        ok = want is None or r.derived == want
        say("batch_plane", f"{r.name}: {r.derived!r}"
            + ("" if want is None else f" vs reference {want!r}: "
               f"{'ok' if ok else 'FAIL'}"))
        if not ok:
            bad.append(r.name)
    if bad:
        raise AssertionError(f"batch rows differ from batch_reference.json: "
                             f"{bad}")

    # Times on the card: the anneals of the rows, one schedule_order
    # evaluation at the annealer's [R, N], and the ops of one anneal.
    plans = [w for (_, _, pol), (_, w) in card.items() if pol == "plan"]
    anneal_ms = float(np.median(plans)) * 1e3
    q = card[(bench.PRESETS[0], seeds[0], "plan")][0].queue
    cols = queue_columns(q, device)
    order0 = torch.from_numpy(arrival_order(q)).to(device)
    orders = order0.expand(params.sa_restarts, -1).contiguous()
    eval_ms = time_ms(lambda: schedule_order(orders, cols, q.cluster.n_nodes,
                                             q.cluster.bb_total), reps)
    # Host launches of an anneal: the ops it runs at once (set-up and the
    # step's warm-up) plus one graph replay a step; the kernels of a step:
    # the ops captured into the graph.
    _, eager, step_kernels = count_ops(lambda: anneal(
        order0, cols, q.cluster.n_nodes, q.cluster.bb_total, params,
        seeds[0], plan_window(q, params)))
    ops = eager + sa_steps
    synced(device)
    (bridge_row,) = [r for r in rows if r.name == "batch_bridge_themis_gbps"]
    tick_ms = float(bridge_row.us_per_call) * 1e-3 / ticks
    metrics = dict(anneal_ms=round(anneal_ms, 1),
                   schedule_order_ms=round(eval_ms, 3),
                   launches_per_anneal=ops, kernels_per_step=step_kernels,
                   bridge_ms_per_tick=round(tick_ms, 3),
                   bridge_ticks=ticks)
    say("batch_plane", f"{n_jobs} jobs, {sa_steps} steps x "
        f"{params.sa_restarts} restarts: {anneal_ms:.1f} ms per anneal "
        f"(median of {len(plans)}, host clock to the plan on the host), "
        f"{eval_ms:.3f} ms per schedule_order evaluation at [R, N] = "
        f"[{params.sa_restarts}, {n_jobs}] (eager), {ops} host launches "
        f"per anneal ({eager} torch ops run on the card outside the graph, "
        f"views and allocations not counted, and one graph replay a step), "
        f"{step_kernels} kernels a step (ops captured in the graph); bridge "
        f"{ticks} ticks at {tick_ms:.3f} ms/tick, kernel launches {launches}")
    say("batch_plane", "metrics " + json.dumps(metrics))
    return {"tick_step[themis]": launches["tick_step"]}, metrics


#: docs/workspace.md's example knob (its EXAMPLE_SECONDS = 1, cut in depth
#: to 0.5 s), and its grid and seeds.
WORKSPACE_SECONDS = 0.5
WORKSPACE_GRID = {"burst_s": [0.5, 1.0], "repay": [0.5, 1.0]}


def phase_workspace(device, seconds=WORKSPACE_SECONDS, solo_seconds=1.0):
    """docs/workspace.md's resumable sweep on the card (interrupted by
    max_chunks, resumed, reused; merged = plain bit for bit), then a themis
    solo cached in the workspace (first call one tick_step launch per
    tick, second call none and the same result).  Returns the solo's
    tick_step launches."""
    import tempfile

    import numpy as np
    from repro_torch.api import Experiment
    from repro_torch.workspace import (CampaignInterrupted, WorkspaceStore,
                                       run_sweep)

    def make():
        return (Experiment(scheduler="adaptbf", policy="job-fair",
                           device=device)
                .add_job(user=0, procs=56, req_mb=10, end_s=seconds)
                .add_job(user=1, procs=112, req_mb=10, end_s=seconds))

    fields = ("gbps", "issued", "completed", "dropped", "idle_worker_ticks")
    with tempfile.TemporaryDirectory(prefix="chip-smoke-ws-") as root:
        reset_launches()
        t0 = time.perf_counter()
        plain = make().sweep(WORKSPACE_GRID, seconds, seeds=(0, 1))
        t_plain = time.perf_counter() - t0
        store = WorkspaceStore(root)
        try:
            run_sweep(make(), WORKSPACE_GRID, seconds, seeds=(0, 1),
                      store=store, campaign="doc-sweep", chunk=2,
                      max_chunks=1)
            raise AssertionError("max_chunks=1 did not interrupt the sweep")
        except CampaignInterrupted as stop:
            first = stop.report
        resumed, second = run_sweep(
            make(), WORKSPACE_GRID, seconds, seeds=(0, 1),
            store=WorkspaceStore(root), campaign="doc-sweep", chunk=2)
        t0 = time.perf_counter()
        reused, third = run_sweep(
            make(), WORKSPACE_GRID, seconds, seeds=(0, 1),
            store=WorkspaceStore(root), campaign="doc-sweep")
        t_reuse = time.perf_counter() - t0
        counts = [(r["computed"], r["reused"]) for r in (first, second, third)]
        if counts != [(2, 0), (2, 2), (0, 4)]:
            raise AssertionError(f"workspace (computed, reused) per run "
                                 f"{counts}, expected [(2, 0), (2, 2), (0, 4)]")
        for tag, res in (("resumed", resumed), ("reused", reused)):
            for f in fields:
                if not np.array_equal(getattr(res, f), getattr(plain, f)):
                    raise AssertionError(f"workspace {tag} sweep: {f} "
                                         f"differs from the plain sweep")
        expect_launches("workspace adaptbf sweeps", device, read_launches(),
                        {"tick_step": 0, "token_select": 0})
        say("workspace", f"adaptbf {len(plain.points)} points x 2 seeds x "
            f"{plain.ticks} ticks: (computed, reused) {counts}; resumed and "
            f"reused sweeps equal the plain sweep bit for bit ({', '.join(fields)}); "
            f"plain sweep {t_plain:.2f} s, full reuse {t_reuse * 1e3:.1f} ms")

        # The figures' geometry: 1 server, W = 8, dt 1 ms.
        exp = (Experiment(policy="job-fair", scheduler="themis",
                          device=device)
               .add_job(user=0, size=1, procs=56, req_mb=10)
               .add_job(user=1, size=1, procs=224, req_mb=10))
        runs = []
        for call in ("first", "second"):
            synced(device)
            reset_launches()
            t0 = time.perf_counter()
            res = exp.solo(0, solo_seconds, workspace=root, name="solo")
            synced(device)
            runs.append((res, read_launches(), time.perf_counter() - t0))
        (a, n_a, w_a), (b, n_b, w_b) = runs
        expect_launches("workspace solo (computed)", device, n_a,
                        {"tick_step": a.ticks, "token_select": 0})
        expect_launches("workspace solo (cached)", device, n_b,
                        {"tick_step": 0, "token_select": 0})
        for f in ("gbps", "issued", "completed", "dropped",
                  "idle_worker_ticks", "ticks"):
            if not np.array_equal(getattr(a, f), getattr(b, f)):
                raise AssertionError(f"workspace solo: cached {f} differs")
        say("workspace", f"themis solo {a.ticks} ticks: first call "
            f"{w_a:.2f} s, kernel launches {n_a}; cached call "
            f"{w_b * 1e3:.1f} ms, kernel launches {n_b}, same result")
    return {"tick_step[themis]": n_a["tick_step"]}


# -- fleet sharding: the engine on a mesh of ranks ------------------------------

#: tests/test_shard.py's _BIT_IDENTITY job list (its Poisson phase
#: included), geometry, horizon and batch seeds.
SHARD_JOBS = [dict(user=0, size=2, procs=40, req_mb=8, think_s=0.002),
              dict(user=1, size=1, procs=20, req_mb=4,
                   phases=[dict(start_s=0.0, duration_s=0.08,
                                arrival="poisson", rate_hz=300),
                           dict(start_s=0.1, duration_s=0.1)]),
              dict(user=2, size=1, procs=10, req_mb=16, start_s=0.04,
                   think_s=0.001)]
SHARD_GEOM = dict(n_servers=4, max_jobs=8, n_workers=4, seed=3)
SHARD_SECONDS = 0.2
SHARD_SEEDS = (1, 2, 3, 4)
SHARD_SCHEDULERS = ("themis", "adaptbf")
SHARD_RANKS = 4


def shard_experiment(scheduler, device, **knobs):
    from repro_torch.api import Experiment
    return Experiment(policy="user-fair", scheduler=scheduler, device=device,
                      **SHARD_GEOM, **knobs).add_jobs(SHARD_JOBS)


def state_digest(state) -> str:
    """sha256 of every leaf's bytes (aux included) and the tick."""
    import hashlib
    h = hashlib.sha256(str(state.t).encode())
    for f in state._fields:
        leaves = (state.aux if f == "aux" else
                  () if f == "t" else (getattr(state, f),))
        for x in leaves:
            h.update(x.cpu().contiguous().view(-1).numpy().tobytes())
    return h.hexdigest()


def shard_rank(device):
    """One rank of the shard phase's world: themis and adaptbf ``run`` at
    ``shard_servers=4`` (rank 0 timing it between barriers) and
    ``run_batch`` at ``mesh_shape=(2, 2)`` over ``SHARD_SEEDS``.  Returns
    rank 0's states on the CPU, and every rank's digest of its results, its
    kernel launches and its collectives per tick."""
    import torch.distributed as dist
    from repro_torch.core import engine, shard
    reset_launches()
    out, digests, per_tick = {}, [], {}
    for name in SHARD_SCHEDULERS:
        exp = shard_experiment(name, device, shard_servers=SHARD_RANKS)
        c0 = shard.COLLECTIVES
        shard.barrier()
        t0 = synced(device)
        res = exp.run(SHARD_SECONDS)
        t1 = synced(device)
        shard.barrier()
        per_tick[name] = (shard.COLLECTIVES - c0) / res.ticks
        batch = shard_experiment(name, device, mesh_shape=(2, 2)).run_batch(
            SHARD_SECONDS, seeds=SHARD_SEEDS)
        out[name] = dict(run=engine.map_state(res.state, lambda x: x.cpu()),
                         batch=engine.map_state(batch.state,
                                                lambda x: x.cpu()),
                         ms_per_tick=(t1 - t0) / res.ticks * 1e3)
        digests += [state_digest(res.state), state_digest(batch.state)]
    mine = dict(digest=digests, launches=read_launches(),
                collectives_per_tick=per_tick)
    ranks = [None] * dist.get_world_size()
    dist.all_gather_object(ranks, mine)
    return dict(results=out, ranks=ranks, backend=dist.get_backend())


def leaves_equal_but_bytes(a, b, tag, n_adds):
    """Every leaf of states ``a`` and ``b`` (aux included) equal, but
    ``bytes_bin``, held within ``n_adds`` ulps (the order of the card's
    atomic adds).  Returns that gap."""
    import torch
    if a.t != b.t:
        raise AssertionError(f"{tag}: t differs")
    for f in a._fields:
        if f in ("t", "bytes_bin"):
            continue
        pairs = (zip(a.aux._fields, a.aux, b.aux) if f == "aux"
                 else ((f, getattr(a, f), getattr(b, f)),))
        for name, x, y in pairs:
            if not torch.equal(x.cpu(), y.cpu()):
                raise AssertionError(f"{tag}: {name} differs")
    gap = ulps_apart(a.bytes_bin, b.bytes_bin)
    if gap > n_adds:
        raise AssertionError(f"{tag}: bytes_bin {gap:.0f} ulps apart, bound "
                             f"{n_adds}")
    return gap


def phase_shard(device):
    """The 4-rank sharded runs against the unsharded card runs (every leaf
    exact but bytes_bin) and against the CPU's integer counters; every
    rank's result equal.  Returns rank 0's token_select launches."""
    import torch
    from repro_torch.launch.mesh import spawn
    t0 = time.perf_counter()
    world = spawn(shard_rank, SHARD_RANKS, args=(device,), backend="gloo",
                  device=device)
    spawn_s = time.perf_counter() - t0
    ranks = world["ranks"]
    if len({tuple(r["digest"]) for r in ranks}) != 1:
        raise AssertionError("shard: the ranks' results differ")
    n_cards = torch.cuda.device_count() if device != "cpu" else 1
    ms = {}
    for name in SHARD_SCHEDULERS:
        got = world["results"][name]
        exp = shard_experiment(name, device)
        n_adds = lane_bytes_bound(exp.engine_config())
        t1 = synced(device)
        one = exp.run(SHARD_SECONDS)
        t2 = synced(device)
        ms[name] = dict(x1=(t2 - t1) / one.ticks * 1e3,
                        x4=got["ms_per_tick"])
        gap = leaves_equal_but_bytes(got["run"], one.state, f"{name} run x4",
                                     n_adds)
        batch = exp.run_batch(SHARD_SECONDS, seeds=SHARD_SEEDS)
        gap_b = leaves_equal_but_bytes(got["batch"], batch.state,
                                       f"{name} run_batch (2, 2)", n_adds)
        cpu = shard_experiment(name, "cpu").run(SHARD_SECONDS)
        bad = int_leaves_equal(got["run"], cpu.state)
        if bad is not None:
            raise AssertionError(f"{name} run x4: {bad} differs from the "
                                 "CPU's")
        say("shard", f"{name}: run at shard_servers=4 = the unsharded card "
            f"run in every leaf but bytes_bin ({gap:.0f} ulps, bound "
            f"{n_adds}); run_batch at mesh (2, 2) over seeds "
            f"{list(SHARD_SEEDS)} = the unsharded batch ({gap_b:.0f} ulps); "
            f"integer counters = the CPU's; "
            f"completed {int(cpu.completed.sum())}")
    say("shard", f"backend {world['backend']}, {SHARD_RANKS} ranks on "
        f"{n_cards} card(s) ({SHARD_RANKS // n_cards} ranks per card), "
        f"collectives per tick {ranks[0]['collectives_per_tick']}; ms/tick "
        f"{json.dumps(ms)}; world {spawn_s:.1f} s; every rank's result "
        "equal")
    say("shard", "kernel launches per rank " + json.dumps(
        [r["launches"] for r in ranks]))
    return ranks[0]["launches"]["token_select"]


#: The fleet phase's depth: the reference's 0.1 s cut to 0.02 s (100 ticks
#: at dt 2e-4), the depth fleet_reference.json was recorded at.
FLEET_PHASE_SECONDS = 0.02
FLEET_COUNTERS = ("issued", "completed", "dropped", "idle_worker_ticks")
FLEET_ROWS = ["fleet_run_us_per_tick_x1", "fleet_gbps_x1",
              "fleet_run_us_per_tick_x2", "fleet_x2_vs_x1",
              "fleet_run_us_per_tick_x4", "fleet_x4_vs_x1"]


def phase_fleet(device, seconds=FLEET_PHASE_SECONDS):
    """The fleet rows of repro_torch.bench.fleet at the fleet geometry:
    the reference's row names, fleet_gbps_x1's text and x1's integer
    counters equal to bench/fleet_reference.json, every rung's integer
    counters equal to x1's.  Returns rank 0's launches per rung."""
    import numpy as np
    from repro_torch.bench import fleet
    results = {}
    rows = fleet.run_fleet(device=device, seconds=seconds, results=results)
    for r in rows:
        say("fleet", f"{r.name},{r.us_per_call},{r.derived}")
    if [r.name for r in rows] != FLEET_ROWS:
        raise AssertionError(f"fleet rows {[r.name for r in rows]}, expected "
                             f"{FLEET_ROWS}")
    ref = fleet.load_reference()
    if ref["seconds"] != seconds:
        raise AssertionError(f"fleet_reference.json was recorded at "
                             f"{ref['seconds']} s, the phase runs {seconds}")
    got = {r.name: r.derived for r in rows}["fleet_gbps_x1"]
    want = ref["rows"]["fleet_gbps_x1"]["derived"]
    if got != want:
        raise AssertionError(f"fleet_gbps_x1 {got!r}, the reference's "
                             f"{want!r}")
    one = results[1]
    same = lambda a, b: np.array_equal(np.reshape(a, -1), np.reshape(b, -1))
    bad = [f for f in FLEET_COUNTERS if not same(one[f], ref["x1"][f])]
    if bad:
        raise AssertionError(f"fleet x1: {bad} differ from the reference's")
    for k, rung in results.items():
        for f in FLEET_COUNTERS:
            if not np.array_equal(rung[f], one[f]):
                raise AssertionError(f"fleet x{k}: {f} differs from x1's")
        say("fleet", f"x{k}: {rung['wall_s'] / rung['ticks'] * 1e3:.3f} "
            f"ms/tick over {rung['ticks']} ticks"
            + (f", world {rung['spawn_s']:.1f} s" if k > 1 else "")
            + "; per rank launches and collectives per tick "
            + json.dumps(rung["ranks"]))
    say("fleet", f"fleet_gbps_x1 = the reference's text ({want!r}); x1's "
        f"integer counters = the reference's; every "
        f"rung's integer counters equal x1's (completed "
        f"{int(one['completed'].sum())})")
    return {k: rung["ranks"][0] for k, rung in results.items()}


# -- the paper's benchmark CLI ---------------------------------------------------

#: What each section runs on the card: fig7 the paper's quoted rungs, fig13
#: one application; the CPU tests run every variant.
PAPER_SUBSETS = {"fig7": {"servers": (1, 8, 128)}, "fig9": {},
                 "fig13": {"apps": ("wrf",)}, "fig14": {}}
#: A run's attribution and integer counters, held to the reference's.
RUN_COUNTERS = ("scheduler", "params_hash", "dropped", "idle_worker_ticks",
                "issued", "completed")


def recording_runs(log):
    """``Experiment.run`` that zeroes the draw kernels' launch counts just
    before each call and appends ``(scheduler, ticks, launches, wall s)``
    just after it."""
    from repro_torch.api import Experiment
    inner = Experiment.run

    def wrapper(self, *args, **kw):
        reset_launches()
        t0 = time.perf_counter()
        out = inner(self, *args, **kw)
        synced(self.device)
        log.append((self.scheduler, out.ticks, read_launches(),
                    time.perf_counter() - t0))
        return out
    return inner, wrapper


def paper_section(name):
    """The port's row function of a paper section."""
    from repro_torch.bench import apps, composite, lambda_sync, scaling
    return {"fig7": scaling.run_fig7, "fig9": composite.run_fig9_11,
            "fig13": apps.run_fig13, "fig14": lambda_sync.run_fig14}[name]


def subset_runs(name, runs, subset):
    """The reference's runs of a section (in its order) that ``subset``
    makes: fig7 two per server count, fig13 three per application."""
    from repro_torch.bench import apps, scaling
    if name == "fig7" and "servers" in subset:
        return [runs[2 * scaling.LADDER.index(n) + k]
                for n in subset["servers"] for k in range(2)]
    if name == "fig13" and "apps" in subset:
        return [runs[3 * list(apps.APPS).index(a) + k]
                for a in subset["apps"] for k in range(3)]
    return runs


def phase_paper(device, name, depth="card", subset=None):
    """One of fig7, fig9 (Figs. 9-11), fig13 and fig14 at the depth
    paper_reference.json was recorded at (``depth``: "card" or "test"):
    every row's text equal to the reference's, every run's attribution and
    integer counters equal, one tick_step launch per tick of each fused
    run (themis and fifo), no token_select launch.  Returns the launches of
    each fused mode and the ms/tick of each run."""
    from repro_torch.api import Experiment
    from repro_torch.bench import common
    ref = common.load_paper_reference()[depth][name]
    subset = PAPER_SUBSETS[name] if subset is None else subset
    log: list = []
    inner, Experiment.run = recording_runs(log)
    common.drain_run_log()
    try:
        rows = paper_section(name)(device=device, scale=ref["scale"],
                                   **subset)
    finally:
        Experiment.run = inner
    runs = common.drain_run_log()
    want = subset_runs(name, ref["runs"], subset)
    if len(runs) != len(want):
        raise AssertionError(f"{name}: {len(runs)} runs, the reference "
                             f"made {len(want)}")
    for k, (got, exp) in enumerate(zip(runs, want)):
        bad = [f for f in RUN_COUNTERS if got[f] != exp[f]]
        if bad:
            raise AssertionError(f"{name} run {k} ({got['scheduler']}): {bad} "
                                 "differ from the reference's")
    failed = [r.name for r in rows if r.derived != ref["rows"][r.name]]
    for r in rows:
        say(name, f"{r.name},{r.us_per_call},{r.derived} (reference "
            f"{ref['rows'][r.name]!r})")
    if failed:
        raise AssertionError(f"{name}: rows apart from the reference's: "
                             f"{failed}")
    launches = {"tick_step[themis]": 0, "tick_step[fifo]": 0}
    ms = []
    for sched, ticks, got, wall in log:
        expect_launches(f"{name} {sched} run", device, got,
                        {"tick_step": ticks, "token_select": 0})
        launches[f"tick_step[{sched}]"] += got["tick_step"]
        ms.append(round(wall / ticks * 1e3, 3))
    say(name, f"scale {ref['scale']:g}: {len(rows)} rows = the reference's "
        f"text, {len(runs)} runs' integer counters = the reference's; "
        f"{sum(t for _, t, _, _ in log)} ticks, one tick_step launch per "
        f"tick; ms/tick per run {ms}")
    return launches, ms


def phase_kern(device, iters=30):
    """kern: at each J of its ladder the per-worker scan (one token_select
    launch per worker) and the fused tick (one tick_step launch) on the
    same inputs give the same selections, qcount' and pops on the card, and
    both equal the plain versions on the CPU; then the section's rows,
    their names the reference's, and the roofline budget at the H100's
    constants.  Returns the draw kernels' launches of the section's run."""
    import torch
    from repro_torch.bench import common, tick
    ref = common.load_paper_reference()
    for j in tick.LADDER:
        args = tick.inputs(j, device)
        reset_launches()
        sel_s, q_s, p_s = tick.scan_phase(*args)
        sel_f, q_f, p_f = tick.fused_phase(*args)
        synced(device)
        n = read_launches()
        expect_launches(f"kern J={j}", device, n,
                        {"tick_step": 1, "token_select": tick.N_WORKERS})
        cpu = [a.cpu() for a in args]
        sel_c, q_c, p_c = tick.scan_phase(*cpu)
        for tag, a, b in (("sel", sel_f, sel_s.T), ("qcount'", q_f, q_s),
                          ("pops", p_f, p_s), ("scan sel on the CPU", sel_s,
                                               sel_c),
                          ("qcount' on the CPU", q_s, q_c),
                          ("pops on the CPU", p_s, p_c)):
            if not torch.equal(a.cpu(), b.cpu()):
                raise AssertionError(f"kern J={j}: fused and scan {tag} "
                                     "differ")
        say("kern", f"J={j}: fused tick_step = {tick.N_WORKERS} token_select "
            "launches of the scan, selections, qcount' and pops bit for "
            "bit, and = the CPU's")
    reset_launches()
    rows = tick.run_kern(device=device, iters=iters)
    launches = read_launches()
    for r in rows:
        say("kern", f"{r.name},{r.us_per_call},{r.derived}")
    names = [r.name for r in rows]
    if names != ref["names"]["kern"]:
        raise AssertionError(f"kern rows {names}, the reference's "
                             f"{ref['names']['kern']}")
    from repro_torch.roofline.analysis import tick_step_roofline
    say("kern", "budget at the H100's 3.35e12 B/s and 67e12 op/s: " + "; ".join(
        f"J={j} {tick_step_roofline(tick.N_SERVERS, j, tick.N_WORKERS)['budget_us']:.4f} us"
        for j in tick.LADDER))
    return launches


def phase_micro(device, iters=30):
    """micro: the draw on the card equals its plain version on the CPU,
    the policy chain's shares on the card the CPU's; the rows, their names
    the reference's.  Returns the draw kernels' launches of the run."""
    import torch
    from repro_torch.bench import common, kernels
    from repro_torch.core.policy import Policy, compute_job_shares_from_table
    from repro_torch.kernels.token_select.ops import token_select
    ref = common.load_paper_reference()
    args = kernels.draw_inputs(device)
    got = token_select(*args)
    want = token_select(*[a.cpu() for a in args])
    if not torch.equal(got.cpu(), want):
        raise AssertionError("micro: the card's draws differ from the CPU's")
    pol = Policy.parse("group-user-size-fair")
    sh = compute_job_shares_from_table(pol, kernels.chain_table(device))
    sh_c = compute_job_shares_from_table(pol, kernels.chain_table("cpu"))
    if not torch.equal(sh.cpu(), sh_c):
        raise AssertionError("micro: the card's chain shares differ from the "
                             "CPU's")
    reset_launches()
    rows = kernels.run_micro(device=device, iters=iters)
    launches = read_launches()
    for r in rows:
        say("micro", f"{r.name},{r.us_per_call},{r.derived}")
    if [r.name for r in rows] != ref["names"]["micro"]:
        raise AssertionError(f"micro rows {[r.name for r in rows]}")
    say("micro", "64 draws and the 3-level chain's shares = the CPU's")
    return launches


def schema_stem(pattern: str) -> str:
    """A ROW_SCHEMAS pattern up to its first ``{axis}``."""
    return pattern.split("{", 1)[0]


def phase_calibrate(device, depth="card"):
    """The AdapTBF (20 points) and plan (6 points) calibration sweeps, each
    point x seed a lane of one tick loop, at the depth
    paper_reference.json holds: every row's text and both chosen points
    equal to the reference's.  Returns ms per lane-tick of each sweep."""
    from repro_torch.bench import calibrate, common
    ref = common.load_paper_reference()[depth]["calibrate"]
    seeds = tuple(ref["seeds"])
    ms = {}
    for name, fn in calibrate.SECTIONS.items():
        t0 = time.perf_counter()
        rows, report = fn(ref["seconds"], seeds, device=device)
        wall = time.perf_counter() - t0
        lanes = len(rows) * len(seeds)
        ms[name] = round(wall / (lanes * ref["seconds"] / 1e-3) * 1e3, 4)
        bad = [r.name for r in rows if r.derived != ref[name]["rows"][r.name]]
        if bad or report["chosen"] != ref[name]["chosen"]:
            raise AssertionError(f"calibrate {name}: rows {bad} or chosen "
                                 f"{report['chosen']} apart from the "
                                 "reference's")
        say("calibrate", f"{name}: {len(rows)} points x {len(seeds)} seeds "
            f"at {ref['seconds']:g} s in {wall:.1f} s, every row = the "
            f"reference's, chosen {report['chosen']} = the reference's")
    return ms


def phase_cli(device):
    """``repro_torch.bench.run`` in process on kern and micro with --json:
    both sections with rows and a runs block, every row named by its
    section's ROW_SCHEMAS (kern's patterns each matched in full); then
    the document ingested twice into the trend under two labels, and the
    gate passes."""
    import json as json_
    import re
    import tempfile
    from repro_torch.bench import run, trend
    with tempfile.TemporaryDirectory() as tmp:
        path, hist = Path(tmp) / "BENCH_cli.json", Path(tmp) / "TREND.json"
        rc = run.main(["kern", "micro", "--json", str(path), "--device",
                       device])
        doc = json_.loads(path.read_text())
        if rc != 0 or set(doc["sections"]) != {"kern", "micro"}:
            raise AssertionError(f"run.main -> {rc}, sections "
                                 f"{list(doc['sections'])}")
        for sec, body in doc["sections"].items():
            if not isinstance(body.get("runs"), list) or not body["rows"]:
                raise AssertionError(f"{sec}: no rows or no runs block")
            stems = [schema_stem(p) for p in run.ROW_SCHEMAS[sec]]
            for row in body["rows"]:
                if not any(row["name"].startswith(st) for st in stems):
                    raise AssertionError(f"{sec} row {row['name']} matches "
                                         "no ROW_SCHEMAS pattern")
        names = [r["name"] for r in doc["sections"]["kern"]["rows"]]
        for pattern in run.ROW_SCHEMAS["kern"]:
            rx = re.compile(re.sub(r"\\\{[^}]*\\\}", ".+", re.escape(pattern)))
            if not any(rx.fullmatch(n) for n in names):
                raise AssertionError(f"kern: no row matches {pattern}")
        for label in ("first", "second"):
            rc = trend.main([str(path), "--history", str(hist), "--label",
                             label])
            if rc != 0:
                raise AssertionError(f"trend gate failed on label {label}")
        points = len(json_.loads(hist.read_text())["points"])
    say("cli", f"run.main kern micro --json: both sections with rows and "
        f"runs, every row named by ROW_SCHEMAS; trend ingested it twice "
        f"({points} points), gate passed")


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
                         (ssm, "step_and_decay"), (rwkv, "wkv6")):
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
        steps_before = ssd_ops.STEP_DECAY_LAUNCHES
        t = synced(device)
        logits, caches = step(weights, {"tokens": tokens})
        wall = synced(device) - t
        n = {name: op.LAUNCHES - before[name] for name, op in ops.items()}
        if n != per_prefill:
            raise AssertionError(f"prefill of {tuple(tokens.shape)} launched "
                                 f"{n}, expected {per_prefill}")
        n_passes = {k: v - passes[k] for k, v in ssd_ops.PASS_LAUNCHES.items()}
        n_passes["step_decay"] = ssd_ops.STEP_DECAY_LAUNCHES - steps_before
        if set(n_passes.values()) != {n["mamba2_ssd"]}:
            raise AssertionError(f"prefill launched the mamba2_ssd passes "
                                 f"and step_decay {n_passes} times, expected "
                                 f"each once per call ({n['mamba2_ssd']})")
        if not torch.isfinite(logits).all():
            raise AssertionError("prefill logits are not finite")
        return logits, caches, wall

    ssd_ops = ops["mamba2_ssd"]
    for op in ops.values():
        op.LAUNCHES = 0
    ssd_ops.PASS_LAUNCHES.update(dict.fromkeys(ssd_ops.PASS_LAUNCHES, 0))
    ssd_ops.STEP_DECAY_LAUNCHES = 0
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
    launches["step_decay"] = ssd_ops.STEP_DECAY_LAUNCHES
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
    if excused:
        raise AssertionError(f"{tag}: draws apart from the plain version: "
                             f"{excused}")
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
        f"draw equal to the plain version's (0 excused); "
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
    in XLA CPU's order, but from terms that may differ in the last bit
    (mamba2_ssd takes its log in the kernel, the plain version with
    torch.log), and an ulp of a prefix sum of that size enters each gate's
    exponent; 2e-5 covers the rest of the float32 arithmetic, as
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


#: Operations of the float32 function per element of the step_decay kernel
#: (an FMA counted as two), counted off csrc/mamba2_ssd.cu: the add of
#: dt_bias, softplus (an exp of 33 and a log1p of 79 operations as XLA
#: expands them, and 5 more) and the decay's product and exp.  The
#: exp(a_log) of each head is not counted per element.
STEP_DECAY_OPS = 152


def step_decay_inputs(device, seed):
    """(dt_raw, dt_bias, a_log) cases beside the serve phase's: a float32
    strided view of a projection with edge values (zeros of both signs,
    subnormals, exp's clamp points, the log1p branch point, +-inf, large
    magnitudes) among normal ones, and a decode step's [B, H]."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    edges = np.array([0.0, -0.0, 1e-40, -1e-40, 0.8813736, -0.8813736,
                      87.8, 88.8, 88.9, -87.8, -88.8, -104.0, 100.0, 1e30,
                      -1e30, np.inf, -np.inf, 20.0, -20.0, 1e-7, -1e-7],
                     dtype=np.float32)
    proj = rng.normal(0.0, 4.0, (2, 600, 200)).astype(np.float32)
    flat = proj[..., 120:200].reshape(-1)
    flat[:edges.size] = edges
    proj[..., 120:200] = flat.reshape(2, 600, 80)
    a_log = rng.uniform(-3.0, 3.0, 80).astype(np.float32)
    a_log[:3] = (0.0, 1e-40, -20.0)
    bias = rng.normal(0.0, 1.0, 80).astype(np.float32)
    t = lambda a: torch.from_numpy(a).to(device)   # noqa: E731
    return [("float32 [2, 600, 80] view, edge values",
             (t(proj)[..., 120:200], t(bias), t(a_log))),
            ("float32 [2, 80] (a decode step)",
             (t(proj[:, 7, :80].copy()), t(bias), t(a_log)))]


def phase_step_decay(device, layer0, *, reps=10):
    """The step_decay kernel against its plain version on the same card
    tensors and on the CPU, bit for bit (tolerance 0), on the inputs layer 0
    of serve_zamba2 gave it and on ``step_decay_inputs``; then its time at
    the serving shape beside its bound and the plain version's.  Returns its
    record for the kernels line."""
    import torch
    from repro_torch.kernels.mamba2 import ops as ssd_ops
    from repro_torch.kernels.mamba2.ref import step_and_decay_ref
    serve_args = tuple(layer0["args"])
    cases = [(f"serve layer 0 {serve_args[0].dtype} "
              f"{tuple(serve_args[0].shape)}", serve_args)]
    cases += step_decay_inputs(device, seed=0)
    worst = 0.0
    for tag, args in cases:
        got = ssd_ops.step_and_decay(*args)
        want = step_and_decay_ref(*args)
        cpu = step_and_decay_ref(*(t.cpu() for t in args))
        for name, g, w, c in zip(("dt", "a"), got, want, cpu):
            if not (torch.equal(g, w) and torch.equal(g.cpu(), c)):
                diff = (g.cpu().double() - c.double()).abs()
                raise AssertionError(
                    f"step_decay {tag}: {name} differs from the plain "
                    f"version at {int((g.cpu() != c).sum())} elements, max "
                    f"{float(diff[torch.isfinite(diff)].max())}")
            finite = torch.isfinite(w)
            worst = max(worst, float((g - w)[finite].abs().max()))
        say("mamba2", f"step_decay {tag}: dt and a equal the plain version's "
            "on the card and on the CPU bit for bit (tolerance 0)")
    x = serve_args[0]
    n = x.numel()
    ms = time_ms(lambda: ssd_ops.step_and_decay(*serve_args), reps=reps)
    plain = time_ms(lambda: step_and_decay_ref(*serve_args), reps=reps)
    nbytes = n * (x.element_size() + 8) + 8 * x.shape[-1]
    bound, by = bound_ms(nbytes, n * STEP_DECAY_OPS)
    say("mamba2", f"step_decay {tuple(x.shape)} {x.dtype}: kernel {ms:.4f} "
        f"ms, bound {bound:.4f} ms ({by}: {nbytes / 1e6:.2f} MB, "
        f"{n * STEP_DECAY_OPS / 1e6:.0f} M fp32 operations), plain "
        f"{plain:.3f} ms; no one PyTorch call computes this function")
    return dict(ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by,
                library_ms=None, max_abs_err=worst)


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
    plane_launches, _ = timed("batch_plane", phase_batch_plane, device)
    ws_launches = timed("workspace", phase_workspace, device)
    launches["tick_step[themis]"] += (plane_launches["tick_step[themis]"]
                                      + ws_launches["tick_step[themis]"])
    launches["token_select"] += timed("shard", phase_shard, device)
    fleet_launches = timed("fleet", phase_fleet, device)
    launches["tick_step[themis]"] += fleet_launches[1]["tick_step"]
    launches["token_select"] += sum(r["token_select"]
                                    for k, r in fleet_launches.items() if k > 1)
    # The paper's benchmark CLI: its sections at the card's depth, then the
    # harness itself.
    for name in PAPER_SUBSETS:
        got, ms = timed(name, phase_paper, device, name)
        say(name, "ms/tick " + json.dumps(ms))
        for mode, n in got.items():
            launches[mode] += n
    for name, fn in (("kern", phase_kern), ("micro", phase_micro)):
        got = timed(name, fn, device)
        launches["token_select"] += got["token_select"]
        launches["tick_step[themis]"] += got["tick_step"]
    say("calibrate", "ms per lane-tick " + json.dumps(
        timed("calibrate", phase_calibrate, device)))
    reset_launches()
    timed("cli", phase_cli, device)
    got = read_launches()
    launches["token_select"] += got["token_select"]
    launches["tick_step[themis]"] += got["tick_step"]
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
        if "step_and_decay" in layer0:
            scan_inputs["step_decay"] = layer0["step_and_decay"]
        if "flash_attention" in layer0:
            # zamba2's shared block: MHA 32/32 without a window.
            timed(f"flash_{arch}", flash_at_shape, layer0["flash_attention"],
                  phase, f"{arch} layer 0 attention")
        if arch == "zamba2-2.7b":
            engine_draws, _ = timed("serve_engine_zamba2", phase_serve_engine,
                                    device, params, arch=arch,
                                    tag="serve_engine_zamba2")
            launches["token_select"] += engine_draws
            # serve_zamba2 zeroed the count; serve_engine_zamba2 adds its own.
            launches["step_decay"] = \
                kernel_ops()["mamba2_ssd"].STEP_DECAY_LAUNCHES
        del params, layer0
    for kernel, phase in (("mamba2_ssd", "mamba2"), ("wkv6", "wkv6")):
        records[kernel] = timed(phase, phase_scan, device, kernel,
                                scan_inputs.pop(kernel))
    records["step_decay"] = timed("step_decay", phase_step_decay, device,
                                  scan_inputs.pop("step_decay"))
    timed("ssm_card_vs_cpu", phase_ssm_card_vs_cpu, device)
    say("done", f"phase seconds {json.dumps(seconds)}; total "
        f"{time.perf_counter() - t_start:.1f} s")

    replaces = {"token_select": "src/repro/kernels/token_select/kernel.py:65",
                "tick_step": "src/repro/kernels/tick_step/kernel.py:95",
                "flash_attention":
                    "src/repro/kernels/flash_attention/kernel.py:77",
                "mamba2_ssd": "src/repro/kernels/mamba2/kernel.py:54",
                "wkv6": "src/repro/kernels/rwkv6/kernel.py:67",
                # Not a Pallas kernel: the XLA fusion of softplus and exp.
                "step_decay": "src/repro/models/ssm.py:131"}
    kernels = []
    for name in ("tick_step[themis]", "tick_step[fifo]", "token_select",
                 "flash_attention", "mamba2_ssd", "wkv6", "step_decay"):
        r = records[name]
        base = name.split("[")[0]
        source = "mamba2_ssd" if base == "step_decay" else base
        kernels.append(dict(
            name=name, route="cuda",
            source=f"src/repro_torch/kernels/csrc/{source}.cu",
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
