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
  serve_engine  the port's ServeEngine at full width (its own weights from
                seed 0) with the set-up of
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
                of serve_zamba2 gave it and on edge values (dt_raw float32
                and bf16); the exhaustive sweep of its functions (exp,
                log1p, softplus) over all 2^32 float32 inputs against the
                first version's float64 multiply-adds: 0 differing inputs
                for each function in the version the kernel uses; its time
                beside its bound (bytes), the plain version's and one
                launch of a one-element add_
  ssm_card_vs_cpu  full width cut in depth, float32 (zamba2: one mamba
                block plus the shared block; rwkv6: 2 layers): one
                1100-token prompt and 8 decode steps on the card and on the
                CPU, logits within rtol 1e-3 (atol 1e-3), tokens equal
  serve_blocks  the serve phase on the seven archs the phases above do not
                serve, at full width cut in depth (SERVE_BLOCKS: gemma3-4b
                one 5:1 period, qwen3-32b 4 layers, qwen3-moe-30b-a3b 4
                (128 experts, top-8), mixtral-8x7b 4, minicpm3-4b 4,
                llama-3.2-vision-11b 4 attn + cross, musicgen-medium 4),
                bf16, 2 x 6000 tokens (codes and the vision stub drawn from
                the seed), 16 decode steps; flash launches per prefill for
                every self-attention block (attn_moe's too), MLA's heads
                folded into the batch, none for cross; every cross gate set
                to atanh(0.5); prefill + k vs decode step k (MoE and MLA
                also in float32: MLA's bf16 noise bounds its bf16 check;
                the MoE float32 run is dropless, capacity >= T, and must
                hold a row at each k); a row an MoE prefill keeps
                otherwise than the path that filled the decode cache is
                excused by name and count, a routing flip only at a
                top-k margin under twice the measured router-score gap;
                dropped assignments counted; both MoE dispatches on
                layer 0's MoE input (the same drop count, outputs
                within one bf16 rounding, each timed); flash on layer 0's
                inputs of minicpm3 (folded, D = 96), mixtral (window 4096)
                and gemma3 (D = 256) beside SDPA and its bound
  blocks_card_vs_cpu  qwen3-moe (each dispatch), minicpm3 (past MLA's 512),
                llama-vision (attn + cross) and musicgen at full width cut
                to 2 layers, float32 (qwen3-moe dropless): one 1100-token
                prompt and 8 decode steps on the card and on the CPU,
                logits within rtol 1e-3 (atol 1e-3), tokens equal
  train         ``repro_torch.launch.train``'s entry point: h2o-danube-1.8b
                at full width and depth (bf16, remat "block"), 2 x 4096
                tokens (the reference's train_4k sequence; its global batch
                of 256 cut to 2), 5 AdamW steps on the port's DataLoader:
                every loss finite, the step-0 cross-entropy within 35 % of
                ln(32000) (the reference's smoke test), 48 flash forward
                and 24 backward launches per step (each layer's forward
                again in the recompute); ms/step, tokens/s, peak memory
  flash_bwd     the flash backward kernel against its plain version on the
                card: float32 over a case list (GQA, a window shorter than
                S, ragged S, causal and not, D 16-256, 1e-4 of each
                gradient's max), and bf16 on the inputs layer 0 of the
                train phase gave it against the plain chain in float32
                (2e-2); then its time there beside its bound (tensor
                cores, exponentials or bytes), the plain version's and
                scaled_dot_product_attention's backward (forward and
                backward minus forward)
  train_zamba2  the train phase on zamba2-2.7b at full width and depth
                (54 Mamba-2 layers and the shared block, bf16, remat
                "block", 2 x 4096 tokens, 3 steps): finite losses, the
                step-0 cross-entropy within 35 % of ln(32000), a gradient
                norm above 0; per step 108 mamba2_ssd and step_decay
                launches (forward and recompute), 54 of each backward
                (mamba2_ssd_bwd's four passes once each), 18 flash forward
                and 9 backward launches; ms/step, tokens/s, peak memory
  ssd_bwd       the SSD backward kernels against their plain version on
                the card over a case list (MAMBA2_CASES' geometry, chunk 16,
                P and N padded, chunk 24 with P = 984, a chunk of 20 with
                P = 20 and N = 12): each gradient within 1e-4 of its max
                (da as da * max(a, 1e-20), bf16 db and dc one rounding
                apart), each pass against its plain version, a second run
                bit for bit equal, chunk_bwd's shared-memory layout = the
                wrapper's mirror (ops.bwd_layout); then on the inputs layer
                0 of train_zamba2 gave them, with their time, each pass's,
                the bound (TF32 tensor cores, the FMA bound beside it, and
                the split's own TF32 operations) and the plain version's
  step_decay_bwd  the step and decay's backward kernel (one launch) the
                same way, on train_zamba2's layer-0 inputs and edge values;
                its time beside its bound and the plain version's
  train_rwkv6   rwkv6-7b at full width cut to 10 of its 32 layers (the
                whole model's weights, gradients and AdamW moments, 90.4
                GB, do not fit the card; 16 layers ran out of memory in
                AdamW, which holds old and new moments at once, and 12 in
                one of two runs) through
                the train CLI, bf16, remat
                "block", 2 x 4096 tokens, 3 steps: finite losses, step-0
                cross-entropy within 35 % of ln(vocab), 2 wkv6 and 1
                wkv6_bwd launches a layer a step, grad norm finite and
                above 0; ms/step, tokens/s, peak memory
  wkv6_bwd      the WKV backward kernels against their plain version over
                WKV6_BWD_CASES (chunk 16-192 and 20, K 16-128 and 44,
                float32 and bf16, s0 and the final state's gradient or
                not, strong decay, a padded tail, K padded by the
                wrapper): each gradient within 1e-4 of its max (bf16 one
                rounding apart), each pass against its plain version, a
                second run bit for bit equal, chunk_bwd's layout = the
                wrapper's mirror (printed); then on the inputs layer 0 of
                train_rwkv6 gave them, with their time, each pass's, the
                bound (TF32 tensor cores, the FMA bound beside it, the
                split's own TF32 operations and the exponentials the
                kernels take) and the plain version's
  train_card_vs_cpu  danube at full width cut to 2 layers, zamba2 cut to a
                mamba block and the shared block and rwkv6 to 2 layers,
                float32, 512 tokens (tiles of 256, so through the flash
                kernels, and the scans' kernels forward and backward): one
                train step on the card and on the CPU from the same
                weights and batch; loss to rel 1e-5, every gradient,
                updated parameter and moment within 1e-4 of its leaf's max
                (zamba2's within 3e-4: the scan's sums in other orders);
                rwkv6's loss and gradients within 3e-4 of the CPU's, and
                its whole step within 3e-4 of the same step on the card
                with the WKV backward's plain version (two of its updated
                leaves miss the CPU's by the step's float32 noise outside
                the backward kernels, whichever backward runs: PERF.md,
                PR 27)
  train_blocks  two train steps at full width, bf16, B = 2 of gemma3-4b (6
                layers, one 5:1 period, D = 256, window 1024; S = 4096),
                minicpm3-4b (2 layers, MLA's folded flash; 4096),
                qwen3-moe-30b-a3b (2 layers; 2048), llama-3.2-vision-11b (4
                attn + cross, gate tanh = 0.5; 4096) and musicgen-medium (2
                layers, codebooks; 4096): finite losses, step-0
                cross-entropy within 35 % of initial_ce (ln(vocab); for
                gemma3's tied, sqrt(d)-scaled embedding 0.02 d_model,
                the logit a random model gives its input token), a
                finite grad norm
                above 0, flash launches per step
  train_restart the reference's examples/quickstart.py on the card: danube
                reduced (tiles of 32, through the flash kernels), its data
                shards and checkpoints through a size-fair 2-server burst
                buffer (Experiment.serve), 12 steps, a checkpoint every 4,
                a failure injected at step 6 under run_with_restarts: every
                loss after the restart equals an uninterrupted run's bit
                for bit; the BB servers' processed requests

The phases run in this order: device, build, kernels, engine, batch and
service alone, since each times a kernel or the engine's tick; then three
processes share the card until all are done.  This one runs
fused_vs_scan, card_vs_cpu, anchor, schedulers, schedulers_card_vs_cpu,
poisson and workspace; two more (the script with ``--plane NAME OUT``,
each ended with this one) run figures, scenarios, batch_plane,
calibrate, kern, micro and cli, and shard, fleet, fig7, fig9, fig13 and
fig14, and hand back their draws' launch counts and their lines.  The
host times these phases print are taken while the other processes run.
The serving phases follow, alone again, and the training phases last.

The script ends with one JSON line describing every kernel, the
``nvidia-smi`` line, and as the last line ``{"ok": true, "device":
{...}}``.  Any failure raises and
the script exits non-zero.  Without a CUDA card, or outside a checkout, it
exits 2 and prints no result.  It imports neither ``jax`` nor ``repro``.
"""
from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

#: Published H100 SXM peaks: HBM bytes/s, fp32 (non-tensor-core) op/s and
#: bf16 dense tensor-core op/s.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12
#: Dense TF32 tensor-core op/s (the SSD backward's chunk_bwd).
TF32_OPS_PER_S = 495e12
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


def launches_per_prefill(cfg, seq=None) -> dict:
    """Kernel launches one prefill of ``seq`` tokens makes on the card (by
    default one longer than ``block_q`` and MLA's dense limit):
    flash_attention per self-attention block past ``block_q`` (the shared
    block at each of its invocations, an attn_moe block's attention too) and
    per MLA block past ``MLA_DENSE_MAX`` (its heads folded into the batch),
    none for a cross block (dense attention over the vision tokens);
    mamba2_ssd per mamba block, wkv6 per rwkv block."""
    from repro_torch.models.attention import MLA_DENSE_MAX
    kinds = [k for rep, ks in cfg.pattern for _ in range(rep) for k in ks]
    blocked = seq is None or seq > cfg.block_q
    folded = seq is None or seq > MLA_DENSE_MAX
    return {"flash_attention": blocked * sum(
                k in ("attn", "local", "global", "shared_attn", "attn_moe")
                for k in kinds) + folded * kinds.count("mla"),
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
    """Patch the model modules' kernel wrappers (and the MoE FFN) so that
    the first call of each keeps a copy of its inputs in ``store[name]``
    (``args``, a list with its tensors cloned, and ``kw``); returns the
    undo."""
    import torch
    from repro_torch.models import attention, moe, rwkv, ssm
    saved = []

    def copy(a):
        return a.clone() if isinstance(a, torch.Tensor) else a

    for module, name in ((attention, "flash_attention"), (ssm, "mamba2_ssd"),
                         (ssm, "step_and_decay"), (rwkv, "wkv6"),
                         (moe, "moe_forward")):
        real = getattr(module, name)

        def wrapper(*args, _real=real, _name=name, **kw):
            if _name not in store:
                store[_name] = dict(args=[copy(a) for a in args],
                                    kw={k: copy(v) for k, v in kw.items()})
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


#: tanh of the gate every cross block gets before a serving check: the
#: reference initialises the gate to 0, and tanh(0) = 0 makes a fresh cross
#: block add nothing, so no check of it could fail.
CROSS_GATE = 0.5


def open_gates(params, cfg) -> int:
    """Set every cross block's gate to atanh(CROSS_GATE), in place; returns
    the number of cross layers."""
    import math
    import torch
    n = 0
    for si, (rep, kinds) in enumerate(cfg.pattern):
        for j, kind in enumerate(kinds):
            if kind == "cross":
                with torch.no_grad():    # the leaves may train
                    params[f"seg{si}"][f"blk{j}"]["gate"].fill_(
                        math.atanh(CROSS_GATE))
                n += rep
    return n


def ids_key(cfg) -> str:
    return "codes" if cfg.n_codebooks else "tokens"


def serve_prompt(cfg, batch, seq, device, seed):
    """A prompt of ``batch`` x ``seq`` on ``device``: (token ids [B, S], or
    musicgen's codes [B, S, nq]; the other inputs, i.e. llama-vision's
    vision stub).  Token ids are numpy integers from ``seed``; codes and the
    vision stub are drawn from ``seed`` by
    ``repro_torch.configs.inputs.random_batch`` on the CPU, so the card and
    the CPU get the same inputs."""
    import numpy as np
    import torch
    from repro_torch.configs.inputs import random_batch
    if not (cfg.n_codebooks or cfg.n_vision_tokens):
        ids = np.random.default_rng(seed).integers(0, cfg.vocab, (batch, seq))
        return torch.as_tensor(ids, dtype=torch.int32, device=device), {}
    drawn = random_batch(torch.Generator().manual_seed(seed), cfg, seq, batch,
                         with_labels=False)
    ids = drawn.pop(ids_key(cfg)).to(device)
    return ids, {k: v.to(device) for k, v in drawn.items()}


def greedy(cfg, logits):
    """The next input of a greedy decode step: [B, 1] token ids, or [B, 1,
    nq] codes (each codebook's own argmax)."""
    import torch
    return torch.argmax(logits[..., :cfg.vocab], dim=-1).to(torch.int32)


class RouteLog:
    """Within ``with``: every MoE routing, in call order (one per attn_moe
    block and forward), as (expert indices [T, k], the float32 scores
    [T, E] ``moe.route`` took their top-k of: the router's logits for
    mixtral's topk_softmax, their softmax for qwen3's softmax_topk)."""

    def __enter__(self):
        import torch
        from repro_torch.models import moe
        from repro_torch.models.layers import linear
        self.calls, self._real = [], moe.route

        def wrapper(params, cfg, x_flat):
            out = self._real(params, cfg, x_flat)
            scores = linear(params["router"], x_flat).float()
            if cfg.moe_router != "topk_softmax":
                scores = torch.softmax(scores, dim=-1)
            self.calls.append((out[1], scores))
            return out

        moe.route = wrapper
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe
        moe.route = self._real


def dropless(cfg):
    """``cfg`` with a capacity factor of E / k, so that every expert's
    buffer holds all T tokens of a prefill (capacity = T) and, like decode,
    it drops nothing; a config without experts unchanged."""
    import dataclasses
    if not cfg.n_experts:
        return cfg
    return dataclasses.replace(cfg,
                               moe_capacity_factor=cfg.n_experts / cfg.top_k)


def dropped(cfg, routes) -> int:
    """Assignments a prefill's MoE blocks dropped at capacity."""
    from repro_torch.models.moe import kept
    return sum(int((~kept(cfg, idx)).sum()) for idx, _ in routes)


def moe_excused(cfg, base_routes, pf_routes, dec_routes, batch,
                tol) -> dict:
    """{row: [why, ...]} for the rows a prefill of the prompt plus k tokens
    (``pf_routes``) and decode step k cannot agree on.  Decode (at most 32
    tokens) is dropless, and its cache holds what the prompt's prefill
    (``base_routes``) computed; ``dec_routes[j]`` is step j's routing.

    A row is excused, by name and count, where in some MoE block the longer
    prefill keeps one of its prompt tokens' assignments otherwise than the
    prompt's prefill or drops one of a generated token's (capacity moves
    with the stream), or routes a token to other experts than the path that
    filled the cache.  A routing flip before any such event in its row must
    be a near tie, as ``check_argmax`` holds swaps: the top-k margin of the
    cache path's scores under twice the largest score difference between
    the two paths, and that difference within ``tol``; otherwise this
    raises.  A flip after an event is its consequence."""
    import torch
    from repro_torch.models.moe import kept
    why: dict = {}
    k, n = len(dec_routes), cfg.top_k
    for layer, ((base, z_base), (idx, z_pf)) in enumerate(
            zip(base_routes, pf_routes)):
        seq = base.shape[0] // batch
        keep = kept(cfg, idx).reshape(batch, seq + k, -1).cpu()
        keep0 = kept(cfg, base).reshape(batch, seq, -1).cpu()
        # Each token's routing on the path that filled the decode cache.
        ref = torch.cat([base.reshape(batch, seq, -1)]
                        + [dec_routes[j][layer][0][:, None]
                           for j in range(k)], 1).cpu()
        z_ref = torch.cat([z_base.reshape(batch, seq, -1)]
                          + [dec_routes[j][layer][1][:, None]
                             for j in range(k)], 1).cpu()
        got = idx.reshape(batch, seq + k, -1).cpu()
        z_got = z_pf.reshape(batch, seq + k, -1).cpu()
        flips = (got.sort(-1).values != ref.sort(-1).values).any(-1)
        earlier = set(why)
        for b in range(batch):
            notes = []
            moved = int((keep[b, :seq] != keep0[b]).any(-1).sum())
            if moved:
                notes.append(f"{moved} prompt token(s) kept otherwise than "
                             f"in the prompt's prefill")
            for j in range(k):
                lost = int((~keep[b, seq + j]).sum())
                if lost:
                    notes.append(f"generated token {j} lost {lost} "
                                 f"assignment(s)")
            for t in torch.nonzero(flips[b]).flatten().tolist():
                top = torch.topk(z_ref[b, t], n + 1).values
                margin = float(top[n - 1] - top[n])
                gap = float((z_got[b, t] - z_ref[b, t]).abs().max())
                name, path = ((f"prompt token {t}", "the prompt's prefill")
                              if t < seq else
                              (f"generated token {t - seq}", "its decode step"))
                flip = (f"{name} routed to {sorted(got[b, t].tolist())}, "
                        f"{path} to {sorted(ref[b, t].tolist())} (top-{n} "
                        f"margin {margin:.3g}, score gap {gap:.3g})")
                if b not in earlier and not (gap <= tol and margin < 2 * gap):
                    raise AssertionError(
                        f"row {b} layer {layer}: {flip}: not a near tie "
                        f"(the margin must be under twice the gap, the gap "
                        f"within {tol})")
                notes.append(flip)
            if notes:
                why.setdefault(b, []).append(f"layer {layer}: "
                                             + ", ".join(notes))
    return why


def held_rows(tag, phase, excused, batch, what, require=True):
    """The rows a comparison holds: all but the excused, each of which is
    reported with its reasons.  Where it holds none, it raises unless
    ``require`` is off."""
    for b, why in sorted(excused.items()):
        say(phase, f"{tag}: row {b} excused from {what}: {'; '.join(why)}")
    rows = [b for b in range(batch) if b not in excused]
    if not rows:
        if require:
            raise AssertionError(f"{tag}: every row excused, {what} "
                                 f"compares nothing")
        say(phase, f"{tag}: every row excused, {what} compares nothing")
    return rows


def phase_serve(device, arch=SERVE_ARCH, *, tag="serve", reduced=False,
                seq=6000, steps=16, cut=None):
    """A serving path at full width (its depth cut by ``cut``, overrides of
    the config); returns (params, kernel launches in the phase by kernel,
    the inputs each kernel's first call got, metrics).  Every launch counter
    is zeroed before the path runs and read after.

    Prefill of the prompt plus k generated tokens must agree with k decode
    steps.  For the dense models the bf16 bounds are BF16_LOGIT_TOL.  For a
    model with a recurrent scan (zamba2, rwkv6), MoE blocks or MLA the same
    weights also run in float32 arithmetic, where the two paths must agree
    within F32_DEPTH_TOL: that holds the final state each scan hands to the
    decode cache, MLA's latent cache, whose decode runs in float32 against
    a bf16 prefill, and the MoE blocks' caches.  The bf16 paths of the scan
    and MLA models must then agree within BF16_LOGIT_TOL or within the bf16
    prefill's own distance from the float32 one, whichever is larger: at
    full depth these random models' bf16 rounding noise (RMS 0.22 for
    rwkv6, 0.64 for zamba2 against float32, on an H100) is far above the
    dense model's 0.02 that BF16_LOGIT_TOL was set for.

    An MoE prefill drops assignments at capacity where decode (at most 32
    tokens) is dropless.  The float32 run is therefore dropless (``dropless``:
    capacity = T, by ragged_sort, as dense_onehot's [T, E, T] tensors would
    take 74 GB for qwen3-moe) and must hold a row at each k.  The bf16 run
    keeps the config's capacity: a row the longer prefill keeps otherwise
    than the path that filled the decode cache is excused by name and count
    (``moe_excused``), and the bf16 check, under BF16_LOGIT_TOL (the dropless
    float32 run's distance from it is not rounding noise), may then hold
    none.  A routing flip is excused only as a near tie.  Each prefill's
    dropped assignments are counted.  Cross blocks get tanh(gate) =
    CROSS_GATE."""
    import copy
    import dataclasses
    import torch
    from repro_torch.models import model as M
    from repro_torch.serve.serve_step import make_decode_step, make_prefill_step
    cfg = serve_config(reduced, arch, **(cut or {}))
    kinds = {k for _, ks in cfg.pattern for k in ks}
    ops = kernel_ops()
    batch, check_ks = 2, tuple(sorted({1, min(8, steps)}))
    t0 = synced(device)
    params = M.init_params(cfg, seed=0, device=device)
    say(tag, f"{cfg.name} d={cfg.d_model} layers={cfg.layer_count()} "
        f"pattern={cfg.pattern} heads={cfg.n_heads}/{cfg.n_kv_heads}x"
        f"{cfg.head_dim} window={cfg.window} {cfg.param_dtype}: "
        f"{cfg.param_count() / 1e9:.3f} B params "
        f"({cfg.active_param_count() / 1e9:.3f} B active) initialised in "
        f"{synced(device) - t0:.1f} s")
    if open_gates(params, cfg):
        say(tag, f"every cross block's gate set to atanh({CROSS_GATE}) "
            f"(the fresh gate 0 would make cross-attention add nothing)")
    prompt, extra = serve_prompt(cfg, batch, seq, device, seed=0)
    key = ids_key(cfg)
    max_len = seq + steps
    prefill = make_prefill_step(cfg, max_len)
    decode = make_decode_step(cfg)
    per_prefill = launches_per_prefill(cfg, seq)
    has_scan = per_prefill["mamba2_ssd"] + per_prefill["wkv6"] > 0
    has_moe = "attn_moe" in kinds
    if torch.device(device).type != "cuda":
        per_prefill = dict.fromkeys(per_prefill, 0)
    layer0: dict = {}
    drops: dict = {}

    def run_prefill(tokens, step=prefill, weights=params, c=cfg):
        before = {name: op.LAUNCHES for name, op in ops.items()}
        passes = dict(ssd_ops.PASS_LAUNCHES)
        steps_before = ssd_ops.STEP_DECAY_LAUNCHES
        t = synced(device)
        with RouteLog() as routes:
            logits, caches = step(weights, {key: tokens, **extra})
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
        if has_moe:
            drops[(tokens.shape[1], weights is params)] = dropped(
                c, routes.calls)
        return logits, caches, wall, routes.calls

    def run_decode(weights, caches, step, n, first):
        """``n`` decode steps feeding gen[i]; (logits, routes) per step."""
        out = []
        for i in range(n):
            pos = torch.full((batch,), seq + i, dtype=torch.int32,
                             device=device)
            with RouteLog() as routes:
                logits, _, caches = step(weights, caches, {key: first(i)},
                                         pos)
            out.append((logits, routes.calls))
        return out

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
    logits, caches, prefill_s, base_routes = run_prefill(prompt)
    gen, step_logits, step_routes, step_s = [], [], [], []
    tok = greedy(cfg, logits)
    for i in range(steps):
        gen.append(tok)
        pos = torch.full((batch,), seq + i, dtype=torch.int32, device=device)
        t = synced(device)
        with RouteLog() as routes:
            logits, nxt, caches = decode(params, caches, {key: tok}, pos)
        step_s.append(synced(device) - t)
        if not torch.isfinite(logits).all():
            raise AssertionError(f"decode step {i} logits are not finite")
        step_logits.append(logits)
        step_routes.append(routes.calls)
        tok = greedy(cfg, logits)
    pf, pf_routes, excused = {}, {}, {}
    for k in check_ks:
        pf[k], _, _, pf_routes[k] = run_prefill(
            torch.cat([prompt] + gen[:k], dim=1))
    tol = {k: dict(BF16_LOGIT_TOL) for k in check_ks}
    n_prefills = 2 + len(check_ks)
    if has_scan or has_moe or "mla" in kinds:
        del caches
        cfg32 = dataclasses.replace(dropless(cfg), dtype="float32",
                                    param_dtype="float32")
        if has_moe:
            cfg32 = dataclasses.replace(cfg32, moe_dispatch="ragged_sort")
        params32 = copy.deepcopy(params).float()
        prefill32 = make_prefill_step(cfg32, max_len)
        _, caches32, _, base32 = run_prefill(prompt, prefill32, params32,
                                             cfg32)
        dec32 = run_decode(params32, caches32, make_decode_step(cfg32),
                           max(check_ks), gen.__getitem__)
        del caches32
        for k in check_ks:
            pf32, _, _, routes32 = run_prefill(
                torch.cat([prompt] + gen[:k], dim=1), prefill32, params32,
                cfg32)
            want32 = dec32[k - 1][0]
            rows = held_rows(f"float32 prefill + {k} vs decode step {k}",
                             tag, moe_excused(
                                 cfg32, base32, routes32,
                                 [r for _, r in dec32[:k]], batch,
                                 F32_DEPTH_TOL["max"]),
                             batch, "the float32 check")
            err, rms = logit_gap(pf32[rows], want32[rows])
            say(tag, f"float32 arithmetic: prefill of prompt + {k} "
                f"token(s) vs decode step {k}: max |logit diff| "
                f"{err:.4g}, RMS {rms:.4g} over rows {rows} (tolerance "
                f"{F32_DEPTH_TOL})")
            if err > F32_DEPTH_TOL["max"] or rms > F32_DEPTH_TOL["rms"]:
                raise AssertionError(f"float32 prefill+{k} vs decode: "
                                     f"logits beyond {F32_DEPTH_TOL}")
            noise_max, noise_rms = logit_gap(pf[k], pf32)
            if not has_moe:
                tol[k] = dict(rms=max(tol[k]["rms"], noise_rms),
                              max=max(tol[k]["max"], noise_max))
            say(tag, f"bf16 prefill of prompt + {k} vs float32: max "
                f"{noise_max:.4g}, RMS {noise_rms:.4g} ("
                f"{'at other capacities' if has_moe else 'the bf16 noise'})")
        if has_moe and any(d for (_, bf16), d in drops.items() if not bf16):
            raise AssertionError(f"the dropless float32 prefills dropped "
                                 f"{drops}")
        del params32, dec32
        n_prefills += 1 + len(check_ks)
    worst = 0.0
    for k in check_ks:
        want = step_logits[k - 1]
        excused[k] = moe_excused(cfg, base_routes, pf_routes[k],
                                 step_routes[:k], batch, tol[k]["max"])
        rows = held_rows(f"prefill + {k} vs decode step {k}", tag,
                         excused[k], batch, "the bf16 check",
                         require=not has_moe)
        if not rows:
            continue
        err, rms = logit_gap(pf[k][rows], want[rows])
        worst = max(worst, err)
        say(tag, f"prefill of prompt + {k} generated token(s) vs decode "
            f"step {k}: max |logit diff| {err:.4g}, RMS diff / RMS logit "
            f"{rms:.4g} over rows {rows} (tolerance {tol[k]})")
        if err > tol[k]["max"] or rms > tol[k]["rms"]:
            raise AssertionError(f"prefill+{k} vs decode: logits beyond "
                                 f"{tol[k]}")
        # A swap is excused only where this measured difference explains it.
        check_argmax(f"prefill+{k} vs decode", want[rows], pf[k][rows],
                     cfg.vocab, err, phase=tag)
    launches = {name: op.LAUNCHES for name, op in ops.items()}
    launches["step_decay"] = ssd_ops.STEP_DECAY_LAUNCHES
    decode_ms = sorted(step_s)[len(step_s) // 2] * 1e3
    metrics = dict(prefill_ms=prefill_s * 1e3,
                   prefill_tokens_per_s=batch * seq / prefill_s,
                   decode_ms_per_step=decode_ms,
                   decode_tokens_per_s=batch / (decode_ms / 1e3),
                   prefill_vs_decode_max_abs=worst,
                   excused_rows={k: sorted(v) for k, v in excused.items()})
    if has_moe:
        metrics["dropped"] = {f"{n} tokens{'' if bf16 else ' float32'}": d
                              for (n, bf16), d in drops.items()}
        say(tag, f"assignments dropped at capacity per prefill (of "
            f"{batch} x length x top_k {cfg.top_k} x "
            f"{sum(ks.count('attn_moe') * r for r, ks in cfg.pattern)} "
            f"layers): {metrics['dropped']}")
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


def phase_serve_engine(device, *, arch=SERVE_ARCH, tag="serve_engine",
                       reduced=False):
    """ServeEngine on the card (full width, random weights from seed 0) against the CPU (the arch's reduced config);
    returns (token_select launches, requests/s)."""
    from repro_torch.kernels import parity
    from repro_torch.kernels.token_select import ops as tk_ops
    from repro_torch.kernels.token_select.ref import token_select_ref
    from repro_torch.models import model as M
    cfg = serve_config(reduced, arch)
    params = M.init_params(cfg, seed=0, device=device)
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
    scale = kw.get("scale")
    lib = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, scale=scale), reps=reps)
    lib_err = float((F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                    scale=scale)
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



# -- the flash backward ----------------------------------------------------------

#: (B, Sq, Sk, H, Hk, D, window, causal): MHA and GQA, a window shorter than
#: S, ragged S (not a multiple of the 64-row or 32-row tiles), causal and
#: not, D = 16, 18 (staged by element), 64, 80, 96, 128 (qwen3, qwen3-moe,
#: mixtral and llama-vision; float32's 64-row tiles, bf16's 64-wide ones)
#: and 256 (float32's 32-row tiles; bf16's 32-wide tiles and two dK/dV
#: launches).  Every row has a live key, as in training.
FLASH_BWD_CASES = [
    (1, 200, 200, 4, 4, 16, 0, True),
    (2, 200, 200, 8, 2, 80, 64, True),
    (1, 130, 130, 4, 2, 96, 0, True),
    (1, 200, 200, 8, 2, 128, 0, True),
    (1, 170, 170, 8, 1, 128, 48, True),
    (1, 140, 140, 4, 4, 128, 0, False),
    (1, 200, 200, 4, 1, 256, 64, True),
    (1, 150, 150, 4, 2, 80, 0, False),
    (1, 100, 100, 4, 2, 16, 32, False),
    (2, 256, 256, 8, 2, 64, 0, True),
    (1, 200, 200, 8, 2, 18, 64, True),
    (1, 333, 333, 4, 2, 96, 100, True),
]
#: Each gradient's max abs error over its own max abs value.  float32: the
#: kernel against the plain version on the same inputs (the kernel's own
#: out, m and l), the two summing keys, queries and heads in other orders.
#: bf16: the kernel chain (forward with statistics, then backward) on bf16
#: inputs against the plain chain in float32 on the same values: out and
#: the gradients are rounded to bf16 (2^-9 relative) and p is recomputed
#: from the bf16 forward's m and l.
FLASH_BWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def flash_bwd_inputs(case, dtype, device, seed):
    """q, k, v and dout of a FLASH_BWD_CASES entry, normal from ``seed``."""
    import numpy as np
    import torch
    b, sq, sk, h, hk, d = case[:6]
    rng = np.random.default_rng(seed)
    return [torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32,
                            device=device).to(dtype)
            for shape in ((b, sq, h, d), (b, sk, hk, d), (b, sk, hk, d),
                          (b, sq, h, d))]


def flash_bwd_check(q, k, v, dout, kw, tag):
    """The backward kernel (after the forward with statistics) against the
    plain version; returns the worst of dq/dk/dv's max abs error over
    their max abs value."""
    import torch
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_bwd_ref, flash_attention_ref)
    out, m, l = fa_ops.flash_attention(q, k, v, return_stats=True, **kw)
    got = fa_ops.flash_attention_bwd(q, k, v, out, m, l, dout, **kw)
    if q.is_cuda:
        torch.cuda.synchronize()
    dtype = str(q.dtype).split(".")[-1]
    if q.dtype == torch.float32:
        want = flash_attention_bwd_ref(q, k, v, out, m, l, dout, **kw)
        o32, m32, l32 = flash_attention_ref(q, k, v, return_stats=True, **kw)
        for name, a, b in (("m", m, m32), ("l", l, l32)):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5,
                                       msg=lambda e: f"flash {tag} {name}: {e}")
    else:
        f32 = [t.float() for t in (q, k, v, dout)]
        o32, m32, l32 = flash_attention_ref(*f32[:3], return_stats=True, **kw)
        want = flash_attention_bwd_ref(*f32[:3], o32, m32, l32, f32[3], **kw)
    worst = 0.0
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        err = float((a.float() - b.float()).abs().max()
                    / b.float().abs().max().clamp_min(1e-30))
        if not err <= FLASH_BWD_TOL[dtype]:
            raise AssertionError(f"flash backward {tag}: {name} max abs err "
                                 f"{err:.3g} of its max, over "
                                 f"{FLASH_BWD_TOL[dtype]}")
        worst = max(worst, err)
    return worst


def phase_flash_bwd(device, layer0, *, cases=FLASH_BWD_CASES, reps=5):
    """The backward kernels against their plain version on FLASH_BWD_CASES,
    in float32 (the FMA kernels) and in bf16 (the tensor-core kernels,
    every staging path), and on the inputs layer 0 of the train phase gave
    them (bf16); then the time there beside the bound, the plain version's
    and scaled_dot_product_attention's backward (forward and backward
    minus forward).  Returns the record for the kernels line."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_bwd_ref
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for n, case in enumerate(cases):
            b, sq, sk, h, hk, d, win, causal = case
            q, k, v, dout = flash_bwd_inputs(case, dtype, device, seed=n)
            kw = dict(causal=causal, window=win)
            tag = (f"{str(dtype)[6:]} B={b} Sq={sq} Sk={sk} H={h} Hk={hk} "
                   f"D={d} window={win} causal={causal}")
            err = flash_bwd_check(q, k, v, dout, kw, tag)
            worst = max(worst, err)
            say("flash_bwd", f"{tag}: max abs err / max {err:.3g}")
    (q, k, v, out, m, l, dout), kw = layer0["args"], layer0["kw"]
    tag = "train layer 0"
    err = flash_bwd_check(q, k, v, dout, kw, tag)
    worst = max(worst, err)
    b, sq, h, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    say("flash_bwd", f"{tag} inputs {tuple(q.shape)} / {tuple(k.shape)} "
        f"{q.dtype} {kw}: max abs err / max {err:.3g}")
    ms = time_ms(lambda: fa_ops.flash_attention_bwd(q, k, v, out, m, l, dout,
                                                    **kw), reps=reps)
    plain = time_ms(lambda: flash_attention_bwd_ref(q, k, v, out, m, l, dout,
                                                    **kw), reps=2)
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_(True)
                  for t in (q, k, v))
    gt = dout.transpose(1, 2).contiguous()
    mask = {"is_causal": True}
    if kw["window"] and kw["window"] < sk:     # a window inside S: a mask
        rel = (torch.arange(sq, device=q.device)[:, None]
               - torch.arange(sk, device=q.device)[None, :])
        mask = {"attn_mask": (rel >= 0) & (rel < kw["window"])}

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, **mask,
                                              scale=kw.get("scale"),
                                              enable_gqa=True)

    def sdpa_both():
        sdpa().backward(gt)

    with torch.no_grad():
        fwd = time_ms(sdpa, reps=reps)
    both = time_ms(sdpa_both, reps=reps)
    lib = both - fwd
    pairs = live_pairs(sq, sk, kw["causal"], kw["window"], 0)
    es = q.element_size()
    nbytes = ((4 * q.numel() + 4 * k.numel()) * es + 2 * m.numel() * 4)
    ops, exps = 10 * d * pairs * b * h, pairs * b * h
    bound, by, pipe = pipe_bound(nbytes, ops, exps, BF16_OPS_PER_S
                                 if q.dtype == torch.bfloat16
                                 else FP32_OPS_PER_S,
                                 "tensor cores" if q.dtype == torch.bfloat16
                                 else "FMA")
    say("flash_bwd", f"B={b} S={sq} H={h} Hk={hk} D={d} {q.dtype}: kernel "
        f"{ms:.3f} ms, bound {bound:.4f} ms ({by}, {pipe}: "
        f"{ops / 1e9:.1f} GFLOP, {exps / 1e9:.3f} G exponentials over "
        f"{pairs} live pairs per head, {nbytes / 1e6:.1f} MB), plain "
        f"{plain:.3f} ms, scaled_dot_product_attention backward {lib:.3f} "
        f"ms (forward and backward {both:.3f}, forward {fwd:.3f}); kernel / "
        f"bound {ms / bound:.1f}, kernel / library {ms / lib:.2f}")
    return dict(ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by,
                bound_pipe=pipe, library_ms=lib, max_abs_err=worst)


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
#: dt_bias, softplus (an exp of 33 operations as XLA expands it, one branch
#: of log1p: 33 near 0, 31 by log(1 + x); 33 counted, and 3 more), the
#: decay's negation and product and its exp of 33.  The exp(a_log) of each
#: column is not counted per element.
STEP_DECAY_OPS = 104
#: step_decay_bwd's float32 operations and exponentials per element: the
#: decay's product (2), the add of dt_bias, the sigmoid (a negation, an
#: exponential, an add and a division), the product with the summed
#: gradient (2), the two column sums' adds and the g_step dt product.
STEP_DECAY_BWD_OPS = 12


def step_decay_inputs(device, seed):
    """(dt_raw, dt_bias, a_log) cases beside the serve phase's: a float32
    strided view of a projection with edge values (zeros of both signs,
    subnormals, exp's clamp points, the log1p branch point, +-inf, large
    magnitudes) among normal ones, the same one column on (a view the
    kernel reads by element), and a decode step's [B, H]."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    edges = np.array([0.0, -0.0, 1e-40, -1e-40, 0.8813736, -0.8813736,
                      87.8, 88.8, 88.9, -87.8, -88.8, -104.0, 100.0, 1e30,
                      -1e30, np.inf, -np.inf, 20.0, -20.0, 1e-7, -1e-7],
                     dtype=np.float32)
    proj = rng.normal(0.0, 4.0, (2, 600, 201)).astype(np.float32)
    flat = proj[..., 120:200].reshape(-1)
    flat[:edges.size] = edges
    proj[..., 120:200] = flat.reshape(2, 600, 80)
    a_log = rng.uniform(-3.0, 3.0, 80).astype(np.float32)
    a_log[:3] = (0.0, 1e-40, -20.0)
    bias = rng.normal(0.0, 1.0, 80).astype(np.float32)
    t = lambda a: torch.from_numpy(a).to(device)   # noqa: E731
    return [("float32 [2, 600, 80] view, edge values",
             (t(proj)[..., 120:200], t(bias), t(a_log))),
            ("float32 [2, 600, 80] view one column on, by element",
             (t(proj)[..., 121:201], t(bias), t(a_log))),
            ("float32 [2, 80] (a decode step)",
             (t(proj[:, 7, :80].copy()), t(bias), t(a_log)))]


def step_decay_sweep(phase="step_decay") -> dict:
    """The step_decay kernel's exhaustive sweep on the card: all 2^32
    float32 inputs through exp, log1p and softplus as the first version
    took them (each multiply-add a float64 product and sum, both branches
    of log1p) and as the kernel takes them (float32 multiply-adds; log1p on
    the arguments softplus gives it: +0, normal floats up to 1, NaN).
    Fails unless no input's bits differ for any function.  Returns the
    counts and the sweep's seconds."""
    import torch
    from repro_torch.kernels.mamba2 import ops as ssd_ops
    ssd_ops.step_decay_sweep()                       # warm: first launch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = ssd_ops.step_decay_sweep()
    seconds = time.perf_counter() - t0
    say(phase, f"sweep of all 2^32 float32 inputs in {seconds:.3f} s: "
        "inputs whose bits differ from the first version's: " + ", ".join(
            f"{fn} {n}" + (f" (first 0x{lo:08x})" if n else "")
            for fn, (n, lo) in got.items()))
    bad = {fn: v for fn, v in got.items() if v[0]}
    if bad:
        raise AssertionError(f"step_decay: {bad} differ from the first "
                             "version on some input")
    return dict(seconds=seconds, counts={fn: n for fn, (n, _) in
                                         got.items()})


def phase_step_decay(device, layer0, *, reps=50):
    """The step_decay kernel against its plain version on the same card
    tensors and on the CPU, bit for bit (tolerance 0), on the inputs layer 0
    of serve_zamba2 gave it and on ``step_decay_inputs`` (dt_raw in float32
    and bf16); the exhaustive sweep (on the card); then its time at the
    serving shape beside its bound, the plain version's and one launch of a
    one-element add_ (the fixed cost of a launch under this timing).
    Returns its record for the kernels line."""
    import torch
    from repro_torch.kernels.mamba2 import ops as ssd_ops
    from repro_torch.kernels.mamba2.ref import step_and_decay_ref
    serve_args = tuple(layer0["args"])
    cases = [(f"serve layer 0 {serve_args[0].dtype} "
              f"{tuple(serve_args[0].shape)}", serve_args)]
    cases += step_decay_inputs(device, seed=0)
    cases += [(f"{tag}, dt_raw bf16", (raw.to(torch.bfloat16), bias, a_log))
              for tag, (raw, bias, a_log) in step_decay_inputs(device,
                                                               seed=3)]
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
        say("step_decay", f"{tag}: dt and a equal the plain version's on "
            "the card and on the CPU bit for bit (tolerance 0)")
    # The sweep is a kernel of the card's build: a CPU rehearsal skips it.
    sweep = (step_decay_sweep() if torch.device(device).type == "cuda"
             else None)
    x = serve_args[0]
    n = x.numel()
    one = torch.zeros(1, device=device)
    ms = time_ms(lambda: ssd_ops.step_and_decay(*serve_args), reps=reps)
    empty = time_ms(lambda: one.add_(1), reps=reps)
    plain = time_ms(lambda: step_and_decay_ref(*serve_args), reps=10)
    nbytes = n * (x.element_size() + 8) + 8 * x.shape[-1]
    bound, by = bound_ms(nbytes, n * STEP_DECAY_OPS)
    say("step_decay", f"{tuple(x.shape)} {x.dtype}: kernel {ms * 1e3:.2f} "
        f"us, one launch of a one-element add_ {empty * 1e3:.2f} us, bound "
        f"{bound * 1e3:.3f} us ({by}: {nbytes / 1e6:.2f} MB, "
        f"{n * STEP_DECAY_OPS / 1e6:.0f} M fp32 operations), plain "
        f"{plain:.3f} ms; no one PyTorch call computes this function")
    return dict(ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by,
                library_ms=None, max_abs_err=worst, empty_launch_ms=empty,
                sweep=sweep)


#: (B, S, H, P, N, chunk, b/c dtype, h0, decay, views) of the SSD backward's
#: card checks: MAMBA2_CASES' geometry (the reduced and full widths, chunk
#: 32, 64 and 128, bf16 b/c, an initial state, strong decay, strided b/c
#: views), a chunk of 16, P and N not multiples of 4 (padded by
#: kernel_layout), chunk 24 with P = 984 and N = 4 (P in sixteen slices),
#: a chunk of 20 with P = 20, N = 12 (tiles of 16 x 8 cut at every edge),
#: and the large build (ops.bwd_layout's "build" 1: sum_h M2 in
#: registers) in each of its layouts: chunk 220 with M1^T formed from the
#: Gram, chunk 164 in bf16 and 84 with N = 180 (more 16 x 32 units than
#: the small build holds) with M1^T stored, chunk 180 in float32 and 196
#: in bf16 with unpadded rows; 80 heads, so its blocks take two heads each.
SSD_BWD_CASES = MAMBA2_CASES + [
    (2, 64, 4, 16, 16, 16, "float32", True, "normal", False),
    (1, 128, 3, 18, 30, 32, "bfloat16", True, "strong", True),
    (1, 48, 2, 984, 4, 24, "float32", False, "normal", False),
    (1, 120, 3, 20, 12, 20, "float32", True, "strong", False),
    (1, 440, 80, 4, 4, 220, "float32", True, "strong", False),
    (1, 328, 80, 4, 44, 164, "bfloat16", True, "normal", False),
    (1, 168, 80, 4, 180, 84, "float32", False, "normal", False),
    (1, 360, 80, 4, 12, 180, "float32", True, "normal", False),
    (1, 392, 80, 4, 4, 196, "bfloat16", False, "strong", False),
]
#: Each gradient of the backward kernels against the plain version: max abs
#: error over the gradient's max.  da is compared as da * max(a, 1e-20),
#: the log decay's gradient: 1/a multiplies dla's float32 rounding by up to
#: 1e20 near the clamp.  A bf16 db or dc may land one bf16 step (2^-7
#: of the element) apart, since both sides round their float32 sums once.
SSD_BWD_TOL = 1e-4
BF16_ULP = 2.0 ** -7


def ssd_bwd_inputs(case, device, seed):
    """(args, kw) of an SSD_BWD_CASES entry: (x, a, b, c, dy, dhf), dy and
    dhf normal from ``seed``, and (chunk, cum, h_in), the scratch of the
    forward (``mamba2_ssd(keep=True)``, from the case's h0) that the
    backward reads."""
    import numpy as np
    import torch
    from repro_torch.kernels.mamba2 import ops as ssd_ops
    x, a, b, c, h0 = mamba2_inputs(case, device, seed)
    rng = np.random.default_rng(seed + 1000)
    t = lambda v: torch.as_tensor(v.astype(np.float32), device=device)  # noqa
    dy = t(rng.standard_normal(tuple(x.shape)))
    dhf = t(rng.standard_normal((x.shape[0], x.shape[2], x.shape[3],
                                 b.shape[-1])))
    _, _, cum, h_in = ssd_ops.mamba2_ssd(x, a, b, c, chunk=case[5], h0=h0,
                                         keep=True)
    return (x, a, b, c, dy, dhf), dict(chunk=case[5], cum=cum, h_in=h_in)


def grads_held(tag, names, got, want, scale=None) -> float:
    """Each gradient of ``got`` within SSD_BWD_TOL of its max in ``want``
    where ``want`` is finite (a bf16 one one bf16 step apart at most),
    non-finite where ``want`` is; ``scale`` {name: tensor} multiplies both
    sides first.  Returns the worst error over its gradient's max."""
    import torch
    worst = 0.0
    for name, g, w in zip(names, got, want):
        if g.dtype != w.dtype or g.shape != w.shape:
            raise AssertionError(f"{tag} {name}: {g.dtype} {tuple(g.shape)}"
                                 f" against {w.dtype} {tuple(w.shape)}")
        g32, w32 = g.float(), w.float()
        if scale and name in scale:
            g32, w32 = g32 * scale[name], w32 * scale[name]
        finite = torch.isfinite(w32)
        if not torch.equal(finite, torch.isfinite(g32)):
            raise AssertionError(f"{tag} {name}: finite at other elements "
                                 "than the plain version")
        if not bool(finite.any()):
            continue
        g32, w32 = g32[finite], w32[finite]
        top = float(w32.abs().max().clamp_min(1e-30))
        diff = (g32 - w32).abs()
        bound = SSD_BWD_TOL * top + (BF16_ULP * w32.abs()
                                     if g.dtype == torch.bfloat16 else 0.0)
        if not bool((diff <= bound).all()):
            raise AssertionError(f"{tag} {name}: error {float(diff.max())} "
                                 f"over the bound (max {top})")
        worst = max(worst, float(diff.max()) / top)
    return worst


def ssd_bwd_held(got, want, a, tag) -> float:
    """(dx, da, db, dc, dh0) held by grads_held, da as da * max(a,
    1e-20)."""
    import torch
    return grads_held(tag, ("dx", "da", "db", "dc", "dh0"), got, want,
                      {"da": torch.clamp_min(a.float(), 1e-20)})


def same_bits(got, again) -> bool:
    """Two runs' outputs equal bit for bit (NaNs included)."""
    import torch
    return all(torch.equal(u.view(torch.int16 if u.element_size() == 2
                                  else torch.int32),
                           v.view(torch.int16 if v.element_size() == 2
                                  else torch.int32))
               for u, v in zip(got, again))


def ssd_bwd_check(args, kw, tag, phase) -> float:
    """The SSD backward kernels against their plain version on the same
    card tensors (ssd_bwd_held), and a second run bit for bit equal (no
    atomics); then, where P and N are multiples of 4, each pass against its
    plain version on the plain outputs of the passes before it.  Returns
    the worst error."""
    import torch
    from repro_torch.kernels.mamba2 import ops as ssd_ops
    from repro_torch.kernels.mamba2 import ref as ssd_ref
    x, a, b, c, dy, dhf = args
    got = ssd_ops.mamba2_ssd_bwd(*args, **kw)
    again = ssd_ops.mamba2_ssd_bwd(*args, **kw)
    torch.cuda.synchronize()
    if not same_bits(got, again):
        raise AssertionError(f"mamba2_ssd_bwd {tag}: two runs differ")
    want = ssd_ref.mamba2_ssd_bwd_ref(*args, **kw)
    worst = ssd_bwd_held(got, want, a, f"mamba2_ssd_bwd {tag}")
    passes = 0.0
    if x.shape[-1] % 4 == 0 and b.shape[-1] % 4 == 0:
        chunk, cum, h_in = kw["chunk"], kw["cum"], kw["h_in"]
        q = ssd_ref.chunk_dstate_ref(dy, c, cum, chunk=chunk)
        got_q = ssd_ops.chunk_dstate(dy, c, cum, chunk=chunk)
        r, dh0 = ssd_ref.state_pass_bwd_ref(q.clone(), cum, dhf=dhf)
        got_r, got_dh0 = ssd_ops.state_pass_bwd(q.clone(), cum, dhf=dhf)
        passes = grads_held(f"passes {tag}", ("chunk_dstate q",
                                              "state_pass_bwd r",
                                              "state_pass_bwd dh0"),
                            (got_q, got_r, got_dh0), (q, r, dh0))
        want = ssd_ref.chunk_bwd_ref(x, a, b, c, dy, cum, h_in, r,
                                     chunk=chunk)
        got = ssd_ops.chunk_bwd(x, a, b, c, dy, cum, h_in, r, chunk=chunk)
        passes = max(passes, ssd_bwd_held(tuple(got) + (dh0,),
                                          tuple(want) + (dh0,), a,
                                          f"chunk_bwd {tag}"))
    say(phase, f"{tag}: max error over each gradient's max {worst:.3g}, "
        f"passes {passes:.3g} (tolerance {SSD_BWD_TOL:g}; bf16 one step "
        "apart); a second run equal bit for bit")
    return max(worst, passes)


def ssd_bwd_layout_held(x, b, chunk, tag) -> dict:
    """chunk_bwd's shared-memory layout at this geometry as the kernel
    chooses it (mamba2_chunk_bwd_smem) = the wrapper's mirror
    (ops.bwd_layout), in the kernel's layout of P and N (multiples of 4).
    Returns the layout."""
    import ctypes
    import torch
    from repro_torch.kernels.mamba2 import ops as ssd_ops
    p, n = -(-x.shape[-1] // 4) * 4, -(-b.shape[-1] // 4) * 4
    want = ssd_ops.bwd_layout(chunk, p, n, b.element_size())
    if torch.device(x.device).type != "cuda":
        return want
    out = (ctypes.c_int * 4)()
    with torch.cuda.device(x.device):
        got = ssd_ops._ask("chunk_bwd_smem", p, n, chunk,
                           int(b.dtype == torch.bfloat16), out)
    if (got, out[0], out[1], bool(out[2]), out[3]) != (
            want["bytes"], want["ps"], want["pad"], want["m1"],
            want["build"]):
        raise AssertionError(f"chunk_bwd layout {tag}: kernel {got} B, "
                             f"slice {out[0]}, pad {out[1]}, M1^T {out[2]}, "
                             f"build {out[3]}; mirror {want}")
    return want


def mamba2_bwd_split_ops(x, b, chunk, groups):
    """TF32 operations chunk_bwd's split-TF32 products take on these inputs
    (two per multiply-add of each pass, on its 16 x 8 tiles): per (b, h,
    chunk) M1^T dy and D = dy x^T over the lower tiles (3 passes each), B R
    (2 with bf16 b, else 3), (w x) R^T and dy S^T (3 each); per (b, chunk)
    and each of ``groups`` groups of heads the Gram (1 or 3) and sum_h M2
    B, (sum_h M2)^T C (2 or 3 each)."""
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    lp, np_, pp = -(-chunk // 16) * 16, -(-n // 8) * 8, -(-p // 8) * 8
    nb, nc = lp // 16, s // chunk
    bf = b.element_size() == 2
    lower = 128 * nb * (nb + 1)               # elements of the lower tiles
    # M1^T dy: band tj's 16 rows take k from 16 tj up.
    m1dy = sum(16 * (lp - 16 * tj) for tj in range(nb)) * pp
    per_head = (3 * m1dy + 3 * lower * pp + (2 if bf else 3) * lp * np_ * pp
                + 3 * 2 * lp * pp * np_)
    per_group = ((1 if bf else 3) * lower * np_
                 + 2 * (2 if bf else 3) * lower * np_)
    return 2 * bsz * nc * (h * per_head + groups * per_group)


def mamba2_bwd_work(x, b, chunk):
    """(bytes, fp32 operations, exponentials) the SSD backward needs on
    these inputs: x, a, b, c, dy and dh_final read and dx, da, db, dc and
    dh0 written once; per (b, h, chunk) the states entering the chunks
    (their own states' product), the products over the lower triangle
    (dy . x, and those giving dx, dC and dB: over P twice and N twice),
    the state terms (R B, S^T dy, R^T x and the chunk's dy (x) C: L P N
    each), the C . B^T Gram once per (b, chunk), and an exponential per
    lower pair and 2 per step."""
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    nc, tri = s // chunk, chunk * (chunk + 1) // 2
    nbytes = (3 * x.numel() * 4 + 2 * bsz * s * h * 4
              + 4 * bsz * s * n * b.element_size() + 2 * bsz * h * p * n * 4)
    fma = bsz * nc * (h * (tri * (2 * p + 2 * n) + 5 * chunk * p * n)
                      + tri * n)
    exps = bsz * nc * h * (tri + 2 * chunk)
    return nbytes, 2 * fma, exps


def phase_ssd_bwd(device, layer0, *, cases=SSD_BWD_CASES, reps=5):
    """The SSD backward kernels against their plain version over
    SSD_BWD_CASES and on the inputs layer 0 of train_zamba2 gave them (with
    the forward's scratch, as the autograd Function passes it); then the
    time there beside the bound, the plain version's, and each pass's.
    Returns the record for the kernels line."""
    from repro_torch.kernels.mamba2 import ops as ssd_ops
    from repro_torch.kernels.mamba2.ref import mamba2_ssd_bwd_ref
    worst = 0.0
    for n, case in enumerate(cases):
        args, kw = ssd_bwd_inputs(case, device, seed=n)
        tag = ("B={} S={} H={} P={} N={} chunk={} b/c {} h0={} decay={} "
               "views={}".format(*case))
        worst = max(worst, ssd_bwd_check(args, kw, tag, "ssd_bwd"))
        ssd_bwd_layout_held(args[0], args[2], case[5], tag)
    args, kw = layer0["args"], layer0["kw"]
    x, a, b, c, dy, dhf = args
    tag = (f"train layer 0 inputs x {tuple(x.shape)} b/c {b.dtype} chunk "
           f"{kw['chunk']}, the forward's scratch")
    worst = max(worst, ssd_bwd_check(args, kw, tag, "ssd_bwd"))
    chunk, cum, h_in = kw["chunk"], kw["cum"], kw["h_in"]
    layout = ssd_bwd_layout_held(x, b, chunk, tag)
    ms = time_ms(lambda: ssd_ops.mamba2_ssd_bwd(*args, **kw), reps=reps)
    plain = time_ms(lambda: mamba2_ssd_bwd_ref(*args, **kw), reps=2)
    q = ssd_ops.chunk_dstate(dy, c, cum, chunk=chunk)
    passes = {
        "chunk_dstate": time_ms(lambda: ssd_ops.chunk_dstate(
            dy, c, cum, chunk=chunk), reps=reps),
        "state_pass_bwd": time_ms(lambda: ssd_ops.state_pass_bwd(
            q, cum, dhf=dhf), reps=reps),
        "chunk_bwd + sum_groups": time_ms(lambda: ssd_ops.chunk_bwd(
            x, a, b, c, dy, cum, h_in, q, chunk=chunk), reps=reps)}
    work = mamba2_bwd_work(x, b, chunk)
    bound, by, pipe = pipe_bound(*work, ops_per_s=TF32_OPS_PER_S,
                                 ops_pipe="TF32 tensor")
    fma_bound, _, _ = pipe_bound(*work)
    nbytes, ops, exps = work
    import torch
    split = None  # the kernel's own count: its head groups are the card's
    if torch.device(x.device).type == "cuda":
        with torch.cuda.device(x.device):
            hpb = ssd_ops._ask("chunk_bwd_heads", x.shape[0], x.shape[1],
                               x.shape[2], chunk)
        split = mamba2_bwd_split_ops(x, b, chunk, -(-x.shape[2] // hpb))
    say("ssd_bwd", f"{tag}: device ms per pass " + ", ".join(
        f"{k} {v:.3f}" for k, v in passes.items()))
    say("ssd_bwd", f"{tag}: kernels {ms:.3f} ms, bound {bound:.4f} ms "
        f"({by}, {pipe}: {nbytes / 1e6:.1f} MB, {ops / 1e9:.2f} GFLOP, "
        f"{exps / 1e9:.3f} G exponentials; on the FMA pipes "
        f"{fma_bound:.4f} ms), plain {plain:.3f} ms; kernels / bound "
        f"{ms / bound:.1f}; no PyTorch call computes this function")
    if split is not None:
        say("ssd_bwd", f"{tag}: chunk_bwd's split TF32 takes "
            f"{split / 1e9:.1f} GFLOP of TF32 "
            f"({split / TF32_OPS_PER_S * 1e3:.4f} ms at "
            f"{TF32_OPS_PER_S / 1e12:.0f} TFLOP/s)")
    say("ssd_bwd", f"{tag}: layout: P slices of {layout['ps']}, rows padded "
        f"by {layout['pad']}, M1^T "
        f"{'stored' if layout['m1'] else 'formed from the Gram'}, "
        f"{layout['bytes']} B of shared memory, the "
        f"{('small', 'large')[layout['build']]} build")
    return dict(ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by,
                bound_pipe=pipe, library_ms=None, max_abs_err=worst,
                pass_ms=passes, fma_bound_ms=fma_bound,
                split_tf32_gflop=None if split is None else split / 1e9)


STEP_DECAY_GRADS = ("g_dt_raw", "g_dt_bias", "g_a_log")


def phase_step_decay_bwd(device, layer0, *, reps=50):
    """The step_decay backward kernel against its plain version on the
    inputs layer 0 of train_zamba2 gave it and on ``step_decay_inputs``
    (normal output gradients from a seed): within SSD_BWD_TOL, a second
    run equal bit for bit; then its time at the training shape beside its
    bound and the plain version's.  Returns the record for the kernels
    line."""
    import torch
    from repro_torch.kernels.mamba2 import ops as ssd_ops
    from repro_torch.kernels.mamba2.ref import (step_and_decay_bwd_ref,
                                                step_and_decay_ref)
    train_args = tuple(layer0["args"])
    cases = [(f"train layer 0 dt_raw {train_args[2].dtype} "
              f"{tuple(train_args[2].shape)}", train_args)]
    gen = torch.Generator().manual_seed(5)
    for tag, (raw, bias, a_log) in step_decay_inputs(device, seed=0):
        dt, a = step_and_decay_ref(raw, bias, a_log)
        g_dt, g_a = (torch.randn(dt.shape, generator=gen).to(device)
                     for _ in range(2))
        cases.append((tag, (g_dt, g_a, raw, bias, a_log, dt, a)))
    worst = 0.0
    for tag, args in cases:
        got = ssd_ops.step_and_decay_bwd(*args)
        again = ssd_ops.step_and_decay_bwd(*args)
        if not same_bits(got, again):
            raise AssertionError(f"step_decay_bwd {tag}: two runs differ")
        err = grads_held(f"step_decay_bwd {tag}", STEP_DECAY_GRADS, got,
                         step_and_decay_bwd_ref(*args))
        worst = max(worst, err)
        say("step_decay_bwd", f"{tag}: max error over each gradient's max "
            f"{err:.3g} (tolerance {SSD_BWD_TOL:g}); a second run equal bit "
            "for bit")
    raw = train_args[2]
    n = raw.numel()
    ms = time_ms(lambda: ssd_ops.step_and_decay_bwd(*train_args), reps=reps)
    plain = time_ms(lambda: step_and_decay_bwd_ref(*train_args), reps=10)
    nbytes = n * (16 + 2 * raw.element_size()) + 16 * raw.shape[-1]
    bound, by, pipe = pipe_bound(nbytes, n * STEP_DECAY_BWD_OPS, n)
    say("step_decay_bwd", f"{tuple(raw.shape)} {raw.dtype}: kernel "
        f"{ms * 1e3:.2f} us, bound {bound * 1e3:.3f} us ({by}, {pipe}: "
        f"{nbytes / 1e6:.2f} MB), plain {plain * 1e3:.1f} us; no one "
        "PyTorch call computes this function")
    return dict(ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by,
                bound_pipe=pipe, library_ms=None, max_abs_err=worst)


#: (B, S, H, K, chunk, r/k/v dtype, s0, dsf, decay, tail): chunk 16, 32, 64
#: and 192, and 20 (the last 16-row block of the chunk cut at 4 rows); K 16,
#: 32, 64 and 128, 44 in float32 (the last 8-channel tile cut at 4; 60:
#: padded to the bf16 quantum by the wrapper); float32 and bf16 r, k, v;
#: with and without s0 and the final state's gradient; lw down to -20 per
#: step ("strong"); a tail of 13 steps with r = k = v = lw = 0 and dy = 0,
#: as rwkv6_timemix pads a sequence to the chunk.  chunk_bwd's layouts
#: (ops.bwd_layout): two blocks an SM at K = 64 in bf16 (S read from
#: device memory) and at K = 128, chunk 32 in float32 (dS' and S); one
#: block with all three staged at K = 64 in float32; chunk 192 with K = 16
#: reads dy from device memory.
WKV6_BWD_CASES = [
    (2, 128, 3, 32, 16, "float32", True, True, "normal", False),
    (2, 256, 4, 32, 32, "bfloat16", False, False, "normal", False),
    (1, 256, 4, 64, 64, "float32", True, True, "strong", False),
    (2, 320, 8, 64, 64, "bfloat16", False, True, "normal", True),
    (1, 256, 4, 64, 32, "bfloat16", True, False, "strong", False),
    (1, 128, 2, 128, 64, "bfloat16", True, True, "normal", False),
    (1, 128, 2, 128, 32, "float32", False, True, "strong", False),
    (1, 384, 2, 16, 192, "float32", True, True, "normal", False),
    (1, 128, 2, 60, 32, "bfloat16", True, True, "normal", True),
    (2, 160, 3, 44, 20, "float32", True, True, "strong", True),
]
#: The WKV backward's gradients, in wkv6_bwd's order.
WKV6_GRADS = ("dr", "dk", "dv", "dlw", "du", "ds0")
#: The last steps of a "tail" case that are padding.
WKV6_TAIL = 13


def wkv6_bwd_inputs(case, device, seed):
    """(args, kw) of a WKV6_BWD_CASES entry: (r, k, v, lw, u, dy, dsf), dy
    and dsf (None where the case has none) normal from ``seed``, and
    (chunk, cwl, s_in, sf), the scratch and final state of the forward
    (``wkv6(keep=True)``, from the case's s0) that the backward reads."""
    import numpy as np
    import torch
    from repro_torch.kernels.rwkv6 import ops as wkv_ops
    bsz, s, h, kd, chunk, dtype, with_s0, with_dsf, decay, tail = case
    r, k, v, lw, u, s0 = wkv6_inputs(
        (bsz, s, h, kd, chunk, dtype, with_s0, decay), device, seed)
    rng = np.random.default_rng(seed + 1000)
    t = lambda a: torch.as_tensor(a.astype(np.float32), device=device)  # noqa
    dy = t(rng.standard_normal((bsz, s, h, kd)))
    dsf = t(rng.standard_normal((bsz, h, kd, kd))) if with_dsf else None
    if tail:
        for x in (r, k, v, lw, dy):
            x[:, -WKV6_TAIL:] = 0
    _, sf, cwl, s_in = wkv_ops.wkv6(r, k, v, lw, u, chunk=chunk, s0=s0,
                                    keep=True)
    return (r, k, v, lw, u, dy, dsf), dict(chunk=chunk, cwl=cwl, s_in=s_in,
                                           sf=sf)


def wkv6_bwd_check(args, kw, tag, phase) -> float:
    """The WKV backward kernels against their plain version on the same
    card tensors (grads_held: each gradient within SSD_BWD_TOL of its max,
    a bf16 one one bf16 step apart at most), and a second run bit for bit
    equal (no atomics); then, where K needs no padding, each pass against
    its plain version on the plain outputs of the passes before it.
    Returns the worst error."""
    import torch
    from repro_torch.kernels.rwkv6 import ops as wkv_ops
    from repro_torch.kernels.rwkv6 import ref as wkv_ref
    r, k, v, lw, u, dy, dsf = args
    got = wkv_ops.wkv6_bwd(*args, **kw)
    again = wkv_ops.wkv6_bwd(*args, **kw)
    torch.cuda.synchronize()
    if not same_bits(got, again):
        raise AssertionError(f"wkv6_bwd {tag}: two runs differ")
    want = wkv_ref.wkv6_bwd_ref(*args, **kw)
    worst = grads_held(f"wkv6_bwd {tag}", WKV6_GRADS, got, want)
    passes = 0.0
    if r.shape[-1] % (16 // r.element_size()) == 0:
        chunk, cwl, s_in, sf = kw["chunk"], kw["cwl"], kw["s_in"], kw["sf"]
        q = wkv_ref.chunk_dstate_ref(r, dy, lw, chunk=chunk)
        got_q = wkv_ops.chunk_dstate(r, dy, lw, chunk=chunk)
        ds, ds0 = wkv_ref.state_pass_bwd_ref(q.clone(), cwl, dsf=dsf)
        got_ds, got_ds0 = wkv_ops.state_pass_bwd(q.clone(), cwl, dsf=dsf)
        passes = grads_held(f"passes {tag}", ("chunk_dstate q",
                                              "state_pass_bwd dS'",
                                              "state_pass_bwd ds0"),
                            (got_q, got_ds, got_ds0), (q, ds, ds0))
        want = wkv_ref.chunk_bwd_ref(r, k, v, lw, u, dy, s_in, sf, ds,
                                     chunk=chunk)
        got = wkv_ops.chunk_bwd(r, k, v, lw, u, dy, s_in, sf, ds,
                                chunk=chunk)
        passes = max(passes, grads_held(f"chunk_bwd {tag}", WKV6_GRADS[:5],
                                        got, want))
    say(phase, f"{tag}: max error over each gradient's max {worst:.3g}, "
        f"passes {passes:.3g} (tolerance {SSD_BWD_TOL:g}; bf16 one step "
        "apart); a second run equal bit for bit")
    return max(worst, passes)


def wkv6_bwd_layout_held(r, chunk, tag) -> dict:
    """chunk_bwd's shared-memory layout at this geometry as the kernel
    chooses it (wkv6_chunk_bwd_smem) = the wrapper's mirror
    (ops.bwd_layout), in the kernel's layout of K.  Returns the layout."""
    import torch
    from repro_torch.kernels.rwkv6 import ops as wkv_ops
    quantum = 16 // r.element_size()
    kd = -(-r.shape[-1] // quantum) * quantum
    want = wkv_ops.bwd_layout(chunk, kd, r.element_size())
    if torch.device(r.device).type != "cuda":
        return want
    got = wkv_ops.ask_bwd_layout(chunk, kd, r.dtype, r.device)
    if got != want:
        raise AssertionError(f"wkv6 chunk_bwd layout {tag}: kernel {got}, "
                             f"mirror {want}")
    return want


def wkv6_bwd_work(r, chunk):
    """(bytes, fp32 operations, exponentials) the WKV backward needs on
    these inputs: r, k, v, lw, dy, the final state's gradient and the
    state entering each chunk read, and dr, dk, dv, dlw, du and ds0
    written once; per (b, h, chunk) the gate of each strictly lower pair
    and channel (a subtraction and an exponential) entering the three
    products that reduce it (A over k, P over j, Q over i: a multiply and
    a multiply-add each), dy . v over the lower pairs and the diagonal, the
    attention's product with dy, the four state products (q, S dy, dS' v,
    (exp(cwl - cwe - lw) k) dS': L K^2 multiply-adds each), <dS', S'>, the
    state pass, and an exponential per step and channel for exp(cwe) and
    exp(cwl - cwe - lw)."""
    bsz, s, h, kd = r.shape
    nc, tri = s // chunk, chunk * (chunk - 1) // 2
    n = r.numel()
    nbytes = (3 * n * r.element_size() + 2 * n * 4 + 2 * bsz * h * kd * kd * 4
              + bsz * nc * h * kd * kd * 4
              + 3 * n * r.element_size() + n * 4 + h * kd * 4)
    ops = bsz * nc * h * (10 * tri * kd + 2 * (tri + chunk) * kd
                          + 2 * tri * kd + 4 * 2 * chunk * kd * kd
                          + 2 * kd * kd + 2 * kd * kd + 12 * chunk * kd)
    exps = bsz * nc * h * (tri * kd + 2 * chunk * kd + kd)
    return nbytes, ops, exps


def wkv6_bwd_split_ops(r, chunk):
    """TF32 operations the WKV backward's split-TF32 products take on these
    inputs (two per multiply-add of each pass, on the kernels' tiles: rows
    padded to 16, channels to 8; chunk_dstate's channels as rows to 16).
    Per (b, h, chunk): D = dy v^T on the lower tiles and the state term dS'
    v of Q (2 passes with bf16 v, else 3); every other product 3: A^T's
    anchored blocks, the state term S dy of P, P's and Q's anchored terms,
    dv's (exp(cwl - cwe - lw) k) dS' and A^T dy, and chunk_dstate's (r
    exp(cwe))^T dy."""
    bsz, s, h, kd = r.shape
    lp, kp, km = -(-chunk // 16) * 16, -(-kd // 8) * 8, -(-kd // 16) * 16
    nb, nc = lp // 16, s // chunk
    pv = 2 if r.element_size() == 2 else 3
    macs = (pv * 128 * nb * (nb + 1) * kp                   # D
            + 3 * 256 * kp * nb * (nb - 1) // 2             # A^T anchored
            + (3 + pv) * lp * kp * kp                        # S dy, dS' v
            + 3 * sum(16 * kp * (16 * a + (lp - 16 * (a + 1))
                                 + (lp - 16 * a))
                      for a in range(nb))                    # P, Q, A^T dy
            + 3 * lp * kp * kp                               # dv's state term
            + 3 * km * kp * lp)                              # chunk_dstate
    return 2 * bsz * nc * h * macs


def wkv6_bwd_design_exps(r, chunk):
    """Exponentials the WKV backward's kernels take on these inputs (on
    their padded tiles), per (b, h, chunk): A^T's anchored operands (32
    rows of kp a block pair), its diagonal blocks (120 pairs of a block), P's
    and Q's diagonal blocks (the same pairs, each gate taken once for both),
    their anchored operands, their row scales (exp(cwe), exp(cwl - cwe -
    lw), which dv's product reuses, and the anchored blocks' factors), and
    chunk_dstate's exp(cwe)."""
    bsz, s, h, kd = r.shape
    lp, kp = -(-chunk // 16) * 16, -(-kd // 8) * 8
    nb, nc = lp // 16, s // chunk
    per = (32 * kp * nb * (nb - 1) // 2 + 2 * 120 * nb * kp
           + sum(16 * a * kp + (lp - 16 * (a + 1)) * kp
                 + 16 * kp * (2 + (a > 0) + (a < nb - 1))
                 for a in range(nb))
           + chunk * kd)
    return bsz * nc * h * per


def phase_wkv6_bwd(device, layer0, *, cases=WKV6_BWD_CASES, reps=5):
    """The WKV backward kernels against their plain version over
    WKV6_BWD_CASES and on the inputs layer 0 of train_rwkv6 gave them
    (with the forward's scratch, as the autograd Function passes it);
    chunk_bwd's layout = its Python mirror; then the time there beside the
    bound, the plain version's, and each pass's.  Returns the record for
    the kernels line."""
    from repro_torch.kernels.rwkv6 import ops as wkv_ops
    from repro_torch.kernels.rwkv6.ref import wkv6_bwd_ref
    worst = 0.0
    for n, case in enumerate(cases):
        args, kw = wkv6_bwd_inputs(case, device, seed=n)
        tag = ("B={} S={} H={} K={} chunk={} r/k/v {} s0={} dsf={} "
               "decay={} tail={}".format(*case))
        worst = max(worst, wkv6_bwd_check(args, kw, tag, "wkv6_bwd"))
        layout = wkv6_bwd_layout_held(args[0], case[4], tag)
        say("wkv6_bwd", f"{tag}: chunk_bwd layout {layout}")
    args, kw = layer0["args"], layer0["kw"]
    r, k, v, lw, u, dy, dsf = args
    chunk, cwl, s_in, sf = kw["chunk"], kw["cwl"], kw["s_in"], kw["sf"]
    tag = (f"train layer 0 inputs r {tuple(r.shape)} {r.dtype} chunk "
           f"{chunk}, the forward's scratch")
    worst = max(worst, wkv6_bwd_check(args, kw, tag, "wkv6_bwd"))
    layout = wkv6_bwd_layout_held(r, chunk, tag)
    ms = time_ms(lambda: wkv_ops.wkv6_bwd(*args, **kw), reps=reps)
    plain = time_ms(lambda: wkv6_bwd_ref(*args, **kw), reps=2)
    q = wkv_ops.chunk_dstate(r, dy, lw, chunk=chunk)
    passes = {
        "chunk_dstate": time_ms(lambda: wkv_ops.chunk_dstate(
            r, dy, lw, chunk=chunk), reps=reps),
        "state_pass_bwd": time_ms(lambda: wkv_ops.state_pass_bwd(
            q, cwl, dsf=dsf), reps=reps),
        "chunk_bwd + sum_du": time_ms(lambda: wkv_ops.chunk_bwd(
            r, k, v, lw, u, dy, s_in, sf, q, chunk=chunk), reps=reps)}
    work = wkv6_bwd_work(r, chunk)
    bound, by, pipe = pipe_bound(*work, ops_per_s=TF32_OPS_PER_S,
                                 ops_pipe="TF32 tensor")
    fma_bound, _, _ = pipe_bound(*work)
    nbytes, ops, exps = work
    split = wkv6_bwd_split_ops(r, chunk)
    taken = wkv6_bwd_design_exps(r, chunk)
    say("wkv6_bwd", f"{tag}: device ms per pass " + ", ".join(
        f"{k} {v:.3f}" for k, v in passes.items()))
    say("wkv6_bwd", f"{tag}: kernels {ms:.3f} ms, bound {bound:.4f} ms "
        f"({by}, {pipe}: {nbytes / 1e6:.1f} MB, {ops / 1e9:.2f} GFLOP, "
        f"{exps / 1e9:.3f} G exponentials; on the FMA pipes "
        f"{fma_bound:.4f} ms), plain {plain:.3f} ms; kernels / bound "
        f"{ms / bound:.1f}; no PyTorch call computes this function")
    say("wkv6_bwd", f"{tag}: the split TF32 takes {split / 1e9:.1f} GFLOP "
        f"of TF32 ({split / TF32_OPS_PER_S * 1e3:.4f} ms at "
        f"{TF32_OPS_PER_S / 1e12:.0f} TFLOP/s); the kernels take "
        f"{taken / 1e9:.3f} G exponentials "
        f"({taken / SFU_OPS_PER_S * 1e3:.4f} ms on the SFUs); layout "
        f"{layout}")
    return dict(ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by,
                bound_pipe=pipe, library_ms=None, max_abs_err=worst,
                pass_ms=passes, fma_bound_ms=fma_bound,
                split_tf32_gflop=split / 1e9, exps_taken=taken)


def model_card_vs_cpu(device, cfg, *, phase, seq, steps):
    """``cfg`` (float32) on the card and on the CPU from the same
    parameters: one ``seq``-token prompt and ``steps`` decode steps, logits
    within F32_LOGIT_TOL, greedy tokens equal.  The card's prefill must
    launch each kernel of ``cfg`` as ``launches_per_prefill`` says.  The
    card's prefill of the prompt plus the first and the last k generated
    tokens must also agree with its k-th decode step within F32_LOGIT_TOL:
    in float32 this holds the caches the prefill hands to decode (a scan
    kernel's final state, MLA's latent cache among them) far more tightly
    than the bf16 serve phases can.  An MoE config runs dropless
    (``dropless``), so only a routing flip at a near tie excuses a row
    (``moe_excused``), and each k must hold the row.  Cross blocks get
    tanh(gate) = CROSS_GATE.  Returns the largest logit difference."""
    import copy
    import torch
    from repro_torch.models import model as M
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmuls are on; float32 parity needs "
                             "them off")
    cfg = dropless(cfg)
    # Drawn on the card (the CPU's generator takes seconds a GB), copied.
    card_params = M.init_params(cfg, seed=1, device=device)
    open_gates(card_params, cfg)
    cpu_params = copy.deepcopy(card_params).to("cpu")
    key = ids_key(cfg)
    prompt, extra = serve_prompt(cfg, 1, seq, "cpu", seed=1)
    ops = kernel_ops()
    before = {name: op.LAUNCHES for name, op in ops.items()}
    sides = {}
    for name, dev, params in (("card", device, card_params),
                              ("cpu", "cpu", cpu_params)):
        with RouteLog() as log:
            sides[name] = M.prefill(params, cfg, {
                key: prompt.to(dev),
                **{k: v.to(dev) for k, v in extra.items()}},
                max_len=seq + steps)
        if name == "card":
            base_routes = log.calls
    launched = {name: op.LAUNCHES - before[name] for name, op in ops.items()}
    if device != "cpu" and launched != launches_per_prefill(cfg, seq):
        raise AssertionError(f"the card's prefill launched {launched}, "
                             f"expected {launches_per_prefill(cfg, seq)}")
    worst, swapped = 0.0, 0
    gen, card_steps = [], []
    for i in range(steps + 1):
        card_logits, cpu_logits = sides["card"][0], sides["cpu"][0]
        if i:
            card_steps.append((card_logits, routes.calls))
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
        tok = greedy(cfg, cpu_logits)
        gen.append(tok)
        for name, dev, params in (("card", device, card_params),
                                  ("cpu", "cpu", cpu_params)):
            pos = torch.full((1,), seq + i, dtype=torch.int32, device=dev)
            with RouteLog() as log:
                sides[name] = M.decode_step(params, cfg, sides[name][1],
                                            {key: tok.to(dev)}, pos)
            if name == "card":
                routes = log
    say(phase, f"{cfg.name} at full width, pattern {cfg.pattern}, float32, "
        f"prompt {seq}, {steps} decode steps: logits max abs diff "
        f"{worst:.3g} ({F32_LOGIT_TOL}), greedy tokens equal"
        f"{f' except {swapped} swapped at a gap under tolerance' if swapped else ''}")
    for k in sorted({1, steps}):
        tokens = torch.cat([prompt] + gen[:k], dim=1).to(device)
        with RouteLog() as log:
            pf, _ = M.prefill(card_params, cfg, {
                key: tokens, **{n: v.to(device) for n, v in extra.items()}},
                max_len=seq + steps)
        want = card_steps[k - 1][0]
        tag = f"the card's prefill of prompt + {k} token(s) vs its decode " \
              f"step {k}"
        held_rows(tag, phase, moe_excused(
            cfg, base_routes, log.calls, [r for _, r in card_steps[:k]], 1,
            F32_LOGIT_TOL["atol"]), 1, "the float32 check")
        if dropped(cfg, log.calls):
            raise AssertionError(f"{tag}: the dropless prefill dropped "
                                 f"{dropped(cfg, log.calls)} assignments")
        err = float((pf - want).abs().max())
        torch.testing.assert_close(
            pf, want, **F32_LOGIT_TOL, msg=lambda m: f"{tag}: {m}")
        say(phase, f"{cfg.name}: {tag}: max abs diff {err:.3g} "
            f"({F32_LOGIT_TOL}){'; dropless' if log.calls else ''}")
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


# -- the remaining block kinds (serve_blocks) ------------------------------------

#: The serve_blocks phase's archs at full width, each cut in depth (the
#: config overrides): gemma3 one 5:1 local:global period, llama-vision one
#: period (four attn layers and its cross layer), the others 4 layers
#: (qwen3-moe with all 128 experts, top-8; mixtral's 46.7 B parameters do
#: not fit one card).
SERVE_BLOCKS = {
    "gemma3-4b": dict(n_layers=6, pattern=((1, ("local",) * 5
                                            + ("global",)),)),
    "qwen3-32b": dict(n_layers=4, pattern=((4, ("attn",)),)),
    "qwen3-moe-30b-a3b": dict(n_layers=4, pattern=((4, ("attn_moe",)),)),
    "mixtral-8x7b": dict(n_layers=4, pattern=((4, ("attn_moe",)),)),
    "minicpm3-4b": dict(n_layers=4, pattern=((4, ("mla",)),)),
    "llama-3.2-vision-11b": dict(n_layers=5, pattern=((1, ("attn",) * 4
                                                       + ("cross",)),)),
    "musicgen-medium": dict(n_layers=4, pattern=((4, ("attn",)),)),
}
#: The archs whose layer-0 flash inputs serve_blocks times: minicpm3's MLA
#: heads folded into the batch (B*H = 80, Hk = 1, D = 96), mixtral's window
#: of 4096 at S = 6000, gemma3's head width 256.
FLASH_SHAPES = ("minicpm3-4b", "mixtral-8x7b", "gemma3-4b")


def phase_moe_dispatch(record, phase, tag):
    """The two MoE dispatches on the input layer 0's MoE block got in a
    serve phase (its routing): outputs within one bf16 rounding, 2^-7
    relative (plus 2^-16 of the largest output where terms cancel): both
    keep the assignments ``moe.kept`` names, feed the experts the same
    buffers and add the same float32 terms in other orders (a differing
    kept set would move a whole expert's term).  Returns (dropped
    assignments, ms of each dispatch)."""
    import torch
    from repro_torch.models import moe as MOE
    p, cfg, x = record["args"]
    x_flat = x.reshape(-1, x.shape[-1])
    w, idx, _ = MOE.route(p, cfg, x_flat)
    dense = MOE.moe_dense_onehot(p, cfg, x_flat, w, idx)
    ragged = MOE.moe_ragged_sort(p, cfg, x_flat, w, idx)
    n_drop = int((~MOE.kept(cfg, idx)).sum())
    scale = float(ragged.float().abs().max())
    torch.testing.assert_close(dense.float(), ragged.float(), rtol=2 ** -7,
                               atol=2 ** -16 * scale,
                               msg=lambda m: f"{tag}: dense vs ragged: {m}")
    err = float((dense.float() - ragged.float()).abs().max())
    ms = {name: time_ms(lambda fn=fn: fn(p, cfg, x_flat, w, idx), reps=5)
          for name, fn in (("dense_onehot", MOE.moe_dense_onehot),
                           ("ragged_sort", MOE.moe_ragged_sort))}
    say(phase, f"{tag}: T={x_flat.shape[0]} E={cfg.n_experts} top-"
        f"{cfg.top_k}, capacity {MOE._capacity(cfg, x_flat.shape[0])}: "
        f"{n_drop} of {idx.numel()} assignments dropped; outputs max "
        f"abs diff {err:.3g} (largest output "
        f"{scale:.3g}); dense_onehot {ms['dense_onehot']:.2f} ms, "
        f"ragged_sort {ms['ragged_sort']:.2f} ms")
    return n_drop, ms


def phase_serve_blocks(device, *, reduced=False, seq=6000, steps=16):
    """Every served architecture the earlier phases do not serve, at full
    width cut in depth (SERVE_BLOCKS), through phase_serve: tokens/s,
    ms/step and flash launches per arch; for the MoE archs both dispatches
    on layer 0's MoE input; flash on layer 0's inputs of FLASH_SHAPES.
    Returns (flash launches, {arch: metrics}, {arch: flash record})."""
    import torch
    flash, metrics, shapes = 0, {}, {}
    for arch in SERVE_BLOCKS:
        params, served, layer0, m = phase_serve(
            device, arch, tag="serve_blocks", reduced=reduced, seq=seq,
            steps=steps, cut=SERVE_BLOCKS[arch])
        flash += served["flash_attention"]
        m["flash_launches"] = served["flash_attention"]
        if "moe_forward" in layer0:
            m["dropped_layer0"], m["dispatch_ms"] = phase_moe_dispatch(
                layer0["moe_forward"], "serve_blocks",
                f"{arch} layer 0 MoE")
        if arch in FLASH_SHAPES and "flash_attention" in layer0:
            shapes[arch] = flash_at_shape(layer0["flash_attention"],
                                          "serve_blocks",
                                          f"{arch} layer 0 attention")
        say("serve_blocks", f"{arch} metrics " + json.dumps(m))
        metrics[arch] = m
        del params, layer0
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    return flash, metrics, shapes


#: The depth cuts of the blocks_card_vs_cpu phase (float32, full width):
#: 2 layers of qwen3-moe under each dispatch, of minicpm3 (its 1100-token
#: prompt past MLA's dense limit, so the folded flash runs) and of musicgen;
#: llama-vision's attn layer and a cross layer.
BLOCK_CUTS = [
    ("qwen3-moe-30b-a3b", dict(n_layers=2, pattern=((2, ("attn_moe",)),),
                               moe_dispatch="dense_onehot")),
    ("qwen3-moe-30b-a3b", dict(n_layers=2, pattern=((2, ("attn_moe",)),),
                               moe_dispatch="ragged_sort")),
    ("minicpm3-4b", dict(n_layers=2, pattern=((2, ("mla",)),))),
    ("llama-3.2-vision-11b", dict(n_layers=2,
                                  pattern=((1, ("attn", "cross")),))),
    ("musicgen-medium", dict(n_layers=2, pattern=((2, ("attn",)),))),
]


def phase_blocks_card_vs_cpu(device, *, reduced=False, seq=1100, steps=8):
    """The new block kinds at full width cut in depth (BLOCK_CUTS), float32,
    on the card and the CPU."""
    return {f"{arch} {cut.get('moe_dispatch', '')}".strip(): model_card_vs_cpu(
        device, serve_config(reduced, arch, dtype="float32",
                             param_dtype="float32", **cut),
        phase="blocks_card_vs_cpu", seq=seq, steps=steps)
        for arch, cut in BLOCK_CUTS}



# -- training ---------------------------------------------------------------------

#: The train phase: h2o-danube-1.8b at full width and depth (bf16, remat
#: "block"), the reference's train_4k sequence (configs/base.py:182), its
#: global batch of 256 cut to 2, 5 AdamW steps.
TRAIN_ARGS = dict(seq=4096, batch=2, steps=5)
#: The train_zamba2 phase: zamba2-2.7b at full width and depth (54 Mamba-2
#: layers and the shared block, bf16, remat "block"), the same sequence and
#: batch, 3 AdamW steps.
TRAIN_ZAMBA2_ARGS = dict(seq=4096, batch=2, steps=3)
#: The train_rwkv6 phase: rwkv6-7b at full width (d_model 4096, 64 heads of
#: 64, d_ff 14336, vocab 65536, chunk 64) cut to 10 of its 32 layers, bf16,
#: remat "block", the same sequence and batch, 3 AdamW steps.  Its 7.53 B
#: parameters at 12 bytes each (bf16 weights and gradients, float32 AdamW
#: moments) are 90.4 GB, and optimizer.apply makes the new moments while
#: the old ones live, 20 bytes a parameter at its peak: on an H100 80GB, 16
#: layers (4.04 B) ran out of memory in their first step, and 12 (3.16 B)
#: peaked at 69.27 GB and in one of two runs ran out on their fourth, with
#: 14.06 GiB of the allocator's pool free in pieces (PERF.md, PR 27).  10
#: layers hold 2.72 B.
TRAIN_RWKV6_ARGS = dict(seq=4096, batch=2, steps=3)
RWKV6_TRAIN_CUT = dict(n_layers=10, pattern=((10, ("rwkv",)),))
#: The reference smoke test's bound (tests/test_models_smoke.py:30-33): a
#: random model's first cross-entropy within 35 % of ln(vocab).
CE_SPREAD = 0.35
#: The init scale of the embedding table (``layers.embedding_init``).
EMBED_STD = 0.02


def initial_ce(cfg) -> float:
    """A random model's expected first cross-entropy on random labels:
    ln(vocab), unless the embeddings are tied and scaled by sqrt(d_model)
    (gemma3-4b).  Then the final hidden state of position t is nearly its
    own embedding e_t normalised to RMS 1, e_t / EMBED_STD, so the model
    gives its input token the logit |e_t|^2 / EMBED_STD = EMBED_STD *
    d_model (51.2 for gemma3-4b; the reference's loss_fn gives 45.5 at
    full width and one layer) and the cross-entropy of a random label is
    about that.  The reference's smoke test runs the reduced configs,
    where EMBED_STD * d_model (2.6) is below ln(vocab)."""
    import math
    if cfg.tie_embeddings and cfg.embed_scale:
        return max(math.log(cfg.vocab), EMBED_STD * cfg.d_model)
    return math.log(cfg.vocab)


def flash_counts() -> tuple[int, int]:
    from repro_torch.kernels.flash_attention import ops as fa_ops
    return fa_ops.LAUNCHES, fa_ops.BWD_LAUNCHES


def zero_flash_counts() -> None:
    from repro_torch.kernels.flash_attention import ops as fa_ops
    fa_ops.LAUNCHES = fa_ops.BWD_LAUNCHES = 0


def train_launches(cfg, seq) -> tuple[int, int]:
    """(forward, backward) flash launches of one train step: every blocked
    attention call runs its forward twice under remat "block" (forward and
    recompute) and its backward once."""
    n = launches_per_prefill(cfg, seq)["flash_attention"]
    return n * (2 if cfg.remat == "block" else 1), n


def check_ce(tag, phase, ce, cfg) -> None:
    import math
    want = initial_ce(cfg)
    if not (math.isfinite(ce) and abs(ce - want) <= CE_SPREAD * want):
        raise AssertionError(f"{phase} {tag}: step-0 cross-entropy {ce} is "
                             f"not within {CE_SPREAD:.0%} of {want:.3f} "
                             f"(initial_ce; ln(vocab) = "
                             f"{math.log(cfg.vocab):.3f})")


def capture_last_calls(store):
    """Patch the model modules' backward wrappers so that ``store[name]``
    holds the inputs of each one's latest call (``args`` cloned, ``kw``;
    the last layer a backward reaches is layer 0): flash_attention_bwd,
    mamba2_ssd_bwd, step_and_decay_bwd and wkv6_bwd.  Returns the undo."""
    import torch
    from repro_torch.models import attention, rwkv, ssm
    saved = []

    def copy(a):
        return a.clone() if isinstance(a, torch.Tensor) else a

    for module, name in ((attention, "flash_attention_bwd"),
                         (ssm, "mamba2_ssd_bwd"),
                         (ssm, "step_and_decay_bwd"),
                         (rwkv, "wkv6_bwd")):
        real = getattr(module, name)

        def wrapper(*args, _real=real, _name=name, **kw):
            store[_name] = dict(args=[copy(a) for a in args],
                                kw={k: copy(v) for k, v in kw.items()})
            return _real(*args, **kw)

        setattr(module, name, wrapper)
        saved.append((module, name, real))

    def undo():
        for module, name, real in saved:
            setattr(module, name, real)
    return undo


def layers_of(cfg, kind) -> int:
    return sum(k == kind for rep, ks in cfg.pattern for _ in range(rep)
               for k in ks)


def scan_counts() -> dict:
    """The SSD scan's, the step and decay's and the WKV scan's launch
    counts, forward and backward, and the backwards' passes."""
    from repro_torch.kernels.mamba2 import ops as ssd_ops
    from repro_torch.kernels.rwkv6 import ops as wkv_ops
    return {"mamba2_ssd": ssd_ops.LAUNCHES,
            "step_decay": ssd_ops.STEP_DECAY_LAUNCHES,
            "mamba2_ssd_bwd": ssd_ops.SSD_BWD_LAUNCHES,
            "step_decay_bwd": ssd_ops.STEP_DECAY_BWD_LAUNCHES,
            **{f"bwd {k}": v for k, v in ssd_ops.BWD_PASS_LAUNCHES.items()},
            "wkv6": wkv_ops.LAUNCHES, "wkv6_bwd": wkv_ops.WKV_BWD_LAUNCHES,
            **{f"wkv6_bwd {k}": v
               for k, v in wkv_ops.BWD_PASS_LAUNCHES.items()}}


def zero_scan_counts() -> None:
    from repro_torch.kernels.mamba2 import ops as ssd_ops
    from repro_torch.kernels.rwkv6 import ops as wkv_ops
    ssd_ops.LAUNCHES = ssd_ops.STEP_DECAY_LAUNCHES = 0
    ssd_ops.SSD_BWD_LAUNCHES = ssd_ops.STEP_DECAY_BWD_LAUNCHES = 0
    for k in ssd_ops.BWD_PASS_LAUNCHES:
        ssd_ops.BWD_PASS_LAUNCHES[k] = 0
    wkv_ops.LAUNCHES = wkv_ops.WKV_BWD_LAUNCHES = 0
    for k in wkv_ops.BWD_PASS_LAUNCHES:
        wkv_ops.BWD_PASS_LAUNCHES[k] = 0


def scan_train_launches(cfg, steps=1) -> dict:
    """scan_counts of ``steps`` train steps: each mamba block's scan and
    step and decay, and each rwkv block's WKV scan, run forward twice under
    remat "block" (forward and recompute) and backward once (each
    backward's four passes once)."""
    n = layers_of(cfg, "mamba") * steps
    w = layers_of(cfg, "rwkv") * steps
    f = 2 if cfg.remat == "block" else 1
    return {"mamba2_ssd": n * f, "step_decay": n * f, "mamba2_ssd_bwd": n,
            "step_decay_bwd": n, "bwd chunk_dstate": n,
            "bwd state_pass_bwd": n, "bwd chunk_bwd": n,
            "bwd sum_groups": n, "wkv6": w * f, "wkv6_bwd": w,
            "wkv6_bwd chunk_dstate": w, "wkv6_bwd state_pass_bwd": w,
            "wkv6_bwd chunk_bwd": w, "wkv6_bwd sum_du": w}


def phase_train(device, *, arch=SERVE_ARCH, full=True, tag="train",
                cut=None, **args):
    """``repro_torch.launch.train``'s entry point at TRAIN_ARGS (or
    ``args``), its config cut in depth by ``cut`` (overrides of the config
    ``launch.train`` builds) if given: every loss finite, the step-0
    cross-entropy within CE_SPREAD of initial_ce, the flash kernels (and
    the scan kernels, forward and backward) launched as train_launches and
    scan_train_launches say.  Then one more step with the backward
    wrappers' inputs captured (layer 0's: flash_bwd, ssd_bwd,
    step_decay_bwd, wkv6_bwd), whose gradient norm must be finite and above
    0.  Returns (forward launches, backward launches, the captures by
    wrapper name, metrics)."""
    import dataclasses
    import math
    import statistics
    import torch
    from repro_torch.launch import train
    args = {**TRAIN_ARGS, **args}
    cuda = torch.device(device).type == "cuda"
    argv = ["--arch", arch, "--seq", str(args["seq"]), "--batch",
            str(args["batch"]), "--steps", str(args["steps"]), "--device",
            device] + (["--full"] if full else [])
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    zero_flash_counts()
    zero_scan_counts()
    real_config = train.get_config
    if cut:
        train.get_config = lambda *a, **kw: dataclasses.replace(
            real_config(*a, **kw), **cut)
    try:
        t0 = synced(device)
        trainer = train.main(argv)
        wall = synced(device) - t0
    finally:
        train.get_config = real_config
    fwd, bwd = flash_counts()
    scans = scan_counts()
    cfg = trainer.cfg
    hist = trainer.history
    losses = [h["loss"] for h in hist]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{tag}: a loss is not finite: {losses}")
    check_ce("step 0", tag, losses[0], cfg)
    per_step = train_launches(cfg, args["seq"])
    steps = len(hist)
    expect_launches(tag, device, (fwd, bwd),
                    (per_step[0] * steps, per_step[1] * steps))
    expect_launches(tag, device, scans, scan_train_launches(cfg, steps))
    if cuda and per_step[1] + scans["mamba2_ssd_bwd"] \
            + scans["wkv6_bwd"] == 0:
        raise AssertionError(f"{tag}: no backward kernel on the main path")
    ms = [1e3 * h["dt"] for h in hist]
    steady = statistics.median(ms[1:]) if len(ms) > 1 else ms[0]
    tokens = args["batch"] * args["seq"]
    metrics = dict(
        arch=arch, layers=cfg.n_layers, d_model=cfg.d_model,
        dtype=cfg.param_dtype, remat=cfg.remat, seq=args["seq"],
        batch=args["batch"], steps=steps, losses=losses,
        ms_per_step=steady, first_step_ms=ms[0], tokens_per_s=tokens
        / (steady / 1e3), wall_s=wall,
        peak_gb=torch.cuda.max_memory_allocated() / 1e9 if cuda else None,
        flash_fwd_per_step=fwd / steps, flash_bwd_per_step=bwd / steps,
        scan_launches={k: v / steps for k, v in scans.items() if v})
    layer0 = {}
    undo = capture_last_calls(layer0)
    try:
        _, m = trainer.step_fn(trainer.state, trainer.loader.next_batch())
    finally:
        undo()
    metrics["grad_norm"] = float(m["grad_norm"])
    if not (math.isfinite(metrics["grad_norm"]) and metrics["grad_norm"] > 0):
        raise AssertionError(f"{tag}: grad norm {metrics['grad_norm']}")
    say(tag, f"{arch} {'full' if full else 'reduced'} "
        f"({cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.param_dtype}, "
        f"remat {cfg.remat}), {args['batch']} x {args['seq']} tokens: "
        f"losses {[round(x, 4) for x in losses]}, {steady:.1f} ms/step "
        f"(first {ms[0]:.1f}), {metrics['tokens_per_s']:.0f} tokens/s, "
        f"peak {metrics['peak_gb']} GB, grad norm {metrics['grad_norm']:.4g}"
        f", flash forward {fwd / steps:g} and backward {bwd / steps:g} "
        f"launches per step; scan launches per step "
        f"{metrics['scan_launches']}")
    del trainer
    if cuda:
        torch.cuda.empty_cache()
    return fwd, bwd, layer0, metrics


#: train_card_vs_cpu: float32 on both sides.  The loss to rel 1e-5; each
#: gradient leaf and each updated parameter and moment within 1e-4 of its
#: leaf's max (sums in other orders over 512 tokens and 2 layers).  AdamW's
#: eps is 1e-5 there: at the default 1e-8 a gradient at float32 noise level
#: takes a whole +-lr step whose sign is the noise's, on either side.
TRAIN_F32_TOL = dict(loss=1e-5, leaf=1e-4)
#: zamba2's leaves within 3e-4 of their max: its gradients run back through
#: the SSD scan's chunk products and the log decay's in-chunk prefix sums,
#: which the backward kernels sum in other orders than the plain version
#: (tests/test_torch_train.py's SCAN_GRAD_TOL against the reference, for
#: the same reason).
TRAIN_F32_SCAN_TOL = dict(loss=1e-5, leaf=3e-4)
#: The archs of train_card_vs_cpu: (cut in depth, tolerances, the run the
#: updated parameters and AdamW's moments are held to: the CPU's, or the
#: same step on the card with the WKV backward's plain version).  rwkv6's
#: loss and gradients are held to the CPU's, and its whole step to that
#: card step: the float32 noise of the step outside the backward kernels
#: (the card's and the CPU's GEMMs and elementwise kernels sum in other
#: orders, and the forward kernel's exponentials are not torch.exp's)
#: takes two of its updated leaves past 3e-4 of their max whichever WKV
#: backward the card runs (PERF.md, PR 27): AdamW's nu of tm.u (nu grows
#: as g^2, so twice du's error; du sums r k (dy . v) of both signs over
#: every token) and ln1.bias (AdamW divides its gradient elements near eps
#: by sqrt(nu) + eps).
TRAIN_CARD_VS_CPU = {
    SERVE_ARCH: (lambda n: dict(n_layers=n, pattern=((n, ("attn",)),)),
                 TRAIN_F32_TOL, "cpu"),
    "zamba2-2.7b": (lambda n: SSM_CUTS["zamba2-2.7b"], TRAIN_F32_SCAN_TOL,
                    "cpu"),
    "rwkv6-7b": (lambda n: SSM_CUTS["rwkv6-7b"], TRAIN_F32_SCAN_TOL,
                 "card plain backward"),
}


def plain_wkv_bwd():
    """A context in which the model's WKV scan takes its backward's plain
    version, on whatever device its tensors lie (no backward launch)."""
    import contextlib
    from repro_torch.kernels.rwkv6 import ref as wkv_ref
    from repro_torch.models import rwkv

    @contextlib.contextmanager
    def swapped():
        real = rwkv.wkv6_bwd
        rwkv.wkv6_bwd = wkv_ref.wkv6_bwd_ref
        try:
            yield
        finally:
            rwkv.wkv6_bwd = real
    return swapped()


def step_leaf_errors(a, b, whats=("grad", "param", "mu", "nu")) -> dict:
    """{"<what> <leaf path>": max abs error over the leaf's max} between two
    train steps' (loss, grads, params, opt) of the same parameters, taken
    in float64 on the device of ``a``'s leaves."""
    from repro_torch.train import optimizer as O
    trees = {"grad": (a[1], b[1]), "param": (a[2], b[2]),
             "mu": (a[3].mu, b[3].mu), "nu": (a[3].nu, b[3].nu)}
    worst = {}
    for what in whats:
        ta, tb = trees[what]
        for path, x in O.leaves(ta):
            x = x.detach().double()
            y = O.get_path(tb, path).detach().to(x.device).double()
            err = float((x - y).abs().max() / y.abs().max().clamp_min(1e-30))
            worst[f"{what} {'.'.join(path)}"] = err
    return worst


def phase_train_card_vs_cpu(device, *, reduced=False, n_layers=2, seq=512,
                            archs=tuple(TRAIN_CARD_VS_CPU)):
    """danube at full width cut to ``n_layers``, zamba2 cut as SSM_CUTS (a
    mamba block and the shared block) and rwkv6 (2 layers), float32, tiles
    of 256 (so the 512 tokens go through the flash kernels, zamba2's
    through the SSD kernels and rwkv6's through the WKV kernels, and their
    backwards): one train step's loss, gradients and AdamW update on the
    card and on the CPU from the same weights and batch; the loss and
    every gradient leaf within each arch's tolerance of the CPU's, and the
    updated parameters and moments within it of the run TRAIN_CARD_VS_CPU
    names (rwkv6: the same step on the card with the WKV backward's plain
    version, the loss and every leaf).  Returns {arch: errors}."""
    import copy
    from contextlib import nullcontext
    import numpy as np
    import torch
    from repro_torch.models import model as M
    from repro_torch.train import optimizer as O
    from repro_torch.train import train_step as T
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmuls are on; float32 parity needs "
                             "them off")
    results = {}
    for arch in archs:
        cut_of, tol, partner = TRAIN_CARD_VS_CPU[arch]
        cfg = serve_config(reduced, arch, dtype="float32",
                           param_dtype="float32", block_q=256, block_k=256,
                           loss_chunk=256,
                           **({} if reduced else cut_of(n_layers)))
        card = M.init_params(cfg, seed=2, device=device).requires_grad_(True)
        runs = [("card", card), ("cpu", copy.deepcopy(card).to("cpu"))]
        if partner != "cpu":
            runs.append((partner, copy.deepcopy(card)))
        ids = np.random.default_rng(2).integers(0, cfg.vocab, (1, seq + 1))
        ocfg = O.OptConfig(lr=1e-3, warmup_steps=1, eps=1e-5)
        zero_flash_counts()
        zero_scan_counts()
        out = {}
        for name, params in runs:
            dev = O.leaves(params)[0][1].device
            batch = T.to_device({"tokens": ids[:, :-1],
                                 "labels": ids[:, 1:]}, dev)
            with (plain_wkv_bwd() if name == "card plain backward"
                  else nullcontext()):
                loss, _, grads = T._grads(params, cfg, batch)
            params, opt, om = O.apply(ocfg, params, grads, O.init(params))
            out[name] = (loss, grads, params, opt)
            if name == "card":  # the launches of the card's own step
                fwd, bwd = flash_counts()
                scans = scan_counts()
        expect_launches(f"train_card_vs_cpu {arch}", device, (fwd, bwd),
                        train_launches(cfg, seq))
        expect_launches(f"train_card_vs_cpu {arch}", device, scans,
                        scan_train_launches(cfg))
        losses = {name: float(r[0]) for name, r in out.items()}
        errs = {}
        for other in dict.fromkeys(("cpu", partner)):
            whats = (("grad", "param", "mu", "nu") if other == partner
                     else ("grad",))
            worst = step_leaf_errors(out["card"], out[other], whats)
            loss_err = abs(losses["card"] - losses[other]) / abs(
                losses[other])
            bad = {k: v for k, v in worst.items() if not v <= tol["leaf"]}
            if not loss_err <= tol["loss"] or bad:
                raise AssertionError(f"train_card_vs_cpu {arch} against "
                                     f"{other}: loss rel err {loss_err:.3g}, "
                                     f"leaves over {tol['leaf']}: {bad}")
            top = max(worst, key=worst.get)
            say("train_card_vs_cpu", f"{arch} {cfg.n_layers} layers float32, "
                f"{seq} tokens, card against {other}: loss "
                f"{losses['card']:.6f} vs {losses[other]:.6f}, rel err "
                f"{loss_err:.3g}; worst of {len(worst)} leaves "
                f"({', '.join(whats)}) {top} {worst[top]:.3g} of its max "
                f"(tolerance "
                f"{tol['leaf']:g})")
            errs[other] = dict(loss_rel_err=loss_err, worst_leaf=worst[top])
        if partner != "cpu":
            update = step_leaf_errors(out["card"], out["cpu"],
                                      ("param", "mu", "nu"))
            top = max(update, key=update.get)
            say("train_card_vs_cpu", f"{arch}: the update against the CPU's "
                f"(not held: the step's float32 noise outside the backward "
                f"kernels): worst {top} {update[top]:.3g}")
        say("train_card_vs_cpu", f"{arch}: flash forward {fwd}, backward "
            f"{bwd}; scan launches "
            f"{({k: v for k, v in scans.items() if v})}")
        results[arch] = errs
        del card, runs, out
    return results


#: The train_blocks phase: each arch at full width cut in depth, bf16,
#: B = 2, with its sequence (the MoE case at T = 4096 tokens: dense_onehot
#: saves float32 [T, E, C] tensors for the backward).
TRAIN_BLOCKS = {
    "gemma3-4b": (dict(n_layers=6, pattern=((1, ("local",) * 5
                                            + ("global",)),)), 4096),
    "minicpm3-4b": (dict(n_layers=2, pattern=((2, ("mla",)),)), 4096),
    "qwen3-moe-30b-a3b": (dict(n_layers=2, pattern=((2, ("attn_moe",)),)),
                          2048),
    "llama-3.2-vision-11b": (dict(n_layers=5, pattern=((1, ("attn",) * 4
                                                        + ("cross",)),)),
                             4096),
    "musicgen-medium": (dict(n_layers=2, pattern=((2, ("attn",)),)), 4096),
}

def phase_train_blocks(device, *, reduced=False, steps=2, seq=None,
                       batch=2):
    """Two train steps of each TRAIN_BLOCKS arch (cross gates at
    tanh = CROSS_GATE): finite losses, the step-0 cross-entropy within
    CE_SPREAD of initial_ce, a finite gradient norm above 0, the flash
    kernels launched as train_launches says; then the flash backward of
    the last step's layer 0, on the inputs it was given (bf16), against
    the plain version (flash_bwd_check), outside the counts.
    Returns (forward, backward launches, {arch: metrics}, the worst
    backward error)."""
    import math
    import torch
    from repro_torch.configs.inputs import random_batch
    from repro_torch.train import optimizer as O
    from repro_torch.train import train_step as T
    cuda = torch.device(device).type == "cuda"
    total_fwd = total_bwd = 0
    worst = 0.0
    metrics = {}
    for arch, (cut, arch_seq) in TRAIN_BLOCKS.items():
        s = seq or arch_seq
        cfg = serve_config(reduced, arch, **({} if reduced else cut))
        state = T.init_state(cfg, seed=3, device=device)
        open_gates(state.params, cfg)
        step = T.make_train_step(cfg, O.OptConfig(lr=1e-4, warmup_steps=1))
        gen = torch.Generator().manual_seed(3)
        zero_flash_counts()
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        store = {}
        undo = capture_last_calls(store)
        try:
            rows, t0 = [], synced(device)
            for _ in range(steps):
                state, m = step(state, random_batch(gen, cfg, s, batch))
                rows.append({k: float(v) for k, v in m.items()})
            wall = synced(device) - t0
        finally:
            undo()
        fwd, bwd = flash_counts()
        per = train_launches(cfg, s)
        expect_launches(f"train_blocks {arch}", device, (fwd, bwd),
                        (per[0] * steps, per[1] * steps))
        total_fwd, total_bwd = total_fwd + fwd, total_bwd + bwd
        if not all(math.isfinite(r["loss"]) for r in rows):
            raise AssertionError(f"train_blocks {arch}: losses {rows}")
        check_ce(arch, "train_blocks", rows[0]["ce"], cfg)
        if not all(math.isfinite(r["grad_norm"]) and r["grad_norm"] > 0
                   for r in rows):
            raise AssertionError(f"train_blocks {arch}: grad norms {rows}")
        if "flash_attention_bwd" not in store:
            raise AssertionError(f"train_blocks {arch}: no flash backward "
                                 "ran")
        layer0 = store.pop("flash_attention_bwd")
        (q, k, v, _, _, _, dout), kw = layer0["args"], layer0["kw"]
        q_shape, kv_shape, q_dtype = q.shape, k.shape, str(q.dtype)[6:]
        err = flash_bwd_check(q, k, v, dout, kw, f"train_blocks {arch} "
                              f"layer 0")
        worst = max(worst, err)
        del layer0, q, k, v, dout
        metrics[arch] = dict(
            layers=cfg.n_layers, seq=s, batch=batch,
            losses=[r["loss"] for r in rows], ce0=rows[0]["ce"],
            grad_norms=[r["grad_norm"] for r in rows],
            ms_per_step=1e3 * wall / steps, flash_fwd=fwd, flash_bwd=bwd,
            flash_bwd_layer0=dict(q=list(q_shape), kv=list(kv_shape),
                                  dtype=q_dtype, **kw, max_abs_err=err),
            peak_gb=torch.cuda.max_memory_allocated() / 1e9 if cuda
            else None)
        say("train_blocks", f"{arch} metrics " + json.dumps(metrics[arch]))
        del state, step
        if cuda:
            torch.cuda.empty_cache()
    return total_fwd, total_bwd, metrics, worst


def phase_train_restart(device, *, steps=12, ckpt_every=4, die_at=6):
    """The reference's examples/quickstart.py on the port: danube reduced
    (tiles of 32, so its 64-token sequences run the flash kernels) trains
    with its data shards and checkpoints going through a size-fair 2-server
    burst buffer (Experiment.serve), a checkpoint every ``ckpt_every``
    steps; under run_with_restarts a failure at ``die_at`` restarts from
    the last checkpoint, and every loss from there equals an uninterrupted
    run's bit for bit.  Returns the BB servers' processed requests."""
    import dataclasses
    import math
    from repro_torch.api import Experiment
    from repro_torch.ckpt.manager import CheckpointManager
    from repro_torch.data.pipeline import DataConfig, DataLoader, ShardWriter
    from repro_torch.train import optimizer as O
    from repro_torch.train.trainer import (Trainer, TrainerConfig,
                                           run_with_restarts)
    cfg = serve_config(True, SERVE_ARCH, block_q=32, block_k=32)
    exp = (Experiment(policy="size-fair", n_servers=2, device=device)
           .add_job(user=0, size=4, req_mb=8)
           .bursts(period_s=5.0, duty=0.2, n=6))
    svc = exp.serve()
    client = svc.client(0)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=64, batch_size=4,
                      shard_tokens=1 << 15, n_shards=2)
    ShardWriter(dcfg, client=client).write_epoch(0)

    def make(root):
        return Trainer(cfg, O.OptConfig(lr=1e-3, warmup_steps=steps // 2,
                                        total_steps=steps),
                       TrainerConfig(total_steps=steps,
                                     ckpt_every=ckpt_every),
                       DataLoader(dcfg, client=client),
                       ckpt=CheckpointManager(root, client=client),
                       bb_client=client, device=device)

    zero_flash_counts()
    whole = make("/ckpt_whole")
    whole.init_or_restore()
    want = whole.run()
    got = run_with_restarts(lambda: make("/ckpt_restart"), die_at=die_at)
    fwd, bwd = flash_counts()
    resumed = (die_at // ckpt_every) * ckpt_every
    if [h["step"] for h in got] != list(range(resumed, steps)):
        raise AssertionError(f"train_restart: resumed steps "
                             f"{[h['step'] for h in got]}")
    lost = [(a["step"], a["loss"], b["loss"]) for a, b in
            zip(got, want[resumed:]) if a["loss"] != b["loss"]]
    if lost or not all(math.isfinite(h["loss"]) for h in want):
        raise AssertionError(f"train_restart: losses after the restart "
                             f"differ from the uninterrupted run's: {lost}")
    if want[-1]["loss"] >= want[0]["loss"]:
        raise AssertionError(f"train_restart: loss {want[0]['loss']} -> "
                             f"{want[-1]['loss']} did not fall")
    processed = [len(srv.processed) for srv in svc.cluster.servers]
    written = sum(st.bytes_written for st in svc.cluster.fs.stores)
    say("train_restart", f"{steps} steps, checkpoint every {ckpt_every}, "
        f"failure at {die_at}: resumed from {resumed}, losses "
        f"{[round(h['loss'], 4) for h in got]} equal the uninterrupted "
        f"run's bit for bit ({want[0]['loss']:.4f} -> {want[-1]['loss']:.4f})"
        f"; BB servers processed {processed} requests, "
        f"{written / 1e6:.1f} MB written; flash forward {fwd}, backward "
        f"{bwd}")
    return processed


# -- the other processes ---------------------------------------------------------

#: The argument that makes the script one of the other processes:
#: ``chip_smoke.py --plane NAME OUT`` runs ``PLANES[NAME]`` and writes its
#: result to OUT.
PLANE_FLAG = "--plane"
DRAW_MODES = ("tick_step[themis]", "tick_step[fifo]", "token_select")


def timer(seconds: dict):
    """``timed(name, fn, *args, **kw)``: calls ``fn`` and puts its wall
    seconds, rounded to 0.1, in ``seconds[name]``."""
    def timed(name, fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        seconds[name] = round(time.perf_counter() - t0, 1)
        return out
    return timed


def add_launches(total: dict, got: dict) -> None:
    for mode, n in got.items():
        total[mode] += n


def plane_rows(device, timed) -> dict:
    """figures, scenarios, batch_plane, calibrate, kern, micro and cli:
    the benchmark's row tables held to their recorded references.  Returns
    the draw kernels' launches of their runs."""
    launches = dict.fromkeys(DRAW_MODES, 0)
    fig_launches, _ = timed("figures", phase_figures, device)
    add_launches(launches, fig_launches)
    scen_launches, scen_ms = timed("scenarios", phase_scenarios, device)
    say("scenarios", "ms/tick " + json.dumps(scen_ms))
    add_launches(launches, scen_launches)
    bp_launches, _ = timed("batch_plane", phase_batch_plane, device)
    add_launches(launches, bp_launches)
    say("calibrate", "ms per lane-tick " + json.dumps(
        timed("calibrate", phase_calibrate, device)))
    for name, fn in (("kern", phase_kern), ("micro", phase_micro)):
        got = timed(name, fn, device)
        launches["token_select"] += got["token_select"]
        launches["tick_step[themis]"] += got["tick_step"]
    reset_launches()
    timed("cli", phase_cli, device)
    got = read_launches()
    launches["token_select"] += got["token_select"]
    launches["tick_step[themis]"] += got["tick_step"]
    return launches


def plane_sections(device, timed) -> dict:
    """shard, fleet, fig7, fig9, fig13 and fig14: the sharded runs and the
    paper's sections at the card's depth.  Returns the draw kernels'
    launches of their runs."""
    launches = dict.fromkeys(DRAW_MODES, 0)
    launches["token_select"] += timed("shard", phase_shard, device)
    fleet_launches = timed("fleet", phase_fleet, device)
    launches["tick_step[themis]"] += fleet_launches[1]["tick_step"]
    launches["token_select"] += sum(r["token_select"]
                                    for k, r in fleet_launches.items() if k > 1)
    for name in PAPER_SUBSETS:
        got, ms = timed(name, phase_paper, device, name)
        say(name, "ms/tick " + json.dumps(ms))
        add_launches(launches, got)
    return launches


#: The checks that time no kernel and hold the benchmark's rows or the
#: sharded runs to references, in two processes beside the main one.
PLANES = {"rows": plane_rows, "sections": plane_sections}


def plane_main(name: str, out: str) -> int:
    """One of the other processes: ``PLANES[name]`` on the card, its
    launches and phase seconds as JSON in ``out``.  It ends with its
    parent."""
    import ctypes
    import torch
    ctypes.CDLL(None).prctl(1, int(signal.SIGTERM))  # PR_SET_PDEATHSIG
    signal.signal(signal.SIGTERM, lambda *_: (kill_tree(os.getpid()),
                                              os._exit(143)))
    if os.getppid() == 1 or not torch.cuda.is_available():
        print("chip_smoke --plane: no parent or no CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    seconds: dict = {}
    launches = PLANES[name]("cuda", timer(seconds))
    Path(out).write_text(json.dumps(dict(launches=launches, seconds=seconds)))
    return 0


def start_plane(tmp: Path, name: str) -> subprocess.Popen:
    """Starts the process of ``PLANES[name]``; its standard output goes to
    ``tmp/NAME.log``, its standard error to this one's."""
    with open(tmp / f"{name}.log", "w") as log:
        return subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                                 PLANE_FLAG, name, str(tmp / f"{name}.json")],
                                stdout=log)


def join_plane(proc: subprocess.Popen, tmp: Path,
               name: str) -> tuple[dict, dict]:
    """Waits for the process of ``PLANES[name]``, prints its lines and
    returns its launches and phase seconds; raises if it failed."""
    rc = proc.wait()
    sys.stdout.write((tmp / f"{name}.log").read_text())
    sys.stdout.flush()
    if rc != 0:
        raise AssertionError(f"the {name} process exited {rc} (its "
                             "traceback is on standard error)")
    doc = json.loads((tmp / f"{name}.json").read_text())
    return doc["launches"], doc["seconds"]


def descendants(pid: int) -> list[int]:
    """Every process below ``pid``, from /proc's children lists."""
    out, todo = [], [pid]
    while todo:
        p = todo.pop()
        for task in Path(f"/proc/{p}/task").glob("*"):
            try:
                kids = [int(c) for c in (task / "children").read_text().split()]
            except OSError:
                continue
            out += kids
            todo += kids
    return out


def kill_tree(pid: int) -> None:
    """SIGKILL to every process below ``pid``."""
    for child in descendants(pid):
        try:
            os.kill(child, signal.SIGKILL)
        except ProcessLookupError:
            pass


def stop_plane(proc: subprocess.Popen) -> None:
    """The process and everything it started, ended."""
    kill_tree(proc.pid)
    if proc.poll() is None:
        proc.kill()
    proc.wait()


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
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))
    device = "cuda"
    t_start = time.perf_counter()
    seconds = {}
    timed = timer(seconds)

    smi = timed("device", phase_device)
    timed("build", phase_build)
    # The phases that time a kernel or the engine's tick run alone first.
    records = timed("kernels", phase_kernels, device)
    launches, engine_ms = timed("engine", phase_engine, device)
    say("engine", "ms/tick " + json.dumps(engine_ms))
    batch_launches, batch_ms, row_records = timed("batch", phase_batch, device)
    say("batch", "ms " + json.dumps(batch_ms))
    for name in ("tick_step[themis]", "tick_step[fifo]"):
        launches[name] += batch_launches[name]
    service_draws, service_record, _ = timed("service", phase_service, device)
    launches["token_select"] += service_draws
    records["token_select"].update(service_record)
    # Then the checks, in three processes on the card: the PLANES in two,
    # the rest here.
    with tempfile.TemporaryDirectory() as tmp:
        planes = {}
        try:
            for name in PLANES:
                planes[name] = start_plane(Path(tmp), name)
            timed("fused_vs_scan", phase_fused_vs_scan, device)
            timed("card_vs_cpu", phase_card_vs_cpu, device)
            timed("anchor", phase_anchor, device)
            sched_ms = timed("schedulers", phase_schedulers, device)
            say("schedulers", "ms/tick " + json.dumps(sched_ms))
            timed("schedulers_card_vs_cpu", phase_schedulers_card_vs_cpu,
                  device)
            pois_launches, _ = timed("poisson", phase_poisson, device)
            launches["tick_step[themis]"] += pois_launches
            ws_launches = timed("workspace", phase_workspace, device)
            launches["tick_step[themis]"] += ws_launches["tick_step[themis]"]
            for name, proc in planes.items():
                got, plane_seconds = timed(f"wait_{name}", join_plane, proc,
                                           Path(tmp), name)
                add_launches(launches, got)
                seconds.update(plane_seconds)
        finally:
            for proc in planes.values():
                stop_plane(proc)
    params, served, layer0, serve = timed("serve", phase_serve, device)
    launches["flash_attention"] = served["flash_attention"]
    say("serve", "metrics " + json.dumps(serve))
    del params
    engine_draws, rps = timed("serve_engine", phase_serve_engine, device)
    launches["token_select"] += engine_draws
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
                                    device, arch=arch,
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
    # The remaining block kinds: seven more archs, each with every counter
    # zeroed before it.
    flash, block_metrics, shapes = timed("serve_blocks", phase_serve_blocks,
                                         device)
    launches["flash_attention"] += flash
    records["flash_attention"]["at_shapes"] = {
        arch: {k: r[k] for k in ("ms", "plain_ms", "bound_ms", "library_ms",
                                 "max_abs_err")} for arch, r in shapes.items()}
    timed("blocks_card_vs_cpu", phase_blocks_card_vs_cpu, device)
    # Training, alone too: danube at full width and depth through the train
    # CLI, with every counter zeroed before it; then the backward kernel,
    # the card against the CPU, the other block kinds and a restart.
    fwd, bwd, layer0, train_metrics = timed("train", phase_train, device)
    say("train", "metrics " + json.dumps(train_metrics))
    launches["flash_attention"] += fwd
    launches["flash_attention_bwd"] = bwd
    records["flash_attention_bwd"] = timed(
        "flash_bwd", phase_flash_bwd, device, layer0["flash_attention_bwd"])
    del layer0
    # zamba2 at full width through the train CLI: the SSD scan and the
    # step and decay forward and backward on the card, every counter zeroed
    # before it; then their backward kernels against their plain versions.
    fwd, bwd, layer0, train_metrics = timed(
        "train_zamba2", phase_train, device, arch="zamba2-2.7b",
        tag="train_zamba2", **TRAIN_ZAMBA2_ARGS)
    say("train_zamba2", "metrics " + json.dumps(train_metrics))
    launches["flash_attention"] += fwd
    launches["flash_attention_bwd"] += bwd
    per_step = train_metrics["steps"]
    for name in ("mamba2_ssd", "step_decay", "mamba2_ssd_bwd",
                 "step_decay_bwd"):
        launches[name] = launches.get(name, 0) + round(
            train_metrics["scan_launches"][name] * per_step)
    records["mamba2_ssd_bwd"] = timed("ssd_bwd", phase_ssd_bwd, device,
                                      layer0["mamba2_ssd_bwd"])
    records["step_decay_bwd"] = timed("step_decay_bwd", phase_step_decay_bwd,
                                      device, layer0["step_and_decay_bwd"])
    del layer0
    # rwkv6 at full width cut to 16 layers through the train CLI: the WKV
    # scan forward and backward on the card, every counter zeroed before
    # it; then its backward kernels against their plain version.
    fwd, bwd, layer0, train_metrics = timed(
        "train_rwkv6", phase_train, device, arch="rwkv6-7b",
        tag="train_rwkv6", cut=RWKV6_TRAIN_CUT, **TRAIN_RWKV6_ARGS)
    say("train_rwkv6", "metrics " + json.dumps(train_metrics))
    per_step = train_metrics["steps"]
    for name in ("wkv6", "wkv6_bwd"):
        launches[name] = launches.get(name, 0) + round(
            train_metrics["scan_launches"][name] * per_step)
    records["wkv6_bwd"] = timed("wkv6_bwd", phase_wkv6_bwd, device,
                                layer0["wkv6_bwd"])
    del layer0
    timed("train_card_vs_cpu", phase_train_card_vs_cpu, device)
    fwd, bwd, _, bwd_err = timed("train_blocks", phase_train_blocks, device)
    launches["flash_attention"] += fwd
    launches["flash_attention_bwd"] += bwd
    record = records["flash_attention_bwd"]
    record["max_abs_err"] = max(record["max_abs_err"], bwd_err)
    timed("train_restart", phase_train_restart, device)
    say("done", f"phase seconds {json.dumps(seconds)}; total "
        f"{time.perf_counter() - t_start:.1f} s")

    replaces = {"token_select": "src/repro/kernels/token_select/kernel.py:65",
                "tick_step": "src/repro/kernels/tick_step/kernel.py:95",
                "flash_attention":
                    "src/repro/kernels/flash_attention/kernel.py:77",
                "mamba2_ssd": "src/repro/kernels/mamba2/kernel.py:54",
                "wkv6": "src/repro/kernels/rwkv6/kernel.py:67",
                # Not a Pallas kernel: the XLA fusion of softplus and exp.
                "step_decay": "src/repro/models/ssm.py:131",
                # Not a Pallas kernel: plain JAX under a custom_vjp.
                "flash_attention_bwd": "src/repro/models/attention.py:241",
                # Not Pallas kernels: jax.vjp of ssd_chunked and jax.grad of
                # the softplus and exp fusion.
                "mamba2_ssd_bwd": "src/repro/models/ssm.py:66",
                "step_decay_bwd": "src/repro/models/ssm.py:131",
                # Not a Pallas kernel: jax.grad through wkv6_chunked's scan.
                "wkv6_bwd": "src/repro/models/rwkv.py:64"}
    kernels = []
    for name in ("tick_step[themis]", "tick_step[fifo]", "token_select",
                 "flash_attention", "mamba2_ssd", "wkv6", "step_decay",
                 "flash_attention_bwd", "mamba2_ssd_bwd", "step_decay_bwd",
                 "wkv6_bwd"):
        r = records[name]
        base = name.split("[")[0]
        source = {"step_decay": "mamba2_ssd", "mamba2_ssd_bwd": "mamba2_ssd",
                  "step_decay_bwd": "mamba2_ssd", "wkv6_bwd": "wkv6",
                  "flash_attention_bwd": "flash_attention"}.get(base, base)
        kernels.append(dict(
            name=name, route="cuda",
            source=f"src/repro_torch/kernels/csrc/{source}.cu",
            replaces=replaces[base], launches=launches[name],
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r.get("library_ms"),
            **{k: r[k] for k in ("pass_ms", "at_shapes", "empty_launch_ms",
                                 "sweep") if k in r},
            **{k: v for k, v in r.items() if k.startswith("service_")},
            **row_records.get(name, {})))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == [PLANE_FLAG]:
        sys.exit(plane_main(*sys.argv[2:4]))
    sys.exit(main())
