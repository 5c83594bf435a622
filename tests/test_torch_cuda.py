"""The port's CUDA kernels and engine on the card (marker ``cuda``).

Skipped without a CUDA card.  On the card::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Kernels are held to their plain versions with the tolerance of
``repro_torch.kernels.parity`` (flash attention: 2e-5 in float32, 2e-2 in
bf16; the scans and each pass of ``mamba2_ssd`` and ``wkv6``:
``chip_smoke.prefix_tol``); the engine's fused and scan
paths must agree bit for bit in integer state, the engine on the card must
agree with the engine on the CPU (``chip_smoke.phase_card_vs_cpu``, for the
interval schedulers ``phase_schedulers_card_vs_cpu``), every lane of a
batched run must equal its single run, and so
must the dense, the recurrent and the remaining block kinds' models
(``chip_smoke.phase_serve_card_vs_cpu``, ``phase_ssm_card_vs_cpu``,
``phase_blocks_card_vs_cpu``), the two MoE dispatches must agree, and
the batch plane's list schedule and annealer must give the CPU's bits."""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import parity
from repro_torch.kernels.tick_step import ops as ts_ops
from repro_torch.kernels.tick_step.ref import tick_step_ref
from repro_torch.kernels.token_select import ops as tk_ops
from repro_torch.kernels.token_select.ref import token_select_ref

pytestmark = pytest.mark.cuda


def _load_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


smoke = _load_smoke()


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def inputs(s, j, w, seed, device):
    rng = np.random.default_rng(seed)
    qcount = rng.integers(0, 4, (s, j)).astype(np.int32)
    qcount[rng.random((s, j)) < 0.5] = 0
    arrays = (rng.random((s, j), dtype=np.float32), qcount,
              np.floor(np.cumsum(rng.random((s, j, w), dtype=np.float32),
                                 axis=-1) * 4).astype(np.float32) / 4,
              rng.random((s, w)) < 0.8, rng.random((s, w), dtype=np.float32))
    return [torch.as_tensor(a, device=device).contiguous() for a in arrays]


@pytest.mark.parametrize("s,j,w", [(1, 1, 1), (3, 31, 2), (16, 1000, 4),
                                   (128, 1024, 4), (4, 5000, 8)])
def test_kernels_match_plain_versions(card, s, j, w):
    shares, qcount, window, free, u = inputs(s, j, w, seed=j, device=card)
    before = tk_ops.LAUNCHES
    got = tk_ops.token_select(shares, qcount, u)
    torch.cuda.synchronize()
    assert tk_ops.LAUNCHES == before + 1
    lines, err = parity.compare_token_select(
        got, token_select_ref(shares, qcount, u), shares, qcount, u)
    assert err == 0 and not lines, lines
    for mode in ("themis", "fifo"):
        got = ts_ops.tick_step(shares, qcount, window, free, u, mode=mode)
        torch.cuda.synchronize()
        want = tick_step_ref(shares, qcount, window, free, u, mode=mode)
        lines, err = parity.compare_tick_step(got, want, shares, qcount, u,
                                              mode)
        assert err == 0 and not lines, lines


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("j", [5, 33, 1000, 1024, 4096])
def test_draw_kernels_share_dtypes_and_widths(card, j, dtype):
    """token_select and tick_step (themis and fifo) on float32 and bf16
    shares against their plain versions, every pick equal (both draw in
    the reference's order of sums), at J below a lane's run (5), just past
    one slot per lane (33), not a multiple of 32 (1000), the fleet's 1024
    (the longest run in registers) and 4096 (the shared-memory slab)."""
    shares, qcount, window, free, u = inputs(16, j, 4, seed=j, device=card)
    shares = shares.to(getattr(torch, dtype))
    before = tk_ops.LAUNCHES, ts_ops.LAUNCHES
    got = tk_ops.token_select(shares, qcount, u)
    torch.cuda.synchronize()
    lines, err = parity.compare_token_select(
        got, token_select_ref(shares, qcount, u), shares.float(), qcount, u)
    assert err == 0 and not lines, lines
    for mode in ("themis", "fifo"):
        got = ts_ops.tick_step(shares, qcount, window, free, u, mode=mode)
        torch.cuda.synchronize()
        want = tick_step_ref(shares, qcount, window, free, u, mode=mode)
        lines, err = parity.compare_tick_step(got, want, shares.float(),
                                              qcount, u, mode)
        assert err == 0 and not lines, lines
    assert (tk_ops.LAUNCHES, ts_ops.LAUNCHES) == (before[0] + 1,
                                                  before[1] + 2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_tick_equals_scan_at_fleet_shape(card, dtype):
    """S=128, J=1024, W=4: one tick_step themis launch and four token_select
    launches on the live counts pick bit-identically."""
    shares, qcount, _, free, u = inputs(128, 1024, 4, seed=11, device=card)
    before = tk_ops.LAUNCHES
    smoke.fused_equals_scan(shares.to(getattr(torch, dtype)), qcount, free, u)
    assert tk_ops.LAUNCHES == before + 4


def test_scans_refuse_grad_on_the_card(card):
    """Both scans train on the card: under a gradient the WKV scan runs its
    forward kernel's three passes and, in the backward, the WKV backward
    kernels once, with gradients within grads_held's tolerance of the plain
    backward's, and the same call without grad runs the forward alone; the
    SSD scan under a gradient runs its forward kernel's three passes and,
    in the backward, the backward kernels once, with gradients within
    ssd_bwd_held's tolerance of the plain backward's."""
    from repro_torch.kernels.mamba2 import ops as ssd_ops
    from repro_torch.kernels.mamba2 import ref as ssd_ref
    from repro_torch.kernels.rwkv6 import ops as wkv_ops
    from repro_torch.kernels.rwkv6 import ref as wkv_ref
    from repro_torch.models import rwkv, ssm
    x, a, b, c, _ = smoke.mamba2_inputs(smoke.MAMBA2_CASES[0], card, seed=0)
    r, k, v, lw, u, _ = smoke.wkv6_inputs(smoke.WKV6_CASES[0], card, seed=0)
    leaves = [t.clone().requires_grad_() for t in (r, k, v, lw, u)]
    before = wkv_ops.LAUNCHES, wkv_ops.WKV_BWD_LAUNCHES
    y, sf = rwkv.wkv6_chunked(*leaves, chunk=32)
    dy, dsf = torch.randn_like(y), torch.randn_like(sf)
    got = torch.autograd.grad((y * dy).sum() + (sf * dsf).sum(), leaves)
    torch.cuda.synchronize()
    assert (wkv_ops.LAUNCHES, wkv_ops.WKV_BWD_LAUNCHES) == (before[0] + 1,
                                                            before[1] + 1)
    _, sf_, cwl, s_in = wkv_ops.wkv6(r, k, v, lw, u, chunk=32, keep=True)
    want = wkv_ref.wkv6_bwd_ref(r, k, v, lw, u, dy, dsf, chunk=32, cwl=cwl,
                                s_in=s_in, sf=sf_)
    smoke.grads_held("wkv6_chunked", smoke.WKV6_GRADS[:5], got, want[:5])
    before = wkv_ops.LAUNCHES, wkv_ops.WKV_BWD_LAUNCHES
    with torch.no_grad():
        rwkv.wkv6_chunked(*leaves, chunk=32)
    assert (wkv_ops.LAUNCHES, wkv_ops.WKV_BWD_LAUNCHES) == (before[0] + 1,
                                                            before[1])
    leaves = [t.clone().requires_grad_() for t in (x, a, b, c)]
    before = ssd_ops.LAUNCHES, ssd_ops.SSD_BWD_LAUNCHES
    y, hf = ssm.ssd_chunked(*leaves, chunk=32)
    dy, dhf = torch.randn_like(y), torch.randn_like(hf)
    got = torch.autograd.grad((y * dy).sum() + (hf * dhf).sum(), leaves)
    torch.cuda.synchronize()
    assert (ssd_ops.LAUNCHES, ssd_ops.SSD_BWD_LAUNCHES) == (before[0] + 1,
                                                            before[1] + 1)
    _, _, cum, h_in = ssd_ops.mamba2_ssd(x, a, b, c, chunk=32, keep=True)
    want = ssd_ref.mamba2_ssd_bwd_ref(x, a, b, c, dy, dhf, chunk=32, cum=cum,
                                      h_in=h_in)
    smoke.ssd_bwd_held(tuple(got) + (want[4],), want, a, "ssd_chunked")


@pytest.mark.parametrize("case", smoke.WKV6_BWD_CASES, ids=lambda c: (
    "B{}-S{}-H{}-K{}-L{}-{}-s0{}-dsf{}-{}-tail{}".format(*c)))
def test_wkv6_bwd_kernels_match_plain_version(card, case):
    """The WKV backward kernels against their plain version on the same
    card tensors over chip_smoke's WKV6_BWD_CASES (wkv6_bwd_check: each
    gradient within 1e-4 of its max, bf16 dr, dk, dv one rounding apart at
    most; each pass against its plain version where K needs no padding; a
    second run equal bit for bit); each call launches the four passes
    once; chunk_bwd's layout as the kernel chooses it = ops.bwd_layout."""
    from repro_torch.kernels.rwkv6 import ops as wkv_ops
    args, kw = smoke.wkv6_bwd_inputs(case, card, seed=case[1] + case[3])
    before = wkv_ops.WKV_BWD_LAUNCHES, dict(wkv_ops.BWD_PASS_LAUNCHES)
    smoke.wkv6_bwd_check(args, kw, str(case), "test")
    assert wkv_ops.WKV_BWD_LAUNCHES == before[0] + 2
    passes = 2 + (case[3] % (16 // args[0].element_size()) == 0)
    assert all(wkv_ops.BWD_PASS_LAUNCHES[k] == before[1][k] + passes
               for k in before[1])
    smoke.wkv6_bwd_layout_held(args[0], case[4], str(case))


def test_rwkv6_train_step_on_card(card):
    """rwkv6 reduced (float32, loss chunks of 32) through make_train_step
    on the card, 150 tokens (not a multiple of the WKV chunk, so the padded
    tail runs): the WKV kernels launch as scan_train_launches says, the
    gradient norm is finite and above 0, and the loss and every gradient
    leaf equal the CPU's on a copy of the same parameters within 1e-5 and
    3e-4 of the leaf's max (TRAIN_F32_SCAN_TOL)."""
    import copy
    import dataclasses
    from repro_torch.configs.base import get_config
    from repro_torch.configs.inputs import random_batch
    from repro_torch.train import optimizer as O
    from repro_torch.train import train_step as T
    cfg = dataclasses.replace(get_config("rwkv6-7b", reduced=True),
                              loss_chunk=30)
    batch = random_batch(torch.Generator().manual_seed(1), cfg, 150, 2)
    params = T.init_state(cfg, seed=0, device=card).params
    cpu_params = copy.deepcopy(params).to("cpu")
    smoke.zero_scan_counts()
    loss, _, grads = T._grads(params, cfg, T.to_device(batch, card))
    assert smoke.scan_counts() == smoke.scan_train_launches(cfg)
    want_loss, _, want = T._grads(cpu_params, cfg, T.to_device(batch, "cpu"))
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    tol = smoke.TRAIN_F32_SCAN_TOL["leaf"]
    total = 0.0
    for path, g in O.leaves(grads):
        w = O.get_path(want, path)
        total += float(g.float().pow(2).sum())
        err = float((g.cpu().double() - w.double()).abs().max()
                    / w.double().abs().max().clamp_min(1e-30))
        assert err <= tol, (path, err)
    assert np.isfinite(total) and total > 0


@pytest.mark.parametrize("case", smoke.SSD_BWD_CASES, ids=lambda c: (
    "B{}-S{}-H{}-P{}-N{}-L{}-{}-h0{}-{}-views{}".format(*c)))
def test_ssd_bwd_kernels_match_plain_version(card, case):
    """The SSD backward kernels against their plain version on the same
    card tensors over chip_smoke's SSD_BWD_CASES (ssd_bwd_check: each
    gradient within 1e-4 of its max, da scaled by max(a, 1e-20), bf16 db
    and dc one rounding apart at most; each pass against its plain version;
    a second run equal bit for bit); each call launches the four passes
    once."""
    from repro_torch.kernels.mamba2 import ops as ssd_ops
    args, kw = smoke.ssd_bwd_inputs(case, card, seed=case[1] + case[3])
    before = ssd_ops.SSD_BWD_LAUNCHES, dict(ssd_ops.BWD_PASS_LAUNCHES)
    smoke.ssd_bwd_check(args, kw, str(case), "test")
    assert ssd_ops.SSD_BWD_LAUNCHES == before[0] + 2
    passes = 2 + (case[3] % 4 == 0 and case[4] % 4 == 0)
    assert all(ssd_ops.BWD_PASS_LAUNCHES[k] == before[1][k] + passes
               for k in before[1])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_step_decay_bwd_kernel_matches_plain_version(card, dtype):
    """step_decay_bwd against step_and_decay_bwd_ref on the same card
    tensors (chip_smoke.grads_held: 1e-4 of each gradient's max where
    finite, a bf16 g_dt_raw one bf16 step apart at most) on
    chip_smoke's edge-value cases, dt_raw in float32 and bf16; a second
    run equal bit for bit; one counted call each, one device launch a call
    (the profiler sees one kernel: the last block sums the tiles); calls on
    two streams at once give the same bits (each stream has counters of its
    own)."""
    from repro_torch.kernels.mamba2 import ops as ssd_ops
    from repro_torch.kernels.mamba2.ref import (step_and_decay_bwd_ref,
                                                step_and_decay_ref)
    gen = torch.Generator().manual_seed(4)
    for tag, (raw, bias, a_log) in smoke.step_decay_inputs(card, seed=3):
        raw = raw.to(getattr(torch, dtype))
        dt, a = step_and_decay_ref(raw, bias, a_log)
        g_dt, g_a = (torch.randn(dt.shape, generator=gen).to(card)
                     for _ in range(2))
        args = (g_dt, g_a, raw, bias, a_log, dt, a)
        before = ssd_ops.STEP_DECAY_BWD_LAUNCHES
        got = ssd_ops.step_and_decay_bwd(*args)
        again = ssd_ops.step_and_decay_bwd(*args)
        assert ssd_ops.STEP_DECAY_BWD_LAUNCHES == before + 2
        assert smoke.same_bits(got, again)
        smoke.grads_held(tag, smoke.STEP_DECAY_GRADS, got,
                         step_and_decay_bwd_ref(*args))
        torch.cuda.synchronize()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            ssd_ops.step_and_decay_bwd(*args)
            torch.cuda.synchronize()
        kernels = [e.name for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        assert len(kernels) == 1 and "step_decay_bwd" in kernels[0], kernels
        side = torch.cuda.Stream(card)
        side.wait_stream(torch.cuda.current_stream(card))
        with torch.cuda.stream(side):
            on_side = ssd_ops.step_and_decay_bwd(*args)
        on_main = ssd_ops.step_and_decay_bwd(*args)
        torch.cuda.synchronize()
        assert smoke.same_bits(on_side, got) and smoke.same_bits(on_main, got)


def test_chunk_bwd_layout_matches_its_mirror(card):
    """chunk_bwd's shared-memory layout as the kernel chooses it
    (mamba2_chunk_bwd_smem) = ops.bwd_layout, the mirror the CPU tests
    sweep over every geometry the forward takes: zamba2's, the case list's,
    the forward's largest chunks and widths, b and c in both dtypes, and
    the build that holds its tiles."""
    geoms = [(128, 64, 64), (24, 984, 4), (20, 20, 12), (16, 16, 16),
             (220, 4, 4), (84, 4, 180), (164, 4, 44), (64, 100, 60),
             (32, 1024, 8), (128, 8, 32), (180, 4, 12), (196, 4, 4)]
    for chunk, p, n in geoms:
        for t in (torch.float32, torch.bfloat16):
            x = torch.empty((1, chunk, 1, p), device=card)
            b = torch.empty((1, chunk, n), dtype=t, device=card)
            smoke.ssd_bwd_layout_held(x, b, chunk, str((chunk, p, n, t)))


def test_step_decay_sweep_finds_no_difference(card):
    """The exhaustive sweep over all 2^32 float32 inputs: the functions the
    step_decay kernel evaluates (exp, log1p on softplus's arguments,
    softplus) give the first version's bits on every input
    (chip_smoke.step_decay_sweep raises otherwise)."""
    got = smoke.step_decay_sweep("test")
    assert got["counts"] == {"exp": 0, "log1p": 0, "softplus": 0}


def test_zamba2_train_step_on_card(card):
    """zamba2 reduced (float32, tiles of 64, loss chunks of 32) through
    make_train_step on the card, 160 tokens (past block_q, so the shared
    block's flash kernels run; not a multiple of the SSD chunk, so the
    padded tail runs): every new kernel launches as scan_train_launches
    says, the gradient norm is finite and above 0, and the loss equals the
    CPU's on a copy of the same parameters within 1e-5."""
    import copy
    import dataclasses
    from repro_torch.configs.base import get_config
    from repro_torch.configs.inputs import random_batch
    from repro_torch.models import model as M
    from repro_torch.train import optimizer as O
    from repro_torch.train import train_step as T
    cfg = dataclasses.replace(get_config("zamba2-2.7b", reduced=True),
                              block_q=64, block_k=64, loss_chunk=32)
    batch = random_batch(torch.Generator().manual_seed(1), cfg, 160, 2)
    state = T.init_state(cfg, seed=0, device=card)
    cpu_params = copy.deepcopy(state.params).to("cpu")
    step = T.make_train_step(cfg, O.OptConfig(lr=1e-3, warmup_steps=1))
    smoke.zero_scan_counts()
    _, m = step(state, T.to_device(batch, card))
    assert smoke.scan_counts() == smoke.scan_train_launches(cfg)
    assert np.isfinite(float(m["grad_norm"])) and m["grad_norm"] > 0
    with torch.no_grad():
        want, _ = M.loss_fn(cpu_params, cfg, T.to_device(batch, "cpu"))
    np.testing.assert_allclose(float(m["loss"]), float(want), rtol=1e-5)


@pytest.mark.parametrize("kernel,case,view", smoke.LAYOUT_CASES,
                         ids=lambda c: str(c).replace(" ", ""))
def test_scan_kernels_in_their_layout(card, kernel, case, view):
    """Geometry the kernels take after the wrapper's ``kernel_layout``
    (channels zero-padded, strided or misaligned inputs copied): the kernel
    against the plain version on the original inputs, within
    ``prefix_tol``; one call each."""
    from repro_torch.kernels.mamba2 import ops as ssd_ops
    from repro_torch.kernels.rwkv6 import ops as wkv_ops
    ops = wkv_ops if kernel == "wkv6" else ssd_ops
    args, kw = smoke.layout_inputs(kernel, case, view, card, seed=3)
    before = ops.LAUNCHES
    smoke.scan_check(kernel, args, kw, f"{case} {view}", "layout")
    assert ops.LAUNCHES == before + 1


def test_engine_fused_and_scan_agree(card):
    from repro_torch.api import Experiment
    jobs = [dict(user=i % 3, size=1 + i % 2, procs=6 + i, req_mb=2 + i % 3,
                 servers=[i % 4, (i + 1) % 4]) for i in range(10)]
    runs = {}
    tk_ops.LAUNCHES = ts_ops.LAUNCHES = 0
    for impl in ("fused", "scan"):
        runs[impl] = Experiment(policy="user-fair", n_servers=4, n_workers=4,
                                max_jobs=16, tick_impl=impl
                                ).add_jobs(jobs).run(0.3)
    assert ts_ops.LAUNCHES == 300 and tk_ops.LAUNCHES == 300 * 4
    a, b = runs["fused"].state, runs["scan"].state
    for f in ("qcount", "head", "wheel", "issued", "completed", "key"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    torch.testing.assert_close(a.bytes_bin, b.bytes_bin, rtol=1e-6, atol=0)


def test_engine_on_card_matches_cpu(card):
    """fifo and themis counter-exact on every tick on both worker paths."""
    smoke.phase_card_vs_cpu("cuda", ticks=300)


@pytest.mark.parametrize("scheduler", ("themis", "fifo", "gift", "plan"))
def test_run_batch_lanes_equal_runs_on_card(card, scheduler):
    """Each lane of a 3-seed batch equals run() with its seed: integer state
    exact, bytes_bin within the atomic adds' bound (one add per worker per
    tick of a bin); themis and fifo launch tick_step once per batched
    tick, the scan schedulers never."""
    from repro_torch.api import Experiment
    from repro_torch.core import engine
    jobs = [dict(user=i % 3, size=1 + i % 2, procs=6 + i, req_mb=2 + i % 3,
                 servers=[i % 4, (i + 1) % 4]) for i in range(10)]
    point = (smoke.scheduler_params(scheduler, 40)
             if scheduler in smoke.SCAN_SCHEDULERS else None)

    def exp(seed):
        return Experiment(policy="user-fair", scheduler=scheduler, seed=seed,
                          params=point, n_servers=4, n_workers=4,
                          max_jobs=16, bin_ticks=50).add_jobs(jobs)

    tk_ops.LAUNCHES = ts_ops.LAUNCHES = 0
    batch = exp(0).run_batch(0.2, seeds=(0, 3, 8))
    fused = scheduler in ("themis", "fifo")
    assert ts_ops.LAUNCHES == (200 if fused else 0)
    assert tk_ops.LAUNCHES == 0
    bound = smoke.lane_bytes_bound(exp(0).engine_config())
    for k, seed in enumerate((0, 3, 8)):
        one = exp(seed).run(0.2)
        lane = engine.map_state(batch.state, lambda x: x[k])
        for f in smoke.INT_LEAVES:
            assert torch.equal(getattr(lane, f), getattr(one.state, f)), f
        a, b = lane.bytes_bin.cpu(), one.state.bytes_bin.cpu()
        ulp = torch.from_numpy(np.spacing(b.abs().numpy()))
        assert ((a - b).abs() <= bound * ulp).all()


@pytest.mark.parametrize("scheduler", ("themis", "fifo", "gift", "tbf",
                                       "adaptbf", "plan"))
def test_sweep_and_solo_on_card(card, scheduler):
    """A 2-point x 2-seed sweep and a solo run of every scheduler on the
    card: each sweep lane's integer counters equal its single run's."""
    from repro_torch.api import Experiment
    from repro_torch.core.scheduler import get_scheduler
    cls = get_scheduler(scheduler).params_cls
    kw = {"mu_ticks": 40} if "mu_ticks" in cls.__dataclass_fields__ else {}
    points = [cls(**kw), cls(**kw)]
    jobs = [dict(user=i % 3, size=1, procs=6 + i, req_mb=2 + i % 3,
                 servers=[i % 2]) for i in range(6)]

    def exp(seed=0):
        return Experiment(policy="user-fair", scheduler=scheduler, seed=seed,
                          params=points[0], n_servers=2, n_workers=4,
                          max_jobs=8).add_jobs(jobs)

    sw = exp().sweep(points, 0.1, seeds=(0, 5))
    one = exp(5).run(0.1)
    np.testing.assert_array_equal(sw.completed[1, 1], one.completed)
    np.testing.assert_array_equal(sw.issued[0, 1], one.issued)
    solo = exp().solo(2, 0.1)
    assert solo.n_jobs == 1 and solo.issued[0] > 0


def test_interval_schedulers_on_card(card):
    """gift, tbf, adaptbf and plan at a small geometry: conserved, and each
    in lockstep with the CPU (counter-exact until an edge-band pick)."""
    geom = dict(n_servers=8, max_jobs=64, n_workers=4, dt=2e-4, wheel=128,
                ring_cap=16, bin_ticks=500)
    smoke.phase_schedulers("cuda", geom, 0.02)
    smoke.phase_schedulers_card_vs_cpu("cuda", ticks=200)


def test_poisson_on_card_matches_cpu(card):
    """Poisson arrivals (both branches) on the card equal the CPU's draws."""
    from repro_torch.api import Experiment
    jobs = [dict(user=i % 3, size=1, procs=3 + i, req_mb=2) for i in range(6)]

    def run(device):
        e = Experiment(scheduler="fifo", device=device, n_servers=2,
                       n_workers=4, max_jobs=8, ring_cap=64).add_jobs(jobs)
        e.arrivals(arrival="poisson", rate_hz=300.0)
        e.arrivals(job=0, rate_hz=8000.0)
        return e.run_batch(0.05, seeds=(0, 1))

    card_res, cpu_res = run("cuda"), run("cpu")
    assert cpu_res.issued[:, 0].sum() > 0
    np.testing.assert_array_equal(card_res.issued, cpu_res.issued)
    np.testing.assert_array_equal(card_res.dropped, cpu_res.dropped)
    np.testing.assert_array_equal(card_res.completed, cpu_res.completed)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", smoke.FLASH_CASES,
                         ids=lambda c: "B{}-Sq{}-Sk{}-H{}-Hk{}-D{}-w{}-c{}-o{}-s{}"
                         .format(*c))
def test_flash_kernel_matches_plain_version(card, dtype, case):
    """(B, Sq, Sk, H, Hk, D, window, causal, q_offset, storage_offset) of
    chip_smoke's flash phase; one launch per call."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    window, causal, q_offset = case[6:9]
    q, k, v = smoke.flash_inputs(case, getattr(torch, dtype), card,
                                 seed=case[1] + case[5])
    before = fa_ops.LAUNCHES
    smoke.flash_check(q, k, v, dict(causal=causal, window=window,
                                    q_offset=q_offset), str(case))
    assert fa_ops.LAUNCHES == before + 1


@pytest.mark.parametrize("d", [80, 128, 256, 81, 255])
def test_flash_bf16_kernel_head_widths(card, d):
    """The bf16 tensor-core kernel at the configs' head widths (80 danube
    and zamba2, 128 qwen3, 256 gemma3) and at odd widths, staged element by
    element: GQA 4:1, a window, ragged S; one launch per call."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    case = (2, 300, 300, 8, 2, d, 128, True, 0, 0)
    q, k, v = smoke.flash_inputs(case, torch.bfloat16, card, seed=d)
    assert smoke.flash_path(q, k, v) == ("bf16 by element" if d % 8
                                         else "bf16 by cp.async")
    before = fa_ops.LAUNCHES
    smoke.flash_check(q, k, v, dict(causal=True, window=128, q_offset=0),
                      str(case))
    assert fa_ops.LAUNCHES == before + 1


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_flash_rows_without_a_live_key(card, dtype):
    """A continuation whose last rows see no key (Sq + q_offset >= Sk +
    window): the second kernel gives them the plain version's sum of V over
    its key slots (1024 for Sk = 700 in 512-key tiles), within the
    tolerance.  One counted launch per call."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    case = (2, 300, 700, 8, 2, 80, 128, True, 600, 0)
    q, k, v = smoke.flash_inputs(case, getattr(torch, dtype), card, seed=5)
    kw = dict(causal=True, window=128, q_offset=600)
    assert fa_ops.first_dead_row(300, 700, 128, 600) == 227
    before = fa_ops.LAUNCHES
    smoke.flash_check(q, k, v, kw, str(case))
    assert fa_ops.LAUNCHES == before + 1
    got = fa_ops.flash_attention(q, k, v, **kw)[:, 227:].float()
    want = (v.float().sum(1, keepdim=True) / 1024).repeat_interleave(4, 2)
    torch.testing.assert_close(got, want.expand_as(got), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.parametrize("case", smoke.FLASH_BWD_CASES,
                         ids=lambda c: str(c).replace(" ", ""))
def test_flash_bwd_kernel_matches_plain_version(card, case):
    """The backward kernel against its plain version in float32 (each
    gradient within 1e-4 of its max), over chip_smoke's case list; one
    counted launch per call."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    q, k, v, dout = smoke.flash_bwd_inputs(case, torch.float32, card,
                                           seed=len(case))
    before = fa_ops.BWD_LAUNCHES
    smoke.flash_bwd_check(q, k, v, dout, dict(causal=case[7],
                                              window=case[6]), str(case))
    assert fa_ops.BWD_LAUNCHES == before + 1


@pytest.mark.parametrize("case", [(2, 700, 700, 32, 8, 80, 0, True),
                                  (2, 600, 600, 32, 4, 128, 0, True),
                                  (1, 500, 500, 8, 4, 256, 128, True),
                                  (1, 400, 400, 24, 24, 64, 0, True),
                                  (80, 300, 300, 1, 1, 96, 0, True),
                                  (1, 333, 333, 8, 2, 18, 100, False)],
                         ids=["danube-D80", "qwen3-moe-D128",
                              "gemma3-local-D256", "musicgen-MHA-D64",
                              "minicpm3-folded-D96", "ragged-D18-window"])
def test_flash_bwd_kernel_bf16(card, case):
    """bf16 inputs at the head widths that train on the card (GQA, MHA,
    minicpm3's heads folded into the batch) and at a width staged element
    by element, on the tensor-core kernels: the kernel chain against the
    plain chain in float32 on the same values (2e-2 of each gradient's
    max); two runs give the same bits."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    q, k, v, dout = smoke.flash_bwd_inputs(case, torch.bfloat16, card,
                                           seed=3)
    kw = dict(causal=case[7], window=case[6])
    smoke.flash_bwd_check(q, k, v, dout, kw, str(case))
    out, m, l = fa_ops.flash_attention(q, k, v, return_stats=True, **kw)
    first = fa_ops.flash_attention_bwd(q, k, v, out, m, l, dout, **kw)
    again = fa_ops.flash_attention_bwd(q, k, v, out, m, l, dout, **kw)
    for a, b in zip(first, again):
        assert torch.equal(a, b)


def test_flash_bwd_kernel_refuses_rows_without_a_live_key(card):
    """Rows with no live key never occur in training; the backward kernel
    refuses them by name (the plain version computes them)."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    q, k, v, dout = smoke.flash_bwd_inputs((1, 300, 700, 8, 2, 80),
                                           torch.float32, card, seed=1)
    kw = dict(causal=True, window=128, q_offset=600)
    out, m, l = fa_ops.flash_attention(q, k, v, return_stats=True, **kw)
    with pytest.raises(NotImplementedError, match="no live key"):
        fa_ops.flash_attention_bwd(q, k, v, out, m, l, dout, **kw)


def test_remat_block_gradients_equal_no_remat(card):
    """h2o-danube-1.8b reduced, float32, 600 tokens (past block_q, through
    the flash kernels): the loss and every gradient leaf with remat
    "block" equal those without, bit for bit (the recompute runs the same
    kernels on the same inputs); the forward kernel runs twice a layer
    under remat, the backward once."""
    import dataclasses
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models import model as M
    base = dataclasses.replace(get_config("h2o-danube-1.8b", reduced=True),
                               block_q=256, block_k=256, loss_chunk=200)
    rng = np.random.default_rng(0)
    ids = torch.as_tensor(rng.integers(0, base.vocab, (2, 601)), device=card)
    batch = {"tokens": ids[:, :-1], "labels": ids[:, 1:]}
    results = []
    for remat in ("none", "block"):
        cfg = dataclasses.replace(base, remat=remat)
        params = M.init_params(cfg, seed=0, device=card).requires_grad_(True)
        launches = fa_ops.LAUNCHES, fa_ops.BWD_LAUNCHES
        loss, _ = M.loss_fn(params, cfg, batch)
        loss.backward()
        n = cfg.n_layers
        assert (fa_ops.LAUNCHES - launches[0],
                fa_ops.BWD_LAUNCHES - launches[1]) == (
                    n * (2 if remat == "block" else 1), n)
        results.append((loss.detach(), {name: p.grad.clone() for name, p
                                        in params.named_parameters()}))
    (l0, g0), (l1, g1) = results
    assert torch.equal(l0, l1)
    assert g0.keys() == g1.keys()
    for name in g0:
        assert torch.equal(g0[name], g1[name]), name


def test_dense_model_on_card_matches_cpu(card):
    """h2o-danube-1.8b at full width cut to one layer, float32: prefill of
    700 tokens (through the flash kernel) and 3 decode steps, logits within
    1e-3 of the CPU's."""
    smoke.phase_serve_card_vs_cpu("cuda", n_layers=1, seq=700, steps=3)


@pytest.mark.parametrize("case", smoke.MAMBA2_CASES,
                         ids=lambda c: "B{}-S{}-H{}-P{}-N{}-L{}-{}-h0{}-{}-views{}"
                         .format(*c))
def test_mamba2_kernel_matches_plain_version(card, case):
    """(B, S, H, P, N, chunk, b/c dtype, h0, decay, views) of chip_smoke's
    mamba2 phase: output and final state within ``prefix_tol``; one call
    (its three passes) per check."""
    from repro_torch.kernels.mamba2 import ops as ssd_ops
    x, a, b, c, h0 = smoke.mamba2_inputs(case, card, seed=case[1] + case[3])
    before = ssd_ops.LAUNCHES, dict(ssd_ops.PASS_LAUNCHES)
    smoke.scan_check("mamba2_ssd", (x, a, b, c), dict(chunk=case[5], h0=h0),
                     str(case), "mamba2")
    assert ssd_ops.LAUNCHES == before[0] + 1
    assert all(v == before[1][k] + 1 for k, v in ssd_ops.PASS_LAUNCHES.items())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_step_decay_kernel_matches_plain_version(card, dtype):
    """The step_decay kernel against its plain version on the card and on
    the CPU, bit for bit, on chip_smoke's edge-value cases (dt_raw also in
    bf16, the serving dtype); one launch per call."""
    from repro_torch.kernels.mamba2 import ops as ssd_ops
    from repro_torch.kernels.mamba2.ref import step_and_decay_ref
    for _, (raw, bias, a_log) in smoke.step_decay_inputs(card, seed=3):
        raw = raw.to(getattr(torch, dtype))
        before = ssd_ops.STEP_DECAY_LAUNCHES
        got = ssd_ops.step_and_decay(raw, bias, a_log)
        assert ssd_ops.STEP_DECAY_LAUNCHES == before + 1
        want = step_and_decay_ref(raw, bias, a_log)
        cpu = step_and_decay_ref(raw.cpu(), bias.cpu(), a_log.cpu())
        for g, w, c in zip(got, want, cpu):
            assert torch.equal(g, w) and torch.equal(g.cpu(), c)


@pytest.mark.parametrize("case", smoke.MAMBA2_CASES, ids=lambda c: (
    "B{}-S{}-H{}-P{}-N{}-L{}-{}-h0{}-{}-views{}".format(*c)))
def test_mamba2_passes_match_plain_versions(card, case):
    """Each of the mamba2_ssd kernel's three passes (chunk_state,
    state_pass, chunk_scan) against its plain version on the plain
    outputs of the passes before it, within ``prefix_tol``; one launch of
    each."""
    from repro_torch.kernels.mamba2 import ops as ssd_ops
    x, a, b, c, h0 = smoke.mamba2_inputs(case, card, seed=case[1] + case[3])
    before = dict(ssd_ops.PASS_LAUNCHES)
    smoke.ssd_pass_check((x, a, b, c), dict(chunk=case[5], h0=h0), str(case),
                         "mamba2")
    assert all(ssd_ops.PASS_LAUNCHES[k] == before[k] + 1 for k in before)


@pytest.mark.parametrize("case", smoke.WKV6_CASES,
                         ids=lambda c: "B{}-S{}-H{}-K{}-L{}-{}-s0{}-{}"
                         .format(*c))
def test_wkv6_kernel_matches_plain_version(card, case):
    """(B, S, H, K, chunk, r/k/v dtype, s0, decay) of chip_smoke's wkv6
    phase: output and final state within ``prefix_tol``; one launch per
    call."""
    from repro_torch.kernels.rwkv6 import ops as wkv_ops
    r, k, v, lw, u, s0 = smoke.wkv6_inputs(case, card, seed=case[1] + case[3])
    before = wkv_ops.LAUNCHES
    smoke.scan_check("wkv6", (r, k, v, lw, u), dict(chunk=case[4], s0=s0),
                     str(case), "wkv6")
    assert wkv_ops.LAUNCHES == before + 1


@pytest.mark.parametrize("case", smoke.WKV6_CASES,
                         ids=lambda c: "B{}-S{}-H{}-K{}-L{}-{}-s0{}-{}"
                         .format(*c))
def test_wkv6_passes_match_plain_versions(card, case):
    """Each of the wkv6 kernel's three passes (chunk_state, state_pass,
    chunk_scan) against its plain version on the plain outputs of the
    passes before it, within ``prefix_tol``; one launch of each, and a
    call of ``wkv6`` launches each once more."""
    from repro_torch.kernels.rwkv6 import ops as wkv_ops
    r, k, v, lw, u, s0 = smoke.wkv6_inputs(case, card, seed=case[1] + case[3])
    before = dict(wkv_ops.PASS_LAUNCHES)
    smoke.wkv6_pass_check((r, k, v, lw, u), dict(chunk=case[4], s0=s0),
                          str(case), "wkv6")
    assert all(wkv_ops.PASS_LAUNCHES[k] == before[k] + 1 for k in before)
    wkv_ops.wkv6(r, k, v, lw, u, chunk=case[4], s0=s0)
    assert all(wkv_ops.PASS_LAUNCHES[k] == before[k] + 2 for k in before)


def test_recurrent_models_on_card_match_cpu(card):
    """zamba2 (one mamba block and the shared block) and rwkv6 (2 layers)
    at full width in float32: prefill of 700 tokens (through the scan
    kernels and flash) and 3 decode steps, logits within 1e-3 of the
    CPU's."""
    smoke.phase_ssm_card_vs_cpu("cuda", seq=700, steps=3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "mixtral-8x7b"])
def test_moe_dispatches_on_card(card, arch, dtype):
    """Both MoE dispatches of one full-width block on 1000 random tokens at
    capacity factor 0.5: some assignments dropped, dense = ragged within
    one bf16 rounding (float32: 1e-5); in float32 also the same routing and
    kept assignments as the CPU's and each dispatch within 1e-4 of it."""
    import dataclasses
    from repro_torch.configs.base import get_config
    from repro_torch.models import moe as MOE
    from repro_torch.models.layers import draw
    cfg = dataclasses.replace(get_config(arch), dtype=dtype,
                              param_dtype=dtype, moe_capacity_factor=0.5)
    gen = torch.Generator().manual_seed(0)
    specs = MOE.moe_init(cfg)
    dt = getattr(torch, dtype)
    cpu_p = {"router": {"w": draw(specs["router"]["w"], gen, dt)},
             **{n: draw(specs[n], gen, dt) for n in ("gate", "up", "down")}}
    x = torch.randn(1000, cfg.d_model, generator=gen).to(dt)
    tol = dict(rtol=2 ** -7, atol=1e-5) if dtype == "bfloat16" else \
        dict(rtol=1e-5, atol=1e-5)
    outs = {}
    for dev in ("cuda", "cpu")[:2 if dtype == "float32" else 1]:
        p = {"router": {"w": cpu_p["router"]["w"].to(dev)},
             **{n: cpu_p[n].to(dev) for n in ("gate", "up", "down")}}
        xd = x.to(dev)
        w, idx, _ = MOE.route(p, cfg, xd)
        dense = MOE.moe_dense_onehot(p, cfg, xd, w, idx)
        ragged = MOE.moe_ragged_sort(p, cfg, xd, w, idx)
        kd = MOE.kept(cfg, idx)
        assert 0 < int((~kd).sum())
        torch.testing.assert_close(dense.float(), ragged.float(), **tol)
        outs[dev] = idx.cpu(), kd.cpu(), dense.cpu(), ragged.cpu()
    if dtype == "float32":
        for a, b in zip(outs["cuda"][:2], outs["cpu"][:2]):
            assert torch.equal(a, b)
        for a, b in zip(outs["cuda"][2:], outs["cpu"][2:]):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_folded_flash_on_card(card, dtype):
    """minicpm3's MLA at full width over 1100 tokens: its heads folded into
    the batch (B*H = 80, Hk = 1, D = 96) through one flash_attention
    launch; output and latent cache within 1e-3 of the CPU's in float32,
    2e-2 in bf16."""
    import dataclasses
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models import attention as TA
    from repro_torch.models.layers import draw
    cfg = dataclasses.replace(get_config("minicpm3-4b"), dtype=dtype,
                              param_dtype=dtype)
    dt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(1)

    def leaves(tree):
        return {k: leaves(v) if isinstance(v, dict) else draw(v, gen, dt)
                for k, v in tree.items()}

    def to(tree, dev):
        return {k: to(v, dev) if isinstance(v, dict) else v.to(dev)
                for k, v in tree.items()}

    cpu_p = leaves(TA.mla_init(cfg))
    x = torch.randn(2, 1100, cfg.d_model, generator=gen).to(dt)
    pos = torch.arange(1100, dtype=torch.int32)[None].expand(2, -1)
    tol = 1e-3 if dtype == "float32" else 2e-2
    before = fa_ops.LAUNCHES
    card_out = TA.mla_forward(to(cpu_p, "cuda"), cfg, x.cuda(), pos.cuda(),
                              return_cache=True)
    assert fa_ops.LAUNCHES == before + 1
    cpu_out = TA.mla_forward(cpu_p, cfg, x, pos, return_cache=True)
    for a, b in ((card_out[0], cpu_out[0]), *zip(card_out[1], cpu_out[1])):
        torch.testing.assert_close(a.float().cpu(), b.float(), rtol=tol,
                                   atol=tol)


def test_block_models_on_card_match_cpu(card):
    """qwen3-moe (both dispatches), minicpm3, llama-vision (attn + cross,
    gate opened) and musicgen at the reduced width in float32: prefill of
    700 tokens (through flash; MLA's folded) and 3 decode steps, logits
    within 1e-3 of the CPU's; then the serve_blocks phase at the reduced
    width on the card (flash launches per prefill counted, prefill + k vs
    decode)."""
    smoke.phase_blocks_card_vs_cpu("cuda", reduced=True, seq=700, steps=3)
    flash, metrics, _ = smoke.phase_serve_blocks("cuda", reduced=True,
                                                 seq=700, steps=4)
    assert set(metrics) == set(smoke.SERVE_BLOCKS)
    assert flash == sum(m["flash_launches"] for m in metrics.values()) > 0


@pytest.mark.parametrize("j", [2, 8, 33])
def test_token_select_one_row_one_draw(card, j):
    """The service's shape: one ``[1, J]`` row and one draw per launch."""
    for seed in range(16):
        shares, qcount, _, _, u = inputs(1, j, 1, seed, card)
        got = tk_ops.token_select(shares, qcount, u)
        lines, _ = parity.compare_token_select(
            got, token_select_ref(shares, qcount, u), shares, qcount, u)
        assert not lines, lines


def test_service_on_card_matches_cpu(card):
    """The presets replayed through the service on the card and on the CPU:
    counts and completion order equal (a themis pick apart only in the edge
    band), one token_select launch per themis pop, and the cross-plane
    ON/OFF shares within the reference's bounds."""
    launched, record, _ = smoke.phase_service("cuda", seconds=3.0,
                                              reqs_per_round=4, reps=5)
    assert launched > 0 and record["service_shape"] == [1, 8]


@pytest.mark.parametrize("scheduler", ("themis", "fifo"))
def test_scenario_run_on_card_matches_cpu(card, scheduler):
    """A phased preset (the burster idle in the middle third), compressed
    to 0.6 s and stepped on the card and on the CPU in lockstep: every
    integer counter equal at every tick, themis's picks included (0 draws
    excused)."""
    from repro_torch.api import Experiment
    from repro_torch.scenario import PRESET_SECONDS, Scenario, preset, scale
    tree = scale(preset("bursty-interferer").tree, time=0.6 / PRESET_SECONDS)

    def make(dev):
        return Experiment.from_scenario(
            Scenario(tree=tree), policy="job-fair", scheduler=scheduler,
            n_workers=2, device=dev)

    got, want = smoke.lockstep(scheduler, "fused", card, 600, make=make)
    assert want.t == 600 and int(want.completed[:, 1].sum()) > 0
    assert smoke.int_leaves_equal(got, want) is None


def test_poisson_and_log_on_card_equal_cpu(card):
    """XLA's float32 log/log1p expansions and the Poisson sampler at the
    rates of tests/test_torch_prng.py (2e4 and 1e5 included) give the same
    bits on the card as on the CPU, which equal jax's there."""
    from repro_torch.core import prng
    x = np.arange(0, 2 ** 32, 4093, dtype=np.uint64).astype(np.uint32).view(
        np.float32)
    xt = torch.from_numpy(x.copy())
    for fn in (prng.log_f32, prng.log1p_f32):
        a, b = fn(xt.to(card)).cpu().numpy(), fn(xt).numpy()
        same = (a.view(np.uint32) == b.view(np.uint32)) | (
            np.isnan(a) & np.isnan(b))
        assert same.all(), x[~same][:10]
    rates = (0.0, 0.05, 0.7, 3.0, 9.9, 10.0, 10.5, 37.0, 400.0, 2e4, 1e5)
    lam = torch.tensor(rates, dtype=torch.float32)[:, None].repeat(1, 2000)
    for seed in (0, 7):
        kw = dict(knuth_iters=prng.poisson_iters(9.9, 5 * 2000),
                  rejection_iters=prng.rejection_iters(lam.numel()))
        got, unf = prng.poisson(prng.PRNGKey(seed, card), lam.to(card), **kw)
        want, _ = prng.poisson(prng.PRNGKey(seed), lam, **kw)
        assert not bool(unf)
        assert int((got.cpu() != want).sum()) == 0


@pytest.mark.parametrize("preset", ("bb-heavy", "longtail", "mixed"))
def test_batch_plane_on_card_equals_cpu(card, preset):
    """``schedule_order`` (FCFS and a batch of random orders) and
    ``plan_schedule`` give the CPU's bits on the card; exp_f32 and pow_f32
    too."""
    from repro_torch.batch import PlanOptParams, plan_schedule, queue_preset
    from repro_torch.batch.sim import (queue_columns, schedule_order,
                                       simulate_fcfs)
    from repro_torch.core import prng
    q = queue_preset(preset, n_jobs=24, seed=3)
    np.testing.assert_array_equal(simulate_fcfs(q, device=card),
                                  simulate_fcfs(q, device="cpu"))
    rng = np.random.default_rng(1)
    orders = torch.from_numpy(np.stack([rng.permutation(24)
                                        for _ in range(4)]))
    args = (q.cluster.n_nodes, q.cluster.bb_total)
    got = schedule_order(orders.to(card), queue_columns(q, card), *args)
    want = schedule_order(orders, queue_columns(q, "cpu"), *args)
    assert got.cpu().numpy().tobytes() == want.numpy().tobytes()
    p = PlanOptParams(sa_steps=60, lookahead_s=4000.0)
    s_card, o_card, c_card = plan_schedule(q, p, seed=5, device=card)
    s_cpu, o_cpu, c_cpu = plan_schedule(q, p, seed=5, device="cpu")
    assert o_card.tolist() == o_cpu.tolist() and c_card == c_cpu
    assert s_card.tobytes() == s_cpu.tobytes()
    # The steps recorded by the card's CUDA graph equal the CPU's.
    from repro_torch.batch.plan import anneal, plan_window
    from repro_torch.batch.sim import arrival_order
    order0 = torch.from_numpy(arrival_order(q))
    recs = [anneal(order0.to(dev), queue_columns(q, dev), *args, p, 5,
                   plan_window(q, p), record=True)[2] for dev in (card, "cpu")]
    for f, v in recs[1].items():
        assert torch.equal(recs[0][f].cpu(), v), f
    x = torch.from_numpy(np.arange(0, 2 ** 32, 4093, dtype=np.uint64)
                         .astype(np.uint32).view(np.float32).copy())
    a, b = prng.exp_f32(x.to(card)).cpu().numpy(), prng.exp_f32(x).numpy()
    assert ((a.view(np.uint32) == b.view(np.uint32))
            | (np.isnan(a) & np.isnan(b))).all()
    base = x[(x >= 0) & (x <= 1)]
    for s in (1.0, 299.0, 4000.0):
        e = torch.full_like(base, s)
        assert torch.equal(prng.pow_f32(base.to(card), e.to(card)).cpu(),
                           prng.pow_f32(base, e))


def test_workspace_sweep_resume_and_solo_on_card(card):
    """docs/workspace.md's sweep interrupted by max_chunks, resumed and
    reused on the card (merged = plain bit for bit), and a cached themis
    solo (chip_smoke.phase_workspace at 0.3 s)."""
    launches = smoke.phase_workspace(card, seconds=0.3, solo_seconds=0.3)
    assert launches["tick_step[themis]"] == 300
