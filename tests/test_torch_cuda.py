"""The port's CUDA kernels and engine on the card (marker ``cuda``).

Skipped without a CUDA card.  On the card::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Kernels are held to their plain versions with the tolerance of
``repro_torch.kernels.parity``; the engine's fused and scan paths must agree
bit for bit in integer state, and the engine on the card must agree with
the engine on the CPU (``chip_smoke.phase_card_vs_cpu``)."""
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
    _, err = parity.compare_token_select(
        got, token_select_ref(shares, qcount, u), shares, qcount, u)
    assert err == 0
    for mode in ("themis", "fifo"):
        got = ts_ops.tick_step(shares, qcount, window, free, u, mode=mode)
        torch.cuda.synchronize()
        want = tick_step_ref(shares, qcount, window, free, u, mode=mode)
        _, err = parity.compare_tick_step(got, want, shares, qcount, u, mode)
        assert err == 0


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
    """fifo counter-exact on every tick on both worker paths; themis
    counter-exact until a flipped edge-band pick, then within 2 %."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    smoke.phase_card_vs_cpu("cuda", ticks=300)
