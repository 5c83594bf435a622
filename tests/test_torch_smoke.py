"""The checks of ``chip_smoke.py`` that run without a card, on the CPU.

The lockstep harness of its ``card_vs_cpu`` phase, the way it names the
pick that made a card tick differ from the CPU's, and the bytes its kernel
bounds count.  The phases themselves run on the card
(``python3 chip_smoke.py``, ``tests/test_torch_cuda.py``)."""
import importlib.util
from pathlib import Path

import pytest
import torch

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)


@pytest.mark.parametrize("impl", ("fused", "scan"))
@pytest.mark.parametrize("scheduler", ("fifo", "themis"))
def test_lockstep_cpu_against_cpu_never_differs(scheduler, impl):
    from repro_torch.core import engine, tokens
    saved = engine.tick_step, tokens.token_select
    flip, why, a, b = smoke.lockstep(scheduler, impl, "cpu", 80)
    assert (flip, why) == (None, None)
    assert a.t == b.t == 80 and int(b.completed.sum()) > 0
    assert smoke.int_leaves_equal(a, b) is None
    assert (engine.tick_step, tokens.token_select) == saved   # unpatched


def draw_call(shares, qcount, u, picks):
    return ("token_select", [shares, qcount, u],
            [torch.tensor(picks, dtype=torch.int32)], "themis")


def test_explain_divergence_names_the_edge_band_pick():
    qcount = torch.tensor([[1, 1]], dtype=torch.int32)
    u = torch.tensor([[0.5]])
    cpu = draw_call(torch.tensor([[0.5, 0.5]]), qcount, u, [[1]])
    card = draw_call(torch.tensor([[0.5, 0.5000001]]), qcount, u, [[0]])
    agree = draw_call(torch.tensor([[0.5, 0.5]]), qcount, u, [[1]])
    why = smoke.explain_divergence([agree, card], [agree, cpu])
    assert why.startswith("token_select themis: row 0, draw 0: got 0")


def test_explain_divergence_refuses_other_faults():
    qcount = torch.tensor([[1, 1]], dtype=torch.int32)
    shares = torch.tensor([[0.5, 0.5]])
    cpu = draw_call(shares, qcount, torch.tensor([[0.1]]), [[0]])
    with pytest.raises(AssertionError, match="outside the edge band"):
        smoke.explain_divergence(
            [draw_call(shares, qcount, torch.tensor([[0.1]]), [[1]])], [cpu])
    with pytest.raises(AssertionError, match="inputs differ"):
        smoke.explain_divergence(
            [draw_call(shares, qcount, torch.tensor([[0.2]]), [[0]])], [cpu])
    with pytest.raises(AssertionError, match="shares differ"):
        smoke.explain_divergence(
            [draw_call(torch.tensor([[0.6, 0.4]]), qcount,
                       torch.tensor([[0.1]]), [[0]])], [cpu])
    with pytest.raises(AssertionError, match="every kernel call agreed"):
        smoke.explain_divergence([cpu], [cpu])


def test_needed_bytes_count_only_what_each_mode_reads():
    s, j, w = 2, 4, 3
    qcount = torch.tensor([[0, 2, 1, 0], [5, 0, 0, 0]], dtype=torch.int32)
    u = torch.zeros(s, w)
    out = s * w * 6 + s * j * 8
    # themis: qcount, the shares of the 3 demanded slots, free and u.
    assert smoke.needed_bytes("tick_step", qcount, u) \
        == s * j * 4 + 3 * 4 + s * w * 5 + out
    # fifo: qcount, free and the stamps min(pops + 1, qcount) per slot.
    pops = torch.tensor([[0, 2, 0, 0], [1, 0, 0, 0]], dtype=torch.int32)
    assert smoke.needed_bytes("tick_step", qcount, u, mode="fifo", pops=pops) \
        == s * j * 4 + (2 + 1 + 2) * 4 + s * w + out
    assert smoke.needed_bytes("token_select", qcount, u) \
        == s * j * 4 + 3 * 4 + 2 * s * w * 4

