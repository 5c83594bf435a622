"""Plain versions of the port's kernels against the JAX functions.

The same numpy inputs go through the port's wrappers (on CPU tensors they
run the plain PyTorch versions) and through the reference's
``token_select`` / ``tick_step`` with ``impl="pallas"`` (the Pallas kernel in
interpret mode) and ``impl="ref"``.  fifo and every integer output must be
exact; a themis pick may differ only where ``u`` lies within ``J * 2**-24``
of a float64 segment end (``repro_torch.kernels.parity``), and such draws are
counted.  The card's kernels are held to the same plain versions by
``chip_smoke.py`` and ``tests/test_torch_cuda.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.tick_step.ops import tick_step as ref_tick_step
from repro.kernels.token_select.ops import token_select as ref_token_select
from repro_torch.kernels import _build, parity
from repro_torch.kernels.tick_step import ops as ts_ops
from repro_torch.kernels.token_select import ops as tk_ops

JS = (16, 127, 128, 129, 1024)
EDGE = ("random", "zero-shares", "single-live", "no-demand")
MODES = ("themis", "fifo")


def make_inputs(s, j, w, seed, case="random"):
    rng = np.random.default_rng(seed)
    shares = rng.random((s, j), dtype=np.float32)
    qcount = rng.integers(0, 4, (s, j)).astype(np.int32)
    qcount[rng.random((s, j)) < 0.4] = 0
    if case == "zero-shares":
        shares[:] = 0
    elif case == "single-live":
        qcount[:] = 0
        qcount[np.arange(s), rng.integers(0, j, s)] = 2
    elif case == "no-demand":
        qcount[:] = 0
    window = np.cumsum(rng.random((s, j, w), dtype=np.float32), axis=-1)
    window = (np.floor(window * 4) / 4).astype(np.float32)   # FIFO ties
    free = rng.random((s, w)) < 0.8
    u = rng.random((s, w), dtype=np.float32)
    return shares, qcount, window, free, u


def torch_of(*arrays):
    return [torch.as_tensor(a) for a in arrays]


def token_select_vs_jax(j, case):
    """The port's token_select on one case against both JAX impls:
    (picks, input tensors, edge-band draws excused per impl)."""
    shares, qcount, _, _, u = make_inputs(4, j, 4, seed=j, case=case)
    ts, tq, tu = torch_of(shares, qcount, u)
    before = tk_ops.LAUNCHES
    got = tk_ops.token_select(ts, tq, tu)
    assert tk_ops.LAUNCHES == before          # CPU: plain version, no launch
    excused = []
    for impl in ("pallas", "ref"):
        want = torch.as_tensor(np.array(ref_token_select(
            jnp.asarray(shares), jnp.asarray(qcount), jnp.asarray(u),
            impl=impl)))
        lines, err = parity.compare_token_select(got, want, ts, tq, tu)
        assert err == 0
        excused.append(len(lines))
    return got, (ts, tq, tu), excused


def tick_step_vs_jax(j, case, mode):
    """The port's tick_step on one case against both JAX impls: edge-band
    rows excused per impl."""
    arrays = make_inputs(3, j, 4, seed=1000 + j, case=case)
    tensors = torch_of(*arrays)
    before = ts_ops.LAUNCHES
    got = ts_ops.tick_step(*tensors, mode=mode)
    assert ts_ops.LAUNCHES == before
    excused = []
    for impl in ("pallas", "ref"):
        want = [torch.as_tensor(np.array(x)) for x in ref_tick_step(
            *(jnp.asarray(a) for a in arrays), mode=mode, impl=impl)]
        lines, err = parity.compare_tick_step(got, want, tensors[0],
                                              tensors[1], tensors[4], mode)
        assert err == 0
        excused.append(len(lines))
    return excused


@pytest.mark.parametrize("case", EDGE)
@pytest.mark.parametrize("j", JS)
def test_token_select_matches_jax(j, case):
    got, (ts, tq, tu), _ = token_select_vs_jax(j, case)
    assert got.dtype == torch.int32 and got.shape == (4, 4)
    if case == "no-demand":
        assert (got == -1).all()
    if case == "single-live":
        assert (tq.gather(1, got.long()) > 0).all()


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", EDGE)
@pytest.mark.parametrize("j", JS)
def test_tick_step_matches_jax(j, case, mode):
    tick_step_vs_jax(j, case, mode)


@pytest.mark.parametrize("mode", MODES)
def test_tick_step_conservation(mode):
    shares, qcount, window, free, u = torch_of(*make_inputs(6, 40, 6, seed=5))
    sel, valid, dany, qout, pops = ts_ops.tick_step(shares, qcount, window,
                                                    free, u, mode=mode)
    assert (qout >= 0).all()
    assert torch.equal(qout + pops, qcount)
    assert int(pops.sum(dim=-1).max()) <= 6
    assert torch.equal(pops.sum(dim=-1), valid.sum(dim=-1).to(torch.int32))
    assert not (valid & ~free).any()
    assert ((sel >= 0) == dany).all()


def test_fifo_ties_break_to_lowest_job():
    shares = torch.zeros(1, 5)
    qcount = torch.tensor([[0, 2, 1, 3, 0]], dtype=torch.int32)
    window = torch.full((1, 5, 3), 7.0)
    window[0, 3, 0] = 5.0
    free = torch.ones(1, 3, dtype=torch.bool)
    u = torch.zeros(1, 3)
    sel = ts_ops.tick_step(shares, qcount, window, free, u, mode="fifo")[0]
    # job 3 holds the earliest stamp; then 1 and 2 tie at 7.0 -> lowest j.
    assert sel.tolist() == [[3, 1, 1]]


def test_parity_excuses_only_edge_band_draws():
    """A pick may differ where u sits on a segment end (0.5 here), and
    nowhere else; each excused draw is named."""
    shares = torch.tensor([[0.5, 0.5]])
    qcount = torch.tensor([[1, 1]], dtype=torch.int32)
    u = torch.tensor([[0.5, 0.1]])
    want = tk_ops.token_select(shares, qcount, u)
    assert want.tolist() == [[1, 0]]
    got = torch.tensor([[0, 0]], dtype=torch.int32)
    excused, err = parity.compare_token_select(got, want, shares, qcount, u)
    assert err == 0 and len(excused) == 1 and "draw 0" in excused[0]
    with pytest.raises(AssertionError, match="outside the edge band"):
        parity.compare_token_select(torch.tensor([[1, 1]], dtype=torch.int32),
                                    want, shares, qcount, u)

    window = torch.zeros(1, 2, 2)
    free = torch.ones(1, 2, dtype=torch.bool)
    want = ts_ops.tick_step(shares, qcount, window, free, u, mode="themis")
    flipped = [t.clone() for t in want]
    flipped[0][0, 0] = 0      # first pick flipped on the edge: row excused
    excused, _ = parity.compare_tick_step(flipped, want, shares, qcount, u,
                                          "themis")
    assert len(excused) == 1
    with pytest.raises(AssertionError):
        parity.compare_tick_step(flipped, want, shares, qcount, u, "fifo")


def test_parity_band_spans_two_share_tables():
    """Share tables computed apart (card and CPU engines) excuse a draw
    that lies between their segment ends, and only with both tables."""
    shares = torch.tensor([[0.5, 0.5]])
    other = torch.tensor([[0.52, 0.48]])
    qcount = torch.tensor([[1, 1]], dtype=torch.int32)
    u = torch.tensor([[0.51, 0.9]])
    band = parity.edge_band(shares, qcount, u, other_shares=other)
    assert band.tolist() == [[True, False]]
    assert not parity.edge_band(shares, qcount, u).any()
    got = torch.tensor([[0, 1]], dtype=torch.int32)
    want = torch.tensor([[1, 1]], dtype=torch.int32)
    excused, err = parity.compare_token_select(got, want, shares, qcount, u,
                                               other_shares=other)
    assert len(excused) == 1 and err == 0
    with pytest.raises(AssertionError, match="outside the edge band"):
        parity.compare_token_select(got, want, shares, qcount, u)


def test_excused_edge_band_draws_are_rare():
    """Edge-band draws excused over every case of the two tests above,
    counted here (exact agreement is expected almost everywhere)."""
    counts = []
    for j in JS:
        for case in EDGE:
            counts += token_select_vs_jax(j, case)[2]
            for mode in MODES:
                counts += tick_step_vs_jax(j, case, mode)
    total = sum(counts)
    print(f"edge-band draws excused across {len(counts)} comparisons: {total}")
    assert len(counts) == 2 * len(JS) * len(EDGE) * (1 + len(MODES))
    assert total <= max(1, len(counts) // 20)


def test_build_paths_stay_in_the_checkout(monkeypatch, tmp_path):
    path = _build.lib_path("tick_step")
    assert path.parent == _build.build_dir()
    assert path.name.startswith("tick_step-") and path.suffix == ".so"
    assert path == _build.lib_path("tick_step")          # stable digest
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path))
    assert _build.lib_path("token_select").parent == tmp_path
    with pytest.raises(ValueError):
        _build.lib_path("no_such_kernel")
