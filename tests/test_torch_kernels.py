"""Plain versions of the port's kernels against the JAX functions.

The same numpy inputs go through the port's wrappers (on CPU tensors they
run the plain PyTorch versions) and through the reference's
``token_select`` / ``tick_step`` with ``impl="pallas"`` (the Pallas kernel in
interpret mode) and ``impl="ref"``.  fifo and every integer output must be
exact; a themis pick may differ only where ``u`` lies within ``J * 2**-24``
of a float64 segment end (``repro_torch.kernels.parity``), and such draws are
counted.  With bf16 shares both sides renormalise and prefix-sum in bf16,
the port in the reference's order (``repro_torch.core.ordered``), so the
bf16 draws are held to the same band with ``J * 2**-8``
(``parity.UNIT_ROUNDOFF``) and must need none of it.  The card's kernels
are held to the same plain versions by ``chip_smoke.py`` and
``tests/test_torch_cuda.py``."""
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
IMPLS = ("pallas", "ref")


@pytest.fixture(scope="module")
def reference():
    """The reference's outputs as numpy arrays, each case run (and its
    shapes compiled) once per module: ``reference(kernel, arrays, impl,
    mode)``, keyed by the caller's case key."""
    cache = {}

    def run(key, kernel, arrays, impl, mode=None):
        if (key, impl) not in cache:
            jx = [jnp.asarray(a) for a in arrays]
            if kernel == "token_select":
                out = [ref_token_select(*jx, impl=impl)]
            else:
                out = ref_tick_step(*jx, mode=mode, impl=impl)
            cache[key, impl] = [np.array(x) for x in out]
        return [torch.as_tensor(x) for x in cache[key, impl]]
    return run


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


def with_dtype(shares, tensors, dtype):
    """(numpy shares for JAX, torch tensors for the port) with the shares
    rounded to ``dtype`` once, so both sides see the same values."""
    if dtype == "float32":
        return shares, tensors
    t = torch.as_tensor(shares).to(torch.bfloat16)
    return (jnp.asarray(t.float().numpy()).astype(jnp.bfloat16),
            [t, *tensors[1:]])


def token_select_vs_jax(reference, j, case, dtype="float32"):
    """The port's token_select on one case against both JAX impls:
    (picks, input tensors, edge-band draws excused per impl)."""
    shares, qcount, _, _, u = make_inputs(4, j, 4, seed=j, case=case)
    jshares, (ts, tq, tu) = with_dtype(shares, torch_of(shares, qcount, u),
                                       dtype)
    before = tk_ops.LAUNCHES
    got = tk_ops.token_select(ts, tq, tu)
    assert tk_ops.LAUNCHES == before          # CPU: plain version, no launch
    excused = []
    for impl in IMPLS:
        want, = reference(("token_select", j, case, dtype), "token_select",
                          (jshares, qcount, u), impl)
        lines, err = parity.compare_token_select(
            got, want, ts.float(), tq, tu, sum_dtype=getattr(torch, dtype))
        assert err == 0
        excused.append(len(lines))
    return got, (ts, tq, tu), excused


def tick_step_vs_jax(reference, j, case, mode, dtype="float32"):
    """The port's tick_step on one case against both JAX impls: edge-band
    rows excused per impl."""
    arrays = make_inputs(3, j, 4, seed=1000 + j, case=case)
    jshares, tensors = with_dtype(arrays[0], torch_of(*arrays), dtype)
    before = ts_ops.LAUNCHES
    got = ts_ops.tick_step(*tensors, mode=mode)
    assert ts_ops.LAUNCHES == before
    excused = []
    for impl in IMPLS:
        want = reference(("tick_step", j, case, mode, dtype), "tick_step",
                         (jshares, *arrays[1:]), impl, mode)
        lines, err = parity.compare_tick_step(
            got, want, tensors[0].float(), tensors[1], tensors[4], mode,
            sum_dtype=getattr(torch, dtype))
        assert err == 0
        excused.append(len(lines))
    return excused


def check_picks(got, tq, case):
    assert got.dtype == torch.int32 and got.shape == (4, 4)
    if case == "no-demand":
        assert (got == -1).all()
    if case == "single-live":
        assert (tq.gather(1, got.long()) > 0).all()


@pytest.mark.parametrize("case", EDGE)
@pytest.mark.parametrize("j", JS)
def test_token_select_matches_jax(reference, j, case):
    got, (ts, tq, tu), _ = token_select_vs_jax(reference, j, case)
    check_picks(got, tq, case)


@pytest.mark.parametrize("case", EDGE)
@pytest.mark.parametrize("j", JS)
def test_token_select_bf16_shares_match_jax(reference, j, case):
    """bf16 shares: the plain version draws in bf16 as the reference does,
    pick for pick (no draw excused)."""
    got, (ts, tq, tu), excused = token_select_vs_jax(reference, j, case,
                                                     "bfloat16")
    assert ts.dtype == torch.bfloat16
    check_picks(got, tq, case)
    assert excused == [0, 0]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", EDGE)
@pytest.mark.parametrize("j", JS)
def test_tick_step_matches_jax(reference, j, case, mode):
    tick_step_vs_jax(reference, j, case, mode)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", EDGE)
@pytest.mark.parametrize("j", JS)
def test_tick_step_bf16_shares_match_jax(reference, j, case, mode):
    """bf16 shares through the fused tick: fifo and themis exact."""
    assert tick_step_vs_jax(reference, j, case, mode, "bfloat16") == [0, 0]


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


def excused_counts(reference, dtype):
    """Edge-band draws excused per comparison over every case of the
    token_select and tick_step tests in ``dtype``."""
    counts = []
    for j in JS:
        for case in EDGE:
            counts += token_select_vs_jax(reference, j, case, dtype)[2]
            for mode in MODES:
                counts += tick_step_vs_jax(reference, j, case, mode, dtype)
    assert len(counts) == 2 * len(JS) * len(EDGE) * (1 + len(MODES))
    return counts


def test_excused_edge_band_draws_are_rare(reference):
    """Edge-band draws excused over every case of the two tests above,
    counted here (exact agreement is expected almost everywhere)."""
    counts = excused_counts(reference, "float32")
    total = sum(counts)
    print(f"edge-band draws excused across {len(counts)} comparisons: {total}")
    assert total <= max(1, len(counts) // 20)


def test_excused_bf16_edge_band_draws_are_counted(reference):
    """bf16 shares: the plain versions renormalise and prefix-sum in bf16 in
    the reference's order (windows of 32 for the totals, blocks of 16 for
    the prefix sums, each partial sum rounded where XLA rounds it), so no
    draw needs the edge band, at any J (a float32 draw of the same shares
    differed from the reference in 48 of 640 token_select draws and 20 of
    120 themis rows here)."""
    per_j = {}
    draws = rows = 0
    for j in JS:
        n = [0, 0, 0]
        for case in EDGE:
            n[0] += sum(token_select_vs_jax(reference, j, case,
                                            "bfloat16")[2])
            for m, mode in enumerate(MODES):
                n[1 + m] += sum(tick_step_vs_jax(reference, j, case, mode,
                                                 "bfloat16"))
        per_j[j] = n
        draws += len(IMPLS) * len(EDGE) * 4 * 4
        rows += len(IMPLS) * len(EDGE) * 3
    print("bf16 excused (token_select draws, themis rows, fifo rows) per J:",
          per_j)
    assert draws and rows
    assert all(n == [0, 0, 0] for n in per_j.values())


def test_build_paths_stay_in_the_checkout(monkeypatch, tmp_path):
    path = _build.lib_path("tick_step")
    assert path.parent == _build.build_dir()
    assert path.name.startswith("tick_step-") and path.suffix == ".so"
    assert path == _build.lib_path("tick_step")          # stable digest
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path))
    assert _build.lib_path("token_select").parent == tmp_path
    with pytest.raises(ValueError):
        _build.lib_path("no_such_kernel")
