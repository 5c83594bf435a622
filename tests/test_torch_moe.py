"""The port's Mixture-of-Experts FFN (``repro_torch.models.moe``) against
the JAX package's, on the CPU.

Both routers (mixtral's top-k softmax, qwen3-moe's softmax then top-k with
renorm), the capacity, each dispatch alone and against the other, the
group-local dispatch and a capacity that drops assignments run on the same
numpy inputs and the reference's parameters, in float32 at the reduced
configs.  Tolerance 2e-5 unless a case states otherwise; expert indices
and kept assignments are compared exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as ref_get_config
from repro.models import moe as RMOE
from repro_torch.configs import base as tcfg
from repro_torch.core import convert
from repro_torch.models import moe as TMOE
from repro_torch.models.layers import draw

ARCHS = ("qwen3-moe-30b-a3b", "mixtral-8x7b")
F32_TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **tol)


def cfgs(arch, **kw):
    return (dataclasses.replace(ref_get_config(arch, reduced=True), **kw),
            dataclasses.replace(tcfg.get_config(arch, reduced=True), **kw))


def tokens_in(cfg, t, seed):
    return np.random.default_rng(seed).standard_normal(
        (t, cfg.d_model)).astype(np.float32)


@pytest.fixture(scope="module", params=ARCHS)
def moe_setup(request):
    """The reference's MoE parameters (float32) for one arch, as numpy and
    as the port's tensors, and its jitted route / dispatches."""
    rcfg, cfg = cfgs(request.param)
    ref_p = jax.tree.map(np.asarray, RMOE.moe_init(jax.random.PRNGKey(7),
                                                   rcfg, jnp.float32))
    ref = dict(
        route=jax.jit(lambda p, x: RMOE.route(p, rcfg, x)),
        dense_onehot=jax.jit(lambda p, x, w, i: RMOE.moe_dense_onehot(
            p, rcfg, x, w, i)),
        ragged_sort=jax.jit(lambda p, x, w, i: RMOE.moe_ragged_sort(
            p, rcfg, x, w, i)))
    return rcfg, cfg, ref_p, convert.caches_from_numpy(ref_p), ref


def test_route_both_routers(moe_setup):
    """Weights 2e-5, expert indices exact, aux loss 2e-5."""
    rcfg, cfg, ref_p, p, ref = moe_setup
    x = tokens_in(cfg, 120, seed=1)
    rw, ridx, raux = ref["route"](ref_p, jnp.asarray(x))
    w, idx, aux = TMOE.route(p, cfg, torch.as_tensor(x))
    assert idx.dtype == torch.int32 and w.dtype == torch.float32
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ridx))
    close(w, rw, **F32_TOL)
    close(aux, raux, **F32_TOL)
    assert cfg.moe_router == ("topk_softmax" if cfg.name == "mixtral-8x7b"
                              else "softmax_topk")


def test_top_k_orders_ties_by_index():
    x = torch.tensor([[1.0, 3.0, 3.0, 2.0, 3.0]])
    vals, idx = TMOE.top_k(x, 3)
    rv, ri = jax.lax.top_k(jnp.asarray(x.numpy()), 3)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(rv))


@pytest.mark.parametrize("t", [1, 2, 7, 32, 33, 96, 1000, 12000])
def test_capacity(t):
    for arch in ARCHS:
        rcfg, cfg = cfgs(arch)
        assert TMOE._capacity(cfg, t) == RMOE._capacity(rcfg, t)
        rcfg, cfg = (dataclasses.replace(c, n_experts=128, top_k=8)
                     for c in (rcfg, cfg))
        assert TMOE._capacity(cfg, t) == RMOE._capacity(rcfg, t)


@pytest.mark.parametrize("dispatch", ["dense_onehot", "ragged_sort"])
def test_dispatch_matches_reference(moe_setup, dispatch):
    """Each dispatch alone on the reference's routing of 96 tokens: 2e-5."""
    rcfg, cfg, ref_p, p, ref = moe_setup
    x = tokens_in(cfg, 96, seed=2)
    rw, ridx, _ = ref["route"](ref_p, jnp.asarray(x))
    want = ref[dispatch](ref_p, jnp.asarray(x), rw, ridx)
    fn = {"dense_onehot": TMOE.moe_dense_onehot,
          "ragged_sort": TMOE.moe_ragged_sort}[dispatch]
    got = fn(p, cfg, torch.as_tensor(x), torch.tensor(np.asarray(rw)),
             torch.tensor(np.asarray(ridx)))
    close(got, want, **F32_TOL)


def drops(rcfg, idx):
    """The reference's kept assignments, from its own position rule
    (dense_onehot's cumulative count over the flattened stream)."""
    t, k = idx.shape
    oh = np.asarray(jax.nn.one_hot(idx, rcfg.n_experts)).reshape(t * k, -1)
    pos = ((np.cumsum(oh, 0) - oh) * oh).sum(-1).reshape(t, k)
    return pos < RMOE._capacity(rcfg, t)


@pytest.mark.parametrize("factor", [1.25, 0.5])
def test_dense_equals_ragged_and_drops(moe_setup, factor):
    """The two dispatches on the same routing: ``moe.kept`` is the
    reference's rule, outputs within 2e-5 (a differing kept set would move
    a whole expert's term).  At a capacity factor of 0.5 some assignments
    must be dropped, and a dropped token's output lacks exactly that
    expert's term."""
    rcfg, cfg, ref_p, p, _ = moe_setup
    rcfg, cfg = (dataclasses.replace(c, moe_capacity_factor=factor)
                 for c in (rcfg, cfg))
    x = torch.as_tensor(tokens_in(cfg, 160, seed=3))
    w, idx, _ = TMOE.route(p, cfg, x)
    keep = TMOE.kept(cfg, idx)
    np.testing.assert_array_equal(keep.numpy(), drops(rcfg, idx.numpy()))
    if factor < 1:
        assert 0 < int((~keep).sum()) < keep.numel()
    dense = TMOE.moe_dense_onehot(p, cfg, x, w, idx)
    ragged = TMOE.moe_ragged_sort(p, cfg, x, w, idx)
    close(dense, ragged, **F32_TOL)
    want = RMOE.moe_ragged_sort(ref_p, rcfg, jnp.asarray(x.numpy()),
                                jnp.asarray(w.numpy()),
                                jnp.asarray(idx.numpy()))
    close(ragged, want, **F32_TOL)
    # Each token's output: the sum of its kept experts' weighted FFNs.
    t = int(torch.nonzero(~keep.all(1))[0]) if factor < 1 else 0
    ffn = [TMOE._expert_ffn(p, x[t][None, None].expand(cfg.n_experts, 1, -1)
                            .contiguous())[e, 0] for e in idx[t].tolist()]
    want_t = sum(float(w[t, j]) * ffn[j] for j in range(cfg.top_k)
                 if keep[t, j])
    close(dense[t], want_t, **F32_TOL)


@pytest.mark.parametrize("dispatch", ["dense_onehot", "ragged_sort"])
def test_moe_forward_with_local_groups(moe_setup, dispatch):
    """moe_forward at moe_local_groups = 1 and 2 against the reference's
    (its vmap over groups): outputs 2e-5, aux 2e-5; with two groups each
    has its own capacity, so the output differs from one group's."""
    rcfg, cfg, ref_p, p, _ = moe_setup
    x = np.random.default_rng(4).standard_normal(
        (2, 200, cfg.d_model)).astype(np.float32)
    outs = {}
    for g in (1, 2):
        rc, c = (dataclasses.replace(k, moe_dispatch=dispatch,
                                     moe_local_groups=g,
                                     moe_capacity_factor=0.75)
                 for k in (rcfg, cfg))
        ry, raux = RMOE.moe_forward(ref_p, rc, jnp.asarray(x))
        y, aux = TMOE.moe_forward(p, c, torch.as_tensor(x))
        assert y.shape == x.shape and aux.dtype == torch.float32
        close(y, ry, **F32_TOL)
        close(aux, raux, **F32_TOL)
        outs[g] = y
    assert not torch.equal(outs[1], outs[2])


def test_moe_bf16_dispatches_agree():
    """In bf16 the two dispatches feed the experts the same buffers and add
    the same float32 terms in other orders: outputs within one bf16
    rounding (2^-7 relative, 1e-6 absolute)."""
    cfg = dataclasses.replace(tcfg.get_config(ARCHS[0], reduced=True),
                              dtype="bfloat16", param_dtype="bfloat16",
                              moe_capacity_factor=0.5)
    gen = torch.Generator().manual_seed(3)
    specs = TMOE.moe_init(cfg)
    p = {"router": {"w": draw(specs["router"]["w"], gen, torch.bfloat16)},
         **{n: draw(specs[n], gen, torch.bfloat16)
            for n in ("gate", "up", "down")}}
    x = torch.as_tensor(tokens_in(cfg, 200, seed=5)).to(torch.bfloat16)
    w, idx, _ = TMOE.route(p, cfg, x)
    dense = TMOE.moe_dense_onehot(p, cfg, x, w, idx)
    ragged = TMOE.moe_ragged_sort(p, cfg, x, w, idx)
    assert dense.dtype == torch.bfloat16
    torch.testing.assert_close(dense.float(), ragged.float(), rtol=2 ** -7,
                               atol=1e-6)
