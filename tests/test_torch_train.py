"""The port's loss, gradients, AdamW and train step against the JAX
package, on the CPU.

The same numpy inputs and the reference's parameters (carried across with
``repro_torch.core.convert.params_from_numpy`` / ``train_state_from_numpy``)
go through the reference's jitted functions and the port's, in float32 at
reduced size with tiles of 32, so that every self-attention block runs
``blocked_attention`` and its backward.  Tolerances are stated where each
comparison is made.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as ref_get_config
from repro.models import model as RM
from repro.train import optimizer as RO
from repro.train import train_step as RT
from repro_torch.configs import base as tcfg
from repro_torch.core import convert
from repro_torch.models import model as TM
from repro_torch.train import optimizer as TO
from repro_torch.train import train_step as TT

ARCHS = ("h2o-danube-1.8b", "qwen3-32b", "gemma3-4b", "zamba2-2.7b",
         "rwkv6-7b", "qwen3-moe-30b-a3b", "mixtral-8x7b", "minicpm3-4b",
         "llama-3.2-vision-11b", "musicgen-medium")
SEQ = 64
TILES = dict(block_q=32, block_k=32, loss_chunk=32)
#: The loss: float32 sums in other orders over a few layers.
LOSS_RTOL = 1e-5
#: Each gradient leaf: max abs error over the leaf's max abs value.
GRAD_TOL = 1e-4
#: zamba2 and rwkv6: their gradients run back through the scans' chunk
#: products and in-chunk prefix sums of the log decay, summed in another
#: order by autograd than by jax.grad (measured worst 1.2e-4, zamba2's
#: in_proj, spread evenly over its columns).
SCAN_GRAD_TOL = 3e-4
#: bf16 parameters and activations (danube reduced): both sides round each
#: product and activation to bf16 (2^-8 relative) at other points.  The
#: loss to rel 5e-4 (measured worst 1.5e-4 over three seeds), each gradient
#: leaf within 4e-2 of the leaf's max (measured worst 2.6e-2, a few bf16
#: steps of the max; a wrong cast or a float32 master copy is off by O(1)).
BF16_LOSS_RTOL = 5e-4
BF16_GRAD_TOL = 4e-2


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def cfgs(arch, **kw):
    kw = {**TILES, **kw}
    return (dataclasses.replace(ref_get_config(arch, reduced=True), **kw),
            dataclasses.replace(tcfg.get_config(arch, reduced=True), **kw))


def ref_params(cfg, seed=0):
    """Parameters as the reference's numpy tree (the port's init, whose
    paths, shapes and dtypes are the reference's: tests/test_torch_blocks.py
    and the decay-mask test below), every cross gate at tanh = 0.5 (a zero
    gate would hide the cross block from the gradients)."""
    params = convert.tree_to_numpy(TM.init_params(cfg, seed, device="cpu"))
    for si, (_, kinds) in enumerate(cfg.pattern):
        for j, kind in enumerate(kinds):
            if kind == "cross":
                blk = params[f"seg{si}"][f"blk{j}"]
                blk["gate"] = np.full_like(blk["gate"], math.atanh(0.5))
    return params


def lm_batch(cfg, seed, b=2, s=SEQ):
    rng = np.random.default_rng(seed)
    shape = (b, s, cfg.n_codebooks) if cfg.n_codebooks else (b, s)
    out = {"codes" if cfg.n_codebooks else "tokens":
           rng.integers(0, cfg.vocab, shape).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab, shape).astype(np.int32)}
    if cfg.n_vision_tokens:
        out["vision"] = rng.standard_normal(
            (b, cfg.n_vision_tokens, cfg.vision_dim)).astype(np.float32)
    return out


def path_name(path):
    return ".".join(str(getattr(k, "key", k)) for k in path)


def grad_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# -- loss and gradients ---------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch):
    """loss, ce and aux to rel 1e-5, every gradient leaf within GRAD_TOL of
    the leaf's max; the port's parameters get exactly the reference's
    gradient leaves."""
    rcfg, cfg = cfgs(arch)
    np_params = ref_params(cfg)
    batch = lm_batch(cfg, seed=1)
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p, b: RM.loss_fn(p, rcfg, b), has_aux=True))(
            jax.tree.map(jnp.asarray, np_params),
            jax.tree.map(jnp.asarray, batch))
    params = convert.params_from_numpy(np_params, cfg).requires_grad_(True)
    got, got_metrics = TM.loss_fn(params, cfg, {k: torch.as_tensor(v) for
                                                k, v in batch.items()})
    got.backward()
    np.testing.assert_allclose(got.item(), float(loss), rtol=LOSS_RTOL)
    for key in ("ce", "aux"):
        np.testing.assert_allclose(got_metrics[key].item(),
                                   float(metrics[key]), rtol=LOSS_RTOL,
                                   atol=1e-7)
    flat = jax.tree_util.tree_flatten_with_path(grads)[0]
    assert sorted(path_name(p) for p, _ in flat) == sorted(
        name for name, _ in params.named_parameters())
    worst = {path_name(p): grad_err(params.get_parameter(path_name(p)).grad,
                                    g) for p, g in flat}
    tol = SCAN_GRAD_TOL if arch in ("zamba2-2.7b", "rwkv6-7b") else GRAD_TOL
    bad = {k: v for k, v in worst.items() if not v <= tol}
    assert not bad, bad


def test_bf16_loss_grads_and_apply_match_reference():
    """danube reduced with bf16 parameters and activations, as the card
    trains: the loss and every gradient leaf (in the parameter's dtype on
    both sides, no float32 copy) within the BF16 tolerances; then one AdamW
    step on both sides from the reference's gradients: the bf16 parameters
    it casts back equal the reference's bit for bit, mu and nu (float32)
    within 1e-6 of each leaf's max and grad_norm to rel 2e-6 (float32 sums
    in other orders; the clip scale carries their last bits into every
    element)."""
    rcfg, cfg = cfgs("h2o-danube-1.8b", dtype="bfloat16",
                     param_dtype="bfloat16")
    np_params = ref_params(cfg)
    batch = lm_batch(cfg, seed=1)
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p, b: RM.loss_fn(p, rcfg, b), has_aux=True))(
            jax.tree.map(jnp.asarray, np_params),
            jax.tree.map(jnp.asarray, batch))
    params = convert.params_from_numpy(np_params, cfg).requires_grad_(True)
    got, _ = TM.loss_fn(params, cfg, {k: torch.as_tensor(v) for k, v in
                                      batch.items()})
    got.backward()
    np.testing.assert_allclose(got.item(), float(loss), rtol=BF16_LOSS_RTOL)
    worst = {}
    for path, g in jax.tree_util.tree_flatten_with_path(grads)[0]:
        name = path_name(path)
        mine = params.get_parameter(name).grad
        assert mine.dtype == torch.bfloat16 and g.dtype == jnp.bfloat16, name
        worst[name] = grad_err(mine.float(), np.asarray(g, np.float32))
    bad = {k: v for k, v in worst.items() if not v <= BF16_GRAD_TOL}
    assert not bad, bad

    ocfg = dict(lr=1e-3, warmup_steps=2, total_steps=10)
    opt = RO.init(np_params)
    want_p, want_s, want_m = jax.jit(lambda p, g, s: RO.apply(
        RO.OptConfig(**ocfg), p, g, s))(
            jax.tree.map(jnp.asarray, np_params), grads, opt)
    tstate = convert.train_state_from_numpy(RT.TrainState(np_params, opt),
                                            cfg)
    got_p, got_s, got_m = TO.apply(
        TO.OptConfig(**ocfg), tstate.params,
        jax.tree.map(lambda g: torch.tensor(np.asarray(g, np.float32))
                     .to(torch.bfloat16), grads), tstate.opt)
    assert float(want_m["grad_norm"]) > 1.0      # the clip is active
    np.testing.assert_allclose(float(got_m["grad_norm"]),
                               float(want_m["grad_norm"]), rtol=2e-6)
    flat_got = jax.tree_util.tree_flatten_with_path(
        convert.tree_to_numpy(got_p))[0]
    flat_want = dict(jax.tree_util.tree_flatten_with_path(want_p)[0])
    for path, a in flat_got:
        b = np.asarray(flat_want[path])
        assert a.dtype == b.dtype and np.array_equal(
            a.astype(np.float32), b.astype(np.float32)), path_name(path)
    for got, want in ((got_s.mu, want_s.mu), (got_s.nu, want_s.nu)):
        errs = jax.tree.map(grad_err, convert.tree_to_numpy(got),
                            jax.tree.map(np.asarray, want))
        assert max(jax.tree.leaves(errs)) <= 1e-6, errs


def test_remat_gives_the_same_gradients():
    """remat "block" checkpoints each repeat and recomputes it in the
    backward: the same loss and gradients bit for bit on the CPU."""
    _, base = cfgs("gemma3-4b")
    batch = {k: torch.as_tensor(v) for k, v in lm_batch(base, 2).items()}
    grads = []
    for remat in ("none", "block"):
        cfg = dataclasses.replace(base, remat=remat)
        params = TM.init_params(cfg, seed=3, device="cpu").requires_grad_(True)
        loss, _ = TM.loss_fn(params, cfg, batch)
        loss.backward()
        grads.append((loss.detach(), {n: p.grad for n, p in
                                      params.named_parameters()}))
    assert torch.equal(grads[0][0], grads[1][0])
    for name, g in grads[0][1].items():
        assert torch.equal(g, grads[1][1][name]), name


def test_params_serve_frozen_and_train_on_request():
    _, cfg = cfgs("h2o-danube-1.8b")
    params = TM.init_params(cfg, seed=0, device="cpu")
    assert not any(p.requires_grad for p in params.parameters())
    state = TT.init_state(cfg, seed=0, device="cpu")
    assert all(p.requires_grad for p in state.params.parameters())
    assert int(state.opt.step) == 0 and state.opt.step.dtype == torch.int32


# -- the optimizer ----------------------------------------------------------------

def test_schedule_matches_reference():
    cfg = dict(lr=1e-3, warmup_steps=10, total_steps=50)
    rcfg, ocfg = RO.OptConfig(**cfg), TO.OptConfig(**cfg)
    for step in (0, 1, 5, 10, 30, 50, 80):
        want = float(RO.schedule(rcfg, jnp.asarray(step, jnp.int32)))
        got = float(TO.schedule(ocfg, torch.tensor(step, dtype=torch.int32)))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)


def test_decay_mask_on_every_leaf_of_every_arch():
    """The port's param_specs paths are the reference's, and the decay mask
    is the same on each (the MoE router and the cross block's scalar both
    called ``gate``, and both decayed)."""
    seen = set()
    for arch in ARCHS:
        rcfg, cfg = cfgs(arch)
        shapes = jax.eval_shape(lambda k: RM.init_params(k, rcfg),
                                jax.random.PRNGKey(0))
        want = {path_name(p): RO._decay_mask(p) for p, _ in
                jax.tree_util.tree_flatten_with_path(shapes)[0]}
        specs = TM.param_specs(cfg)

        def walk(tree, path=()):
            if isinstance(tree, dict):
                for k, v in tree.items():
                    yield from walk(v, path + (k,))
            else:
                yield path

        got = {".".join(p): TO._decay_mask(p) for p in walk(specs)}
        assert got == want, arch
        seen |= {name.rsplit(".", 1)[-1] for name, d in got.items() if d}
    assert {"w", "table", "gate", "up", "down"} <= seen


def test_apply_matches_reference():
    """One AdamW step from a mid-run state (step 6, nonzero mu/nu), with
    clipping active: grad_norm to rel 2e-6 (float32 sums of squares in
    other orders), lr to 1e-6, and params, mu and nu within 1e-6 of each
    leaf's max (the clip scale carries grad_norm's last bits into every
    element; measured worst 1.8e-7)."""
    rcfg, cfg = cfgs("qwen3-moe-30b-a3b")
    np_params = ref_params(cfg)
    rng = np.random.default_rng(4)

    def like(scale):
        return jax.tree.map(lambda p: (rng.standard_normal(p.shape) * scale)
                            .astype(np.float32), np_params)

    grads, mu, nu = like(0.3), like(0.01), jax.tree.map(np.abs, like(1e-3))
    ocfg = dict(lr=1e-3, warmup_steps=3, total_steps=20)
    state = RO.OptState(step=jnp.asarray(6, jnp.int32), mu=mu, nu=nu)
    want_p, want_s, want_m = jax.jit(lambda p, g, s: RO.apply(
        RO.OptConfig(**ocfg), p, g, s))(np_params, grads, state)
    tstate = convert.train_state_from_numpy(RT.TrainState(np_params, state),
                                            cfg)
    got_p, got_s, got_m = TO.apply(
        TO.OptConfig(**ocfg), tstate.params,
        jax.tree.map(lambda g: torch.tensor(g), grads), tstate.opt)
    assert int(got_s.step) == 7
    np.testing.assert_allclose(float(got_m["grad_norm"]),
                               float(want_m["grad_norm"]), rtol=2e-6)
    assert float(want_m["grad_norm"]) > 1.0      # the clip is active
    np.testing.assert_allclose(float(got_m["lr"]), float(want_m["lr"]),
                               rtol=1e-6)
    for got, want in ((got_p, want_p), (got_s.mu, want_s.mu),
                      (got_s.nu, want_s.nu)):
        errs = jax.tree.map(grad_err, convert.tree_to_numpy(got),
                            jax.tree.map(np.asarray, want))
        assert max(jax.tree.leaves(errs)) <= 1e-6, errs


# -- the train step ---------------------------------------------------------------

@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_matches_reference(accum):
    """Three steps of make_train_step on danube reduced (4 sequences of 64
    tokens) from the reference's state: the loss of each step to rel 1e-5,
    grad_norm and lr to 1e-5, and the parameters and moments after the
    third step within 1e-4 of each leaf's max (measured worst 3.1e-5).
    AdamW's eps is 1e-5 here: at the default 1e-8 a gradient at float32
    noise level (~1e-8 in the embedding) takes a whole +-lr step whose
    sign is the noise's, on either side (2e-3 apart after three steps)."""
    rcfg, cfg = cfgs("h2o-danube-1.8b")
    ocfg = dict(lr=3e-3, warmup_steps=2, total_steps=10, eps=1e-5)
    np_params = ref_params(cfg, seed=1)
    ref_state = RT.TrainState(params=jax.tree.map(jnp.asarray, np_params),
                              opt=RO.init(np_params))
    state = convert.train_state_from_numpy(ref_state, cfg)
    ref_step = jax.jit(RT.make_train_step(rcfg, RO.OptConfig(**ocfg), accum))
    step = TT.make_train_step(cfg, TO.OptConfig(**ocfg), accum)
    for i in range(3):
        batch = lm_batch(cfg, seed=10 + i, b=4)
        ref_state, want = ref_step(ref_state, batch)
        state, got = step(state, batch)
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(got[key]), float(want[key]),
                                       rtol=1e-5, err_msg=f"{key} step {i}")
    for got, want in ((convert.tree_to_numpy(state.params), ref_state.params),
                      (convert.tree_to_numpy(state.opt.mu),
                       ref_state.opt.mu),
                      (convert.tree_to_numpy(state.opt.nu),
                       ref_state.opt.nu)):
        errs = jax.tree.map(lambda a, b: grad_err(a, b), got,
                            jax.tree.map(np.asarray, want))
        assert max(jax.tree.leaves(errs)) <= 1e-4, errs
    assert int(state.opt.step) == int(ref_state.opt.step) == 3
