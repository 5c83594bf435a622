"""The port's remaining block kinds against the JAX package, on the CPU.

MLA (minicpm3: the dense and the head-folded flash prefill, the absorbed
decode against its latent cache), cross-attention (llama-3.2-vision, with
a nonzero gate: the reference's fresh gate is tanh(0) = 0, which would make
the block add nothing and no check of it could fail), musicgen's codebook
embeddings and heads, and the five architectures built of them and of
``attn_moe`` (qwen3-moe-30b-a3b, mixtral-8x7b): prefill logits and caches,
six greedy decode steps, parameter counts, and the serving engine and CLI.
The same numpy inputs and the reference's parameters (carried across with
``params_from_numpy``) go through both packages in float32 at reduced size;
the tolerance of each comparison is stated where it is made.
"""
import dataclasses
import math
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as ref_get_config
from repro.launch import serve as ref_launch
from repro.models import attention as RA
from repro.models import model as RM
from repro.serve import engine as ref_engine
from repro_torch.configs import base as tcfg
from repro_torch.configs import inputs as tinputs
from repro_torch.core import convert
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.launch import serve as launch
from repro_torch.models import attention as TA
from repro_torch.models import model as TM
from repro_torch.serve import engine as port_engine

ARCHS = ("qwen3-moe-30b-a3b", "mixtral-8x7b", "minicpm3-4b",
         "llama-3.2-vision-11b", "musicgen-medium")
F32_TOL = dict(rtol=2e-5, atol=2e-5)
#: float32 over a prefill and six decode steps of 3-5 layers.
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
#: The cross blocks' gate in every comparison: tanh(GATE) = 0.5.
GATE = math.atanh(0.5)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def tt(x):
    return torch.tensor(np.asarray(x))


def close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **tol)


def cfgs(arch, **kw):
    return (dataclasses.replace(ref_get_config(arch, reduced=True), **kw),
            dataclasses.replace(tcfg.get_config(arch, reduced=True), **kw))


def open_gates(np_params, cfg):
    """Set every cross block's gate to GATE (in place)."""
    for si, (_, kinds) in enumerate(cfg.pattern):
        for j, kind in enumerate(kinds):
            if kind == "cross":
                blk = np_params[f"seg{si}"][f"blk{j}"]
                blk["gate"] = np.full_like(blk["gate"], GATE)
    return np_params


def model_batch(cfg, rng, b, s):
    """Token ids (musicgen: codes) and the vision stub, as numpy."""
    shape = (b, s, cfg.n_codebooks) if cfg.n_codebooks else (b, s)
    out = {"codes" if cfg.n_codebooks else "tokens":
           rng.integers(0, cfg.vocab, shape).astype(np.int32)}
    if cfg.n_vision_tokens:
        out["vision"] = rng.standard_normal(
            (b, cfg.n_vision_tokens, cfg.vision_dim)).astype(np.float32)
    return out


def step_input(cfg, logits):
    """The greedy next input of a decode step: [B, 1] tokens, or [B, 1, nq]
    codes (each codebook's own argmax)."""
    tok = np.asarray(logits)[..., :cfg.vocab].argmax(-1).astype(np.int32)
    return {"codes" if cfg.n_codebooks else "tokens": tok}


# -- MLA ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def mla_setup():
    rcfg, cfg = cfgs("minicpm3-4b")
    ref_p = jax.tree.map(np.asarray, RA.mla_init(jax.random.PRNGKey(1), rcfg,
                                                 jnp.float32))
    return rcfg, cfg, ref_p, convert.caches_from_numpy(ref_p)


@pytest.mark.parametrize("b,s", [(2, 150), (1, 520)])
def test_mla_forward(mla_setup, b, s):
    """At 150 tokens the dense path; at 520 (> 512, the reference's
    constant) the heads fold into the batch through blocked_attention, here
    the flash wrapper's plain version with 512 x 512 tiles (no launch on
    the CPU), on contiguous copies as the kernel takes them (at B = 1 the
    folded view alone would not be).  Output and latent cache entries:
    2e-5."""
    rcfg, cfg, ref_p, p = mla_setup
    rng = np.random.default_rng(s)
    x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))
    before = fa_ops.LAUNCHES
    calls = []
    real = TA.flash_attention

    def spy(*args, **kw):
        calls.append([(tuple(a.shape), a.is_contiguous()) for a in args])
        return real(*args, **kw)

    TA.flash_attention = spy
    try:
        y, (ckv, kr) = TA.mla_forward(p, cfg, tt(x), tt(pos),
                                      return_cache=True)
    finally:
        TA.flash_attention = real
    m = cfg.mla
    folded = ((b * cfg.n_heads, s, 1, m.nope + m.rope), True)
    assert calls == ([] if s <= TA.MLA_DENSE_MAX else [[folded] * 3])
    assert fa_ops.LAUNCHES == before
    ry, (rckv, rkr) = RA.mla_forward(ref_p, rcfg, jnp.asarray(x),
                                     jnp.asarray(pos), return_cache=True)
    for got, want in ((y, ry), (ckv, rckv), (kr, rkr)):
        close(got, want, **F32_TOL)
    assert kr.shape == (b, s, m.rope)


def test_mla_decode_against_latent_cache(mla_setup):
    """One absorbed decode step per row against a filled latent cache (rows
    at positions 7 and 39 of 48): output and both caches, 2e-5."""
    rcfg, cfg, ref_p, p = mla_setup
    rng = np.random.default_rng(2)
    m = cfg.mla
    ckv = rng.standard_normal((2, 48, m.kv_lora)).astype(np.float32)
    kr = rng.standard_normal((2, 48, m.rope)).astype(np.float32)
    x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    pos = np.array([7, 39], np.int32)
    y, nc, nr = TA.mla_decode(p, cfg, tt(x), tt(ckv), tt(kr), tt(pos))
    ry, rc, rr = RA.mla_decode(ref_p, rcfg, jnp.asarray(x), jnp.asarray(ckv),
                               jnp.asarray(kr), jnp.asarray(pos))
    for a, b in ((y, ry), (nc, rc), (nr, rr)):
        close(a, b, **F32_TOL)


# -- cross-attention --------------------------------------------------------------

def test_cross_block_and_decode_with_open_gate():
    """llama-vision's cross block with tanh(gate) = 0.5 in prefill (output
    and its vision K/V cache) and one decode step against that cache:
    2e-5.  The same block with the fresh zero gate differs from it, so the
    gate is live in the comparison."""
    rcfg, cfg = cfgs("llama-3.2-vision-11b")
    ref_blk = jax.tree.map(np.asarray, RM._init_block(
        "cross", jax.random.PRNGKey(3), rcfg, jnp.float32))
    ref_blk["gate"] = np.full_like(ref_blk["gate"], GATE)
    p = convert.caches_from_numpy(ref_blk)
    rng = np.random.default_rng(3)
    s = 12
    x = rng.standard_normal((2, s, cfg.d_model)).astype(np.float32)
    vision = rng.standard_normal((2, cfg.n_vision_tokens,
                                  cfg.vision_dim)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (2, s))
    rctx = {"positions": jnp.asarray(pos), "vision": jnp.asarray(vision)}
    ctx = {"positions": tt(pos), "vision": tt(vision)}
    rx, rcache, _ = RM._apply_block_seq("cross", ref_blk, None, rcfg,
                                        jnp.asarray(x), rctx, True)
    got, cache, aux = TM._apply_block_seq("cross", p, None, cfg, tt(x), ctx,
                                          True)
    assert aux is None
    close(got, rx, **F32_TOL)
    for n in ("k", "v"):
        close(cache[n], rcache[n], **F32_TOL)
    shut = dict(p, gate=torch.zeros(1))
    assert not torch.allclose(
        TM._apply_block_seq("cross", shut, None, cfg, tt(x), ctx, False)[0],
        got, atol=1e-3)
    x1 = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    dctx = {"pos": torch.full((2,), s, dtype=torch.int32)}
    rdx, rdc = RM._apply_block_decode(
        "cross", ref_blk, None, rcfg, jnp.asarray(x1),
        {n: jnp.asarray(np.asarray(rcache[n])) for n in ("k", "v")},
        {"pos": jnp.full((2,), s, jnp.int32)})
    dx = TM._apply_block_decode("cross", p, None, cfg, tt(x1), cache, dctx)
    close(dx, rdx, **F32_TOL)
    for n in ("k", "v"):
        close(cache[n], rdc[n], **F32_TOL)


def test_cross_blocks_need_vision():
    _, cfg = cfgs("llama-3.2-vision-11b")
    params = TM.init_params(cfg, device="cpu")
    with pytest.raises(ValueError, match="vision"):
        TM.forward_hidden(params, cfg, {"tokens": torch.zeros(1, 4,
                                                              dtype=torch.int32)})


# -- codebooks --------------------------------------------------------------------

def test_codebook_embedding_and_head():
    """musicgen's nq embeddings summed in the parameter dtype from 0, in
    codebook order: bit for bit in bf16 (with rope positions, so no float
    sin/cos enters); with its sinusoidal positions in float32, 2e-5.  The
    head's [vocab_padded * nq] logits reshape to [B, S, nq, vocab_padded]:
    2e-5."""
    for dtype in ("bfloat16", "float32"):
        pos = "rope" if dtype == "bfloat16" else "sinusoidal"
        rcfg, cfg = cfgs("musicgen-medium", dtype=dtype, param_dtype=dtype,
                         pos=pos)
        ref_p = RM.init_params(jax.random.PRNGKey(4), rcfg)
        params = convert.params_from_numpy(jax.tree.map(np.asarray, ref_p),
                                           cfg)
        assert params["embed"]["codes"].shape == (cfg.n_codebooks,
                                                  cfg.vocab_padded,
                                                  cfg.d_model)
        codes = np.random.default_rng(4).integers(
            0, cfg.vocab, (2, 9, cfg.n_codebooks)).astype(np.int32)
        x = TM.embed_inputs(params, cfg, {"codes": tt(codes)}, pos_offset=5)
        rx = RM.embed_inputs(ref_p, rcfg, {"codes": jnp.asarray(codes)},
                             pos_offset=5)
        if dtype == "bfloat16":
            np.testing.assert_array_equal(
                convert.tensor_to_numpy(x).view(np.uint16),
                np.asarray(rx).view(np.uint16))
            continue
        close(x, rx, **F32_TOL)
        logits = TM.head_logits(params, cfg, x)
        assert logits.shape == (2, 9, cfg.n_codebooks, cfg.vocab_padded)
        close(logits, RM.head_logits(ref_p, rcfg, rx), **F32_TOL)


# -- whole models: prefill and greedy decode -------------------------------------

#: 150 tokens with 32 x 32 tiles: the blocked path for the self-attention
#: kinds, past mixtral's 64-token window (its ring wraps); minicpm3 stays on
#: MLA's dense path (test_mla_forward takes the folded one).
SEQ, DECODE_STEPS = 150, 6


@pytest.fixture(scope="module", params=ARCHS)
def arch_run(request):
    """The reference's prefill + 6 greedy decode steps for one arch (each
    jitted once), and the port's parameters: the reference's, with every
    cross gate opened."""
    rcfg, cfg = cfgs(request.param, block_q=32, block_k=32)
    np_params = open_gates(jax.tree.map(np.asarray, RM.init_params(
        jax.random.PRNGKey(0), rcfg)), rcfg)
    ref_params = jax.tree.map(jnp.asarray, np_params)
    params = convert.params_from_numpy(np_params, cfg)
    batch = model_batch(cfg, np.random.default_rng(5), 2, SEQ)
    max_len = SEQ + DECODE_STEPS + 4
    prefill = jax.jit(lambda p, b: RM.prefill(p, rcfg, b, max_len=max_len))
    decode = jax.jit(lambda p, c, b, pos: RM.decode_step(p, rcfg, c, b, pos))
    ref = {"logits": [], "inputs": []}
    logits, caches = prefill(ref_params, jax.tree.map(jnp.asarray, batch))
    ref["prefill_caches"] = jax.tree.map(np.asarray, caches)
    for i in range(DECODE_STEPS):
        ref["logits"].append(np.asarray(logits))
        nxt = step_input(rcfg, logits)
        ref["inputs"].append(nxt)
        pos = jnp.full((2,), SEQ + i, jnp.int32)
        logits, caches = decode(ref_params, caches,
                                jax.tree.map(jnp.asarray, nxt), pos)
    ref["logits"].append(np.asarray(logits))
    ref["caches"] = jax.tree.map(np.asarray, caches)
    ref["aux"] = np.asarray(jax.jit(lambda p, b: RM.forward_hidden(
        p, rcfg, b)[2])(ref_params, jax.tree.map(jnp.asarray, batch)))
    return cfg, params, batch, max_len, ref


def test_prefill_logits_and_caches(arch_run):
    """Last-token logits and every cache leaf (a cross block's vision K/V,
    MLA's ckv/kr, mixtral's wrapped ring): 1e-4."""
    cfg, params, batch, max_len, ref = arch_run
    logits, caches = TM.prefill(params, cfg, {k: tt(v) for k, v in
                                              batch.items()}, max_len=max_len)
    close(logits, ref["logits"][0], **MODEL_TOL)
    jax.tree.map(lambda a, b: close(a, b, **MODEL_TOL),
                 convert.caches_to_numpy(caches), ref["prefill_caches"])


def test_greedy_decode_matches(arch_run):
    """Six greedy decode steps: the same tokens (musicgen: codes), logits and
    caches (1e-4)."""
    cfg, params, batch, max_len, ref = arch_run
    logits, caches = TM.prefill(params, cfg, {k: tt(v) for k, v in
                                              batch.items()}, max_len=max_len)
    for i in range(DECODE_STEPS):
        close(logits, ref["logits"][i], **MODEL_TOL)
        nxt = step_input(cfg, logits)
        for name, want in ref["inputs"][i].items():
            np.testing.assert_array_equal(nxt[name], want)
        pos = torch.full((2,), SEQ + i, dtype=torch.int32)
        logits, caches = TM.decode_step(params, cfg, caches,
                                        {k: tt(v) for k, v in nxt.items()},
                                        pos)
    close(logits, ref["logits"][-1], **MODEL_TOL)
    jax.tree.map(lambda a, b: close(a, b, **MODEL_TOL),
                 convert.caches_to_numpy(caches), ref["caches"])


def test_moe_aux_loss_matches(arch_run):
    """forward_hidden's aux: the MoE blocks' load-balancing losses summed
    (0 for the other archs), 2e-5."""
    cfg, params, batch, _, ref = arch_run
    _, _, aux = TM.forward_hidden(params, cfg, {k: tt(v) for k, v in
                                                batch.items()})
    assert (float(aux) != 0) == (cfg.family == "moe")
    close(aux, ref["aux"], **F32_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_and_names(arch):
    """param_count and active_param_count at full size equal the
    reference's analytic counts; at reduced size the port's init makes the
    reference's parameter names."""
    cfg, rcfg = tcfg.get_config(arch), ref_get_config(arch)
    assert cfg.param_count() == RM.count_params_analytic(rcfg)
    assert cfg.active_param_count() == RM.count_params_analytic(
        rcfg, active_only=True)
    assert (cfg.active_param_count() < cfg.param_count()) == \
        (cfg.family == "moe")
    rcfg, cfg = cfgs(arch)
    shapes = jax.eval_shape(lambda k: RM.init_params(k, rcfg),
                            jax.random.PRNGKey(0))
    want = {jax.tree_util.keystr(path, simple=True, separator="."):
            tuple(leaf.shape)
            for path, leaf in jax.tree_util.tree_leaves_with_path(shapes)}
    got = {n: tuple(t.shape) for n, t in
           TM.init_params(cfg, device="cpu").named_parameters()}
    assert got == want


def test_random_batch_specs():
    """configs.inputs: the batches' keys, shapes and dtypes are the specs',
    drawn from the generator (the same seed, the same batch)."""
    for arch in ("musicgen-medium", "llama-3.2-vision-11b", "qwen3-32b"):
        cfg = tcfg.get_config(arch, reduced=True)
        shape = tcfg.SHAPES["train_4k"]
        specs = tinputs.input_specs(cfg, dataclasses.replace(
            shape, seq_len=16, global_batch=2))
        batch = tinputs.random_batch(torch.Generator().manual_seed(0), cfg,
                                     16, 2)
        assert {k: (tuple(v.shape), v.dtype) for k, v in batch.items()} \
            == specs
        again = tinputs.random_batch(torch.Generator().manual_seed(0), cfg,
                                     16, 2)
        assert all(torch.equal(batch[k], again[k]) for k in batch)
        ids = batch["codes" if cfg.n_codebooks else "tokens"]
        assert 0 <= int(ids.min()) and int(ids.max()) < cfg.vocab
        dec = tinputs.input_specs(cfg, tcfg.SHAPES["decode_32k"])
        assert list(dec) == ["codes" if cfg.n_codebooks else "tokens"]


# -- serving: ServeEngine and the CLI ---------------------------------------------

SERVE_ARCHS = ("musicgen-medium", "qwen3-moe-30b-a3b")


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_engine_matches_reference(arch):
    """ServeEngine on the reference's parameters: the same admissions and
    request tokens as the reference engine (musicgen feeds each token on
    every codebook and reads codebook 0, as the reference does)."""
    rcfg, cfg = cfgs(arch)
    ref_params = RM.init_params(jax.random.PRNGKey(0), rcfg)
    params = convert.params_from_numpy(jax.tree.map(np.asarray, ref_params),
                                       cfg)
    runs = []
    for eng, tenant_cls in (
            (ref_engine.ServeEngine(rcfg, ref_params, batch_slots=2,
                                    max_len=48, policy="size-fair", seed=3),
             ref_engine.Tenant),
            (port_engine.ServeEngine(cfg, params, batch_slots=2, max_len=48,
                                     policy="size-fair", seed=3,
                                     device="cpu"), port_engine.Tenant)):
        rng = np.random.default_rng(4)
        tenants = [tenant_cls(tenant_id=i, user=i, size=1 + i)
                   for i in range(2)]
        reqs = [eng.submit(tenants[i % 2],
                           rng.integers(0, cfg.vocab, size=3 + i % 4),
                           max_new=4 + i % 3) for i in range(5)]
        eng.drain()
        runs.append(([r.out_tokens for r in reqs],
                     [r.finished_at for r in reqs], eng.decoded_per_tenant,
                     eng.step_count))
    assert all(toks for toks in runs[1][0])
    assert runs[1] == runs[0]


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_serve_cli_runs_block_archs(arch, monkeypatch, capsys):
    """``--arch musicgen-medium`` / ``qwen3-moe-30b-a3b`` with ``--device
    cpu``: the same completions, ticks and tokens per tenant as the
    reference CLI."""
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", arch, "--requests",
                                      "5"])
    ref_launch.main()
    ref_out = capsys.readouterr().out.splitlines()
    eng, reqs = launch.main(["--arch", arch, "--requests", "5", "--device",
                             "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert eng.cfg.name == arch
    assert out[0].split(" (")[0] == ref_out[0]
    assert out[1] == ref_out[1]
    assert all(r.finished_at is not None for r in reqs)
