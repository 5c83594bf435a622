"""The port's LM path (dense, zamba2 hybrid, rwkv6) against the JAX
package, on the CPU.

The same numpy inputs (and the reference's parameters, carried across with
``repro_torch.core.convert.params_from_numpy``) go through the reference's
functions and the port's.  Everything runs in float32 at reduced size; the
tolerance of each comparison is stated where it is made.  The port's flash
wrapper runs its plain version on a CPU tensor; the card's kernel is held
to that plain version by ``chip_smoke.py`` and ``tests/test_torch_cuda.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as ref_get_config
from repro.kernels.flash_attention.kernel import flash_attention_pallas
from repro.models import attention as RA
from repro.models import layers as RL
from repro.models import model as RM
from repro_torch.configs import base as tcfg
from repro_torch.core import convert
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL
from repro_torch.models import model as TM

ARCHS = ("h2o-danube-1.8b", "qwen3-32b", "gemma3-4b", "zamba2-2.7b",
         "rwkv6-7b")
#: float32 on both sides; the two frameworks sum in other orders, so
#: results agree to a few ulps per op, compounded over a few layers.
F32_TOL = dict(rtol=2e-5, atol=2e-5)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU sums on one intra-op thread, so their order is fixed
    however loaded the machine is (the float64 checks below then show which
    side moved if a comparison with the reference ever fails)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def tt(x):
    return torch.as_tensor(np.asarray(x))


def close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **tol)


def qkv(b, sq, sk, h, hk, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, sq, h, d), (b, sk, hk, d), (b, sk, hk, d))]


def attention_f64(q, k, v, window=0):
    """Causal (windowed) attention in float64 with numpy: the exact result
    both frameworks' float32 versions are held to."""
    q, k, v = (np.asarray(a, np.float64) for a in (q, k, v))
    rep = q.shape[2] // k.shape[2]
    k, v = (np.repeat(a, rep, axis=2) for a in (k, v))
    s = np.einsum("bqhd,bkhd->bhqk", q * q.shape[-1] ** -0.5, k)
    rel = np.arange(q.shape[1])[:, None] - np.arange(k.shape[1])[None, :]
    ok = (rel >= 0) & ((rel < window) if window else True)
    s = np.where(ok, s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    return np.einsum("bhqk,bkhd->bqhd", p / p.sum(-1, keepdims=True), v)


# -- the plain flash version ----------------------------------------------------

FLASH_CASES = [
    (128, 4, 4, 32, 0),       # MHA
    (256, 8, 2, 64, 0),       # GQA
    (256, 4, 2, 32, 64),      # sliding window
    (200, 4, 2, 32, 0),       # ragged (padding path)
    (200, 8, 2, 80, 64),      # h2o-danube's head_dim, with a window
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sq,h,hk,d,win", FLASH_CASES)
def test_flash_plain_matches_pallas_and_blocked(dtype, sq, h, hk, d, win):
    """Against the float64 result, the Pallas kernel (interpret mode) and
    the blocked jnp path, with the tolerance of tests/test_kernels.py: 2e-5
    in float32, 2e-2 in bf16 (compared in float32)."""
    q, k, v = qkv(2, sq, sq, h, hk, d, seed=sq + d + win)
    jq, jk, jv = (jnp.asarray(a).astype(dtype) for a in (q, k, v))
    tq, tk, tv = (torch.as_tensor(a).to(getattr(torch, dtype))
                  for a in (q, k, v))
    before = fa_ops.LAUNCHES
    got = fa_ops.flash_attention(tq, tk, tv, causal=True, window=win,
                                 block_q=64, block_k=64)
    assert fa_ops.LAUNCHES == before          # CPU: plain version, no launch
    assert got.dtype == tq.dtype and got.shape == tq.shape
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    got32 = got.float().numpy()
    exact = attention_f64(tq.float(), tk.float(), tv.float(), win)
    close(got32, exact, rtol=tol, atol=tol)
    pallas = flash_attention_pallas(jq, jk, jv, causal=True, window=win,
                                    block_q=64, block_k=64, interpret=True)
    close(pallas, exact, rtol=tol, atol=tol)
    close(got32, pallas, rtol=tol, atol=tol)
    blocked = RA.blocked_attention(jq, jk, jv, causal=True, window=win,
                                   block_q=64, block_k=64)
    close(got32, blocked, rtol=tol, atol=tol)


def test_flash_plain_with_unequal_tiles():
    """The shape and tiles of tests/test_kernels.py's blocked-path test
    (block_q 128, block_k 64): float32, 2e-5."""
    q, k, v = qkv(1, 256, 256, 4, 4, 32, seed=1)
    got = fa_ops.flash_attention(tt(q), tt(k), tt(v), block_q=128,
                                 block_k=64)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    close(got, flash_attention_pallas(jq, jk, jv, block_q=128, block_k=64,
                                      interpret=True), **F32_TOL)
    close(got, RA.blocked_attention(jq, jk, jv, block_q=128, block_k=64),
          **F32_TOL)


@pytest.mark.parametrize("causal,window,q_offset", [(True, 0, 37),
                                                    (True, 48, 100),
                                                    (False, 0, 0)])
def test_flash_plain_offset_and_noncausal(causal, window, q_offset):
    """Prefill of a continuation (q_offset) and non-causal attention
    against the reference's blocked path: float32, 2e-5."""
    q, k, v = qkv(1, 70, 170, 4, 2, 16, seed=q_offset)
    got = TA.blocked_attention(tt(q), tt(k), tt(v), causal=causal,
                               window=window, q_offset=q_offset,
                               block_q=32, block_k=32)
    want = RA.blocked_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=causal, window=window,
                                q_offset=q_offset, block_q=32, block_k=32)
    close(got, want, **F32_TOL)


def test_flash_wrapper_refuses_what_the_kernel_does_not_take():
    q, k, v = (tt(a) for a in qkv(1, 8, 8, 4, 2, 16, seed=0))
    with pytest.raises(TypeError, match="bfloat16"):
        fa_ops.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(TypeError):
        fa_ops.flash_attention(q, k.to(torch.bfloat16), v)
    with pytest.raises(ValueError, match="multiple"):
        fa_ops.flash_attention(q[:, :, :3], k, v)
    with pytest.raises(ValueError, match="head_dim"):
        big = torch.zeros(1, 8, 2, 264)
        fa_ops.flash_attention(big, big, big)
    with pytest.raises(ValueError):
        fa_ops.flash_attention(q, k, v[:, :4])
    with pytest.raises(ValueError, match=">= 0"):
        fa_ops.flash_attention(q, k, v, window=-1)


# -- layers ----------------------------------------------------------------------

def test_rmsnorm_and_rope():
    """float32, 2e-5."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, 4, 16)).astype(np.float32)
    scale = rng.standard_normal(16).astype(np.float32)
    close(TL.rmsnorm({"scale": tt(scale)}, tt(x)),
          RL.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x)),
          **F32_TOL)
    pos = rng.integers(0, 5000, (2, 9)).astype(np.int32)
    for theta in (1e4, 1e6):
        close(TL.apply_rope(tt(x), tt(pos), theta),
              RL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta),
              rtol=2e-5, atol=2e-4)   # angles up to 5000 rad: sin/cos of
        # a large float32 argument differ by a few ulps of the argument


@pytest.mark.parametrize("act", ["swiglu", "geglu"])
def test_mlp(act):
    """float32, 2e-5."""
    rng = np.random.default_rng(2)
    p = {n: {"w": (rng.standard_normal(s) * 0.1).astype(np.float32)}
         for n, s in (("gate", (32, 48)), ("up", (32, 48)),
                      ("down", (48, 32)))}
    x = rng.standard_normal((2, 5, 32)).astype(np.float32)
    got = TL.mlp({n: {"w": tt(w["w"])} for n, w in p.items()}, tt(x), act)
    want = RL.mlp({n: {"w": jnp.asarray(w["w"])} for n, w in p.items()},
                  jnp.asarray(x), act)
    close(got, want, **F32_TOL)


@pytest.mark.parametrize("window,q_offset", [(0, 0), (16, 0), (0, 11)])
def test_dense_attention(window, q_offset):
    """GQA, causal, with a window, an offset and a kv_len mask: 2e-5."""
    q, k, v = qkv(2, 20, 40, 4, 2, 16, seed=window + q_offset)
    kv_len = np.array([40, 25], np.int32)
    got = TA.dense_attention(tt(q), tt(k), tt(v), window=window,
                             q_offset=q_offset, kv_len=tt(kv_len))
    want = RA.dense_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              window=window, q_offset=q_offset,
                              kv_len=jnp.asarray(kv_len))
    close(got, want, **F32_TOL)


@pytest.mark.parametrize("window", [0, 12])
def test_gqa_decode_with_ring_cache(window):
    """One decode step per row against a filled cache (a ring of C = 12
    with positions past it when windowed): output and new cache, 2e-5."""
    cfg = dataclasses.replace(ref_get_config("qwen3-32b", reduced=True),
                              d_model=32, n_heads=4, n_kv_heads=2,
                              head_dim=8)
    ref_p = RA.attn_init(jax.random.PRNGKey(0), cfg, jnp.float32)
    p = convert.caches_from_numpy(jax.tree.map(np.asarray, ref_p))
    rng = np.random.default_rng(3)
    c = 12 if window else 30
    ck = rng.standard_normal((2, c, 2, 8)).astype(np.float32)
    cv = rng.standard_normal((2, c, 2, 8)).astype(np.float32)
    x = rng.standard_normal((2, 1, 32)).astype(np.float32)
    pos = np.array([5, 29], np.int32)
    y, nk, nv = TA.gqa_decode(p, cfg, tt(x), tt(ck), tt(cv), tt(pos),
                              window=window, theta=1e4)
    ry, rk, rv = RA.gqa_decode(ref_p, cfg, jnp.asarray(x), jnp.asarray(ck),
                               jnp.asarray(cv), jnp.asarray(pos),
                               window=window, theta=1e4)
    for a, b in ((y, ry), (nk, rk), (nv, rv)):
        close(a, b, **F32_TOL)


# -- the model: prefill and greedy decode ------------------------------------------

#: 150 is not a multiple of zamba2's SSD chunk (128) nor of rwkv6's WKV
#: chunk (64), so the padded tail of both scans runs.
SEQ, DECODE_STEPS = 150, 6


def _cfgs(arch):
    """Reduced config on both sides with 32 x 32 tiles, so a 150-token
    prompt takes the blocked path, past the window (64) and gemma3's local
    window (32), and zamba2's shared block takes it too."""
    return (dataclasses.replace(ref_get_config(arch, reduced=True),
                                block_q=32, block_k=32),
            dataclasses.replace(tcfg.get_config(arch, reduced=True),
                                block_q=32, block_k=32))


@pytest.fixture(scope="module", params=ARCHS)
def arch_run(request):
    """The reference's prefill + 6 greedy decode steps for one arch (each
    jitted once), and the port's on the same parameters."""
    rcfg, cfg = _cfgs(request.param)
    ref_params = RM.init_params(jax.random.PRNGKey(0), rcfg)
    np_params = jax.tree.map(np.asarray, ref_params)
    params = convert.params_from_numpy(np_params, cfg)
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, rcfg.vocab, (2, SEQ)).astype(np.int32)
    max_len = SEQ + DECODE_STEPS + 4

    prefill = jax.jit(lambda p, t: RM.prefill(p, rcfg, {"tokens": t},
                                              max_len=max_len))
    decode = jax.jit(lambda p, c, t, pos: RM.decode_step(
        p, rcfg, c, {"tokens": t}, pos))
    ref = {"logits": [], "caches": []}
    logits, caches = prefill(ref_params, jnp.asarray(tokens))
    ref["prefill_caches"] = jax.tree.map(np.asarray, caches)
    ref_tokens = []
    for i in range(DECODE_STEPS):
        ref["logits"].append(np.asarray(logits))
        tok = np.asarray(jnp.argmax(logits[..., :rcfg.vocab], -1)).astype(np.int32)
        ref_tokens.append(tok)
        pos = jnp.full((2,), SEQ + i, jnp.int32)
        logits, caches = decode(ref_params, caches, jnp.asarray(tok), pos)
    ref["logits"].append(np.asarray(logits))
    ref["caches"] = jax.tree.map(np.asarray, caches)
    ref["tokens"] = ref_tokens
    return rcfg, cfg, params, tokens, max_len, ref


def test_prefill_logits_and_caches(arch_run):
    _, cfg, params, tokens, max_len, ref = arch_run
    logits, caches = TM.prefill(params, cfg, {"tokens": tt(tokens)},
                                max_len=max_len)
    close(logits, ref["logits"][0], **MODEL_TOL)
    got = convert.caches_to_numpy(caches)
    jax.tree.map(lambda a, b: close(a, b, **MODEL_TOL), got,
                 ref["prefill_caches"])


def test_greedy_decode_matches(arch_run):
    """Six greedy decode steps: the same tokens, logits and caches
    (1e-4: float32 over a prefill and six steps of 3-8 layers)."""
    _, cfg, params, tokens, max_len, ref = arch_run
    logits, caches = TM.prefill(params, cfg, {"tokens": tt(tokens)},
                                max_len=max_len)
    for i in range(DECODE_STEPS):
        close(logits, ref["logits"][i], **MODEL_TOL)
        tok = torch.argmax(logits[..., :cfg.vocab], -1).to(torch.int32)
        np.testing.assert_array_equal(tok.numpy(), ref["tokens"][i])
        pos = torch.full((2,), SEQ + i, dtype=torch.int32)
        logits, caches = TM.decode_step(params, cfg, caches, {"tokens": tok},
                                        pos)
    close(logits, ref["logits"][-1], **MODEL_TOL)
    jax.tree.map(lambda a, b: close(a, b, **MODEL_TOL),
                 convert.caches_to_numpy(caches), ref["caches"])


def test_forward_hidden_short_prompt_takes_dense_path():
    """A prompt no longer than block_q runs dense attention on both sides
    (1e-4)."""
    rcfg, cfg = (ref_get_config("gemma3-4b", reduced=True),
                 tcfg.get_config("gemma3-4b", reduced=True))
    ref_params = RM.init_params(jax.random.PRNGKey(1), rcfg)
    params = convert.params_from_numpy(jax.tree.map(np.asarray, ref_params),
                                       cfg)
    tokens = np.random.default_rng(5).integers(0, rcfg.vocab, (2, 40))
    x, _, _ = TM.forward_hidden(params, cfg, {"tokens": tt(tokens)})
    rx, _, _ = RM.forward_hidden(ref_params, rcfg,
                                 {"tokens": jnp.asarray(tokens)})
    close(TM.head_logits(params, cfg, x), RM.head_logits(ref_params, rcfg, rx),
          **MODEL_TOL)


# -- configs, params, what still refuses ------------------------------------------------------

@pytest.mark.parametrize("arch", tcfg.PORTED)
def test_param_count_matches_reference(arch):
    assert tcfg.get_config(arch).param_count() == \
        RM.count_params_analytic(ref_get_config(arch))
    for reduced in (False, True):
        assert dataclasses.asdict(tcfg.get_config(arch, reduced=reduced)) \
            == dataclasses.asdict(ref_get_config(arch, reduced=reduced))


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "rwkv6-7b"])
def test_params_from_numpy_keeps_float32_leaves(arch):
    """In a bf16 model the reference keeps the SSM decay, skip and bonus
    leaves in float32; they cross as float32, bit for bit, and the port's
    own init makes them float32 too."""
    rcfg = dataclasses.replace(ref_get_config(arch, reduced=True),
                               param_dtype="bfloat16", dtype="bfloat16")
    cfg = dataclasses.replace(tcfg.get_config(arch, reduced=True),
                              param_dtype="bfloat16", dtype="bfloat16")
    np_params = jax.tree.map(np.asarray,
                             RM.init_params(jax.random.PRNGKey(3), rcfg))
    params = convert.params_from_numpy(np_params, cfg)
    own = dict(TM.init_params(cfg, device="cpu").named_parameters())
    flat = {}

    def walk(tree, path):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, f"{path}{k}.")
            else:
                flat[f"{path}{k}"] = v
    walk(np_params, "")
    got = dict(params.named_parameters())
    assert set(got) == set(flat) == set(own)
    f32 = {n for n, a in flat.items() if a.dtype == np.float32}
    want = ({"a_log", "dt_bias", "d_skip"} if arch == "zamba2-2.7b"
            else {"w0", "u"})
    assert {n.split(".")[-1] for n in f32} == want
    for name, leaf in flat.items():
        t = got[name]
        assert t.dtype == (torch.float32 if name in f32 else torch.bfloat16)
        assert own[name].dtype == t.dtype, name
        back = convert.tensor_to_numpy(t)
        assert back.dtype == leaf.dtype
        np.testing.assert_array_equal(back.view(np.uint8), leaf.view(np.uint8))
    # The port's constant leaves equal the reference's.
    for name in flat:
        if name.split(".")[-1] in ("a_log", "w0", "mu", "dt_bias", "d_skip"):
            close(own[name].float(), np.asarray(flat[name], np.float32),
                  rtol=1e-6, atol=1e-6)
    leaf_name = next(iter(f32))
    *path, last = leaf_name.split(".")
    node = np_params
    for k in path:
        node = node[k]
    node[last] = node[last].astype(jnp.bfloat16)
    with pytest.raises(ValueError, match="dtype"):
        convert.params_from_numpy(np_params, cfg)


def test_params_from_numpy_round_trip_with_bf16():
    rcfg = dataclasses.replace(ref_get_config("h2o-danube-1.8b", reduced=True),
                               param_dtype="bfloat16")
    cfg = dataclasses.replace(tcfg.get_config("h2o-danube-1.8b", reduced=True),
                              param_dtype="bfloat16")
    np_params = jax.tree.map(np.asarray,
                             RM.init_params(jax.random.PRNGKey(2), rcfg))
    leaf = np_params["seg0"]["blk0"]["attn"]["wq"]["w"]
    assert leaf.dtype.name == "bfloat16"
    params = convert.params_from_numpy(np_params, cfg)
    got = params["seg0"]["blk0"]["attn"]["wq"]["w"]
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == leaf.shape
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  leaf.view(np.int16))
    names = {n for n, _ in params.named_parameters()}
    assert "seg0.blk0.attn.wq.w" in names and "head.w" in names
    assert names == {n for n, _ in TM.init_params(cfg, device="cpu")
                     .named_parameters()}
    back = convert.tensor_to_numpy(got)
    assert back.dtype == leaf.dtype
    np.testing.assert_array_equal(back.view(np.uint16), leaf.view(np.uint16))
    np_params["seg0"]["blk0"]["attn"]["wq"]["w"] = leaf[:, :, :8]
    with pytest.raises(ValueError, match="wq.w"):
        convert.params_from_numpy(np_params, cfg)


def test_unported_entry_points_raise():
    """What the training slices ported runs (loss_fn, blocked_attention's
    backward, the SSD and the WKV scans' autograd Functions); none of it
    is left unported.  A tensor that reports itself on the card stands in
    for a CUDA input: both scans take it into their Functions (the WKV
    scan refused it before its backward kernel was ported)."""
    from repro_torch.models import rwkv as TR
    from repro_torch.models import ssm as TS
    cfg = tcfg.get_config("qwen3-32b", reduced=True)
    params = TM.init_params(cfg, 0, device="cpu")
    ids = torch.zeros(1, 8, dtype=torch.int32)
    loss, _ = TM.loss_fn(params, cfg, {"tokens": ids, "labels": ids})
    assert torch.isfinite(loss)
    q = torch.zeros(1, 8, 2, 16, requires_grad=True)
    TA.blocked_attention(q, q, q).sum().backward()
    assert q.grad is not None

    class OnCard(torch.Tensor):
        is_cuda = property(lambda self: True)

    def card(*shape):
        return torch.zeros(shape).as_subclass(OnCard).requires_grad_()

    y, hf = TS.ssd_chunked(card(1, 8, 2, 4), card(1, 8, 2), card(1, 8, 4),
                           card(1, 8, 4), chunk=4)
    assert type(y.grad_fn).__name__ == "_SSDBackward"
    assert y.grad_fn is hf.grad_fn
    y, sf = TR.wkv6_chunked(*(card(1, 8, 2, 4) for _ in range(4)),
                            card(2, 4), chunk=4)
    assert type(y.grad_fn).__name__ == "_WKVBackward"
    assert y.grad_fn is sf.grad_fn


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_cuda_default_raises_without_a_card(no_card):
    cfg = tcfg.get_config("h2o-danube-1.8b", reduced=True)
    with pytest.raises(RuntimeError, match="cuda"):
        TM.init_params(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        TM.init_caches(cfg, 1, 8)
