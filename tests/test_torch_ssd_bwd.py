"""The SSD scan's backward and the step and decay's backward: their plain
versions (``repro_torch.kernels.mamba2.ref``) against the JAX package's
gradients, on the CPU.

The same numpy inputs, made from a seed, go through ``jax.vjp`` of
``repro.models.ssm.ssd_chunked`` (compiled once per case in a
module-scoped fixture) and ``mamba2_ssd_bwd_ref``, and through
``jax.grad`` of the reference's step and decay (``ssm.py:131-132``) and
``step_and_decay_bwd_ref``.  Every gradient is held within ``GRAD_TOL`` of
its max.  The decay's gradient is compared as ``da * max(a, 1e-20)``, the
gradient of the log decay: ``da = dla / a`` multiplies the float32
rounding of ``dla`` (a sum of terms of order one) by up to 1e20 where a is
near 1e-20, so both packages' ``da`` there is rounding noise of the same
size as its max, while ``dla`` agrees to ~1e-6.  Where a = 1e-20 exactly,
``jnp.maximum``'s gradient gives each side half, which the scaled
comparison checks (a full share would be off by half of ``dla``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as RS
from repro_torch.kernels.mamba2 import ops
from repro_torch.kernels.mamba2 import ref
from repro_torch.models import ssm as TS

#: Each gradient against jax.vjp / jax.grad: max abs error over its max.
GRAD_TOL = 1e-4
#: Against torch autograd through mamba2_ssd_ref, whose float32 products
#: are summed in other orders by einsum's backward (measured worst 2.4e-7).
AUTOGRAD_TOL = 2e-6
#: bf16 g_dt_raw: both packages round the float32 gradient to bf16 once, so
#: an element may land one bf16 step (up to 2^-7 of it) apart.
BF16_RTOL = 2.0 ** -7

#: (B, S, H, P, N, chunk, b/c dtype, h0, decay).  S is 2-4 chunks.
CASES = [
    (2, 64, 4, 16, 16, 16, "float32", False, "normal"),
    (2, 64, 4, 16, 16, 32, "float32", True, "normal"),
    (2, 48, 4, 16, 16, 16, "bfloat16", True, "normal"),
    (2, 96, 4, 16, 16, 32, "bfloat16", False, "normal"),
    (2, 64, 4, 16, 16, 16, "float32", True, "strong"),
    (2, 96, 4, 16, 16, 32, "float32", False, "padded"),
]
IDS = ["L16-f32", "L32-f32-h0", "L16-bf16-h0", "L32-bf16", "L16-strong-h0",
       "L32-padded-tail"]
NAMES = ("dx", "da", "db", "dc", "dh0")


def ssd_inputs(case, seed):
    """numpy (x, a, b, c, h0, dy, dhf) of a case: strong decay puts a
    below, at and just above the 1e-20 clamp; "padded" ends each sequence
    with 5 steps of a = 1 and x = 0, as mamba2_forward pads to a chunk."""
    bsz, s, h, p, n, _, dtype, with_h0, decay = case
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((bsz, s, h, p)) * 0.5).astype(np.float32)
    if decay == "strong":
        a = np.exp(-rng.uniform(2.0, 46.0, (bsz, s, h))).astype(np.float32)
        a[:, ::7] = 1e-30
        a[:, 3::11] = 2e-20
        a[:, 5::9] = np.float32(1e-20)
    else:
        a = (1 / (1 + np.exp(-rng.standard_normal((bsz, s, h)))) * 0.5
             + 0.45).astype(np.float32)
    if decay == "padded":
        a[:, -5:] = 1.0
        x[:, -5:] = 0.0
    b, c = ((rng.standard_normal((bsz, s, n)) * 0.3).astype(np.float32)
            for _ in range(2))
    if dtype == "bfloat16":
        b, c = (np.asarray(jnp.asarray(t, jnp.bfloat16)) for t in (b, c))
    h0 = (rng.standard_normal((bsz, h, p, n)).astype(np.float32) if with_h0
          else None)
    dy = rng.standard_normal((bsz, s, h, p)).astype(np.float32)
    dhf = rng.standard_normal((bsz, h, p, n)).astype(np.float32)
    return x, a, b, c, h0, dy, dhf


def to_torch(v):
    if v is None:
        return None
    if v.dtype == jnp.bfloat16:
        return torch.from_numpy(v.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(v))


@pytest.fixture(scope="module")
def reference():
    """{case index: (inputs, the reference's (dx, da, db, dc, dh0))}."""
    out = {}
    for k, case in enumerate(CASES):
        x, a, b, c, h0, dy, dhf = ssd_inputs(case, seed=k)
        hj = h0 if h0 is not None else np.zeros(dhf.shape, np.float32)
        _, vjp = jax.vjp(lambda *t: RS.ssd_chunked(*t[:4], None,
                                                   chunk=case[5], h0=t[4]),
                         x, a, b, c, hj)
        grads = vjp((jnp.asarray(dy), jnp.asarray(dhf)))
        out[k] = ((x, a, b, c, h0, dy, dhf), [np.asarray(g) for g in grads])
    return out


def rel_err(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def held(got, want, a):
    """{gradient: error} with da scaled by max(a, 1e-20) on both sides."""
    scale = np.maximum(a, np.float32(1e-20)).astype(np.float64)
    errs = {}
    for name, g, w in zip(NAMES, got, want):
        g = g.float().numpy().astype(np.float64) if torch.is_tensor(g) else g
        w = np.asarray(w).astype(np.float64)
        if name == "da":
            g, w = g * scale, w * scale
        errs[name] = rel_err(g, w)
    return errs


@pytest.mark.parametrize("k", range(len(CASES)), ids=IDS)
def test_ssd_bwd_plain_version_matches_jax_vjp(reference, k):
    """dx, da, db, dc and dh0 of mamba2_ssd_bwd_ref (through the wrapper's
    CPU path) within GRAD_TOL of jax.vjp of the reference's ssd_chunked;
    db and dc come back in b's dtype."""
    (x, a, b, c, h0, dy, dhf), want = reference[k]
    chunk = CASES[k][5]
    x, a, b, c, h0, dy, dhf = map(to_torch, (x, a, b, c, h0, dy, dhf))
    _, _, cum, h_in = ops.mamba2_ssd(x, a, b, c, chunk=chunk, h0=h0,
                                     keep=True)
    got = ops.mamba2_ssd_bwd(x, a, b, c, dy, dhf, chunk=chunk, cum=cum,
                             h_in=h_in)
    assert got[2].dtype == got[3].dtype == b.dtype
    a = a.numpy()
    errs = held(got, want, a)
    assert all(v <= GRAD_TOL for v in errs.values()), errs


@pytest.mark.parametrize("k", range(len(CASES)), ids=IDS)
def test_ssd_bwd_plain_version_matches_torch_autograd(reference, k):
    """The same gradients against torch autograd through mamba2_ssd_ref
    (b and c in float32 on both sides), within AUTOGRAD_TOL."""
    (x, a, b, c, h0, dy, dhf), _ = reference[k]
    chunk = CASES[k][5]
    leaves = [to_torch(t).float().requires_grad_()
              for t in (x, a, b, c, h0 if h0 is not None
                        else np.zeros(dhf.shape, np.float32))]
    y, hf, cum, h_in = ref.mamba2_ssd_ref(*leaves[:4], chunk=chunk,
                                          h0=leaves[4], keep=True)
    loss = (y * to_torch(dy)).sum() + (hf * to_torch(dhf)).sum()
    want = torch.autograd.grad(loss, leaves)
    got = ref.mamba2_ssd_bwd_ref(*(t.detach() for t in leaves[:4]),
                                 to_torch(dy), to_torch(dhf), chunk=chunk,
                                 cum=cum.detach(), h_in=h_in.detach())
    errs = held(got, [w.numpy() for w in want], a)
    assert all(v <= AUTOGRAD_TOL for v in errs.values()), errs


def test_ssd_bwd_passes_compose(reference):
    """The forward's kept scratch comes with the same (y, h_final), and
    the backward is its passes composed: each pass's wrapper on the CPU is
    its plain version, and chunk_dstate, state_pass_bwd and chunk_bwd in
    turn give mamba2_ssd_bwd's gradients bit for bit."""
    (x, a, b, c, h0, dy, dhf), _ = reference[1]
    x, a, b, c, h0, dy, dhf = map(to_torch, (x, a, b, c, h0, dy, dhf))
    chunk = CASES[1][5]
    y, hf, cum, h_in = ops.mamba2_ssd(x, a, b, c, chunk=chunk, h0=h0,
                                      keep=True)
    assert all(torch.equal(u, v) for u, v in zip(
        (y, hf), ops.mamba2_ssd(x, a, b, c, chunk=chunk, h0=h0)))
    whole = ops.mamba2_ssd_bwd(x, a, b, c, dy, dhf, chunk=chunk, cum=cum,
                               h_in=h_in)
    q = ops.chunk_dstate(dy, c, cum, chunk=chunk)
    assert torch.equal(q, ref.chunk_dstate_ref(dy, c, cum, chunk=chunk))
    r, dh0 = ops.state_pass_bwd(q.clone(), cum, dhf=dhf)
    r_ref, dh0_ref = ref.state_pass_bwd_ref(q.clone(), cum, dhf=dhf)
    assert torch.equal(r, r_ref) and torch.equal(dh0, dh0_ref)
    got = ops.chunk_bwd(x, a, b, c, dy, cum, h_in, r, chunk=chunk)
    assert all(torch.equal(u, v) for u, v in zip(got, whole[:4]))
    assert torch.equal(dh0, whole[4])


def test_ssd_function_on_the_cpu():
    """ssd_chunked under a gradient goes through the autograd Function:
    its forward equals mamba2_ssd_ref bit for bit, and its backward runs
    the plain backward once, giving autograd's gradients through the plain
    version within AUTOGRAD_TOL."""
    (x, a, b, c, h0, dy, dhf) = map(to_torch, ssd_inputs(CASES[1], seed=7))
    leaves = [t.clone().requires_grad_() for t in (x, a, b, c, h0)]
    y, hf = TS.ssd_chunked(*leaves[:4], chunk=32, h0=leaves[4])
    assert type(y.grad_fn).__name__ == "_SSDBackward"
    want_y, want_hf = ref.mamba2_ssd_ref(x, a, b, c, chunk=32, h0=h0)
    assert torch.equal(y, want_y) and torch.equal(hf, want_hf)
    calls = []
    real = ops.mamba2_ssd_bwd_ref

    def counted(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    ops.mamba2_ssd_bwd_ref = counted
    try:
        got = torch.autograd.grad((y * dy).sum() + (hf * dhf).sum(), leaves)
    finally:
        ops.mamba2_ssd_bwd_ref = real
    assert len(calls) == 1
    plain = [t.clone().requires_grad_() for t in (x, a, b, c, h0)]
    py, phf = ref.mamba2_ssd_ref(*plain[:4], chunk=32, h0=plain[4])
    want = torch.autograd.grad((py * dy).sum() + (phf * dhf).sum(), plain)
    for g, w in zip(got, want):
        assert rel_err(g.numpy(), w.numpy()) <= AUTOGRAD_TOL


def test_ssd_function_without_h0_gives_no_h0_gradient():
    """With h0 None the Function returns no gradient for it, and dt (folded
    into x, as in the reference) is not an input of the Function."""
    x, a, b, c, _, dy, _ = map(to_torch, ssd_inputs(CASES[0], seed=8))
    x.requires_grad_()
    y, _ = TS.ssd_chunked(x, a, b, c, torch.ones_like(a), chunk=16)
    (y * dy).sum().backward()
    assert x.grad is not None and torch.isfinite(x.grad).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_step_and_decay_bwd_plain_version_matches_jax_grad(dtype):
    """step_and_decay_bwd_ref against jax.grad of the reference's
    dt = softplus(dt_raw + dt_bias), a = exp(-dt exp(a_log)) under the
    loss sum(g_dt dt) + sum(g_a a): g_dt_raw (in dt_raw's dtype: bf16 one
    rounding apart at most, BF16_RTOL), g_dt_bias and g_a_log within
    GRAD_TOL of each one's max."""
    rng = np.random.default_rng(5)
    raw = (rng.standard_normal((2, 50, 8)) * 3).astype(np.float32)
    if dtype == "bfloat16":
        raw = np.asarray(jnp.asarray(raw, jnp.bfloat16))
    bias = rng.standard_normal(8).astype(np.float32)
    a_log = rng.uniform(-3.0, 3.0, 8).astype(np.float32)
    g_dt, g_a = (rng.standard_normal((2, 50, 8)).astype(np.float32)
                 for _ in range(2))

    def loss(raw, bias, a_log):
        dt = jax.nn.softplus(raw.astype(jnp.float32) + bias)
        a = jnp.exp(-dt * jnp.exp(a_log))
        return jnp.sum(g_dt * dt) + jnp.sum(g_a * a)

    want = jax.grad(loss, argnums=(0, 1, 2))(raw, bias, a_log)
    t_raw, t_bias, t_alog = map(to_torch, (raw, bias, a_log))
    dt, a = ref.step_and_decay_ref(t_raw, t_bias, t_alog)
    got = ops.step_and_decay_bwd(to_torch(g_dt), to_torch(g_a), t_raw,
                                 t_bias, t_alog, dt, a)
    assert got[0].dtype == t_raw.dtype and got[0].shape == t_raw.shape
    w_raw = np.asarray(want[0]).astype(np.float64)
    g_raw = got[0].float().numpy().astype(np.float64)
    if dtype == "bfloat16":
        scale = np.abs(w_raw).max()
        assert np.all(np.abs(g_raw - w_raw)
                      <= BF16_RTOL * np.abs(w_raw) + GRAD_TOL * scale)
    else:
        assert rel_err(g_raw, w_raw) <= GRAD_TOL
    for g, w in zip(got[1:], want[1:]):
        assert rel_err(g.numpy(), w) <= GRAD_TOL


def test_step_decay_function_on_the_cpu():
    """_step_and_decay under a gradient runs the plain backward once, and
    its gradients equal step_and_decay_bwd_ref's bit for bit."""
    g = torch.Generator().manual_seed(2)
    raw = torch.randn(2, 30, 8, generator=g).requires_grad_()
    bias = torch.randn(8, generator=g).requires_grad_()
    a_log = torch.rand(8, generator=g).requires_grad_()
    g_dt, g_a = torch.randn(2, 30, 8, generator=g), torch.randn(2, 30, 8,
                                                                 generator=g)
    dt, a = TS._step_and_decay(raw, bias, a_log)
    calls = []
    real = ops.step_and_decay_bwd_ref

    def counted(*args):
        calls.append(1)
        return real(*args)

    ops.step_and_decay_bwd_ref = counted
    try:
        got = torch.autograd.grad((g_dt * dt).sum() + (g_a * a).sum(),
                                  (raw, bias, a_log))
    finally:
        ops.step_and_decay_bwd_ref = real
    assert len(calls) == 1
    want = real(g_dt, g_a, raw.detach(), bias.detach(), a_log.detach(),
                dt.detach(), a.detach())
    assert all(torch.equal(u, v) for u, v in zip(got, want))


def test_backward_takes_the_forward_geometry():
    """chunk_bwd's shared memory fits wherever the forward's does, over
    chunks up to 256 and P, N up to 1024 and 256 (multiples of 4), with b
    and c in float32 or bf16: for each geometry the forward takes, one of
    the backward's layouts (P in slices, rows padded or not, M1^T stored or
    formed from the Gram) fits, and one of its builds holds the tiles (the
    kernel refuses past them).  zamba2's training layer takes 32-column
    slices in bf16 with every buffer padded and the small build, and chunk
    24 with P = 984, N = 4 (refused by the layout before P was sliced) is
    taken."""
    chunk = np.arange(4, 257, 4)[:, None, None]
    p = np.arange(4, 1025, 4)[None, :, None]
    n = np.arange(4, 257, 4)[None, None, :]
    taken = ops.smem_bytes(chunk, p, n) <= ops.MAX_SMEM
    assert int(taken.sum()) > 70000
    p8 = -(-p // 8) * 8
    for itemsize in (4, 2):
        fits = np.zeros(taken.shape, dtype=bool)
        for m1, pad, ps in ops.BWD_LAYOUTS:
            size = 4 * ops._bwd_layout_floats(chunk, n, ps, pad, m1,
                                              itemsize)
            fits |= (size <= ops.MAX_SMEM) & ((ps <= p8) | (ps == 8))
        fits &= ops._bwd_build(chunk, n) < 2
        refused = np.argwhere(taken & ~fits)
        assert refused.size == 0, [(4 * (c + 1), 4 * (q + 1), 4 * (m + 1))
                                   for c, q, m in refused[:10]]
    assert ops.bwd_layout(128, 64, 64, 2) == {
        "ps": 32, "pad": 4, "m1": True,
        "bytes": ops.bwd_smem_bytes(128, 64, 64, 2), "build": 0}
    layout = ops.bwd_layout(24, 984, 4)
    assert layout["ps"] == 64 and layout["bytes"] <= ops.MAX_SMEM


def test_backward_names_its_builds():
    """chunk_bwd's two builds by the tiles they hold (ops.BWD_BUILDS, as
    the kernel's dispatcher picks them): zamba2's geometry and chunk 24
    with P = 984 take the small one; chunks 164 and 220 (more lower tiles
    than it holds) and N = 180 at chunk 84 (more 16 x 32 units) the large
    one; a geometry past both (chunk 256, which the forward refuses too)
    raises by name, where the kernel would return a bare CUDA error."""
    got = {g: ops.bwd_layout(*g)["build"] for g in
           [(128, 64, 64), (24, 984, 4), (164, 4, 44), (220, 4, 4),
            (84, 4, 180)]}
    assert got == {(128, 64, 64): 0, (24, 984, 4): 0, (164, 4, 44): 1,
                   (220, 4, 4): 1, (84, 4, 180): 1}
    assert ops.smem_bytes(256, 4, 4) > ops.MAX_SMEM
    with pytest.raises(ValueError, match="more tiles than its builds hold"):
        ops.bwd_layout(256, 4, 4)
