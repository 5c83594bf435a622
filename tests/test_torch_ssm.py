"""The port's recurrent scans and blocks (Mamba-2 SSD, RWKV-6) against the
JAX package, on the CPU.

The same numpy inputs go through the reference's functions and the port's.
On a CPU tensor the port's ``mamba2_ssd`` / ``wkv6`` wrappers run their
plain versions (the card's kernels are held to those by ``chip_smoke.py``
and ``tests/test_torch_cuda.py``).  Tolerances: 2e-5 (atol and rtol) in
float32 against the reference's chunked scans and its Pallas kernels in
interpret mode, the JAX tests' 2e-4 / 2e-3 against the sequential oracles,
1e-5 for the blocks built on them (a few float32 ops more).  Under strong
decay the prefix sums of the log decay grow to thousands, and the two
frameworks round them apart (the port's CPU cumsum accumulates in float64,
JAX's in float32): each gate exponent then carries an error of about
``max |prefix| * 2**-24``, so those cases take :func:`prefix_tol`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as ref_get_config
from repro.kernels.mamba2.kernel import mamba2_ssd_pallas
from repro.kernels.rwkv6.kernel import wkv6_pallas
from repro.models import rwkv as RR
from repro.models import ssm as RS
from repro_torch.configs import base as tcfg
from repro_torch.core import convert
from repro_torch.kernels.mamba2 import ops as ssd_ops
from repro_torch.kernels.rwkv6 import ops as wkv_ops
from repro_torch.models import rwkv as TR
from repro_torch.models import ssm as TS

SCAN_TOL = dict(rtol=2e-5, atol=2e-5)
ORACLE_TOL = dict(rtol=2e-3, atol=2e-4)
BLOCK_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """A fixed summation order for the port's CPU sums."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def tt(x):
    return torch.as_tensor(np.asarray(x))


def close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **tol)


def prefix_tol(prefix):
    """atol = rtol = max(2e-5, 4 * max|prefix| * 2**-24): the rounding of a
    prefix sum of that size, four times over, enters an exponent."""
    t = max(2e-5, 4 * float(np.abs(prefix).max()) * 2.0 ** -24)
    return dict(rtol=t, atol=t)


def to_torch(tree):
    return convert.caches_from_numpy(jax.tree.map(np.asarray, tree))


# -- the scans -------------------------------------------------------------------

def ssd_inputs(s, h, p, n, seed, b=2):
    """tests/test_kernels.py's Mamba-2 distributions, from numpy."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, s, h, p)) * 0.5).astype(np.float32)
    a = (1 / (1 + np.exp(-rng.standard_normal((b, s, h)))) * 0.5
         + 0.45).astype(np.float32)
    bb = (rng.standard_normal((b, s, n)) * 0.3).astype(np.float32)
    c = (rng.standard_normal((b, s, n)) * 0.3).astype(np.float32)
    return x, a, bb, c


#: (S, H, P, N, chunk, with h0): tests/test_kernels.py:178-192, then one
#: carrying an initial state.
SSD_CASES = [(64, 2, 8, 16, 32, False), (128, 4, 16, 16, 64, False),
             (96, 3, 8, 16, 32, True)]


@pytest.mark.parametrize("s,h,p,n,chunk,with_h0", SSD_CASES)
def test_ssd_plain_matches_reference_and_pallas(s, h, p, n, chunk, with_h0):
    x, a, bb, c = ssd_inputs(s, h, p, n, seed=s + p)
    h0 = (np.random.default_rng(1).standard_normal((2, h, p, n))
          .astype(np.float32) if with_h0 else None)
    before = ssd_ops.LAUNCHES
    y, hf = TS.ssd_chunked(tt(x), tt(a), tt(bb), tt(c), chunk=chunk,
                           h0=None if h0 is None else tt(h0))
    assert ssd_ops.LAUNCHES == before            # CPU: the plain version
    assert y.dtype == hf.dtype == torch.float32
    jx = [jnp.asarray(t) for t in (x, a, bb, c)]
    ry, rh = RS.ssd_chunked(*jx, None, chunk=chunk,
                            h0=None if h0 is None else jnp.asarray(h0))
    close(y, ry, **SCAN_TOL)
    close(hf, rh, **SCAN_TOL)
    if h0 is None:
        close(y, mamba2_ssd_pallas(*jx, chunk=chunk, interpret=True),
              **SCAN_TOL)
        oy, oh = RS.ssd_reference(*jx)
        close(y, oy, **ORACLE_TOL)
        close(hf, oh, **ORACLE_TOL)
        py, ph = TS.ssd_reference(*(tt(t) for t in (x, a, bb, c)))
        close(py, oy, **ORACLE_TOL)
        close(ph, oh, **ORACLE_TOL)


def test_ssd_strong_decay_stays_finite():
    """a at the 1e-20 clamp and below: the pairwise exponent stays <= 0, so
    nothing overflows, and the plain version agrees with the reference
    within ``prefix_tol`` of the chunk's prefix sums (here ~1300)."""
    x, a, bb, c = ssd_inputs(128, 2, 8, 16, seed=5)
    a[:, ::3] = 1e-30
    a[:, 1::3] = 1e-6
    y, hf = TS.ssd_chunked(tt(x), tt(a), tt(bb), tt(c), chunk=64)
    assert torch.isfinite(y).all() and torch.isfinite(hf).all()
    ry, rh = RS.ssd_chunked(*(jnp.asarray(t) for t in (x, a, bb, c)), None,
                            chunk=64)
    la = np.log(np.maximum(a, 1e-20)).reshape(2, 2, 64, 2)
    tol = prefix_tol(np.cumsum(la, axis=2))
    assert tol["atol"] > SCAN_TOL["atol"]
    close(y, ry, **tol)
    close(hf, rh, **tol)


def wkv_inputs(s, h, kd, seed, b=2, lw_shift=-1.5):
    rng = np.random.default_rng(seed)
    r, k, v = ((rng.standard_normal((b, s, h, kd)) * 0.5).astype(np.float32)
               for _ in range(3))
    lw = (-np.exp(rng.standard_normal((b, s, h, kd)) * 0.5
                  + lw_shift)).astype(np.float32)
    u = (rng.standard_normal((h, kd)) * 0.1).astype(np.float32)
    return r, k, v, lw, u


#: (S, H, K, chunk, with s0): tests/test_kernels.py:146-177, then one
#: carrying an initial state.
WKV_CASES = [(64, 2, 8, 32, False), (96, 3, 16, 32, False),
             (128, 1, 32, 64, False), (96, 2, 16, 32, True)]


@pytest.mark.parametrize("s,h,kd,chunk,with_s0", WKV_CASES)
def test_wkv6_plain_matches_reference_and_pallas(s, h, kd, chunk, with_s0):
    r, k, v, lw, u = wkv_inputs(s, h, kd, seed=s + kd)
    s0 = (np.random.default_rng(2).standard_normal((2, h, kd, kd))
          .astype(np.float32) if with_s0 else None)
    before = wkv_ops.LAUNCHES
    y, sf = TR.wkv6_chunked(*(tt(t) for t in (r, k, v, lw, u)), chunk=chunk,
                            s0=None if s0 is None else tt(s0))
    assert wkv_ops.LAUNCHES == before
    assert y.dtype == sf.dtype == torch.float32
    jx = [jnp.asarray(t) for t in (r, k, v, lw, u)]
    ry, rs = RR.wkv6_chunked(*jx, chunk=chunk,
                             s0=None if s0 is None else jnp.asarray(s0))
    close(y, ry, **SCAN_TOL)
    close(sf, rs, **SCAN_TOL)
    if s0 is None:
        close(y, wkv6_pallas(*jx, chunk=chunk, interpret=True), **SCAN_TOL)
        oy, os_ = RR.wkv6_reference(*jx)
        close(y, oy, **ORACLE_TOL)
        close(sf, os_, **ORACLE_TOL)
        py, ps = TR.wkv6_reference(*(tt(t) for t in (r, k, v, lw, u)))
        close(py, oy, **ORACLE_TOL)
        close(ps, os_, **ORACLE_TOL)


def test_wkv6_strong_decay_and_zero_bonus():
    """tests/test_kernels.py's chunked-oracle case (u = 0), then lw down to
    about -20 per step: nothing overflows, and the plain version agrees
    with the reference within ``prefix_tol`` of the chunk's prefix sums."""
    for shift, u_zero in ((-1.0, True), (2.5, False)):
        r, k, v, lw, u = wkv_inputs(64, 2, 8, seed=9, b=1, lw_shift=shift)
        if u_zero:
            u[:] = 0
        y, sf = TR.wkv6_chunked(*(tt(t) for t in (r, k, v, lw, u)), chunk=32)
        assert torch.isfinite(y).all() and torch.isfinite(sf).all()
        ry, rs = RR.wkv6_chunked(*(jnp.asarray(t) for t in (r, k, v, lw, u)),
                                 chunk=32)
        tol = prefix_tol(np.cumsum(lw.reshape(1, 2, 32, 2, 8), axis=2))
        close(y, ry, **tol)
        close(sf, rs, **tol)
    assert lw.min() < -15


def test_scan_wrappers_refuse_what_the_kernels_do_not_take():
    x, a, bb, c = (tt(t) for t in ssd_inputs(64, 2, 8, 16, seed=0))
    with pytest.raises(TypeError, match="float32"):
        ssd_ops.mamba2_ssd(x.double(), a, bb, c, chunk=32)
    with pytest.raises(TypeError, match="bfloat16"):
        ssd_ops.mamba2_ssd(x, a, bb.half(), c.half(), chunk=32)
    with pytest.raises(ValueError, match="multiple of chunk"):
        ssd_ops.mamba2_ssd(x, a, bb, c, chunk=48)
    with pytest.raises(ValueError, match="h0"):
        ssd_ops.mamba2_ssd(x, a, bb, c, chunk=32, h0=torch.zeros(2, 2, 8, 8))
    with pytest.raises(ValueError):
        ssd_ops.mamba2_ssd(x, a[:, :, :1], bb, c, chunk=32)
    r, k, v, lw, u = (tt(t) for t in wkv_inputs(64, 2, 8, seed=0))
    with pytest.raises(TypeError, match="bfloat16"):
        wkv_ops.wkv6(r, k.to(torch.bfloat16), v, lw, u, chunk=32)
    with pytest.raises(TypeError, match="float32"):
        wkv_ops.wkv6(r, k, v, lw.to(torch.bfloat16), u, chunk=32)
    with pytest.raises(ValueError, match="u must be"):
        wkv_ops.wkv6(r, k, v, lw, u[:1], chunk=32)
    with pytest.raises(ValueError, match="multiple of chunk"):
        wkv_ops.wkv6(r, k, v, lw, u, chunk=48)
    assert ssd_ops.smem_bytes(128, 64, 64) <= ssd_ops.MAX_SMEM
    assert wkv_ops.smem_bytes(64, 64) <= wkv_ops.MAX_SMEM


#: Geometry the kernels take only after ``kernel_layout``: (scan, a label,
#: its make-inputs arguments).
LAYOUT_CASES = [
    ("wkv6", "K60-bf16", dict(kd=60, dtype=torch.bfloat16)),
    ("wkv6", "K36-f32", dict(kd=36, dtype=torch.float32)),
    ("wkv6", "K30-f32-s0", dict(kd=30, dtype=torch.float32, s0=True)),
    ("wkv6", "K16-strided-v", dict(kd=16, dtype=torch.float32,
                                   strided_v=True)),
    ("mamba2", "P30-N18-h0", dict(p=30, n=18, h0=True)),
    ("mamba2", "P8-N16-misaligned-x", dict(p=8, n=16, offset_x=True)),
]


def layout_inputs(scan, kd=8, dtype=torch.float32, s0=False,
                  strided_v=False, p=8, n=16, h0=False, offset_x=False):
    rng = np.random.default_rng(7)
    if scan == "wkv6":
        r, k, v, lw, u = (tt(t) for t in wkv_inputs(64, 2, kd, seed=kd))
        r, k, v = (t.to(dtype) for t in (r, k, v))
        if strided_v:
            wide = torch.zeros(v.shape[:-1] + (kd + 3,), dtype=dtype)
            wide[..., 1:kd + 1] = v
            v = wide[..., 1:kd + 1]
        st = (tt(rng.standard_normal((2, 2, kd, kd)).astype(np.float32))
              if s0 else None)
        return (r, k, v, lw, u, st), dict(chunk=32, s0=st)
    x, a, bb, c = (tt(t) for t in ssd_inputs(64, 2, p, n, seed=p + n))
    if offset_x:
        wide = torch.zeros(x.shape[:-1] + (p + 1,))
        wide[..., 1:] = x
        x = wide[..., 1:]
    hs = (tt(rng.standard_normal((2, 2, p, n)).astype(np.float32))
          if h0 else None)
    return (x, a, bb, c, hs), dict(chunk=32, h0=hs)


@pytest.mark.parametrize("scan,label,kw", LAYOUT_CASES,
                         ids=[c[1] for c in LAYOUT_CASES])
def test_kernel_layout_is_exact(scan, label, kw):
    """What the wrappers do on the card before launching, done here on CPU
    tensors: the inputs in ``kernel_layout`` (channels zero-padded to the
    kernel's quantum, strided or misaligned tensors copied) meet the
    kernel's checks, and the plain version on them, cut back by
    ``from_kernel_layout``, gives the unpadded plain version's y and final
    state within ``prefix_tol``."""
    args, call = layout_inputs(scan, **kw)
    if scan == "wkv6":
        ops, ref = wkv_ops, wkv_ops.wkv6_ref
        want = ref(*args[:5], chunk=32, s0=args[5])
        laid, real = ops.kernel_layout(*args)
        assert laid[0].shape[-1] % (16 // laid[0].dtype.itemsize) == 0
        ops._check_kernel(list(laid), laid[1].shape[-1], 32, laid[1].dtype)
        got = ref(*laid[:5], chunk=32, s0=laid[5])
        tol = prefix_tol(np.cumsum(args[3].numpy().reshape(2, 2, 32, 2, -1),
                                   axis=2))
    else:
        ops, ref = ssd_ops, ssd_ops.mamba2_ssd_ref
        want = ref(*args[:4], chunk=32, h0=args[4])
        laid, real = ops.kernel_layout(*args)
        assert laid[0].shape[-1] % 4 == 0 and laid[2].shape[-1] % 4 == 0
        ops._check_kernel(*laid[:4], 32, laid[4])
        got = ref(*laid[:4], chunk=32, h0=laid[4])
        tol = prefix_tol(np.cumsum(np.log(args[1].numpy()).reshape(
            2, 2, 32, 2), axis=2))
    got = ops.from_kernel_layout(*got, real)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.is_contiguous()
        close(g, w, **tol)


def test_scans_differentiate_on_the_cpu():
    """The plain versions keep their autograd graph (on the card the scans
    refuse inputs that require grad until their backward is ported)."""
    x, a, bb, c = (tt(t).requires_grad_() for t in ssd_inputs(64, 2, 8, 16,
                                                               seed=1))
    y, hf = TS.ssd_chunked(x, a, bb, c, chunk=32)
    (y.sum() + hf.sum()).backward()
    r, k, v, lw, u = (tt(t).requires_grad_() for t in wkv_inputs(64, 2, 8,
                                                                 seed=1))
    y, sf = TR.wkv6_chunked(r, k, v, lw, u, chunk=32)
    (y.sum() + sf.sum()).backward()
    for t in (x, a, bb, c, r, k, v, lw, u):
        assert t.grad is not None and torch.isfinite(t.grad).all()


# -- the blocks --------------------------------------------------------------------

@pytest.fixture(scope="module")
def zamba2():
    cfg = tcfg.get_config("zamba2-2.7b", reduced=True)
    rcfg = ref_get_config("zamba2-2.7b", reduced=True)
    ref_p = RS.mamba2_init(jax.random.PRNGKey(0), rcfg, jnp.float32)
    # A nonzero conv bias and dt bias, so both reach the comparison.
    rng = np.random.default_rng(7)
    ref_p = dict(ref_p, conv_b=jnp.asarray(
        rng.standard_normal(ref_p["conv_b"].shape).astype(np.float32) * 0.1),
        dt_bias=jnp.asarray(rng.standard_normal(ref_p["dt_bias"].shape)
                            .astype(np.float32)))
    return rcfg, cfg, ref_p, to_torch(ref_p)


def test_causal_conv(zamba2):
    rcfg, _, ref_p, p = zamba2
    rng = np.random.default_rng(3)
    xbc = rng.standard_normal((2, 9, ref_p["conv_w"].shape[1])).astype(
        np.float32)
    state = rng.standard_normal((2, 3, xbc.shape[2])).astype(np.float32)
    for st in (None, state):
        got, gs = TS._causal_conv(p["conv_w"], p["conv_b"], tt(xbc),
                                  None if st is None else tt(st))
        want, ws = RS._causal_conv(ref_p["conv_w"], ref_p["conv_b"],
                                   jnp.asarray(xbc),
                                   None if st is None else jnp.asarray(st))
        close(got, want, **BLOCK_TOL)
        close(gs, ws, **BLOCK_TOL)


@pytest.mark.parametrize("s", [100, 128])
def test_mamba2_forward_and_decode(zamba2, s):
    """A prompt of s tokens (100: the padded tail runs) with its state, then
    three decode steps from that state: outputs and states, 1e-5."""
    rcfg, cfg, ref_p, p = zamba2
    rng = np.random.default_rng(s)
    x = rng.standard_normal((2, s, cfg.d_model)).astype(np.float32)
    out, st = TS.mamba2_forward(p, cfg, tt(x), chunk=64, return_state=True)
    rout, rst = RS.mamba2_forward(ref_p, rcfg, jnp.asarray(x), chunk=64,
                                  return_state=True)
    close(out, rout, **BLOCK_TOL)
    close(st["h"], rst["h"], **BLOCK_TOL)
    close(st["conv"], rst["conv"], **BLOCK_TOL)
    close(TS.mamba2_forward(p, cfg, tt(x), chunk=64), rout, **BLOCK_TOL)
    for i in range(3):
        xt = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        out, st = TS.mamba2_decode(p, cfg, tt(xt), st)
        rout, rst = RS.mamba2_decode(ref_p, rcfg, jnp.asarray(xt), rst)
        close(out, rout, **BLOCK_TOL)
        close(st["h"], rst["h"], **BLOCK_TOL)
        close(st["conv"], rst["conv"], **BLOCK_TOL)


@pytest.fixture(scope="module")
def rwkv6():
    cfg = tcfg.get_config("rwkv6-7b", reduced=True)
    rcfg = ref_get_config("rwkv6-7b", reduced=True)
    k1, k2 = jax.random.split(jax.random.PRNGKey(1))
    ref_tm = RR.rwkv6_init(k1, rcfg, jnp.float32)
    ref_cm = RR.channelmix_init(k2, rcfg, jnp.float32)
    # Token-shift mixes other than 0.5, so each stream reaches the result.
    rng = np.random.default_rng(8)
    ref_tm = dict(ref_tm, mu=jnp.asarray(rng.random((5, cfg.d_model))
                                         .astype(np.float32)))
    ref_cm = dict(ref_cm, mu=jnp.asarray(rng.random((2, cfg.d_model))
                                         .astype(np.float32)))
    return rcfg, cfg, ref_tm, ref_cm, to_torch(ref_tm), to_torch(ref_cm)


@pytest.mark.parametrize("s", [100, 128])
def test_rwkv6_timemix_decode_and_channelmix(rwkv6, s):
    """Time-mix over s tokens (100: the padded tail runs) with its state,
    a continuation from that state, decode steps, and channel-mix with and
    without its carried token: 1e-5."""
    rcfg, cfg, ref_tm, ref_cm, tm, cm = rwkv6
    rng = np.random.default_rng(s)
    x = rng.standard_normal((2, s, cfg.d_model)).astype(np.float32)
    out, st = TR.rwkv6_timemix(tm, cfg, tt(x), chunk=32, return_state=True)
    rout, rst = RR.rwkv6_timemix(ref_tm, rcfg, jnp.asarray(x), chunk=32,
                                 return_state=True)
    close(out, rout, **BLOCK_TOL)
    close(st["s"], rst["s"], **BLOCK_TOL)
    close(st["prev"], rst["prev"], **BLOCK_TOL)
    x2 = rng.standard_normal((2, 40, cfg.d_model)).astype(np.float32)
    close(TR.rwkv6_timemix(tm, cfg, tt(x2), chunk=32, state=st),
          RR.rwkv6_timemix(ref_tm, rcfg, jnp.asarray(x2), chunk=32,
                           state=rst), **BLOCK_TOL)
    for _ in range(3):
        xt = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        out, st = TR.rwkv6_decode(tm, cfg, tt(xt), st)
        rout, rst = RR.rwkv6_decode(ref_tm, rcfg, jnp.asarray(xt), rst)
        close(out, rout, **BLOCK_TOL)
        close(st["s"], rst["s"], **BLOCK_TOL)
    got, prev = TR.channelmix(cm, cfg, tt(x), return_state=True)
    want, rprev = RR.channelmix(ref_cm, rcfg, jnp.asarray(x),
                                return_state=True)
    close(got, want, **BLOCK_TOL)
    close(prev, rprev, **BLOCK_TOL)
    close(TR.channelmix(cm, cfg, tt(x2), state=prev),
          RR.channelmix(ref_cm, rcfg, jnp.asarray(x2), state=rprev),
          **BLOCK_TOL)


def test_zamba2_shared_block_parameters():
    """The shared block's parameters live once in params["shared"]; its
    stacked entry is empty; the config dicts equal the reference's."""
    from repro_torch.models import model as TM
    cfg = tcfg.get_config("zamba2-2.7b", reduced=True)
    params = TM.init_params(cfg, device="cpu")
    names = {n for n, _ in params.named_parameters()}
    assert "shared.in_proj.w" in names
    assert tuple(params["shared"]["in_proj"]["w"].shape) == \
        (2 * cfg.d_model, cfg.d_model)
    assert not any(n.startswith("seg0.blk2.") for n in names)
    assert params["seg0"]["blk2"].keys() == []
    caches = TM.init_caches(cfg, 2, 40, device="cpu")
    assert caches["seg0"]["blk0"]["h"].dtype == torch.float32
    assert tuple(caches["seg0"]["blk2"]["k"].shape) == (3, 2, 40, 4, 32)
