"""The WKV scan's backward: its plain version
(``repro_torch.kernels.rwkv6.ref``) against the JAX package's gradient, on
the CPU.

The same numpy inputs, made from a seed, go through ``jax.vjp`` of
``repro.models.rwkv.wkv6_chunked`` (compiled once per case in a
module-scoped fixture) and ``wkv6_bwd_ref``; every gradient (dr, dk, dv,
dlw, du, ds0) is held within ``GRAD_TOL`` of its max.  Where r, k and v
are bf16, so are dr, dk and dv: both packages round their float32
gradient to bf16 once, so an element may land one bf16 step apart
(``BF16_RTOL`` of it).  The autograd Function ``_WKV`` is checked on the
CPU, and chunk_bwd's shared-memory layout (``ops.bwd_layout``) against
every geometry the forward takes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import rwkv as RR
from repro_torch.kernels.rwkv6 import ops
from repro_torch.kernels.rwkv6 import ref
from repro_torch.models import rwkv as TR

#: Each gradient against jax.vjp: max abs error over its max.
GRAD_TOL = 1e-4
#: Against torch autograd through wkv6_ref (float32 on both sides), whose
#: float32 products are summed in other orders by einsum's backward.
AUTOGRAD_TOL = 1e-5
#: A bf16 gradient may land one bf16 step (2^-7 of it at most) apart.
BF16_RTOL = 2.0 ** -7

#: (B, S, H, K, chunk, r/k/v dtype, s0, dsf, decay, tail).  S is 2-4
#: chunks; "strong" decay puts lw down to -40 a step; a tail ends each
#: sequence with 5 steps of r = k = v = lw = 0 and dy = 0, as
#: rwkv6_timemix pads a sequence to the chunk.
CASES = [
    (2, 32, 2, 8, 8, "float32", True, True, "normal", False),
    (2, 64, 3, 16, 16, "float32", False, True, "strong", False),
    (2, 64, 4, 32, 32, "bfloat16", True, False, "normal", False),
    (2, 48, 2, 16, 16, "bfloat16", False, False, "normal", True),
    (2, 96, 2, 32, 32, "float32", True, True, "strong", False),
    (2, 64, 4, 8, 16, "float32", False, True, "normal", True),
]
IDS = ["L8-s0-dsf", "L16-strong-dsf", "L32-bf16-s0", "L16-bf16-tail",
       "L32-strong-s0-dsf", "L16-tail-dsf"]
NAMES = ("dr", "dk", "dv", "dlw", "du", "ds0")


def wkv_inputs(case, seed):
    """numpy (r, k, v, lw, u, s0, dy, dsf) of a case (s0 and dsf None where
    the case has none)."""
    bsz, s, h, kd, _, dtype, with_s0, with_dsf, decay, tail = case
    rng = np.random.default_rng(seed)
    r, k, v = ((rng.standard_normal((bsz, s, h, kd)) * 0.5).astype(np.float32)
               for _ in range(3))
    if decay == "strong":
        lw = -np.exp(rng.uniform(np.log(2.0), np.log(40.0), (bsz, s, h, kd)))
    else:
        lw = -np.exp(rng.standard_normal((bsz, s, h, kd)) * 0.5 - 1.5)
    lw = lw.astype(np.float32)
    u = (rng.standard_normal((h, kd)) * 0.1).astype(np.float32)
    s0 = rng.standard_normal((bsz, h, kd, kd)).astype(np.float32)
    dy = rng.standard_normal((bsz, s, h, kd)).astype(np.float32)
    dsf = rng.standard_normal((bsz, h, kd, kd)).astype(np.float32)
    if tail:
        for x in (r, k, v, lw, dy):
            x[:, -5:] = 0.0
    if dtype == "bfloat16":
        r, k, v = (np.asarray(jnp.asarray(t, jnp.bfloat16)) for t in (r, k, v))
    return (r, k, v, lw, u, s0 if with_s0 else None, dy,
            dsf if with_dsf else None)


def to_torch(v):
    if v is None:
        return None
    if v.dtype == jnp.bfloat16:
        return torch.from_numpy(v.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(v))


@pytest.fixture(scope="module")
def reference():
    """{case index: (inputs, the reference's (dr, dk, dv, dlw, du, ds0))}:
    jax.vjp of wkv6_chunked with s0 and dsf zeros where the case has
    none."""
    out = {}
    for n, case in enumerate(CASES):
        r, k, v, lw, u, s0, dy, dsf = wkv_inputs(case, seed=n)
        zeros = np.zeros((r.shape[0], r.shape[2], r.shape[3], r.shape[3]),
                         np.float32)
        _, vjp = jax.vjp(lambda *t: RR.wkv6_chunked(*t[:5], chunk=case[4],
                                                    s0=t[5]),
                         r, k, v, lw, u, zeros if s0 is None else s0)
        grads = vjp((jnp.asarray(dy),
                     jnp.asarray(zeros if dsf is None else dsf)))
        out[n] = ((r, k, v, lw, u, s0, dy, dsf), [np.asarray(g) for g in grads])
    return out


def held(got, want, tol):
    """{gradient: max error over its max}; raises where a bf16 gradient
    lands more than one bf16 step apart beyond ``tol`` of its max."""
    errs = {}
    for name, g, w in zip(NAMES, got, want):
        bf16 = g.dtype == torch.bfloat16
        g = g.float().numpy().astype(np.float64)
        w = np.asarray(w).astype(np.float64)
        top = max(np.abs(w).max(), 1e-30)
        diff = np.abs(g - w)
        if bf16:
            assert np.all(diff <= BF16_RTOL * np.abs(w) + tol * top), name
            diff = np.maximum(diff - BF16_RTOL * np.abs(w), 0.0)
        errs[name] = float(diff.max() / top)
    return errs


def run_bwd(inputs, chunk):
    """ops.wkv6_bwd on the CPU from the forward's kept scratch."""
    r, k, v, lw, u, s0, dy, dsf = map(to_torch, inputs)
    _, sf, cwl, s_in = ops.wkv6(r, k, v, lw, u, chunk=chunk, s0=s0,
                                keep=True)
    return ops.wkv6_bwd(r, k, v, lw, u, dy, dsf, chunk=chunk, cwl=cwl,
                        s_in=s_in, sf=sf)


@pytest.mark.parametrize("n", range(len(CASES)), ids=IDS)
def test_wkv_bwd_plain_version_matches_jax_vjp(reference, n):
    """dr, dk, dv, dlw, du and ds0 of wkv6_bwd_ref (through the wrapper's
    CPU path) within GRAD_TOL of jax.vjp of the reference's wkv6_chunked
    (bf16 dr, dk, dv one bf16 step apart at most), strong decay included;
    dr, dk and dv come back in r's dtype."""
    inputs, want = reference[n]
    got = run_bwd(inputs, CASES[n][4])
    assert all(g.dtype == to_torch(inputs[0]).dtype for g in got[:3])
    errs = held(got, want, GRAD_TOL)
    assert all(e <= GRAD_TOL for e in errs.values()), errs


@pytest.mark.parametrize("n", range(len(CASES)), ids=IDS)
def test_wkv_bwd_plain_version_matches_torch_autograd(reference, n):
    """The same gradients (r, k, v in float32 on both sides) against torch
    autograd through wkv6_ref, within AUTOGRAD_TOL."""
    inputs, _ = reference[n]
    r, k, v, lw, u, s0, dy, dsf = map(to_torch, inputs)
    chunk = CASES[n][4]
    zeros = torch.zeros((r.shape[0], r.shape[2], r.shape[3], r.shape[3]))
    leaves = [t.float().clone().requires_grad_()
              for t in (r, k, v, lw, u, zeros if s0 is None else s0)]
    y, sf, cwl, s_in = ref.wkv6_ref(*leaves[:5], chunk=chunk, s0=leaves[5],
                                    keep=True)
    loss = (y * dy).sum() + (0.0 if dsf is None else (sf * dsf).sum())
    want = torch.autograd.grad(loss, leaves)
    got = ref.wkv6_bwd_ref(*(t.detach() for t in leaves[:5]), dy, dsf,
                           chunk=chunk, cwl=cwl.detach(),
                           s_in=s_in.detach(), sf=sf.detach())
    errs = held(got, [w.numpy() for w in want], AUTOGRAD_TOL)
    assert all(e <= AUTOGRAD_TOL for e in errs.values()), errs


def test_wkv_bwd_passes_compose(reference):
    """The forward's kept scratch comes with the same (y, final state), and
    the backward is its passes composed: each pass's wrapper on the CPU is
    its plain version, and chunk_dstate, state_pass_bwd and chunk_bwd in
    turn give wkv6_bwd's gradients bit for bit."""
    inputs, _ = reference[0]
    r, k, v, lw, u, s0, dy, dsf = map(to_torch, inputs)
    chunk = CASES[0][4]
    y, sf, cwl, s_in = ops.wkv6(r, k, v, lw, u, chunk=chunk, s0=s0,
                                keep=True)
    assert all(torch.equal(a, b) for a, b in zip(
        (y, sf), ops.wkv6(r, k, v, lw, u, chunk=chunk, s0=s0)))
    whole = ops.wkv6_bwd(r, k, v, lw, u, dy, dsf, chunk=chunk, cwl=cwl,
                         s_in=s_in, sf=sf)
    q = ops.chunk_dstate(r, dy, lw, chunk=chunk)
    assert torch.equal(q, ref.chunk_dstate_ref(r, dy, lw, chunk=chunk))
    ds, ds0 = ops.state_pass_bwd(q.clone(), cwl, dsf=dsf)
    ds_ref, ds0_ref = ref.state_pass_bwd_ref(q.clone(), cwl, dsf=dsf)
    assert torch.equal(ds, ds_ref) and torch.equal(ds0, ds0_ref)
    got = ops.chunk_bwd(r, k, v, lw, u, dy, s_in, sf, ds, chunk=chunk)
    assert all(torch.equal(a, b) for a, b in zip(got, whole[:5]))
    assert torch.equal(ds0, whole[5])


def test_wkv_function_on_the_cpu():
    """wkv6_chunked under a gradient goes through the autograd Function:
    its forward equals wkv6_ref bit for bit, and its backward runs the
    plain backward once, giving wkv6_bwd_ref's gradients bit for bit."""
    r, k, v, lw, u, s0, dy, dsf = map(to_torch,
                                      wkv_inputs(CASES[0], seed=7))
    leaves = [t.clone().requires_grad_() for t in (r, k, v, lw, u, s0)]
    y, sf = TR.wkv6_chunked(*leaves[:5], chunk=8, s0=leaves[5])
    assert type(y.grad_fn).__name__ == "_WKVBackward"
    want_y, want_sf, cwl, s_in = ref.wkv6_ref(r, k, v, lw, u, chunk=8,
                                              s0=s0, keep=True)
    assert torch.equal(y, want_y) and torch.equal(sf, want_sf)
    calls = []
    real = ops.wkv6_bwd_ref

    def counted(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    ops.wkv6_bwd_ref = counted
    try:
        got = torch.autograd.grad((y * dy).sum() + (sf * dsf).sum(), leaves)
    finally:
        ops.wkv6_bwd_ref = real
    assert len(calls) == 1
    want = real(r, k, v, lw, u, dy, dsf, chunk=8, cwl=cwl, s_in=s_in,
                sf=want_sf)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_wkv_function_without_s0_or_state_gradient():
    """With s0 None the Function returns no gradient for it; a loss on y
    alone (the final state unused, as in training) runs the backward with
    no state gradient, equal to wkv6_bwd_ref's with dsf None; without a
    gradient the scan runs no Function."""
    r, k, v, lw, u, _, dy, _ = map(to_torch, wkv_inputs(CASES[5], seed=8))
    lw.requires_grad_()
    u.requires_grad_()
    y, _ = TR.wkv6_chunked(r, k, v, lw, u, chunk=16)
    got = torch.autograd.grad((y * dy).sum(), (lw, u))
    _, sf, cwl, s_in = ref.wkv6_ref(r, k, v, lw.detach(), u.detach(),
                                    chunk=16, keep=True)
    want = ref.wkv6_bwd_ref(r, k, v, lw.detach(), u.detach(), dy, None,
                            chunk=16, cwl=cwl, s_in=s_in, sf=sf)
    assert torch.equal(got[0], want[3]) and torch.equal(got[1], want[4])
    with torch.no_grad():
        y, _ = TR.wkv6_chunked(r, k, v, lw, u, chunk=16)
    assert y.grad_fn is None


def test_backward_takes_the_forward_geometry():
    """chunk_bwd's shared memory fits wherever the forward's does: over
    chunks up to 1024 and every K up to 128 the forward takes (multiples
    of its 16-byte quantum), with r, k, v in float32 or bf16, a layout fits
    (two blocks an SM where the fixed buffers and dy fit half an SM's
    shared memory, else one); each of dy, dS' and S that it reads from
    device memory would not fit beside the rest in the layout's budget;
    rows go unpadded, or v to device memory, only where the padded layout
    with v staged does not fit one block.  rwkv6-7b's training layer takes
    two blocks an SM with dy and dS' staged (S from device memory); K = 128
    at chunk 64 in bf16 one block with dy staged; chunk 192 with K = 16 one
    block with dS' and S staged; the largest chunks at small K drop the
    padding and v.  Past the forward's geometry the backward refuses by
    name."""
    taken, kinds = 0, set()
    for itemsize in (4, 2):
        quantum = 16 // itemsize
        for kd in range(quantum, 129, quantum):
            for chunk in range(4, 1025, 4):
                if ops.smem_bytes(chunk, kd, itemsize) > ops.MAX_SMEM:
                    continue
                taken += 1
                layout = ops.bwd_layout(chunk, kd, itemsize)
                key = (chunk, kd, itemsize)
                assert layout["bytes"] <= ops.MAX_SMEM, key
                budget = ops.SM_SMEM // layout["blocks"] - 1024
                lp, kp = -(-chunk // 16) * 16, -(-kd // 8) * 8
                lk = kp + 4 * layout["pad"]
                sizes = {"dy": 4 * lp * lk, "ds": 4 * kp * lk,
                         "s": 4 * kp * lk}
                assert all(layout["bytes"] + size > budget
                           for name, size in sizes.items()
                           if not layout[name]), key
                if not (layout["pad"] and layout["v"]):
                    padded = itemsize * 3 * lp * (kp + quantum) + 4 * (
                        2 * lp * (kp + 4) + lp * (lp + 4) + lp + kp)
                    assert padded > ops.MAX_SMEM, key
                kinds.add((layout["blocks"], layout["pad"], layout["v"]))
    assert taken == 1509
    assert kinds == {(2, True, True), (1, True, True), (1, True, False),
                     (1, False, True), (1, False, False)}
    assert ops.bwd_layout(64, 64, 2) == {
        "bytes": 115200, "blocks": 2, "pad": True, "v": True, "dy": True,
        "ds": True, "s": False}
    assert ops.bwd_layout(64, 64, 4) == {
        "bytes": 157184, "blocks": 1, "pad": True, "v": True, "dy": True,
        "ds": True, "s": True}
    assert ops.bwd_layout(64, 128, 2) == {
        "bytes": 171776, "blocks": 1, "pad": True, "v": True, "dy": True,
        "ds": False, "s": False}
    assert ops.bwd_layout(192, 16, 4) == {
        "bytes": 230720, "blocks": 1, "pad": True, "v": True, "dy": False,
        "ds": True, "s": True}
    assert ops.bwd_layout(216, 4, 4) == {
        "bytes": 230816, "blocks": 1, "pad": False, "v": False, "dy": False,
        "ds": True, "s": True}
    assert ops.smem_bytes(256, 64, 4) > ops.MAX_SMEM
    with pytest.raises(ValueError, match="wkv6 backward kernel: chunk 256"):
        ops._check_bwd_smem(256, 64, torch.float32)
