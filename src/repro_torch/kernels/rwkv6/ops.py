"""Wrapper of the RWKV-6 WKV kernel (``csrc/wkv6.cu``).

A CPU tensor goes to the plain version (``ref.py``); a CUDA tensor goes to
the kernel or raises.  The kernel runs as three passes, each one launch
with a wrapper of its own here: ``chunk_state`` (each chunk's total log
decay and its own state), ``state_pass`` (the state carried from chunk to
chunk, written in place over the chunks' own states) and ``chunk_scan``
(the output).  ``wkv6`` runs the three in order with their scratch; one
call makes three device launches.  The kernels read r, k, v and lw in
their ``[B, S, H, K]`` layout (contiguous): no transposed copy and no
tiled ``u``; ``wkv6`` first brings other layouts to it
(``kernel_layout``: K zero-padded to 16 bytes, strided or misaligned
tensors copied).  ``LAUNCHES`` counts calls of ``wkv6`` on the card (one per
rwkv layer), ``PASS_LAUNCHES`` the launches of each pass, from any wrapper.

The backward: ``wkv6_bwd`` runs four passes, each with a wrapper of its own
(``chunk_dstate``, ``state_pass_bwd``, and ``chunk_bwd``, which runs the
per-chunk kernel and the sum of its du partials over the batch and the
chunks); it reads the forward's scratch (``wkv6(..., keep=True)``).
``WKV_BWD_LAUNCHES`` counts its calls on the card, ``BWD_PASS_LAUNCHES``
each pass's launches.  ``bwd_layout`` mirrors the shared memory of
chunk_bwd's block: two blocks an SM where the fixed buffers and dy fit half
an SM's shared memory, else one; dy, the gradient of the state leaving the
chunk and the state entering it staged where they fit that budget, else
read from device memory; the rows padded and v staged where that fits, so
the backward takes every geometry the forward takes.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from .. import _build
from .ref import (chunk_bwd_ref, chunk_dstate_ref, chunk_scan_ref,
                  chunk_state_ref, state_pass_bwd_ref, state_pass_ref,
                  wkv6_bwd_ref, wkv6_ref)

#: Calls of :func:`wkv6` on the card in this process.
LAUNCHES = 0

#: Kernel launches of each pass in this process.
PASS_LAUNCHES = {"chunk_state": 0, "state_pass": 0, "chunk_scan": 0}

#: Calls of :func:`wkv6_bwd` on the card in this process.
WKV_BWD_LAUNCHES = 0

#: Kernel launches of each backward pass in this process.
BWD_PASS_LAUNCHES = {"chunk_dstate": 0, "state_pass_bwd": 0, "chunk_bwd": 0,
                     "sum_du": 0}

#: Shared memory one block may use on the H100 (bytes).
MAX_SMEM = 232448
#: An SM's shared memory on the H100; each resident block reserves 1 KB.
SM_SMEM = 233472
#: chunk_bwd's blocks an SM where its layout fits their share (``bwd_layout``).
BWD_BLOCKS = 2

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_PTR, _INT = ctypes.c_void_p, ctypes.c_int


@functools.lru_cache(maxsize=None)
def _launcher(name: str):
    lib = _build.load("wkv6")
    fn = getattr(lib, f"wkv6_{name}" if name == "chunk_bwd_smem"
                 else f"wkv6_{name}_launch")
    fn.argtypes = {
        "chunk_state": [_PTR] * 5 + [_INT] * 6 + [_PTR],
        "state_pass": [_PTR] * 4 + [_INT] * 4 + [_PTR],
        "chunk_scan": [_PTR] * 7 + [_INT] * 6 + [_PTR],
        "chunk_dstate": [_PTR] * 4 + [_INT] * 6 + [_PTR],
        "state_pass_bwd": [_PTR] * 4 + [_INT] * 4 + [_PTR],
        "chunk_bwd": [_PTR] * 14 + [_INT] * 6 + [_PTR],
        "sum_du": [_PTR] * 2 + [_INT] * 4 + [_PTR],
        "chunk_bwd_smem": [_INT] * 3 + [_PTR],
    }[name]
    fn.restype = (ctypes.c_longlong if name == "chunk_bwd_smem"
                  else ctypes.c_int)
    return fn


def _call(name: str, device, *args) -> None:
    stream = torch.cuda.current_stream(device).cuda_stream
    # The C launcher runs on the current device: make it the tensors'.
    with torch.cuda.device(device):
        rc = _launcher(name)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"wkv6 {name} kernel launch failed: CUDA error "
                           f"{rc}")


def _launch(name: str, device, *args) -> None:
    _call(name, device, *args)
    PASS_LAUNCHES[name] += 1


def _bwd_launch(name: str, device, *args) -> None:
    _call(name, device, *args)
    BWD_PASS_LAUNCHES[name] += 1


def ask_bwd_layout(chunk: int, kd: int, dtype, device) -> dict:
    """chunk_bwd's layout as the kernel's source chooses it (a query of the
    built library: no launch), in ``bwd_layout``'s form."""
    out = (ctypes.c_int * 6)()
    with torch.cuda.device(device):
        nbytes = _launcher("chunk_bwd_smem")(kd, chunk, _DTYPES[dtype], out)
    return {"bytes": int(nbytes), "blocks": int(out[3]), "pad": bool(out[4]),
            "v": bool(out[5]), "dy": bool(out[0]), "ds": bool(out[1]),
            "s": bool(out[2])}


def smem_bytes(chunk: int, kd: int, itemsize: int = 4) -> int:
    """Shared memory of the larger block of the passes, as ``csrc/wkv6.cu``
    lays them out, for r, k, v of ``itemsize`` bytes (4: float32, 2:
    bfloat16)."""
    staged = itemsize * chunk * (kd + 16 // itemsize)
    state = 2 * staged + 4 * (2 * chunk * (kd + 4) + kd)
    scan = 3 * staged + 4 * (2 * chunk * (kd + 4) + kd * (kd + 4)
                             + chunk * (chunk + 4) + chunk)
    return max(state, scan)


def bwd_layout(chunk, kd: int, itemsize: int = 4) -> dict:
    """chunk_bwd's shared memory at (chunk, K) with r, k, v of ``itemsize``
    bytes, as ``csrc/wkv6.cu`` chooses it (``bwd_layout``).  With lp the
    chunk rounded up to 16 and kp K up to 8: r, k and v (v where staged)
    [lp][kp] in their type, lw and cwe [lp][kp], the [lp][lp] matrix (dy
    v^T below its diagonal, the attention's transpose above), the bonus
    [lp], cwl [kp]; rows padded by 16 bytes (4 floats
    in the float32 buffers) and v staged where that fits, else the rows
    padded and v read from device memory, else neither.  The budget is half
    an SM's shared memory less 1 KB (two blocks an SM, ``BWD_BLOCKS``)
    where the fixed buffers and dy fit it, else ``MAX_SMEM``; then dy
    [lp][kp], the gradient of the state leaving the chunk and the state
    entering it ([kp][kp] each) are staged where each still fits the
    budget (else read from device memory).  Returns {"bytes", "blocks",
    "pad", "v", "dy", "ds", "s"}; "bytes" past ``MAX_SMEM`` where no layout
    fits (no geometry the forward takes)."""
    lp, kp = -(-chunk // 16) * 16, -(-kd // 8) * 8
    for pad in (True, False):
        lk, la = kp + 4 * pad, lp + 4 * pad
        lt = kp + (16 // itemsize) * pad
        for v in (True, False):
            base = (itemsize * (2 + v) * lp * lt
                    + 4 * (2 * lp * lk + lp * la + lp + kp))
            sizes = (("dy", 4 * lp * lk), ("ds", 4 * kp * lk),
                     ("s", 4 * kp * lk))
            for blocks in range(BWD_BLOCKS, 0, -1):
                budget = SM_SMEM // blocks - 1024
                if blocks > 1 and base + sizes[0][1] > budget:
                    continue
                if base > budget:
                    break
                out = {"bytes": base, "blocks": blocks, "pad": pad, "v": v}
                for name, size in sizes:
                    out[name] = out["bytes"] + size <= budget
                    out["bytes"] += size if out[name] else 0
                return out
    return {"bytes": base, "blocks": 0, "pad": False, "v": False,
            "dy": False, "ds": False, "s": False}


def bwd_smem_bytes(chunk, kd: int, itemsize: int = 4) -> int:
    """Shared memory of the backward's chunk_bwd block (``bwd_layout``)."""
    return bwd_layout(chunk, kd, itemsize)["bytes"]


def _check_devices(name, tensors) -> None:
    devices = {t.device for t in tensors if t is not None}
    if len(devices) != 1:
        raise ValueError(f"{name} inputs on several devices: {devices}")
    if next(iter(devices)).type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cpu or cuda, not {devices}")


def check_inputs(r, k, v, lw, u, chunk: int, s0) -> None:
    """Raises unless the inputs are what ``wkv6`` takes (``r``/``u`` None: a
    pass that does not read them)."""
    r_ = k if r is None else r
    if r_.dtype not in _DTYPES or k.dtype != r_.dtype or v.dtype != r_.dtype:
        raise TypeError("wkv6 takes r, k, v all float32 or all bfloat16, got "
                        f"{r_.dtype}, {k.dtype}, {v.dtype}")
    u_dtype = torch.float32 if u is None else u.dtype
    if lw.dtype != torch.float32 or u_dtype != torch.float32:
        raise TypeError(f"wkv6 takes float32 lw and u, got {lw.dtype}, "
                        f"{u_dtype}")
    if k.dim() != 4 or any(t.shape != k.shape for t in (r_, v, lw)):
        raise ValueError("wkv6 takes r, k, v, lw of one shape [B,S,H,K], got "
                         f"{[tuple(t.shape) for t in (r_, k, v, lw)]}")
    bsz, s, h, kd = k.shape
    if u is not None and tuple(u.shape) != (h, kd):
        raise ValueError(f"wkv6: u must be {(h, kd)}, got {tuple(u.shape)}")
    if min(bsz, s, h, kd, chunk) < 1 or s % chunk:
        raise ValueError(f"wkv6 needs non-empty inputs and S ({s}) a "
                         f"multiple of chunk ({chunk})")
    if s0 is not None and (s0.dtype != torch.float32
                           or tuple(s0.shape) != (bsz, h, kd, kd)):
        raise ValueError(f"wkv6: s0 must be float32 {(bsz, h, kd, kd)}, got "
                         f"{s0.dtype} {tuple(s0.shape)}")
    _check_devices("wkv6", [r, k, v, lw, u, s0])


def _check_kernel(tensors, kd, chunk, dtype) -> None:
    """What the kernels take beyond ``check_inputs``."""
    quantum = 16 // dtype.itemsize
    if kd % quantum or kd > 128 or chunk % 4:
        raise ValueError(f"wkv6 kernel copies rows in 16-byte pieces and "
                         f"splits a diagonal tile over at most a warp: it "
                         f"needs K ({kd}) a multiple of {quantum} for "
                         f"{dtype}, at most 128, and chunk ({chunk}) a "
                         "multiple of 4")
    need = smem_bytes(chunk, kd, dtype.itemsize)
    if need > MAX_SMEM:
        raise ValueError(f"wkv6 kernel: chunk {chunk} with K={kd} needs "
                         f"{need} bytes of shared memory, more than "
                         f"{MAX_SMEM}")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0
               for t in tensors if t is not None):
        raise ValueError("wkv6 kernel takes contiguous, 16-byte aligned "
                         "tensors")


def _aligned(t) -> bool:
    return t.is_contiguous() and t.data_ptr() % 16 == 0


def kernel_layout(r, k, v, lw, u, s0):
    """``(r, k, v, lw, u, s0)`` as the kernel takes them, and the real K.

    K is zero-padded up to the 16-byte quantum (8 bf16 or 4 float32
    values); every tensor that is not contiguous and 16-byte aligned is
    copied into one that is.  The padding is exact: with r = k = v = 0,
    lw = 0 and u = 0 (and s0 = 0) in the padded channels, their state rows
    never fill, their value columns stay zero, and they add only exact
    zeros to the real channels' y and state, which ``from_kernel_layout``
    slices back out."""
    kd = k.shape[-1]
    pad = -kd % (16 // k.dtype.itemsize)
    if pad:
        r, k, v, lw, u = (F.pad(t, (0, pad)) for t in (r, k, v, lw, u))
        if s0 is not None:
            s0 = F.pad(s0, (0, pad, 0, pad))
    fixed = [t if t is None or _aligned(t)
             else t.clone(memory_format=torch.contiguous_format)
             for t in (r, k, v, lw, u, s0)]
    return tuple(fixed), kd


def from_kernel_layout(y, sf, kd):
    """``(y, final state)`` of the padded channels' run cut back to K =
    ``kd``."""
    if y.shape[-1] == kd:
        return y, sf
    return y[..., :kd].contiguous(), sf[..., :kd, :kd].contiguous()


def _scratch_shapes(k, chunk):
    bsz, s, h, kd = k.shape
    nc = s // chunk
    return (bsz, nc, h, kd), (bsz, nc, h, kd, kd)


def _run_chunk_state(k, v, lw, chunk, cwl, states) -> None:
    bsz, s, h, kd = k.shape
    _launch("chunk_state", k.device, k.data_ptr(), v.data_ptr(),
            lw.data_ptr(), cwl.data_ptr(), states.data_ptr(), bsz, s, h, kd,
            chunk, _DTYPES[k.dtype])


def _run_state_pass(states, cwl, s0, sf) -> None:
    bsz, nc, h, kd, _ = states.shape
    _launch("state_pass", states.device, cwl.data_ptr(), states.data_ptr(),
            s0.data_ptr() if s0 is not None else None, sf.data_ptr(), bsz, nc,
            h, kd)


def _run_chunk_scan(r, k, v, lw, u, s_in, chunk, y) -> None:
    bsz, s, h, kd = r.shape
    _launch("chunk_scan", r.device, r.data_ptr(), k.data_ptr(), v.data_ptr(),
            lw.data_ptr(), u.data_ptr(), s_in.data_ptr(), y.data_ptr(), bsz,
            s, h, kd, chunk, _DTYPES[r.dtype])


def chunk_state(k: torch.Tensor, v: torch.Tensor, lw: torch.Tensor, *,
                chunk: int):
    """Pass 1: (cwl [B,nc,H,K], each chunk's total log decay; states
    [B,nc,H,K,K], each chunk's own state, k-major), float32."""
    check_inputs(None, k, v, lw, None, chunk, None)
    if k.device.type == "cpu":
        return chunk_state_ref(k, v, lw, chunk=chunk)
    _check_kernel([k, v, lw], k.shape[-1], chunk, k.dtype)
    shape_cwl, shape_states = _scratch_shapes(k, chunk)
    cwl = torch.empty(shape_cwl, dtype=torch.float32, device=k.device)
    states = torch.empty(shape_states, dtype=torch.float32, device=k.device)
    _run_chunk_state(k, v, lw, chunk, cwl, states)
    return cwl, states


def state_pass(states: torch.Tensor, cwl: torch.Tensor, *,
               s0: torch.Tensor | None = None):
    """Pass 2: overwrites ``states`` (each chunk's own state, k-major,
    [B,nc,H,K,K]) with the state entering each chunk, carried from ``s0``
    [B,H,K,K] (or zeros) by ``S <- exp(cwl) S + d_c``; returns (states,
    final state [B,H,K,K])."""
    bsz, nc, h, kd, _ = states.shape
    if states.dtype != torch.float32 or cwl.dtype != torch.float32 \
            or tuple(states.shape[3:]) != (kd, kd) \
            or tuple(cwl.shape) != (bsz, nc, h, kd):
        raise ValueError(f"state_pass takes float32 states [B,nc,H,K,K] and "
                         f"cwl [B,nc,H,K], got {states.dtype} "
                         f"{tuple(states.shape)}, {cwl.dtype} "
                         f"{tuple(cwl.shape)}")
    if s0 is not None and (s0.dtype != torch.float32
                           or tuple(s0.shape) != (bsz, h, kd, kd)):
        raise ValueError(f"state_pass: s0 must be float32 "
                         f"{(bsz, h, kd, kd)}, got {s0.dtype} "
                         f"{tuple(s0.shape)}")
    _check_devices("state_pass", [states, cwl, s0])
    if states.device.type == "cpu":
        return state_pass_ref(states, cwl, s0=s0)
    if kd % 4 or not all(t.is_contiguous() and t.data_ptr() % 16 == 0
                         for t in (states, cwl, s0) if t is not None):
        raise ValueError("state_pass kernel takes contiguous, 16-byte "
                         "aligned states, cwl and s0, and K a multiple of 4")
    sf = torch.empty((bsz, h, kd, kd), dtype=torch.float32,
                     device=states.device)
    _run_state_pass(states, cwl, s0, sf)
    return states, sf


def chunk_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               lw: torch.Tensor, u: torch.Tensor, s_in: torch.Tensor, *,
               chunk: int):
    """Pass 3: y [B,S,H,K] float32 from r, k, v, lw, u and the state
    entering each chunk ``s_in`` [B,nc,H,K,K] (k-major)."""
    check_inputs(r, k, v, lw, u, chunk, None)
    want = _scratch_shapes(k, chunk)[1]
    if s_in.dtype != torch.float32 or tuple(s_in.shape) != want:
        raise ValueError(f"chunk_scan: s_in must be float32 {want}, got "
                         f"{s_in.dtype} {tuple(s_in.shape)}")
    _check_devices("chunk_scan", [r, s_in])
    if r.device.type == "cpu":
        return chunk_scan_ref(r, k, v, lw, u, s_in, chunk=chunk)
    _check_kernel([r, k, v, lw, u, s_in], k.shape[-1], chunk, k.dtype)
    y = torch.empty(r.shape, dtype=torch.float32, device=r.device)
    _run_chunk_scan(r, k, v, lw, u, s_in, chunk, y)
    return y


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         lw: torch.Tensor, u: torch.Tensor, *, chunk: int,
         s0: torch.Tensor | None = None, keep: bool = False):
    """Chunked RWKV-6 recurrence: r, k, v [B,S,H,K] float32 or bfloat16, lw
    [B,S,H,K] float32 log decay (<= 0), u [H,K] float32 bonus, s0
    [B,H,K,K] float32 or None (zeros); S a multiple of ``chunk``.  Returns
    (y [B,S,H,K], final state [B,H,K,K] k-major), both float32, and with
    ``keep`` also the scratch the backward reads (cwl, the state entering
    each chunk; on the card in ``kernel_layout``).  On the
    card: the inputs in ``kernel_layout``, then ``chunk_state``,
    ``state_pass``, ``chunk_scan``, three launches with float32 scratch of
    K / chunk + 1 / chunk times y's size."""
    global LAUNCHES
    check_inputs(r, k, v, lw, u, chunk, s0)
    if r.device.type == "cpu":
        return wkv6_ref(r, k, v, lw, u, chunk=chunk, s0=s0, keep=keep)
    (r, k, v, lw, u, s0), k_real = kernel_layout(r, k, v, lw, u, s0)
    _check_kernel([r, k, v, lw, u, s0], k.shape[-1], chunk, k.dtype)
    bsz, s, h, kd = r.shape
    shape_cwl, shape_states = _scratch_shapes(k, chunk)
    cwl = torch.empty(shape_cwl, dtype=torch.float32, device=r.device)
    states = torch.empty(shape_states, dtype=torch.float32, device=r.device)
    sf = torch.empty((bsz, h, kd, kd), dtype=torch.float32, device=r.device)
    y = torch.empty((bsz, s, h, kd), dtype=torch.float32, device=r.device)
    _run_chunk_state(k, v, lw, chunk, cwl, states)
    _run_state_pass(states, cwl, s0, sf)
    _run_chunk_scan(r, k, v, lw, u, states, chunk, y)
    LAUNCHES += 1
    y, sf = from_kernel_layout(y, sf, k_real)
    return (y, sf, cwl, states) if keep else (y, sf)


def _check_grad(name, t, shape) -> None:
    if t is not None and (t.dtype != torch.float32
                          or tuple(t.shape) != tuple(shape)):
        raise ValueError(f"wkv6_bwd: {name} must be float32 {tuple(shape)}, "
                         f"got {t.dtype} {tuple(t.shape)}")


def chunk_dstate(r: torch.Tensor, dy: torch.Tensor, lw: torch.Tensor, *,
                 chunk: int):
    """Backward pass 1: q [B,nc,H,K,K], each chunk's sum_i (r_i *
    exp(cwe_i)) (x) dy_i (k-major, float32), from r, dy [B,S,H,K] (dy
    float32) and lw."""
    check_inputs(r, r, r, lw, None, chunk, None)
    _check_grad("dy", dy, r.shape)
    _check_devices("chunk_dstate", [r, dy, lw])
    if r.device.type == "cpu":
        return chunk_dstate_ref(r, dy, lw, chunk=chunk)
    _check_kernel([r, dy, lw], r.shape[-1], chunk, r.dtype)
    q = torch.empty(_scratch_shapes(r, chunk)[1], dtype=torch.float32,
                    device=r.device)
    _run_chunk_dstate(r, dy, lw, chunk, q)
    return q


def _run_chunk_dstate(r, dy, lw, chunk, q) -> None:
    bsz, s, h, kd = r.shape
    _bwd_launch("chunk_dstate", r.device, r.data_ptr(), lw.data_ptr(),
                dy.data_ptr(), q.data_ptr(), bsz, s, h, kd, chunk,
                _DTYPES[r.dtype])


def state_pass_bwd(q: torch.Tensor, cwl: torch.Tensor, *,
                   dsf: torch.Tensor | None = None):
    """Backward pass 2: overwrites ``q`` ([B,nc,H,K,K], k-major) with the
    gradient of the state leaving each chunk, carried backwards from
    ``dsf`` [B,H,K,K] (or zeros) by ``dS <- exp(cwl) dS' + q_c``; returns
    (q, the initial state's gradient [B,H,K,K])."""
    bsz, nc, h, kd, _ = q.shape
    if q.dtype != torch.float32 or cwl.dtype != torch.float32 \
            or tuple(q.shape[3:]) != (kd, kd) \
            or tuple(cwl.shape) != (bsz, nc, h, kd):
        raise ValueError(f"state_pass_bwd takes float32 q [B,nc,H,K,K] and "
                         f"cwl [B,nc,H,K], got {q.dtype} {tuple(q.shape)}, "
                         f"{cwl.dtype} {tuple(cwl.shape)}")
    _check_grad("dsf", dsf, (bsz, h, kd, kd))
    _check_devices("state_pass_bwd", [q, cwl, dsf])
    if q.device.type == "cpu":
        return state_pass_bwd_ref(q, cwl, dsf=dsf)
    if kd % 4 or not all(t.is_contiguous() and t.data_ptr() % 16 == 0
                         for t in (q, cwl, dsf) if t is not None):
        raise ValueError("state_pass_bwd kernel takes contiguous, 16-byte "
                         "aligned q, cwl and dsf, and K a multiple of 4")
    ds0 = torch.empty((bsz, h, kd, kd), dtype=torch.float32, device=q.device)
    _run_state_pass_bwd(q, cwl, dsf, ds0)
    return q, ds0


def _run_state_pass_bwd(q, cwl, dsf, ds0) -> None:
    bsz, nc, h, kd, _ = q.shape
    _bwd_launch("state_pass_bwd", q.device, cwl.data_ptr(), q.data_ptr(),
                dsf.data_ptr() if dsf is not None else None, ds0.data_ptr(),
                bsz, nc, h, kd)


def _check_bwd_smem(chunk, kd, dtype) -> None:
    """Raises where chunk_bwd's block cannot hold what it always stages (no
    geometry the forward takes: tests/test_torch_wkv_bwd.py sweeps them)."""
    need = bwd_smem_bytes(chunk, kd, dtype.itemsize)
    if need > MAX_SMEM:
        raise ValueError(f"wkv6 backward kernel: chunk {chunk} with K={kd} "
                         f"needs {need} bytes of shared memory, more than "
                         f"{MAX_SMEM}")


def _check_states(name, t, want) -> None:
    if t.dtype != torch.float32 or tuple(t.shape) != tuple(want):
        raise ValueError(f"{name} must be float32 {tuple(want)}, got "
                         f"{t.dtype} {tuple(t.shape)}")


def chunk_bwd(r, k, v, lw, u, dy, s_in, sf, ds, *, chunk: int):
    """Backward passes 3 and 4: (dr, dk, dv in r's dtype, dlw [B,S,H,K]
    float32, du [H,K] float32) from the forward's inputs, dy, the state
    entering each chunk ``s_in`` and the gradient of the state leaving it
    ``ds`` (both [B,nc,H,K,K]) and the final state ``sf`` [B,H,K,K].  On
    the card: the per-chunk kernel over groups of heads, then the sum of
    its du partials over (b, chunk) in order."""
    check_inputs(r, k, v, lw, u, chunk, None)
    _check_grad("dy", dy, r.shape)
    bsz, s, h, kd = r.shape
    for name, t in (("s_in", s_in), ("ds", ds)):
        _check_states(f"chunk_bwd: {name}", t, _scratch_shapes(r, chunk)[1])
    _check_states("chunk_bwd: sf", sf, (bsz, h, kd, kd))
    _check_devices("chunk_bwd", [r, k, v, lw, u, dy, s_in, sf, ds])
    if r.device.type == "cpu":
        return chunk_bwd_ref(r, k, v, lw, u, dy, s_in, sf, ds, chunk=chunk)
    _check_kernel([r, k, v, lw, u, dy, s_in, sf, ds], kd, chunk, r.dtype)
    _check_bwd_smem(chunk, kd, r.dtype)
    return _run_chunk_bwd(r, k, v, lw, u, dy, s_in, sf, ds, chunk)


def _run_chunk_bwd(r, k, v, lw, u, dy, s_in, sf, ds, chunk):
    bsz, s, h, kd = r.shape
    dev = r.device
    dr, dk, dv = (torch.empty(r.shape, dtype=r.dtype, device=dev)
                  for _ in range(3))
    dlw = torch.empty(r.shape, dtype=torch.float32, device=dev)
    part = torch.empty(_scratch_shapes(r, chunk)[0], dtype=torch.float32,
                       device=dev)
    _bwd_launch("chunk_bwd", dev, r.data_ptr(), k.data_ptr(), v.data_ptr(),
                lw.data_ptr(), u.data_ptr(), dy.data_ptr(), s_in.data_ptr(),
                sf.data_ptr(), ds.data_ptr(), dr.data_ptr(), dk.data_ptr(),
                dv.data_ptr(), dlw.data_ptr(), part.data_ptr(), bsz, s, h,
                kd, chunk, _DTYPES[r.dtype])
    du = torch.empty((h, kd), dtype=torch.float32, device=dev)
    _bwd_launch("sum_du", dev, part.data_ptr(), du.data_ptr(), bsz,
                s // chunk, h, kd)
    return dr, dk, dv, dlw, du


def wkv6_bwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             lw: torch.Tensor, u: torch.Tensor, dy: torch.Tensor,
             dsf: torch.Tensor | None = None, *, chunk: int,
             cwl: torch.Tensor, s_in: torch.Tensor, sf: torch.Tensor):
    """The gradient of :func:`wkv6`'s (y, final state) with respect to (r,
    k, v, lw, u, s0), given dy [B,S,H,K] and dsf [B,H,K,K] (float32; None:
    zeros), the forward's scratch ``cwl`` and ``s_in`` (``keep=True``; s0
    entered them) and its final state ``sf``.  Returns (dr, dk, dv in r's
    dtype, dlw float32, du [H,K] float32, ds0 [B,H,K,K] float32).  On the
    card: the inputs in ``kernel_layout``, then ``chunk_dstate``,
    ``state_pass_bwd``, ``chunk_bwd`` and its du sum, four launches,
    deterministic (no atomics)."""
    global WKV_BWD_LAUNCHES
    check_inputs(r, k, v, lw, u, chunk, None)
    bsz, s, h, kd = r.shape
    _check_grad("dy", dy, r.shape)
    _check_grad("dsf", dsf, (bsz, h, kd, kd))
    _check_devices("wkv6_bwd", [r, k, v, lw, u, dy, dsf, cwl, s_in, sf])
    if r.device.type == "cpu":
        return wkv6_bwd_ref(r, k, v, lw, u, dy, dsf, chunk=chunk, cwl=cwl,
                            s_in=s_in, sf=sf)
    (r, k, v, lw, u, _), k_real = kernel_layout(r, k, v, lw, u, None)
    pad = r.shape[-1] - kd
    if pad:
        dy = F.pad(dy, (0, pad))
        sf = F.pad(sf, (0, pad, 0, pad))
        dsf = None if dsf is None else F.pad(dsf, (0, pad, 0, pad))
    dy, sf = dy.contiguous(), sf.contiguous()
    dsf = None if dsf is None else dsf.contiguous()
    _check_kernel([r, k, v, lw, u, dy, sf, dsf, cwl, s_in], r.shape[-1],
                  chunk, r.dtype)
    _check_bwd_smem(chunk, r.shape[-1], r.dtype)
    shape_cwl, shape_states = _scratch_shapes(r, chunk)
    _check_states("wkv6_bwd: cwl", cwl, shape_cwl)
    _check_states("wkv6_bwd: s_in", s_in, shape_states)
    q = torch.empty(shape_states, dtype=torch.float32, device=r.device)
    ds0 = torch.empty(sf.shape, dtype=torch.float32, device=r.device)
    _run_chunk_dstate(r, dy, lw, chunk, q)
    _run_state_pass_bwd(q, cwl, dsf, ds0)
    dr, dk, dv, dlw, du = _run_chunk_bwd(r, k, v, lw, u, dy, s_in, sf, q,
                                         chunk)
    WKV_BWD_LAUNCHES += 1
    if pad:
        dr, dk, dv, dlw = (t[..., :kd].contiguous() for t in (dr, dk, dv, dlw))
        du, ds0 = du[:, :kd].contiguous(), ds0[..., :kd, :kd].contiguous()
    return dr, dk, dv, dlw, du, ds0
