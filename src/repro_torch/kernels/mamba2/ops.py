"""Wrapper of the Mamba-2 SSD scan kernel (``csrc/mamba2_ssd.cu``).

A CPU tensor goes to the plain version (``ref.py``); a CUDA tensor goes to
the kernel or raises.  The kernel runs as three passes, each one launch
with a wrapper of its own here: ``chunk_state`` (the in-chunk prefix sums
of the log decay and each chunk's own state), ``state_pass`` (the state
carried from chunk to chunk, written in place over the chunks' own states)
and ``chunk_scan`` (the output).  ``mamba2_ssd`` runs the three in order
with their scratch; one call makes three device launches.  The kernels read
x, a, b and c in place through their strides (innermost dimension
contiguous), so the slices of the model's fused projection need no copy;
``mamba2_ssd`` brings other layouts to one the kernel reads
(``kernel_layout``: P and N zero-padded to multiples of 4, copies where
the strides do not fit).
``LAUNCHES`` counts calls of ``mamba2_ssd`` on the card (one per mamba
layer), ``PASS_LAUNCHES`` the launches of each pass, from any wrapper.

``step_and_decay`` is a fourth, elementwise kernel of the same source: the
scan's step ``dt`` and decay ``a`` from the projection's ``dt_raw``, in
the reference's float32 roundings (``STEP_DECAY_LAUNCHES`` counts it);
``step_decay_sweep`` runs its exhaustive check over all float32 inputs.

The backward: ``mamba2_ssd_bwd`` runs four passes, each with a wrapper of
its own (``chunk_dstate``, ``state_pass_bwd``, and ``chunk_bwd``, which
runs the per-chunk kernel -- split TF32 on the tensor cores, P in slices,
so it takes every geometry the forward takes (``bwd_layout``) -- and the
sum of its head groups' partials); ``SSD_BWD_LAUNCHES`` counts its calls on
the card, ``BWD_PASS_LAUNCHES`` each pass's launches.
``step_and_decay_bwd`` is the step and decay's backward
(``STEP_DECAY_BWD_LAUNCHES``; one device launch a call, whose last block
to finish sums the row tiles' partials).
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F

from .. import _build
from .ref import (chunk_bwd_ref, chunk_dstate_ref, chunk_scan_ref,
                  chunk_state_ref, mamba2_ssd_bwd_ref, mamba2_ssd_ref,
                  state_pass_bwd_ref, state_pass_ref, step_and_decay_bwd_ref,
                  step_and_decay_ref)

#: Calls of :func:`mamba2_ssd` on the card in this process.
LAUNCHES = 0

#: Kernel launches of each pass in this process.
PASS_LAUNCHES = {"chunk_state": 0, "state_pass": 0, "chunk_scan": 0}

#: Launches of the step_decay kernel in this process.
STEP_DECAY_LAUNCHES = 0

#: Calls of :func:`mamba2_ssd_bwd` on the card in this process.
SSD_BWD_LAUNCHES = 0

#: Kernel launches of each backward pass in this process.
BWD_PASS_LAUNCHES = {"chunk_dstate": 0, "state_pass_bwd": 0, "chunk_bwd": 0,
                     "sum_groups": 0}

#: Calls of :func:`step_and_decay_bwd` on the card in this process, one
#: device launch each.
STEP_DECAY_BWD_LAUNCHES = 0


#: Shared memory one block may use on the H100 (bytes).
MAX_SMEM = 232448

#: Most heads one chunk_state block takes (its prefix sums stay in shared
#: memory); the launcher picks 1 to this many.
MAX_HEADS_PER_BLOCK = 16

#: Column ranges one step_decay_bwd launch takes (``kStepBwdMaxRanges``),
#: each with a counter of the row tiles done.
STEP_BWD_MAX_RANGES = 64

#: step_decay_bwd's counters, one zeroed set per (device, stream): launches
#: on one stream run in order and share a set (each leaves it zero);
#: launches on two streams may overlap, and get a set each.
_STEP_BWD_DONE: dict = {}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_PTR, _INT, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


#: The source's queries: functions that launch nothing (no ``_launch``).
_QUERIES = ("step_decay_bwd_tiles", "chunk_bwd_heads", "chunk_bwd_smem")


@functools.lru_cache(maxsize=None)
def _launcher(name: str):
    lib = _build.load("mamba2_ssd")
    fn = getattr(lib, f"mamba2_{name}" if name in _QUERIES
                 else f"mamba2_{name}_launch")
    fn.argtypes = {
        "chunk_state": [_PTR] * 5 + [_INT] * 6 + [_LL] * 7 + [_INT, _PTR],
        "state_pass": [_PTR] * 4 + [_INT] * 6 + [_PTR],
        "chunk_scan": [_PTR] * 6 + [_INT] * 6 + [_LL] * 7 + [_INT, _PTR],
        "step_decay": [_PTR] * 5 + [_INT] * 2 + [_LL, _INT, _PTR],
        "step_decay_sweep": [_PTR] * 3,
        "step_decay_bwd_tiles": [_INT],
        "step_decay_bwd": [_PTR] * 12 + [_INT] * 2 + [_LL, _INT, _PTR],
        "chunk_dstate": [_PTR] * 4 + [_INT] * 6 + [_LL] * 2 + [_INT, _PTR],
        "state_pass_bwd": [_PTR] * 4 + [_INT] * 6 + [_PTR],
        "chunk_bwd_heads": [_INT] * 4,
        "chunk_bwd_smem": [_INT] * 4 + [_PTR],
        "chunk_bwd": [_PTR] * 12 + [_INT] * 7 + [_LL] * 9 + [_INT, _PTR],
        "sum_groups": [_PTR] * 4 + [_INT] * 5 + [_PTR],
    }[name]
    fn.restype = _LL if name == "chunk_bwd_smem" else ctypes.c_int
    return fn


def _call(name: str, device, *args) -> None:
    stream = torch.cuda.current_stream(device).cuda_stream
    # The C launcher runs on the current device: make it the tensors'.
    with torch.cuda.device(device):
        rc = _launcher(name)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"mamba2_ssd {name} kernel launch failed: CUDA "
                           f"error {rc}")


def _launch(name: str, device, *args) -> None:
    _call(name, device, *args)
    PASS_LAUNCHES[name] += 1


def _ask(name: str, *args) -> int:
    """The value of a launcher's query (no launch) on the current device."""
    return _launcher(name)(*args)


def smem_bytes(chunk, p, n):
    """Shared memory of the larger block of the passes, as
    ``csrc/mamba2_ssd.cu`` lays them out (elementwise for numpy arrays)."""
    lt = chunk // 4
    state = (chunk * (n + 4) + chunk * (p + 4)
             + chunk * (1 + MAX_HEADS_PER_BLOCK))
    scan = (33 * (lt * (lt + 1) // 2) + chunk * (n + 4)
            + 2 * np.maximum(chunk * (p + 4), n * (chunk + 4))
            + 2 * n * (p + 4) + 3 * chunk)
    return 4 * np.maximum(state, scan)


def _bwd_layout_floats(chunk, n, ps, pad, m1, itemsize):
    """Floats of chunk_bwd's shared memory with P slices of ``ps`` columns,
    rows padded by ``pad`` elements, M1^T stored or not and B, C kept in
    b's dtype (``itemsize`` bytes), as ``csrc/mamba2_ssd.cu`` lays it out
    (``bwd_layout_of``: every region rounded up to 4 floats; elementwise
    for numpy arrays)."""
    def r4(r):
        return -(-r // 4) * 4
    lp, np_ = -(-chunk // 16) * 16, -(-n // 8) * 8
    nb, nq = lp // 16, -(-np_ // 32)
    banded = 128 * nb * (nb + 1) + 16 * pad * nb
    small = _bwd_build(chunk, n) == 0  # sum_h M2 stored
    return (2 * r4(lp * (ps + pad)) + 2 * r4(np_ * (ps + pad))
            + 2 * r4(-(-lp * (np_ + pad) * itemsize // 4))
            + r4(banded) * (1 + small + m1) + 6 * r4(lp)
            + r4(512 // 32 + 1) + r4(24 * nb * (nb + 1)) + r4(16 * nb * nq)
            + r4(16 * nb * ps // 8))

#: chunk_bwd's builds, (16 x 32 units of dB and dC, lower 16 x 8 tiles of
#: C B^T) its 16 warps hold (``kSmallUnits``, ``kSmallLower``,
#: ``kLargeUnits``, ``kLargeLower`` times 16): the small one holds sum_h M2
#: in shared memory, the large one in registers.
BWD_BUILDS = ((16, 80), (48, 224))


def _bwd_build(chunk, n):
    """chunk_bwd's build at (chunk, N): 0 small, 1 large, 2 past both (the
    kernel refuses); elementwise for numpy arrays."""
    nb = -(-chunk // 16)
    nq = -(-(-(-n // 8) * 8) // 32)
    fits = [(nb * nq <= units) & (nb * (nb + 1) <= lower)
            for units, lower in BWD_BUILDS]
    return np.where(fits[0], 0, np.where(fits[1], 1, 2))


#: chunk_bwd's layouts in the order ``bwd_layout`` tries them: (M1^T
#: stored, row padding, P slice).
BWD_LAYOUTS = tuple((m1, pad, ps) for m1 in (True, False) for pad in (4, 0)
                    for ps in (64, 32, 16, 8))


def bwd_layout(chunk: int, p: int, n: int, itemsize: int = 4) -> dict:
    """chunk_bwd's layout at (chunk, P, N) with b and c of ``itemsize``
    bytes, as ``csrc/mamba2_ssd.cu`` chooses it (``bwd_layout``): the
    widest P slice (64, 32, 16 or 8 columns, no wider than P rounded up to
    8) that fits ``MAX_SMEM``, rows padded by 4 elements where that fits,
    else by none, and M1^T stored where that fits, else formed from the
    Gram as the kernel reads it, and the build that holds its accumulators
    (``BWD_BUILDS``).  Returns {"ps", "pad", "m1", "bytes", "build"};
    raises where no layout fits or neither build holds the tiles (no
    geometry the forward takes)."""
    build = int(_bwd_build(chunk, n))
    if build == 2:
        raise ValueError(f"mamba2_ssd backward kernel: chunk {chunk} with "
                         f"N={n} has more tiles than its builds hold")
    p8 = -(-p // 8) * 8
    for m1, pad, ps in BWD_LAYOUTS:
        if ps > p8 and ps > 8:
            continue
        nbytes = int(4 * _bwd_layout_floats(chunk, n, ps, pad, m1,
                                            itemsize))
        if nbytes <= MAX_SMEM:
            return {"ps": ps, "pad": pad, "m1": m1, "bytes": nbytes,
                    "build": build}
    raise ValueError(f"mamba2_ssd backward kernel: no shared-memory layout "
                     f"fits chunk {chunk}, P={p}, N={n}")


def bwd_smem_bytes(chunk: int, p: int, n: int, itemsize: int = 4) -> int:
    """Shared memory of the backward's chunk_bwd block (``bwd_layout``)."""
    return bwd_layout(chunk, p, n, itemsize)["bytes"]


def _check_devices(name, tensors) -> None:
    devices = {t.device for t in tensors if t is not None}
    if len(devices) != 1:
        raise ValueError(f"{name} inputs on several devices: {devices}")
    if next(iter(devices)).type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cpu or cuda, not {devices}")


def check_inputs(x, a, b, c, chunk: int, h0) -> None:
    """Raises unless the inputs are what ``mamba2_ssd`` takes (``a`` None:
    a pass that does not read the decay)."""
    a_dtype = torch.float32 if a is None else a.dtype
    if x.dtype != torch.float32 or a_dtype != torch.float32:
        raise TypeError(f"mamba2_ssd takes float32 x and a, got {x.dtype}, "
                        f"{a_dtype}")
    if b.dtype not in _DTYPES or c.dtype != b.dtype:
        raise TypeError("mamba2_ssd takes b and c both float32 or both "
                        f"bfloat16, got {b.dtype}, {c.dtype}")
    a_shape = x.shape[:3] if a is None else a.shape
    if x.dim() != 4 or len(a_shape) != 3 or b.dim() != 3 \
            or c.shape != b.shape:
        raise ValueError("mamba2_ssd takes x [B,S,H,P], a [B,S,H], b/c "
                         f"[B,S,N], got {tuple(x.shape)}, {tuple(a_shape)}, "
                         f"{tuple(b.shape)}, {tuple(c.shape)}")
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    if tuple(a_shape) != (bsz, s, h) or tuple(b.shape[:2]) != (bsz, s):
        raise ValueError(f"mamba2_ssd: a {tuple(a_shape)} and b "
                         f"{tuple(b.shape)} do not match x {tuple(x.shape)}")
    if min(bsz, s, h, p, n, chunk) < 1 or s % chunk:
        raise ValueError(f"mamba2_ssd needs non-empty inputs and S ({s}) a "
                         f"multiple of chunk ({chunk})")
    if h0 is not None and (h0.dtype != torch.float32
                           or tuple(h0.shape) != (bsz, h, p, n)):
        raise ValueError(f"mamba2_ssd: h0 must be float32 {(bsz, h, p, n)}, "
                         f"got {h0.dtype} {tuple(h0.shape)}")
    _check_devices("mamba2_ssd", [x, a, b, c, h0])


def _check_kernel(x, a, b, c, chunk, h0) -> None:
    """What the kernel takes beyond ``check_inputs``."""
    p, n = x.shape[-1], b.shape[-1]
    if p % 4 or n % 4 or chunk % 4:
        raise ValueError(f"mamba2_ssd kernel needs P ({p}), N ({n}) and "
                         f"chunk ({chunk}) multiples of 4")
    if smem_bytes(chunk, p, n) > MAX_SMEM:
        raise ValueError(f"mamba2_ssd kernel: chunk {chunk} with P={p}, "
                         f"N={n} needs {smem_bytes(chunk, p, n)} bytes of "
                         f"shared memory, more than {MAX_SMEM}")
    if x.stride(3) != 1 or (a is not None and a.stride(2) != 1) \
            or b.stride(2) != 1 or (c is not None and c.stride(2) != 1):
        raise ValueError("mamba2_ssd kernel needs the innermost dimension of "
                         "x, a, b and c contiguous")
    if x.data_ptr() % 16 or any(st % 4 for st in x.stride()[:3]):
        raise ValueError("mamba2_ssd kernel copies x in 16-byte pieces: it "
                         "needs x 16-byte aligned with strides that are "
                         "multiples of 4")
    if h0 is not None and not h0.is_contiguous():
        raise ValueError("mamba2_ssd kernel takes a contiguous h0")


def _takes(x, a, b, c, h0) -> bool:
    """Whether the kernel reads these tensors as they lie."""
    return (x.stride(3) == 1 and a.stride(2) == 1 and b.stride(2) == 1
            and c.stride(2) == 1 and x.data_ptr() % 16 == 0
            and all(st % 4 == 0 for st in x.stride()[:3])
            and (h0 is None or h0.is_contiguous()))


def kernel_layout(x, a, b, c, h0):
    """``(x, a, b, c, h0)`` as the kernel takes them, and the real (P, N).

    P and N are zero-padded up to multiples of 4; where the kernel could
    not read a tensor through its strides (innermost dimension strided, x
    misaligned or with strides not multiples of 4, h0 not contiguous),
    every input is copied into a contiguous, 16-byte aligned tensor.  The
    padding is exact: x = 0 in the padded P columns keeps their y and state
    at zero, and b = c = 0 (h0 = 0) in the padded N channels adds only exact
    zeros to the real channels' C.B products and state, which
    ``from_kernel_layout`` slices back out."""
    p, n = x.shape[-1], b.shape[-1]
    pad_p, pad_n = -p % 4, -n % 4
    if pad_p or pad_n:
        x = F.pad(x, (0, pad_p))
        b, c = F.pad(b, (0, pad_n)), F.pad(c, (0, pad_n))
        if h0 is not None:
            h0 = F.pad(h0, (0, pad_n, 0, pad_p))
    if not _takes(x, a, b, c, h0):
        x, a, b, c, h0 = (t if t is None
                          else t.clone(memory_format=torch.contiguous_format)
                          for t in (x, a, b, c, h0))
    return (x, a, b, c, h0), (p, n)


def from_kernel_layout(y, hf, pn):
    """``(y, final state)`` of the padded run cut back to (P, N) = ``pn``."""
    p, n = pn
    if tuple(hf.shape[-2:]) == (p, n):
        return y, hf
    return y[..., :p].contiguous(), hf[..., :p, :n].contiguous()


def _scratch_shapes(x, b, chunk):
    bsz, s, h, p = x.shape
    nc = s // chunk
    return (bsz, nc, h, chunk), (bsz, nc, h, b.shape[-1], p)


def _check_scratch(name, cum, states, x, b, chunk) -> None:
    want_cum, want_states = _scratch_shapes(x, b, chunk)
    for label, t, shape in (("cum", cum, want_cum),
                            ("states", states, want_states)):
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"{name}: {label} must be float32 {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device.type == "cuda" and (not t.is_contiguous()
                                        or t.data_ptr() % 16):
            raise ValueError(f"{name} kernel takes a contiguous {label}, "
                             "16-byte aligned")


def _run_chunk_state(x, a, b, chunk, cum, states) -> None:
    bsz, s, h, p = x.shape
    _launch("chunk_state", x.device, x.data_ptr(), a.data_ptr(), b.data_ptr(),
            cum.data_ptr(), states.data_ptr(), bsz, s, h, p, b.shape[-1],
            chunk, x.stride(0), x.stride(1), x.stride(2), a.stride(0),
            a.stride(1), b.stride(0), b.stride(1), _DTYPES[b.dtype])


def _run_state_pass(states, cum, h0, hf) -> None:
    bsz, nc, h, n, p = states.shape
    _launch("state_pass", states.device, cum.data_ptr(), states.data_ptr(),
            h0.data_ptr() if h0 is not None else None, hf.data_ptr(), bsz,
            nc, h, p, n, cum.shape[-1])


def _run_chunk_scan(x, b, c, cum, h_in, chunk, y) -> None:
    bsz, s, h, p = x.shape
    _launch("chunk_scan", x.device, x.data_ptr(), b.data_ptr(), c.data_ptr(),
            cum.data_ptr(), h_in.data_ptr(), y.data_ptr(), bsz, s, h, p,
            b.shape[-1], chunk, x.stride(0), x.stride(1), x.stride(2),
            b.stride(0), b.stride(1), c.stride(0), c.stride(1),
            _DTYPES[b.dtype])


def chunk_state(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, *,
                chunk: int):
    """Pass 1: (cum [B,nc,H,L], the in-chunk inclusive prefix sums of the log
    decay; states [B,nc,H,N,P], each chunk's own state, transposed),
    float32."""
    check_inputs(x, a, b, b, chunk, None)
    if x.device.type == "cpu":
        return chunk_state_ref(x, a, b, chunk=chunk)
    _check_kernel(x, a, b, None, chunk, None)
    shape_cum, shape_states = _scratch_shapes(x, b, chunk)
    cum = torch.empty(shape_cum, dtype=torch.float32, device=x.device)
    states = torch.empty(shape_states, dtype=torch.float32, device=x.device)
    _run_chunk_state(x, a, b, chunk, cum, states)
    return cum, states


def state_pass(states: torch.Tensor, cum: torch.Tensor, *,
               h0: torch.Tensor | None = None):
    """Pass 2: overwrites ``states`` (each chunk's own state, transposed,
    [B,nc,H,N,P]) with the state entering each chunk, carried from ``h0``
    [B,H,P,N] (or zeros) by ``h <- exp(cum_{L-1}) h + s_c``; returns
    (states, h_final [B,H,P,N])."""
    bsz, nc, h, n, p = states.shape
    chunk = cum.shape[-1]
    if states.dtype != torch.float32 or cum.dtype != torch.float32 \
            or tuple(cum.shape[:3]) != (bsz, nc, h):
        raise ValueError(f"state_pass takes float32 states [B,nc,H,N,P] and "
                         f"cum [B,nc,H,L], got {states.dtype} "
                         f"{tuple(states.shape)}, {cum.dtype} "
                         f"{tuple(cum.shape)}")
    if h0 is not None and (h0.dtype != torch.float32
                           or tuple(h0.shape) != (bsz, h, p, n)):
        raise ValueError(f"state_pass: h0 must be float32 {(bsz, h, p, n)}, "
                         f"got {h0.dtype} {tuple(h0.shape)}")
    _check_devices("state_pass", [states, cum, h0])
    if states.device.type == "cpu":
        return state_pass_ref(states, cum, h0=h0)
    if p % 4 or n % 4 or chunk % 4 or states.data_ptr() % 16 \
            or not (states.is_contiguous() and cum.is_contiguous()) \
            or (h0 is not None and not h0.is_contiguous()):
        raise ValueError("state_pass kernel takes contiguous states (16-byte "
                         "aligned), cum and h0, and P, N and L multiples of 4")
    hf = torch.empty((bsz, h, p, n), dtype=torch.float32, device=states.device)
    _run_state_pass(states, cum, h0, hf)
    return states, hf


def chunk_scan(x: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
               cum: torch.Tensor, h_in: torch.Tensor, *, chunk: int):
    """Pass 3: y [B,S,H,P] float32 from x, b/c, the prefix sums ``cum``
    [B,nc,H,L] and the state entering each chunk, transposed, ``h_in``
    [B,nc,H,N,P]."""
    check_inputs(x, None, b, c, chunk, None)
    _check_scratch("chunk_scan", cum, h_in, x, b, chunk)
    _check_devices("chunk_scan", [x, b, c, cum, h_in])
    if x.device.type == "cpu":
        return chunk_scan_ref(x, b, c, cum, h_in, chunk=chunk)
    _check_kernel(x, None, b, c, chunk, None)
    y = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    _run_chunk_scan(x, b, c, cum, h_in, chunk, y)
    return y


def mamba2_ssd(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
               c: torch.Tensor, *, chunk: int,
               h0: torch.Tensor | None = None, keep: bool = False):
    """Chunked Mamba-2 SSD scan: x [B,S,H,P] float32 (dt-scaled), a [B,S,H]
    float32 decay in (0, 1], b/c [B,S,N] float32 or bfloat16 (shared across
    heads), h0 [B,H,P,N] float32 or None (zeros); S a multiple of
    ``chunk``.  Returns (y [B,S,H,P], h_final [B,H,P,N]), both float32,
    and with ``keep`` also the scratch the backward reads (cum, the state
    entering each chunk; on the card in ``kernel_layout``).
    On the card: the inputs in ``kernel_layout``, then ``chunk_state``,
    ``state_pass``, ``chunk_scan``, three
    launches with float32 scratch of N / chunk + 1 / P times x's size."""
    global LAUNCHES
    check_inputs(x, a, b, c, chunk, h0)
    if x.device.type == "cpu":
        return mamba2_ssd_ref(x, a, b, c, chunk=chunk, h0=h0, keep=keep)
    (x, a, b, c, h0), pn = kernel_layout(x, a, b, c, h0)
    _check_kernel(x, a, b, c, chunk, h0)
    shape_cum, shape_states = _scratch_shapes(x, b, chunk)
    cum = torch.empty(shape_cum, dtype=torch.float32, device=x.device)
    states = torch.empty(shape_states, dtype=torch.float32, device=x.device)
    hf = torch.empty((x.shape[0], x.shape[2], x.shape[3], b.shape[-1]),
                     dtype=torch.float32, device=x.device)
    y = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    _run_chunk_state(x, a, b, chunk, cum, states)
    _run_state_pass(states, cum, h0, hf)
    _run_chunk_scan(x, b, c, cum, states, chunk, y)
    LAUNCHES += 1
    y, hf = from_kernel_layout(y, hf, pn)
    return (y, hf, cum, states) if keep else (y, hf)


def step_and_decay(dt_raw: torch.Tensor, dt_bias: torch.Tensor,
                   a_log: torch.Tensor):
    """(dt = softplus(dt_raw + dt_bias), a = exp(-dt exp(a_log))), both
    float32 of ``dt_raw``'s shape [..., H], every operation rounded as the
    reference's compiled float32 code rounds it (``step_and_decay_ref``).
    ``dt_raw`` is float32 or bfloat16 (read as float32); ``dt_bias`` and
    ``a_log`` are float32 [H].  On the card: one launch that reads
    ``dt_raw`` through its row stride (innermost dimension contiguous)."""
    global STEP_DECAY_LAUNCHES
    h = dt_raw.shape[-1]
    if dt_raw.dtype not in _DTYPES or dt_raw.dim() < 1:
        raise TypeError("step_and_decay takes float32 or bfloat16 dt_raw "
                        f"[..., H], got {dt_raw.dtype} {tuple(dt_raw.shape)}")
    for name, t in (("dt_bias", dt_bias), ("a_log", a_log)):
        if t.dtype != torch.float32 or tuple(t.shape) != (h,):
            raise ValueError(f"step_and_decay: {name} must be float32 "
                             f"({h},), got {t.dtype} {tuple(t.shape)}")
    _check_devices("step_and_decay", [dt_raw, dt_bias, a_log])
    if dt_raw.device.type == "cpu":
        return step_and_decay_ref(dt_raw, dt_bias, a_log)
    rows = dt_raw.reshape(-1, h)
    if rows.stride(1) != 1 or rows.stride(0) < h:
        rows = rows.contiguous()
    if rows.numel() >= 2 ** 31 or rows.shape[0] == 0:
        raise ValueError(f"step_and_decay kernel takes 1 to 2^31 - 1 "
                         f"elements, got {rows.numel()}")
    bias, a_log = dt_bias.contiguous(), a_log.contiguous()
    dt = torch.empty(rows.shape, dtype=torch.float32, device=rows.device)
    a = torch.empty_like(dt)
    _call("step_decay", rows.device, rows.data_ptr(), bias.data_ptr(),
          a_log.data_ptr(), dt.data_ptr(), a.data_ptr(), rows.shape[0], h,
          rows.stride(0), _DTYPES[rows.dtype])
    STEP_DECAY_LAUNCHES += 1
    return dt.view(dt_raw.shape), a.view(dt_raw.shape)


def step_decay_sweep(device="cuda") -> dict:
    """The step_decay kernel's exhaustive check on the card: every float32
    bit pattern through exp, log1p and softplus as the first version
    computed them (each multiply-add a float64 product and sum) and as the
    kernel does (log1p on the arguments softplus gives it: +0, normal
    floats up to 1, NaN).  Returns {function: (inputs whose bits differ,
    the least such input's bits or None)}; two NaNs count as equal."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError("step_decay_sweep runs on the card")
    counts = torch.zeros(3, dtype=torch.int64, device=device)
    first = torch.zeros(3, dtype=torch.int32, device=device)
    _call("step_decay_sweep", device, counts.data_ptr(), first.data_ptr())
    return {fn: (n, None if n == 0 else lo & 0xffffffff)
            for fn, n, lo in zip(("exp", "log1p", "softplus"),
                                 counts.tolist(), first.tolist())}


def step_and_decay_bwd(g_dt: torch.Tensor, g_a: torch.Tensor,
                       dt_raw: torch.Tensor, dt_bias: torch.Tensor,
                       a_log: torch.Tensor, dt: torch.Tensor,
                       a: torch.Tensor):
    """The backward of :func:`step_and_decay`: (g_dt_raw in ``dt_raw``'s
    dtype and shape, g_dt_bias [H], g_a_log [H]) from the gradients of its
    outputs ``g_dt``, ``g_a`` and its inputs and outputs.  On the card: one
    launch, whose last block to finish sums the row tiles' column sums in a
    fixed order (no atomics in the sums)."""
    global STEP_DECAY_BWD_LAUNCHES
    h = dt_raw.shape[-1]
    for name, t in (("g_dt", g_dt), ("g_a", g_a), ("dt", dt), ("a", a)):
        if t.dtype != torch.float32 or t.shape != dt_raw.shape:
            raise ValueError(f"step_and_decay_bwd: {name} must be float32 "
                             f"{tuple(dt_raw.shape)}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    if dt_raw.dtype not in _DTYPES:
        raise TypeError(f"step_and_decay_bwd takes float32 or bfloat16 "
                        f"dt_raw, got {dt_raw.dtype}")
    for name, t in (("dt_bias", dt_bias), ("a_log", a_log)):
        if t.dtype != torch.float32 or tuple(t.shape) != (h,):
            raise ValueError(f"step_and_decay_bwd: {name} must be float32 "
                             f"({h},), got {t.dtype} {tuple(t.shape)}")
    _check_devices("step_and_decay_bwd",
                   [g_dt, g_a, dt_raw, dt_bias, a_log, dt, a])
    if dt_raw.device.type == "cpu":
        return step_and_decay_bwd_ref(g_dt, g_a, dt_raw, dt_bias, a_log, dt,
                                      a)
    raw = dt_raw.reshape(-1, h)
    if raw.stride(1) != 1 or raw.stride(0) < h:
        raw = raw.contiguous()
    rows = raw.shape[0]
    if raw.numel() >= 2 ** 31 or rows == 0:
        raise ValueError(f"step_and_decay_bwd kernel takes 1 to 2^31 - 1 "
                         f"elements, got {raw.numel()}")
    g_dt, g_a, dt, a = (t.reshape(rows, h).contiguous()
                        for t in (g_dt, g_a, dt, a))
    bias, a_log = dt_bias.contiguous(), a_log.contiguous()
    dev = raw.device
    g_raw = torch.empty((rows, h), dtype=raw.dtype, device=dev)
    with torch.cuda.device(dev):
        tiles = _ask("step_decay_bwd_tiles", rows)
    part = torch.empty((tiles, 2, h), dtype=torch.float32, device=dev)
    g_bias = torch.empty(h, dtype=torch.float32, device=dev)
    g_alog = torch.empty_like(g_bias)
    _call("step_decay_bwd", dev, g_dt.data_ptr(), g_a.data_ptr(),
          raw.data_ptr(), dt.data_ptr(), a.data_ptr(), bias.data_ptr(),
          a_log.data_ptr(), g_raw.data_ptr(), part.data_ptr(),
          _step_bwd_done(dev).data_ptr(), g_bias.data_ptr(),
          g_alog.data_ptr(), rows, h, raw.stride(0), _DTYPES[raw.dtype])
    STEP_DECAY_BWD_LAUNCHES += 1
    return g_raw.view(dt_raw.shape), g_bias, g_alog


def _step_bwd_done(dev) -> torch.Tensor:
    """The current stream's step_decay_bwd counters on ``dev``."""
    key = (dev.index, torch.cuda.current_stream(dev).cuda_stream)
    done = _STEP_BWD_DONE.get(key)
    if done is None:  # zeroed on the stream that launches with it
        done = torch.zeros(STEP_BWD_MAX_RANGES, dtype=torch.int32,
                           device=dev)
        _STEP_BWD_DONE[key] = done
    return done


def _bwd_launch(name: str, device, *args) -> None:
    _call(name, device, *args)
    BWD_PASS_LAUNCHES[name] += 1


def _check_grad(name, t, shape) -> None:
    if t is not None and (t.dtype != torch.float32
                          or tuple(t.shape) != tuple(shape)):
        raise ValueError(f"mamba2_ssd_bwd: {name} must be float32 "
                         f"{tuple(shape)}, got {t.dtype} {tuple(t.shape)}")


def chunk_dstate(dy: torch.Tensor, c: torch.Tensor, cum: torch.Tensor, *,
                 chunk: int):
    """Backward pass 1: q [B,nc,H,N,P], each chunk's sum_i exp(cum_i) dy_i
    (x) C_i, transposed, float32, from dy [B,S,H,P] float32, c [B,S,N] and
    the forward's cum [B,nc,H,L]."""
    bsz, s, h, p = dy.shape
    n = c.shape[-1]
    _check_grad("dy", dy, dy.shape)
    if c.dtype not in _DTYPES or c.shape[:2] != dy.shape[:2] or s % chunk \
            or tuple(cum.shape) != (bsz, s // chunk, h, chunk):
        raise ValueError(f"chunk_dstate takes dy [B,S,H,P], c [B,S,N] and cum"
                         f" [B,S/chunk,H,chunk], got {tuple(dy.shape)}, "
                         f"{tuple(c.shape)}, {tuple(cum.shape)}")
    _check_devices("chunk_dstate", [dy, c, cum])
    if dy.device.type == "cpu":
        return chunk_dstate_ref(dy, c, cum, chunk=chunk)
    if p % 4 or n % 4 or chunk % 4 or c.stride(2) != 1 \
            or not (dy.is_contiguous() and cum.is_contiguous()) \
            or dy.data_ptr() % 16 or cum.data_ptr() % 16:
        raise ValueError("chunk_dstate kernel takes contiguous, 16-byte "
                         "aligned dy and cum, c with its innermost dimension "
                         "contiguous, and P, N and chunk multiples of 4")
    q = torch.empty((bsz, s // chunk, h, n, p), dtype=torch.float32,
                    device=dy.device)
    _run_chunk_dstate(dy, c, cum, chunk, q)
    return q


def _run_chunk_dstate(dy, c, cum, chunk, q) -> None:
    bsz, s, h, p = dy.shape
    _bwd_launch("chunk_dstate", dy.device, dy.data_ptr(), c.data_ptr(),
                cum.data_ptr(), q.data_ptr(), bsz, s, h, p, c.shape[-1],
                chunk, c.stride(0), c.stride(1), _DTYPES[c.dtype])


def state_pass_bwd(q: torch.Tensor, cum: torch.Tensor, *,
                   dhf: torch.Tensor | None = None):
    """Backward pass 2: overwrites ``q`` ([B,nc,H,N,P], transposed) with the
    gradient of the state leaving each chunk, carried backwards from
    ``dhf`` [B,H,P,N] (or zeros) by ``R <- exp(cum_{L-1}) R + q_c``;
    returns (q, dh0 [B,H,P,N])."""
    bsz, nc, h, n, p = q.shape
    chunk = cum.shape[-1]
    if q.dtype != torch.float32 or cum.dtype != torch.float32 \
            or tuple(cum.shape[:3]) != (bsz, nc, h):
        raise ValueError(f"state_pass_bwd takes float32 q [B,nc,H,N,P] and "
                         f"cum [B,nc,H,L], got {q.dtype} {tuple(q.shape)}, "
                         f"{cum.dtype} {tuple(cum.shape)}")
    _check_grad("dhf", dhf, (bsz, h, p, n))
    _check_devices("state_pass_bwd", [q, cum, dhf])
    if q.device.type == "cpu":
        return state_pass_bwd_ref(q, cum, dhf=dhf)
    if p % 4 or n % 4 or chunk % 4 or q.data_ptr() % 16 \
            or not (q.is_contiguous() and cum.is_contiguous()) \
            or (dhf is not None and not dhf.is_contiguous()):
        raise ValueError("state_pass_bwd kernel takes contiguous q (16-byte "
                         "aligned), cum and dhf, and P, N and L multiples of "
                         "4")
    dh0 = torch.empty((bsz, h, p, n), dtype=torch.float32, device=q.device)
    _run_state_pass_bwd(q, cum, dhf, dh0)
    return q, dh0


def _run_state_pass_bwd(q, cum, dhf, dh0) -> None:
    bsz, nc, h, n, p = q.shape
    _bwd_launch("state_pass_bwd", q.device, cum.data_ptr(), q.data_ptr(),
                dhf.data_ptr() if dhf is not None else None, dh0.data_ptr(),
                bsz, nc, h, p, n, cum.shape[-1])


def chunk_bwd(x, a, b, c, dy, cum, h_in, r, *, chunk: int):
    """Backward passes 3 and 4: (dx [B,S,H,P], da [B,S,H] float32, db, dc
    [B,S,N] in b's dtype) from the forward's inputs, dy, cum, the state
    entering each chunk ``h_in`` and the gradient of the state leaving it
    ``r`` (both [B,nc,H,N,P], transposed).  On the card: the per-chunk
    kernel over groups of heads, then the sum of the groups' dB and dC
    partials in group order."""
    check_inputs(x, a, b, c, chunk, None)
    _check_grad("dy", dy, x.shape)
    _check_scratch("chunk_bwd", cum, h_in, x, b, chunk)
    _check_scratch("chunk_bwd", cum, r, x, b, chunk)
    _check_devices("chunk_bwd", [x, a, b, c, dy, cum, h_in, r])
    if x.device.type == "cpu":
        return chunk_bwd_ref(x, a, b, c, dy, cum, h_in, r, chunk=chunk)
    _check_kernel(x, a, b, c, chunk, None)
    if not dy.is_contiguous() or dy.data_ptr() % 16:
        raise ValueError("chunk_bwd kernel takes a contiguous, 16-byte "
                         "aligned dy")
    return _run_chunk_bwd(x, a, b, c, dy, cum, h_in, r, chunk)


def _run_chunk_bwd(x, a, b, c, dy, cum, h_in, r, chunk):
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    dev = x.device
    bwd_layout(chunk, p, n, b.element_size())  # refuses by name
    with torch.cuda.device(dev):
        hpb = _ask("chunk_bwd_heads", bsz, s, h, chunk)
    groups = -(-h // hpb)
    dx = torch.empty(x.shape, dtype=torch.float32, device=dev)
    da = torch.empty(a.shape, dtype=torch.float32, device=dev)
    dbp = torch.empty((bsz, s, groups, n), dtype=torch.float32, device=dev)
    dcp = torch.empty_like(dbp)
    _bwd_launch("chunk_bwd", dev, x.data_ptr(), a.data_ptr(), b.data_ptr(),
                c.data_ptr(), dy.data_ptr(), cum.data_ptr(), h_in.data_ptr(),
                r.data_ptr(), dx.data_ptr(), da.data_ptr(), dbp.data_ptr(),
                dcp.data_ptr(), bsz, s, h, p, n, chunk, hpb, x.stride(0),
                x.stride(1), x.stride(2), a.stride(0), a.stride(1),
                b.stride(0), b.stride(1), c.stride(0), c.stride(1),
                _DTYPES[b.dtype])
    db = torch.empty((bsz, s, n), dtype=b.dtype, device=dev)
    dc = torch.empty_like(db)
    _bwd_launch("sum_groups", dev, dbp.data_ptr(), dcp.data_ptr(),
                db.data_ptr(), dc.data_ptr(), bsz, s, groups, n,
                _DTYPES[b.dtype])
    return dx, da, db, dc


def mamba2_ssd_bwd(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                   c: torch.Tensor, dy: torch.Tensor,
                   dhf: torch.Tensor | None = None, *, chunk: int,
                   cum: torch.Tensor, h_in: torch.Tensor):
    """The gradient of :func:`mamba2_ssd`'s (y, h_final) with respect to
    (x, a, b, c, h0), given dy [B,S,H,P] and dhf [B,H,P,N] (float32; None:
    zeros) and the forward's scratch ``cum`` and ``h_in`` (``keep=True``;
    h0 entered them).
    Returns (dx, da float32, db, dc in b's dtype, dh0 float32).  On the
    card: the inputs in ``kernel_layout``, then ``chunk_dstate``,
    ``state_pass_bwd``, ``chunk_bwd`` and its group sum, four launches,
    deterministic."""
    global SSD_BWD_LAUNCHES
    check_inputs(x, a, b, c, chunk, None)
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    _check_grad("dy", dy, x.shape)
    _check_grad("dhf", dhf, (bsz, h, p, n))
    _check_devices("mamba2_ssd_bwd", [x, a, b, c, dy, dhf, cum, h_in])
    if x.device.type == "cpu":
        return mamba2_ssd_bwd_ref(x, a, b, c, dy, dhf, chunk=chunk, cum=cum,
                                  h_in=h_in)
    (x, a, b, c, _), pn = kernel_layout(x, a, b, c, None)
    pad_p, pad_n = x.shape[-1] - p, b.shape[-1] - n
    dy = F.pad(dy, (0, pad_p)) if pad_p else dy
    if dhf is not None and (pad_p or pad_n):
        dhf = F.pad(dhf, (0, pad_n, 0, pad_p))
    dy = dy.contiguous()
    dhf = None if dhf is None else dhf.contiguous()
    _check_kernel(x, a, b, c, chunk, None)
    _check_scratch("mamba2_ssd_bwd", cum, h_in, x, b, chunk)
    q = torch.empty(h_in.shape, dtype=torch.float32, device=x.device)
    dh0 = torch.empty((bsz, h, x.shape[-1], b.shape[-1]),
                      dtype=torch.float32, device=x.device)
    _run_chunk_dstate(dy, c, cum, chunk, q)
    _run_state_pass_bwd(q, cum, dhf, dh0)
    dx, da, db, dc = _run_chunk_bwd(x, a, b, c, dy, cum, h_in, q, chunk)
    SSD_BWD_LAUNCHES += 1
    if pad_p or pad_n:
        dx, db, dc = (dx[..., :p].contiguous(), db[..., :n].contiguous(),
                      dc[..., :n].contiguous())
        dh0 = dh0[..., :p, :n].contiguous()
    return dx, da, db, dc, dh0
