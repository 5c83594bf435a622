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
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from .. import _build
from .ref import (chunk_scan_ref, chunk_state_ref, mamba2_ssd_ref,
                  state_pass_ref)

#: Calls of :func:`mamba2_ssd` on the card in this process.
LAUNCHES = 0

#: Kernel launches of each pass in this process.
PASS_LAUNCHES = {"chunk_state": 0, "state_pass": 0, "chunk_scan": 0}

#: Shared memory one block may use on the H100 (bytes).
MAX_SMEM = 232448

#: Most heads one chunk_state block takes (its prefix sums stay in shared
#: memory); the launcher picks 1 to this many.
MAX_HEADS_PER_BLOCK = 16

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_PTR, _INT, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


@functools.lru_cache(maxsize=None)
def _launcher(name: str):
    lib = _build.load("mamba2_ssd")
    fn = getattr(lib, f"mamba2_{name}_launch")
    fn.argtypes = {
        "chunk_state": [_PTR] * 5 + [_INT] * 6 + [_LL] * 7 + [_INT, _PTR],
        "state_pass": [_PTR] * 4 + [_INT] * 6 + [_PTR],
        "chunk_scan": [_PTR] * 6 + [_INT] * 6 + [_LL] * 7 + [_INT, _PTR],
    }[name]
    fn.restype = ctypes.c_int
    return fn


def _launch(name: str, device, *args) -> None:
    stream = torch.cuda.current_stream(device).cuda_stream
    # The C launcher runs on the current device: make it the tensors'.
    with torch.cuda.device(device):
        rc = _launcher(name)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"mamba2_ssd {name} kernel launch failed: CUDA "
                           f"error {rc}")
    PASS_LAUNCHES[name] += 1


def smem_bytes(chunk: int, p: int, n: int) -> int:
    """Shared memory of the larger block of the passes, as
    ``csrc/mamba2_ssd.cu`` lays them out."""
    lt = chunk // 4
    state = (chunk * (n + 4) + chunk * (p + 4)
             + chunk * (1 + MAX_HEADS_PER_BLOCK))
    scan = (33 * (lt * (lt + 1) // 2) + chunk * (n + 4)
            + 2 * max(chunk * (p + 4), n * (chunk + 4)) + 2 * n * (p + 4)
            + 3 * chunk)
    return 4 * max(state, scan)


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
               h0: torch.Tensor | None = None):
    """Chunked Mamba-2 SSD scan: x [B,S,H,P] float32 (dt-scaled), a [B,S,H]
    float32 decay in (0, 1], b/c [B,S,N] float32 or bfloat16 (shared across
    heads), h0 [B,H,P,N] float32 or None (zeros); S a multiple of
    ``chunk``.  Returns (y [B,S,H,P], h_final [B,H,P,N]), both float32.
    On the card: the inputs in ``kernel_layout``, then ``chunk_state``,
    ``state_pass``, ``chunk_scan``, three
    launches with float32 scratch of N / chunk + 1 / P times x's size."""
    global LAUNCHES
    check_inputs(x, a, b, c, chunk, h0)
    if x.device.type == "cpu":
        return mamba2_ssd_ref(x, a, b, c, chunk=chunk, h0=h0)
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
    return from_kernel_layout(y, hf, pn)
