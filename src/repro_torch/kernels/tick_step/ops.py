"""Wrapper of the tick_step kernel (``csrc/tick_step.cu``).

A CPU tensor goes to the plain version (``ref.py``); a CUDA tensor goes to
the kernel or raises.  ``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from ..token_select.ops import SHARE_DTYPES, max_j
from .ref import MODES, tick_step_ref

#: Kernel launches made by :func:`tick_step` in this process.
LAUNCHES = 0

#: Largest J the kernel takes, per share dtype (3 slab arrays; fifo reads
#: no shares and takes the float32 bound).
MAX_J = {dt: max_j(3, dt) for dt in SHARE_DTYPES}


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = _build.load("tick_step").tick_step_launch
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def check_inputs(shares, qcount, window, free, u, mode) -> None:
    if mode not in MODES:
        raise ValueError(f"unknown tick-step mode {mode!r}; one of {MODES}")
    if shares.dtype not in SHARE_DTYPES or window.dtype != torch.float32 \
            or u.dtype != torch.float32:
        raise TypeError("tick_step takes float32 or bfloat16 shares and "
                        f"float32 window and u, got {shares.dtype}, "
                        f"{window.dtype}, {u.dtype}")
    if qcount.dtype != torch.int32 or free.dtype != torch.bool:
        raise TypeError(f"tick_step takes qcount int32 and free bool, got "
                        f"{qcount.dtype} and {free.dtype}")
    if qcount.dim() != 2 or u.dim() != 2:
        raise ValueError("tick_step takes qcount [S, J] and u [S, W]")
    s, j = qcount.shape
    w = u.shape[1]
    if shares.shape != (s, j) or window.shape != (s, j, w) \
            or free.shape != (s, w) or u.shape[0] != s:
        raise ValueError(
            "tick_step takes shares/qcount [S, J], window [S, J, W], free/u "
            f"[S, W]; got {tuple(shares.shape)}, {tuple(qcount.shape)}, "
            f"{tuple(window.shape)}, {tuple(free.shape)}, {tuple(u.shape)}")
    if min(s, j, w) < 1:
        raise ValueError("tick_step needs S, J, W >= 1")
    devices = {t.device for t in (shares, qcount, window, free, u)}
    if len(devices) != 1:
        raise ValueError(f"tick_step inputs on several devices: {devices}")
    if shares.device.type not in ("cpu", "cuda"):
        raise ValueError(f"tick_step runs on cpu or cuda, not {shares.device}")


def tick_step(shares, qcount, window, free, u, *, mode: str = "themis"):
    """The whole worker phase of one engine tick.  Returns ``(sel i32[S, W],
    valid bool[S, W], demand_any bool[S, W], qcount_out i32[S, J],
    pops i32[S, J])``; semantics in ``ref.py``."""
    global LAUNCHES
    check_inputs(shares, qcount, window, free, u, mode)
    if shares.device.type == "cpu":
        return tick_step_ref(shares, qcount, window, free, u, mode=mode)
    if not all(t.is_contiguous() for t in (shares, qcount, window, free, u)):
        raise ValueError("tick_step kernel takes contiguous tensors")
    s, j = qcount.shape
    w = u.shape[1]
    limit = MAX_J[shares.dtype if mode == "themis" else torch.float32]
    if j > limit:
        raise ValueError(f"J={j} exceeds the kernel's shared memory (J <= "
                         f"{limit})")
    dev = shares.device
    sel = torch.empty((s, w), dtype=torch.int32, device=dev)
    valid = torch.empty((s, w), dtype=torch.bool, device=dev)
    dany = torch.empty((s, w), dtype=torch.bool, device=dev)
    qout = torch.empty((s, j), dtype=torch.int32, device=dev)
    pops = torch.empty((s, j), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    # The C launcher runs on the current device: make it the tensors'.
    with torch.cuda.device(dev):
        rc = _launcher()(shares.data_ptr(), qcount.data_ptr(),
                         window.data_ptr(), free.data_ptr(), u.data_ptr(),
                         sel.data_ptr(), valid.data_ptr(), dany.data_ptr(),
                         qout.data_ptr(), pops.data_ptr(), s, j, w,
                         MODES.index(mode), SHARE_DTYPES[shares.dtype],
                         stream)
    if rc != 0:
        raise RuntimeError(f"tick_step kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return sel, valid, dany, qout, pops
