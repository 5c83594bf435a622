"""Wrapper of the token_select kernel (``csrc/token_select.cu``).

A CPU tensor goes to the plain version (``ref.py``); a CUDA tensor goes to
the kernel or raises.  ``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from .ref import token_select_ref

#: Kernel launches made by :func:`token_select` in this process.
LAUNCHES = 0


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = _build.load("token_select").token_select_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def check_inputs(shares, qcount, u) -> None:
    if shares.dtype != torch.float32:
        raise TypeError(f"token_select takes float32 shares, got {shares.dtype} "
                        "(bf16 shares are not ported yet)")
    if qcount.dtype != torch.int32 or u.dtype != torch.float32:
        raise TypeError("token_select takes qcount int32 and u float32, got "
                        f"{qcount.dtype} and {u.dtype}")
    if shares.dim() != 2 or qcount.shape != shares.shape or u.dim() != 2 \
            or u.shape[0] != shares.shape[0]:
        raise ValueError("token_select takes shares/qcount [S, J] and u [S, W], "
                         f"got {tuple(shares.shape)}, {tuple(qcount.shape)}, "
                         f"{tuple(u.shape)}")
    if min(shares.shape) < 1 or u.shape[1] < 1:
        raise ValueError("token_select needs S, J, W >= 1")
    devices = {shares.device, qcount.device, u.device}
    if len(devices) != 1:
        raise ValueError(f"token_select inputs on several devices: {devices}")
    if shares.device.type not in ("cpu", "cuda"):
        raise ValueError(f"token_select runs on cpu or cuda, not {shares.device}")


def token_select(shares: torch.Tensor, qcount: torch.Tensor,
                 u: torch.Tensor) -> torch.Tensor:
    """All W worker draws for every server row: shares f32[S, J],
    qcount i32[S, J], u f32[S, W] -> i32[S, W] (-1 = idle)."""
    global LAUNCHES
    check_inputs(shares, qcount, u)
    if shares.device.type == "cpu":
        return token_select_ref(shares, qcount, u)
    if not (shares.is_contiguous() and qcount.is_contiguous()
            and u.is_contiguous()):
        raise ValueError("token_select kernel takes contiguous tensors")
    s, j = shares.shape
    w = u.shape[1]
    if j * 4 > 227 * 1024:
        raise ValueError(f"J={j} exceeds the kernel's shared memory")
    dev = shares.device
    out = torch.empty((s, w), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    # The C launcher runs on the current device: make it the tensors'.
    with torch.cuda.device(dev):
        rc = _launcher()(shares.data_ptr(), qcount.data_ptr(), u.data_ptr(),
                         out.data_ptr(), s, j, w, stream)
    if rc != 0:
        raise RuntimeError(f"token_select kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return out
