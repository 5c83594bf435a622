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

#: Share dtypes the kernel takes, by the code its launcher reads.
SHARE_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

def max_j(arrays: int, dtype: torch.dtype) -> int:
    """Largest J a draw kernel takes: beyond 1024 a row's slots live in a
    per-warp shared-memory slab of ``arrays`` arrays of 32 * ceil(J / 32)
    4-byte values, plus for bf16 shares a scratch of 3 * ceil(J / 32) + 32
    floats rounded up to 16 bytes (``draw.cuh`` ``slab_bytes``,
    ``bf16_floats``); one warp's share must fit the H100's 232,448 bytes of
    a block."""
    c = 232448 // (arrays * 128)
    extra = lambda c: 4 * ((3 * c + 35) & ~3) if dtype == torch.bfloat16 else 0
    while arrays * 128 * c + extra(c) > 232448:
        c -= 1
    return 32 * c


#: Largest J the kernel takes, per share dtype.
MAX_J = {dt: max_j(2, dt) for dt in SHARE_DTYPES}


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = _build.load("token_select").token_select_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def check_inputs(shares, qcount, u) -> None:
    if shares.dtype not in SHARE_DTYPES:
        raise TypeError("token_select takes float32 or bfloat16 shares, got "
                        f"{shares.dtype}")
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
    """All W worker draws for every server row: shares f32 or bf16 [S, J]
    (bf16 widened to float32), qcount i32[S, J], u f32[S, W] -> i32[S, W]
    (-1 = idle)."""
    global LAUNCHES
    check_inputs(shares, qcount, u)
    if shares.device.type == "cpu":
        return token_select_ref(shares, qcount, u)
    if not (shares.is_contiguous() and qcount.is_contiguous()
            and u.is_contiguous()):
        raise ValueError("token_select kernel takes contiguous tensors")
    s, j = shares.shape
    w = u.shape[1]
    if j > MAX_J[shares.dtype]:
        raise ValueError(f"J={j} exceeds the kernel's shared memory (J <= "
                         f"{MAX_J[shares.dtype]} for {shares.dtype} shares)")
    dev = shares.device
    out = torch.empty((s, w), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    # The C launcher runs on the current device: make it the tensors'.
    with torch.cuda.device(dev):
        rc = _launcher()(shares.data_ptr(), qcount.data_ptr(), u.data_ptr(),
                         out.data_ptr(), s, j, w, SHARE_DTYPES[shares.dtype],
                         stream)
    if rc != 0:
        raise RuntimeError(f"token_select kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return out
