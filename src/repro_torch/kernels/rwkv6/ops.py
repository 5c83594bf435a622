"""Wrapper of the RWKV-6 WKV kernel (``csrc/wkv6.cu``).

A CPU tensor goes to the plain version (``ref.py``); a CUDA tensor goes to
the kernel or raises.  The kernel reads r, k, v and lw in their
``[B, S, H, K]`` layout (contiguous), one block per (batch, head): no
transposed copy and no tiled ``u``.  ``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from .ref import wkv6_ref

#: Kernel launches made by :func:`wkv6` in this process.
LAUNCHES = 0

#: Shared memory one block may use on the H100 (bytes).
MAX_SMEM = 232448

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = _build.load("wkv6").wkv6_launch
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def smem_bytes(chunk: int, kd: int) -> int:
    """Shared memory of one block, as ``csrc/wkv6.cu`` lays it out."""
    return 4 * (5 * chunk * (kd + 4) + chunk * (chunk + 4) + kd * (kd + 4)
                + chunk + 2 * kd)


def check_inputs(r, k, v, lw, u, chunk: int, s0) -> None:
    if r.dtype not in _DTYPES or k.dtype != r.dtype or v.dtype != r.dtype:
        raise TypeError("wkv6 takes r, k, v all float32 or all bfloat16, got "
                        f"{r.dtype}, {k.dtype}, {v.dtype}")
    if lw.dtype != torch.float32 or u.dtype != torch.float32:
        raise TypeError(f"wkv6 takes float32 lw and u, got {lw.dtype}, "
                        f"{u.dtype}")
    if r.dim() != 4 or any(t.shape != r.shape for t in (k, v, lw)):
        raise ValueError("wkv6 takes r, k, v, lw of one shape [B,S,H,K], got "
                         f"{[tuple(t.shape) for t in (r, k, v, lw)]}")
    bsz, s, h, kd = r.shape
    if tuple(u.shape) != (h, kd):
        raise ValueError(f"wkv6: u must be {(h, kd)}, got {tuple(u.shape)}")
    if min(bsz, s, h, kd, chunk) < 1 or s % chunk:
        raise ValueError(f"wkv6 needs non-empty inputs and S ({s}) a "
                         f"multiple of chunk ({chunk})")
    if s0 is not None and (s0.dtype != torch.float32
                           or tuple(s0.shape) != (bsz, h, kd, kd)):
        raise ValueError(f"wkv6: s0 must be float32 {(bsz, h, kd, kd)}, got "
                         f"{s0.dtype} {tuple(s0.shape)}")
    tensors = [r, k, v, lw, u] + ([s0] if s0 is not None else [])
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"wkv6 inputs on several devices: {devices}")
    if r.device.type not in ("cpu", "cuda"):
        raise ValueError(f"wkv6 runs on cpu or cuda, not {r.device}")


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         lw: torch.Tensor, u: torch.Tensor, *, chunk: int,
         s0: torch.Tensor | None = None):
    """Chunked RWKV-6 recurrence: r, k, v [B,S,H,K] float32 or bfloat16, lw
    [B,S,H,K] float32 log decay (<= 0), u [H,K] float32 bonus, s0
    [B,H,K,K] float32 or None (zeros); S a multiple of ``chunk``.  Returns
    (y [B,S,H,K], final state [B,H,K,K] k-major), both float32."""
    global LAUNCHES
    check_inputs(r, k, v, lw, u, chunk, s0)
    if r.device.type == "cpu":
        return wkv6_ref(r, k, v, lw, u, chunk=chunk, s0=s0)
    bsz, s, h, kd = r.shape
    if kd % 4 or chunk % 4:
        raise ValueError(f"wkv6 kernel needs K ({kd}) and chunk ({chunk}) "
                         "multiples of 4")
    if smem_bytes(chunk, kd) > MAX_SMEM:
        raise ValueError(f"wkv6 kernel: chunk {chunk} with K={kd} needs "
                         f"{smem_bytes(chunk, kd)} bytes of shared memory, "
                         f"more than {MAX_SMEM}")
    tensors = [r, k, v, lw, u] + ([s0] if s0 is not None else [])
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("wkv6 kernel takes contiguous tensors")
    y = torch.empty((bsz, s, h, kd), dtype=torch.float32, device=r.device)
    sf = torch.empty((bsz, h, kd, kd), dtype=torch.float32, device=r.device)
    dev = r.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = _launcher()(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), lw.data_ptr(),
            u.data_ptr(), s0.data_ptr() if s0 is not None else None,
            y.data_ptr(), sf.data_ptr(), bsz, s, h, kd, chunk,
            _DTYPES[r.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"wkv6 kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return y, sf
