"""Wrapper of the Mamba-2 SSD scan kernel (``csrc/mamba2_ssd.cu``).

A CPU tensor goes to the plain version (``ref.py``); a CUDA tensor goes to
the kernel or raises.  The kernel reads x, a, b and c in place through
their strides (innermost dimension contiguous), so the slices of the
model's fused projection need no copy.  ``LAUNCHES`` counts kernel
launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from .ref import mamba2_ssd_ref

#: Kernel launches made by :func:`mamba2_ssd` in this process.
LAUNCHES = 0

#: Shared memory one block may use on the H100 (bytes).
MAX_SMEM = 232448

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = _build.load("mamba2_ssd").mamba2_ssd_launch
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                   + [ctypes.c_longlong] * 9 + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def smem_bytes(chunk: int, p: int, n: int) -> int:
    """Shared memory of one block, as ``csrc/mamba2_ssd.cu`` lays it out."""
    return 4 * (chunk * (p + 4) + 2 * chunk * (n + 4) + p * (n + 4)
                + chunk * (chunk + 4) + 3 * chunk)


def check_inputs(x, a, b, c, chunk: int, h0) -> None:
    if x.dtype != torch.float32 or a.dtype != torch.float32:
        raise TypeError(f"mamba2_ssd takes float32 x and a, got {x.dtype}, "
                        f"{a.dtype}")
    if b.dtype not in _DTYPES or c.dtype != b.dtype:
        raise TypeError("mamba2_ssd takes b and c both float32 or both "
                        f"bfloat16, got {b.dtype}, {c.dtype}")
    if x.dim() != 4 or a.dim() != 3 or b.dim() != 3 or c.shape != b.shape:
        raise ValueError("mamba2_ssd takes x [B,S,H,P], a [B,S,H], b/c "
                         f"[B,S,N], got {tuple(x.shape)}, {tuple(a.shape)}, "
                         f"{tuple(b.shape)}, {tuple(c.shape)}")
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    if tuple(a.shape) != (bsz, s, h) or tuple(b.shape[:2]) != (bsz, s):
        raise ValueError(f"mamba2_ssd: a {tuple(a.shape)} and b "
                         f"{tuple(b.shape)} do not match x {tuple(x.shape)}")
    if min(bsz, s, h, p, n, chunk) < 1 or s % chunk:
        raise ValueError(f"mamba2_ssd needs non-empty inputs and S ({s}) a "
                         f"multiple of chunk ({chunk})")
    if h0 is not None and (h0.dtype != torch.float32
                           or tuple(h0.shape) != (bsz, h, p, n)):
        raise ValueError(f"mamba2_ssd: h0 must be float32 {(bsz, h, p, n)}, "
                         f"got {h0.dtype} {tuple(h0.shape)}")
    tensors = [x, a, b, c] + ([h0] if h0 is not None else [])
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"mamba2_ssd inputs on several devices: {devices}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"mamba2_ssd runs on cpu or cuda, not {x.device}")


def mamba2_ssd(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
               c: torch.Tensor, *, chunk: int,
               h0: torch.Tensor | None = None):
    """Chunked Mamba-2 SSD scan: x [B,S,H,P] float32 (dt-scaled), a [B,S,H]
    float32 decay in (0, 1], b/c [B,S,N] float32 or bfloat16 (shared across
    heads), h0 [B,H,P,N] float32 or None (zeros); S a multiple of
    ``chunk``.  Returns (y [B,S,H,P], h_final [B,H,P,N]), both float32."""
    global LAUNCHES
    check_inputs(x, a, b, c, chunk, h0)
    if x.device.type == "cpu":
        return mamba2_ssd_ref(x, a, b, c, chunk=chunk, h0=h0)
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    if p % 4 or n % 4 or chunk % 4:
        raise ValueError(f"mamba2_ssd kernel needs P ({p}), N ({n}) and "
                         f"chunk ({chunk}) multiples of 4")
    if smem_bytes(chunk, p, n) > MAX_SMEM:
        raise ValueError(f"mamba2_ssd kernel: chunk {chunk} with P={p}, "
                         f"N={n} needs {smem_bytes(chunk, p, n)} bytes of "
                         f"shared memory, more than {MAX_SMEM}")
    if x.stride(3) != 1 or a.stride(2) != 1 or b.stride(2) != 1 \
            or c.stride(2) != 1:
        raise ValueError("mamba2_ssd kernel needs the innermost dimension of "
                         "x, a, b and c contiguous")
    if h0 is not None and not h0.is_contiguous():
        raise ValueError("mamba2_ssd kernel takes a contiguous h0")
    y = torch.empty((bsz, s, h, p), dtype=torch.float32, device=x.device)
    hf = torch.empty((bsz, h, p, n), dtype=torch.float32, device=x.device)
    dev = x.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = _launcher()(
            x.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(),
            h0.data_ptr() if h0 is not None else None, y.data_ptr(),
            hf.data_ptr(), bsz, s, h, p, n, chunk,
            x.stride(0), x.stride(1), x.stride(2), a.stride(0), a.stride(1),
            b.stride(0), b.stride(1), c.stride(0), c.stride(1),
            _DTYPES[b.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"mamba2_ssd kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return y, hf
