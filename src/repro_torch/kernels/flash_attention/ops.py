"""Wrapper of the flash-attention kernel (``csrc/flash_attention.cu``).

A CPU tensor goes to the plain version (``ref.py``) with the caller's
``block_q``/``block_k``; a CUDA tensor goes to the kernel (which tiles by
its own 64 x 64) or raises.  Rows with no live key (``first_dead_row``)
take the reference's value, which depends on ``block_k``: a second kernel
writes them after the first, only when the geometry has them.
``LAUNCHES`` counts calls that launch the kernel.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from .ref import flash_attention_ref

#: Kernel launches made by :func:`flash_attention` in this process.
LAUNCHES = 0

#: Widest head the kernel takes (its per-thread accumulator is sized for it).
MAX_HEAD_DIM = 256

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = _build.load("flash_attention").flash_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 10
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _dead_rows_launcher():
    fn = _build.load("flash_attention").flash_attention_dead_rows_launch
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 10 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def first_dead_row(sq: int, sk: int, window: int, q_offset: int) -> int:
    """The first query row with no live key (``sq`` if none): with a window,
    row i (key position i + q_offset) sees keys from i + q_offset - window
    + 1 on, none of them below ``sk`` once i + q_offset >= sk + window - 1.
    Causal or not, every other row has a live key."""
    if window <= 0:
        return sq
    return min(sq, max(0, sk + window - 1 - q_offset))


def key_slots(sk: int, block_k: int) -> int:
    """Key slots of the reference's tiles: ``sk`` padded to a whole number of
    ``min(block_k, sk)``-key tiles.  A row with no live key is the sum of V
    over the keys divided by this (the -1e30 mask gives every slot p = 1)."""
    bk = min(block_k, sk)
    return -(-sk // bk) * bk


def check_inputs(q, k, v, window: int, q_offset: int) -> None:
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_attention takes q, k, v all float32 or all "
                        f"bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError("flash_attention takes q [B, Sq, H, D] and k, v "
                         f"[B, Sk, Hk, D], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, sq, h, d = q.shape
    _, sk, hk, dk = k.shape
    if k.shape[0] != b or dk != d:
        raise ValueError("q and k/v differ in batch or head_dim: "
                         f"{tuple(q.shape)} vs {tuple(k.shape)}")
    if min(b, sq, sk, h, hk, d) < 1 or h % hk:
        raise ValueError(f"flash_attention needs non-empty tensors and H "
                         f"({h}) a multiple of Hk ({hk})")
    if d > MAX_HEAD_DIM:
        raise ValueError(f"head_dim {d} exceeds the kernel's {MAX_HEAD_DIM}")
    if window < 0 or q_offset < 0:
        raise ValueError(f"window ({window}) and q_offset ({q_offset}) must "
                         "be >= 0")
    devices = {q.device, k.device, v.device}
    if len(devices) != 1:
        raise ValueError(f"flash_attention inputs on several devices: {devices}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention runs on cpu or cuda, not {q.device}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, q_offset: int = 0,
                    scale: float | None = None, block_q: int = 512,
                    block_k: int = 512) -> torch.Tensor:
    """Tiled online-softmax attention: q [B, Sq, H, D], k/v [B, Sk, Hk, D]
    (float32 or bfloat16) -> [B, Sq, H, D] in q's dtype.  Query position i
    sits at ``i + q_offset`` on the key axis; ``causal`` keeps keys at or
    before it, ``window`` > 0 only the last ``window`` of them; ``scale``
    defaults to D ** -0.5.  Query head ``h`` reads KV head ``h // (H/Hk)``."""
    global LAUNCHES
    check_inputs(q, k, v, window, q_offset)
    b, sq, h, d = q.shape
    scale = float(scale) if scale is not None else d ** -0.5
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset, scale=scale,
                                   block_q=block_q, block_k=block_k)
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention kernel takes contiguous tensors")
    if b * h > 65535:
        raise ValueError(f"B*H = {b * h} exceeds the kernel's grid")
    sk, hk = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    dev = q.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    # The C launcher runs on the current device: make it the tensors'.
    with torch.cuda.device(dev):
        rc = _launcher()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         out.data_ptr(), b, sq, sk, h, hk, d, int(causal),
                         window, q_offset, _DTYPES[q.dtype], scale, stream)
        if rc == 0 and first_dead_row(sq, sk, window, q_offset) < sq:
            rc = _dead_rows_launcher()(
                v.data_ptr(), out.data_ptr(), b, sq, sk, h, hk, d, window,
                q_offset, key_slots(sk, block_k), _DTYPES[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {rc}")
    LAUNCHES += 1
    return out
