"""Wrappers of the flash-attention kernels (``csrc/flash_attention.cu``).

A CPU tensor goes to the plain version (``ref.py``) with the caller's
``block_q``/``block_k``; a CUDA tensor goes to the kernel (which tiles by
its own 64 x 64) or raises.  Rows with no live key (``first_dead_row``)
take the reference's value, which depends on ``block_k``: a second kernel
writes them after the first, only when the geometry has them.
``flash_attention(..., return_stats=True)`` also hands back each row's
float32 ``m`` and ``l``; ``flash_attention_bwd`` is the backward from them.
``LAUNCHES`` counts calls that launch the forward, ``BWD_LAUNCHES`` calls
that launch the backward.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from .ref import flash_attention_bwd_ref, flash_attention_ref

#: Kernel launches made by :func:`flash_attention` in this process.
LAUNCHES = 0
#: Kernel launches made by :func:`flash_attention_bwd` in this process.
BWD_LAUNCHES = 0

#: Widest head the kernel takes (its per-thread accumulator is sized for it).
MAX_HEAD_DIM = 256

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = _build.load("flash_attention").flash_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 10
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _bwd_launcher():
    fn = _build.load("flash_attention").flash_attention_bwd_launch
    fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 10
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
                    block_k: int = 512, return_stats: bool = False):
    """Tiled online-softmax attention: q [B, Sq, H, D], k/v [B, Sk, Hk, D]
    (float32 or bfloat16) -> [B, Sq, H, D] in q's dtype.  Query position i
    sits at ``i + q_offset`` on the key axis; ``causal`` keeps keys at or
    before it, ``window`` > 0 only the last ``window`` of them; ``scale``
    defaults to D ** -0.5.  Query head ``h`` reads KV head ``h // (H/Hk)``.
    ``return_stats`` returns ``(out, m, l)``: each row's running max of the
    scaled score and its sum of exp(s - m), float32 [B, H, Sq] (the serving
    launch writes neither)."""
    global LAUNCHES
    check_inputs(q, k, v, window, q_offset)
    b, sq, h, d = q.shape
    scale = float(scale) if scale is not None else d ** -0.5
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset, scale=scale,
                                   block_q=block_q, block_k=block_k,
                                   return_stats=return_stats)
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention kernel takes contiguous tensors")
    if b * h > 65535:
        raise ValueError(f"B*H = {b * h} exceeds the kernel's grid")
    sk, hk = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    m = l = None
    if return_stats:
        m = q.new_empty((b, h, sq), dtype=torch.float32)
        l = torch.empty_like(m)
    dev = q.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    # The C launcher runs on the current device: make it the tensors'.
    with torch.cuda.device(dev):
        rc = _launcher()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         out.data_ptr(), None if m is None else m.data_ptr(),
                         None if l is None else l.data_ptr(), b, sq, sk, h,
                         hk, d, int(causal), window, q_offset,
                         _DTYPES[q.dtype], scale, stream)
        if rc == 0 and first_dead_row(sq, sk, window, q_offset) < sq:
            rc = _dead_rows_launcher()(
                v.data_ptr(), out.data_ptr(), b, sq, sk, h, hk, d, window,
                q_offset, key_slots(sk, block_k), _DTYPES[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {rc}")
    LAUNCHES += 1
    return (out, m, l) if return_stats else out


def flash_attention_bwd(q, k, v, out, m, l, dout, *, causal: bool = True,
                        window: int = 0, q_offset: int = 0,
                        scale: float | None = None, block_q: int = 512,
                        block_k: int = 512):
    """The backward of :func:`flash_attention`: (dq, dk, dv) in the inputs'
    dtype from q, k, v, the forward's ``out``, its row statistics ``m`` and
    ``l`` (``return_stats=True``) and the output's gradient ``dout``.  A
    CPU tensor takes the reference's tile-recompute backward
    (``flash_attention_bwd_ref``, in ``block_q`` x ``block_k`` tiles); a
    CUDA tensor launches the kernel, which does not take rows with no live
    key (they never occur in training: ``q_offset`` = 0 and Sq = Sk)."""
    global BWD_LAUNCHES
    check_inputs(q, k, v, window, q_offset)
    b, sq, h, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    for name, t in (("out", out), ("dout", dout)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"flash_attention_bwd: {name} must be like q "
                             f"{tuple(q.shape)} {q.dtype}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
    for name, t in (("m", m), ("l", l)):
        if (t.shape != (b, h, sq) or t.dtype != torch.float32
                or t.device != q.device):
            raise ValueError(f"flash_attention_bwd: {name} must be float32 "
                             f"{(b, h, sq)} on {q.device}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
    scale = float(scale) if scale is not None else d ** -0.5
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, out, m, l, dout,
                                       causal=causal, window=window,
                                       q_offset=q_offset, scale=scale,
                                       block_q=block_q, block_k=block_k)
    if first_dead_row(sq, sk, window, q_offset) < sq:
        raise NotImplementedError(
            f"flash_attention_bwd kernel: rows from "
            f"{first_dead_row(sq, sk, window, q_offset)} of {sq} have no live "
            f"key (window {window}, q_offset {q_offset}, Sk {sk}); the kernel "
            "does not take them")
    if not all(t.is_contiguous() for t in (q, k, v, out, m, l, dout)):
        raise ValueError("flash_attention_bwd kernel takes contiguous tensors")
    if b * h > 65535:
        raise ValueError(f"B*H = {b * h} exceeds the kernel's grid")
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    delta = torch.empty_like(m)
    dev = q.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = _bwd_launcher()(
            *(t.data_ptr() for t in (q, k, v, out, dout, m, l, delta, dq, dk,
                                     dv)),
            b, sq, sk, h, hk, d, int(causal), window, q_offset,
            _DTYPES[q.dtype], scale, stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention_bwd kernel launch failed: CUDA "
                           f"error {rc}")
    BWD_LAUNCHES += 1
    return dq, dk, dv
