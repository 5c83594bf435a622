"""Checkpointing through the burst buffer: atomic, resumable.

The port of ``repro.ckpt.manager``:
  * two-phase commit: the leaves are written under ``step_N.tmp/``, the
    manifest (with a blake2b checksum per leaf) last; the manifest at its
    final path is the commit point, so a crash mid-save never corrupts the
    latest checkpoint.
  * every leaf is stored whole, as an ``.npy`` file named by a hash of its
    path; the paths are the reference's (``state/.params/seg0/blk0/attn/
    wq/w``: dict keys, and a named tuple's field as ``.field``), so the
    names say which parameter a file holds.  A bfloat16 tensor is stored as
    its uint16 bits, with ``bfloat16`` in the manifest.
  * all I/O goes through the port's ``BBClient`` when one is given, so
    checkpoint traffic is policy-scheduled against competing jobs (the
    paper's workload); else a local directory.
``restore`` rebuilds the structure of a like-tree (dicts, named tuples, a
``ModelParams``, tensors, numpy arrays) with each leaf in the like leaf's
dtype and on its device.
"""
from __future__ import annotations

import hashlib
import io
import json
import os
from typing import Optional

import numpy as np
import torch

from ..models.model import ModelParams


def _children(tree) -> Optional[list]:
    """``[(name, child)]`` of an inner node, ``None`` for a leaf."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [("." + f, getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, (dict, ModelParams)):
        return [(str(k), tree[k]) for k in sorted(tree.keys())]
    if isinstance(tree, (list, tuple)):
        return [(str(i), x) for i, x in enumerate(tree)]
    return None


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    """(array to store, dtype name for the manifest)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _flatten(tree, prefix: str = "") -> list[tuple[str, object]]:
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    out = []
    for name, child in kids:
        out += _flatten(child, f"{prefix}/{name}" if prefix else name)
    return out


def _leaf_like(like, arr: np.ndarray, dtype: str, name: str):
    if tuple(arr.shape) != tuple(np.shape(like)):
        raise ValueError(f"{name}: shape {arr.shape} != {tuple(np.shape(like))}")
    if isinstance(like, torch.Tensor):
        t = torch.from_numpy(arr.copy())    # np.load's array: C order
        if dtype == "bfloat16":
            t = t.view(torch.int16).view(torch.bfloat16)
        # A fresh tensor of the like leaf's dtype and device, not numpy's
        # buffer.
        out = torch.empty(like.shape, dtype=like.dtype, device=like.device)
        out.copy_(t)
        return out.requires_grad_(True) if like.requires_grad else out
    if dtype == "bfloat16":
        raise ValueError(f"{name}: a bfloat16 leaf restores into a tensor")
    return arr.astype(np.asarray(like).dtype)


def _unflatten_into(tree, named: dict, prefix: str = ""):
    kids = _children(tree)
    if kids is None:
        arr, dtype = named[prefix]
        return _leaf_like(tree, arr, dtype, prefix)
    vals = [_unflatten_into(child, named,
                            f"{prefix}/{name}" if prefix else name)
            for name, child in kids]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*vals)
    if isinstance(tree, (dict, ModelParams)):
        out = {k: v for (k, _), v in zip(kids, vals)}
        if isinstance(tree, ModelParams):
            return _as_params(out)
        return out
    return type(tree)(vals)


def _as_params(tree: dict) -> ModelParams:
    """A ModelParams of restored tensors, each keeping requires_grad."""
    params = ModelParams({})
    for key, val in tree.items():
        if isinstance(val, ModelParams):
            params.add_module(key, val)
        else:
            params.register_parameter(key, torch.nn.Parameter(
                val.detach(), requires_grad=val.requires_grad))
    return params


class CheckpointManager:
    def __init__(self, root: str, client=None, keep: int = 3):
        """client: the port's BBClient; None -> local filesystem backend."""
        self.root = root.rstrip("/")
        self.client = client
        self.keep = keep
        if client is None:
            os.makedirs(self.root, exist_ok=True)
        else:
            try:
                client.mkdir(self.root)
            except Exception:
                pass

    # -- backend ops -----------------------------------------------------------
    def _write(self, path: str, data: bytes):
        if self.client is None:
            with open(path, "wb") as f:
                f.write(data)
        else:
            with self.client.open(path, "w") as f:
                f.write(data)

    def _read(self, path: str) -> bytes:
        if self.client is None:
            with open(path, "rb") as f:
                return f.read()
        with self.client.open(path) as f:
            return f.read()

    def _mkdir(self, path: str):
        if self.client is None:
            os.makedirs(path, exist_ok=True)
        else:
            self.client.mkdir(path)

    def _listdir(self) -> list[str]:
        if self.client is None:
            return [os.path.join(self.root, p) for p in os.listdir(self.root)]
        return self.client.readdir(self.root)

    def _steps(self) -> list[int]:
        steps = []
        for p in self._listdir():
            base = p.rsplit("/", 1)[-1]
            if base.endswith(".manifest"):
                steps.append(int(base[len("step_"):-len(".manifest")]))
        return steps

    # -- API --------------------------------------------------------------------
    def save(self, step: int, tree) -> str:
        tmp = f"{self.root}/step_{step:08d}.tmp"
        self._mkdir(tmp)
        manifest = {"step": step, "leaves": {}}
        for name, leaf in _flatten(tree):
            arr, dtype = _to_numpy(leaf)
            buf = io.BytesIO()
            np.save(buf, arr, allow_pickle=False)
            data = buf.getvalue()
            digest = hashlib.blake2b(data, digest_size=16).hexdigest()
            fname = hashlib.blake2b(name.encode(), digest_size=8).hexdigest()
            self._write(f"{tmp}/{fname}.npy", data)
            manifest["leaves"][name] = {
                "file": f"{fname}.npy", "checksum": digest,
                "shape": list(arr.shape), "dtype": dtype}
        # The filesystem has no rename: the manifest at its final path is the
        # commit point; without it the tmp directory is garbage.
        final = f"{self.root}/step_{step:08d}.manifest"
        self._write(final, json.dumps(manifest).encode())
        self._gc()
        return final

    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return max(steps) if steps else None

    def restore(self, like_tree, step: Optional[int] = None):
        """Restore into the structure of ``like_tree``: (tree, step)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError("no checkpoint found")
        manifest = json.loads(self._read(
            f"{self.root}/step_{step:08d}.manifest").decode())
        tmp = f"{self.root}/step_{step:08d}.tmp"
        named = {}
        for name, info in manifest["leaves"].items():
            data = self._read(f"{tmp}/{info['file']}")
            digest = hashlib.blake2b(data, digest_size=16).hexdigest()
            if digest != info["checksum"]:
                raise IOError(f"checksum mismatch for {name}")
            named[name] = (np.load(io.BytesIO(data), allow_pickle=False),
                           info["dtype"])
        return _unflatten_into(like_tree, named), step

    def _gc(self):
        for s in sorted(self._steps())[:-self.keep]:
            try:
                if self.client is None:
                    os.remove(f"{self.root}/step_{s:08d}.manifest")
                else:
                    self.client.unlink(f"{self.root}/step_{s:08d}.manifest")
            except Exception:
                pass
