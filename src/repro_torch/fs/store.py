"""User-space byte-addressable file system (paper §4.3).

Files and directories are both stored as objects; objects and their metadata
are placed on servers by consistent hashing; striping is supported with
stripe records in the metadata.  Reads return byte ranges; concurrent
non-overlapping writes need no lock; metadata updates are serialized per
server (a threading lock stands in for the paper's per-server metadata lock).

This is the storage plane under the burst-buffer service
(:mod:`repro_torch.bb`): every operation is expressed as I/O *requests*
carrying job metadata, which is what the ThemisIO scheduler reorders.  The
port's own copy of the reference's ``fs/store.py``: the same ring (blake2b
placement, so every path lands on the same server) and the same layout.
Pure Python.
"""
from __future__ import annotations

import bisect
import dataclasses
import hashlib
import threading
from typing import Optional


def _hash(key: str, salt: str = "") -> int:
    return int.from_bytes(hashlib.blake2b(
        (salt + key).encode(), digest_size=8).digest(), "big")


class ConsistentHash:
    """Ring with virtual nodes; maps path -> server id (paper §4.3)."""

    def __init__(self, n_servers: int, vnodes: int = 64):
        self.n_servers = n_servers
        self._ring: list[tuple[int, int]] = sorted(
            (_hash(f"s{s}v{v}"), s)
            for s in range(n_servers) for v in range(vnodes))
        self._keys = [h for h, _ in self._ring]

    def server_of(self, path: str, replica: int = 0) -> int:
        h = _hash(path, salt=f"r{replica}")
        i = bisect.bisect_right(self._keys, h) % len(self._ring)
        return self._ring[i][1]

    def stripe_servers(self, path: str, n_stripes: int) -> list[int]:
        first = self.server_of(path)
        return [(first + i) % self.n_servers for i in range(max(1, n_stripes))]


@dataclasses.dataclass
class FileMeta:
    path: str
    size: int = 0
    is_dir: bool = False
    stripe_size: int = 4 * 1024 * 1024
    n_stripes: int = 1
    servers: tuple[int, ...] = (0,)


class ByteStore:
    """One server's NVMe region: an extent map of byte ranges."""

    def __init__(self):
        self._extents: dict[tuple[str, int], bytes] = {}
        self.bytes_written = 0
        self.bytes_read = 0

    def write(self, path: str, offset: int, data: bytes):
        self._extents[(path, offset)] = bytes(data)
        self.bytes_written += len(data)

    def read(self, path: str, offset: int, size: int) -> bytes:
        # reassemble from extents (extents are written at fixed offsets by
        # the stripe layer, so exact-match lookup first, then scan)
        exact = self._extents.get((path, offset))
        if exact is not None and len(exact) >= size:
            self.bytes_read += size
            return exact[:size]
        out = bytearray(size)
        for (p, off), data in self._extents.items():
            if p != path:
                continue
            lo = max(off, offset)
            hi = min(off + len(data), offset + size)
            if lo < hi:
                out[lo - offset:hi - offset] = data[lo - off:hi - off]
        self.bytes_read += size
        return bytes(out)

    def delete(self, path: str):
        self._extents = {k: v for k, v in self._extents.items() if k[0] != path}


class FileSystem:
    """Metadata + striped data across ``n_servers`` ByteStores."""

    def __init__(self, n_servers: int, default_stripes: int = 1,
                 stripe_size: int = 4 * 1024 * 1024):
        self.ring = ConsistentHash(n_servers)
        self.stores = [ByteStore() for _ in range(n_servers)]
        self.meta: dict[str, FileMeta] = {
            "/": FileMeta(path="/", is_dir=True)}
        self.default_stripes = default_stripes
        self.stripe_size = stripe_size
        self._lock = threading.Lock()

    # -- metadata ------------------------------------------------------------
    def create(self, path: str, *, is_dir: bool = False,
               n_stripes: Optional[int] = None) -> FileMeta:
        with self._lock:
            parent = path.rsplit("/", 1)[0] or "/"
            if parent not in self.meta or not self.meta[parent].is_dir:
                raise FileNotFoundError(f"parent {parent} missing")
            ns = n_stripes or self.default_stripes
            fm = FileMeta(path=path, is_dir=is_dir, n_stripes=ns,
                          stripe_size=self.stripe_size,
                          servers=tuple(self.ring.stripe_servers(path, ns)))
            self.meta[path] = fm
            return fm

    def stat(self, path: str) -> FileMeta:
        fm = self.meta.get(path)
        if fm is None:
            raise FileNotFoundError(path)
        return fm

    def listdir(self, path: str) -> list[str]:
        if not self.stat(path).is_dir:
            raise NotADirectoryError(path)
        prefix = path.rstrip("/") + "/"
        return sorted(p for p in self.meta
                      if p.startswith(prefix) and "/" not in p[len(prefix):])

    def unlink(self, path: str):
        with self._lock:
            fm = self.meta.pop(path)
            for s in fm.servers:
                self.stores[s].delete(path)

    # -- data ----------------------------------------------------------------
    def stripe_plan(self, path: str, offset: int, size: int):
        """Yield (server, stripe_offset, length, buf_offset) tuples."""
        fm = self.stat(path)
        ss = fm.stripe_size
        pos = offset
        while pos < offset + size:
            stripe_idx = pos // ss
            server = fm.servers[stripe_idx % len(fm.servers)]
            in_stripe = pos % ss
            length = min(ss - in_stripe, offset + size - pos)
            yield server, pos, length, pos - offset
            pos += length

    def write(self, path: str, offset: int, data: bytes):
        for server, off, length, bo in self.stripe_plan(path, offset, len(data)):
            self.stores[server].write(path, off, data[bo:bo + length])
        with self._lock:
            fm = self.meta[path]
            fm.size = max(fm.size, offset + len(data))

    def read(self, path: str, offset: int, size: int) -> bytes:
        out = bytearray(size)
        for server, off, length, bo in self.stripe_plan(path, offset, size):
            out[bo:bo + length] = self.stores[server].read(path, off, length)
        return bytes(out)
