"""The byte-addressable file system under the port's burst-buffer service."""
from .store import ByteStore, ConsistentHash, FileMeta, FileSystem

__all__ = ["ByteStore", "ConsistentHash", "FileMeta", "FileSystem"]
