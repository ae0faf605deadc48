"""Content hashing for cache keys: the port's copy of
``lzy_tpu/utils/hashing.py``, trimmed to what snapshots, workers and
workflow cache keys use (module-sync hashing waits for the provisioning
slice).

Keys are blake2b digests, as in the reference: a stable hash per stored
entry, combined into a cache key per call, so the two packages derive
their keys the same way.
"""

from __future__ import annotations

import hashlib
from typing import Iterable


class HashingReader:
    """Wraps a readable stream, hashing bytes as a consumer pulls them:
    a storage write and the entry's content hash share one pass."""

    def __init__(self, inner):
        self._inner = inner
        self._hasher = hashlib.blake2b(digest_size=16)

    def read(self, n: int = -1) -> bytes:
        data = self._inner.read(n)
        self._hasher.update(data)
        return data

    def hexdigest(self) -> str:
        return self._hasher.hexdigest()


def hash_bytes(data: bytes) -> str:
    """The digest :class:`HashingReader` gives for the same bytes."""
    return hashlib.blake2b(data, digest_size=16).hexdigest()


def combine_hashes(hashes: Iterable[str]) -> str:
    h = hashlib.blake2b(digest_size=16)
    for x in hashes:
        h.update(x.encode("utf-8"))
        h.update(b"\x00")
    return h.hexdigest()
