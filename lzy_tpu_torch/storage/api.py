"""Storage client interface: the port's copy of ``lzy_tpu/storage/api.py``.

Synchronous and stream-first, as in the reference: ``read`` and ``write``
move file-like objects, so a checkpoint-sized value never has to sit in
memory whole. Trimmed to the ``file://`` and ``mem://`` backends this
slice runs; S3, Azure and the transfer engine wait (ROADMAP queue 1).
"""

from __future__ import annotations

import abc
import dataclasses
import io
from typing import BinaryIO, Iterator


@dataclasses.dataclass(frozen=True)
class StorageConfig:
    """Named storage destination: where a workflow's entries live."""

    uri: str                       # prefix, e.g. "file:///tmp/lzy" or "mem://bucket"


class StorageClient(abc.ABC):
    scheme: str = ""

    @abc.abstractmethod
    def write(self, uri: str, src: BinaryIO) -> int:
        """Store all bytes from ``src`` at ``uri``; returns byte count."""

    @abc.abstractmethod
    def read(self, uri: str, dest: BinaryIO) -> int:
        """Read the object at ``uri`` into ``dest``; returns byte count."""

    @abc.abstractmethod
    def read_range(self, uri: str, offset: int, length: int = -1) -> bytes:
        """Ranged read (``length`` < 0: to the end)."""

    @abc.abstractmethod
    def exists(self, uri: str) -> bool: ...

    @abc.abstractmethod
    def size(self, uri: str) -> int: ...

    @abc.abstractmethod
    def delete(self, uri: str) -> None: ...

    @abc.abstractmethod
    def list(self, prefix: str) -> Iterator[str]: ...

    def open_read(self, uri: str) -> BinaryIO:
        """Readable stream over the object. Default buffers in RAM;
        backends with native streams (fs) override it."""
        buf = io.BytesIO()
        self.read(uri, buf)
        buf.seek(0)
        return buf

    def write_bytes(self, uri: str, data: bytes) -> int:
        return self.write(uri, io.BytesIO(data))

    def read_bytes(self, uri: str) -> bytes:
        buf = io.BytesIO()
        self.read(uri, buf)
        return buf.getvalue()


def join_uri(prefix: str, *parts: str) -> str:
    return "/".join([prefix.rstrip("/"), *[p.strip("/") for p in parts]])
