"""In-memory storage backend (``mem://`` URIs): the port's copy of
``lzy_tpu/storage/mem.py``.

Buckets are global to the process, so the SDK and an in-process runtime
see the same objects. They are the port's OWN buckets: the reference's
``mem://`` store is a different dictionary, and clearing one leaves the
other alone.
"""

from __future__ import annotations

import io
import shutil
import threading
from typing import BinaryIO, Dict, Iterator

from lzy_tpu_torch.storage.api import StorageClient

_BUCKETS: Dict[str, bytes] = {}
_LOCK = threading.Lock()


class MemStorageClient(StorageClient):
    scheme = "mem"

    def write(self, uri: str, src: BinaryIO) -> int:
        buf = io.BytesIO()
        shutil.copyfileobj(src, buf)
        data = buf.getvalue()
        with _LOCK:
            _BUCKETS[uri] = data
        return len(data)

    def read(self, uri: str, dest: BinaryIO) -> int:
        with _LOCK:
            data = _BUCKETS.get(uri)
        if data is None:
            raise FileNotFoundError(uri)
        dest.write(data)
        return len(data)

    def read_range(self, uri: str, offset: int, length: int = -1) -> bytes:
        with _LOCK:
            data = _BUCKETS.get(uri)
        if data is None:
            raise FileNotFoundError(uri)
        return data[offset:] if length < 0 else data[offset : offset + length]

    def exists(self, uri: str) -> bool:
        with _LOCK:
            return uri in _BUCKETS

    def size(self, uri: str) -> int:
        with _LOCK:
            if uri not in _BUCKETS:
                raise FileNotFoundError(uri)
            return len(_BUCKETS[uri])

    def delete(self, uri: str) -> None:
        with _LOCK:
            _BUCKETS.pop(uri, None)

    def list(self, prefix: str) -> Iterator[str]:
        with _LOCK:
            keys = sorted(k for k in _BUCKETS if k.startswith(prefix))
        yield from keys

    @staticmethod
    def clear_all() -> None:
        with _LOCK:
            _BUCKETS.clear()
