"""Local-filesystem storage backend (``file://`` URIs): the port's copy
of ``lzy_tpu/storage/fs.py`` without the transfer engine's fast paths.

Writes are atomic (temporary file, then rename), so a crashed producer
never leaves a half-written object readable.
"""

from __future__ import annotations

import os
import shutil
import tempfile
from pathlib import Path
from typing import BinaryIO, Iterator
from urllib.parse import urlparse

from lzy_tpu_torch.storage.api import StorageClient


class FsStorageClient(StorageClient):
    scheme = "file"

    def _path(self, uri: str) -> Path:
        parsed = urlparse(uri)
        if parsed.scheme != "file":
            raise ValueError(f"FsStorageClient got non-file uri {uri!r}")
        return Path(parsed.path)

    def write(self, uri: str, src: BinaryIO) -> int:
        path = self._path(uri)
        path.parent.mkdir(parents=True, exist_ok=True)
        fd = tempfile.NamedTemporaryFile(dir=path.parent, delete=False)
        try:
            with fd:
                shutil.copyfileobj(src, fd, 4 << 20)
            # NamedTemporaryFile forces 0600: restore umask-governed
            # permissions, so other readers of the store can read it
            umask = os.umask(0)
            os.umask(umask)
            os.chmod(fd.name, 0o666 & ~umask)
            os.replace(fd.name, path)
        except BaseException:
            os.unlink(fd.name)
            raise
        return path.stat().st_size

    def open_read(self, uri: str) -> BinaryIO:
        return open(self._path(uri), "rb")

    def read(self, uri: str, dest: BinaryIO) -> int:
        path = self._path(uri)
        with open(path, "rb") as f:
            shutil.copyfileobj(f, dest)
        return path.stat().st_size

    def read_range(self, uri: str, offset: int, length: int = -1) -> bytes:
        with open(self._path(uri), "rb") as f:
            f.seek(offset)
            return f.read(length if length >= 0 else None)

    def exists(self, uri: str) -> bool:
        return self._path(uri).is_file()

    def size(self, uri: str) -> int:
        return self._path(uri).stat().st_size

    def delete(self, uri: str) -> None:
        p = self._path(uri)
        if p.is_file():
            p.unlink()

    def list(self, prefix: str) -> Iterator[str]:
        # string-prefix semantics, matching mem://: a prefix need not
        # align with a directory boundary
        base = self._path(prefix)
        root = base if base.is_dir() else base.parent
        if not root.is_dir():
            return
        for p in sorted(root.rglob("*")):
            if p.is_file() and str(p).startswith(str(base)):
                yield f"file://{p}"
