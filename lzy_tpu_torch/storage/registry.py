"""Storage registry: named storage configs and client construction, the
port's copy of ``lzy_tpu/storage/registry.py``.

A workflow resolves its storage by name ("default" unless overridden);
clients are built from the URI's scheme. The port serves ``file://`` and
``mem://``; every other scheme, ``s3://`` and ``azure://`` included,
fails with ``ValueError`` until its backend is ported.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple

from lzy_tpu_torch.storage.api import StorageClient, StorageConfig
from lzy_tpu_torch.storage.fs import FsStorageClient
from lzy_tpu_torch.storage.mem import MemStorageClient

DEFAULT_NAME = "default"

_CLIENTS = {"file": FsStorageClient, "mem": MemStorageClient}


def client_for(config: StorageConfig) -> StorageClient:
    scheme = config.uri.split("://", 1)[0]
    if scheme not in _CLIENTS:
        raise ValueError(
            f"unsupported storage scheme {scheme!r} in {config.uri!r}")
    return _CLIENTS[scheme]()


class DefaultStorageRegistry:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._items: Dict[str, Tuple[StorageConfig, StorageClient]] = {}
        self._default: Optional[str] = None

    def register_storage(self, name: str, config: StorageConfig,
                         default: bool = False) -> None:
        with self._lock:
            self._items[name] = (config, client_for(config))
            if default or self._default is None:
                self._default = name

    def unregister_storage(self, name: str) -> None:
        with self._lock:
            self._items.pop(name, None)
            if self._default == name:
                self._default = next(iter(self._items), None)

    def config(self, name: str = DEFAULT_NAME) -> Optional[StorageConfig]:
        with self._lock:
            item = self._items.get(name)
        return item[0] if item else None

    def client(self, name: str = DEFAULT_NAME) -> Optional[StorageClient]:
        with self._lock:
            item = self._items.get(name)
        return item[1] if item else None

    def default_config(self) -> Optional[StorageConfig]:
        with self._lock:
            name = self._default
        return self.config(name) if name else None

    def default_client(self) -> Optional[StorageClient]:
        with self._lock:
            name = self._default
        return self.client(name) if name else None

    def default_name(self) -> Optional[str]:
        with self._lock:
            return self._default
