"""Storage: the port's copy of ``lzy_tpu/storage`` (``file://`` and
``mem://``)."""

from lzy_tpu_torch.storage.api import StorageClient, StorageConfig
from lzy_tpu_torch.storage.fs import FsStorageClient
from lzy_tpu_torch.storage.mem import MemStorageClient
from lzy_tpu_torch.storage.registry import DefaultStorageRegistry, client_for

__all__ = [
    "StorageClient",
    "StorageConfig",
    "FsStorageClient",
    "MemStorageClient",
    "DefaultStorageRegistry",
    "client_for",
]
