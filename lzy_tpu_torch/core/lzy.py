"""The ``Lzy`` facade: the port's copy of ``lzy_tpu/core/lzy.py``.

It holds the environment, the runtime and the serializer and storage
registries, and builds workflows and whiteboard accessors. With no
storage given, ``Lzy()`` stores under ``$LZY_TPU_TORCH_LOCAL_STORAGE``,
else ``<tempdir>/lzy_tpu_torch_storage``: a root of the port's own,
never the reference's ``lzy_tpu_storage``.
"""

from __future__ import annotations

import os
import tempfile
from typing import Optional, Sequence

from lzy_tpu_torch.core.workflow import LzyWorkflow
from lzy_tpu_torch.env.environment import LzyEnvironment, WithEnvironmentMixin
from lzy_tpu_torch.runtime.api import Runtime
from lzy_tpu_torch.serialization import SerializerRegistry, default_registry
from lzy_tpu_torch.storage import DefaultStorageRegistry, StorageConfig

#: the environment variable naming the default storage root
LOCAL_STORAGE_ENV = "LZY_TPU_TORCH_LOCAL_STORAGE"


def lzy_auth(*, user: str, key_path: Optional[str] = None,
             endpoint: Optional[str] = None,
             whiteboards_endpoint: Optional[str] = None) -> None:
    """Set remote credentials through environment variables, the
    reference's contract (``LZY_USER``, ``LZY_KEY_PATH``, ``LZY_ENDPOINT``,
    ``LZY_WHITEBOARD_ENDPOINT``). They are process-wide; the RPC
    client that reads them waits for the RPC control plane."""
    os.environ["LZY_USER"] = user
    if key_path is not None:
        os.environ["LZY_KEY_PATH"] = key_path
    if endpoint is not None:
        os.environ["LZY_ENDPOINT"] = endpoint
    if whiteboards_endpoint is not None:
        os.environ["LZY_WHITEBOARD_ENDPOINT"] = whiteboards_endpoint


def default_storage_root() -> str:
    return os.environ.get(
        LOCAL_STORAGE_ENV,
        os.path.join(tempfile.gettempdir(), "lzy_tpu_torch_storage"))


class Lzy(WithEnvironmentMixin):
    def __init__(
        self,
        *,
        runtime: Optional[Runtime] = None,
        storage_registry: Optional[DefaultStorageRegistry] = None,
        serializer_registry: Optional[SerializerRegistry] = None,
        env: Optional[LzyEnvironment] = None,
    ):
        self.env = env or LzyEnvironment()
        self._runtime = runtime or self._default_runtime()
        self._storage_registry = storage_registry or self._default_storage()
        self._serializer_registry = serializer_registry or default_registry()

    @staticmethod
    def _default_runtime() -> Runtime:
        from lzy_tpu_torch.runtime.local import LocalRuntime

        return LocalRuntime()

    @staticmethod
    def _default_storage() -> DefaultStorageRegistry:
        reg = DefaultStorageRegistry()
        reg.register_storage(
            "default", StorageConfig(uri=f"file://{default_storage_root()}"),
            default=True)
        return reg

    # -- registries ------------------------------------------------------------

    @property
    def runtime(self) -> Runtime:
        return self._runtime

    @property
    def storage_registry(self) -> DefaultStorageRegistry:
        return self._storage_registry

    @property
    def serializer_registry(self) -> SerializerRegistry:
        return self._serializer_registry

    # -- workflows -------------------------------------------------------------

    def workflow(self, name: str, *,
                 env: Optional[LzyEnvironment] = None) -> LzyWorkflow:
        return LzyWorkflow(self, name, env or LzyEnvironment())

    # -- whiteboards -----------------------------------------------------------

    def whiteboard(self, *, id_: str):
        from lzy_tpu_torch.whiteboards.index import WhiteboardIndex
        from lzy_tpu_torch.whiteboards.wb import WhiteboardWrapper

        manifest = WhiteboardIndex.for_lzy(self).get(id_=id_)
        return WhiteboardWrapper(self, manifest)

    def whiteboards(self, *, name: Optional[str] = None, tags: Sequence[str] = ()):
        from lzy_tpu_torch.whiteboards.index import WhiteboardIndex
        from lzy_tpu_torch.whiteboards.wb import WhiteboardWrapper

        manifests = WhiteboardIndex.for_lzy(self).query(name=name, tags=tags)
        return [WhiteboardWrapper(self, m) for m in manifests]
