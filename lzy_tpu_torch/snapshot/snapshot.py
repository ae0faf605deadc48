"""Workflow snapshot: the client-side registry of every data entry a
workflow touches (op args, results, exceptions). The port's copy of
``lzy_tpu/snapshot/snapshot.py``.

Each entry carries an id, a readable name, the Python type, the resolved
data scheme, a storage URI under the workflow's prefix and a content hash
that cache keys are built from. ``put`` and ``get`` stream through the
serializer registry. A sidecar ``<uri>.meta`` JSON travels with every
stored object, so a later execution (a cache hit, a whiteboard read)
recovers the format and the content hash; downstream cache keys are built
from that hash and must be stable across runs.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import tempfile
import threading
from typing import Any, Dict, Optional, Type

from lzy_tpu_torch.serialization.registry import SerializerRegistry
from lzy_tpu_torch.storage.api import StorageClient, join_uri
from lzy_tpu_torch.types import DataScheme
from lzy_tpu_torch.utils import hashing
from lzy_tpu_torch.utils.ids import gen_id


@dataclasses.dataclass
class SnapshotEntry:
    id: str
    name: str
    typ: Optional[Type]
    storage_uri: str
    data_scheme: Optional[DataScheme] = None
    hash: Optional[str] = None            # content hash once materialized

    @property
    def materialized(self) -> bool:
        return self.hash is not None


class Snapshot:
    def __init__(
        self,
        *,
        workflow_name: str,
        execution_id: str,
        storage_client: StorageClient,
        storage_prefix: str,
        serializers: SerializerRegistry,
    ):
        self._client = storage_client
        self._prefix = join_uri(storage_prefix, "lzy_runs", workflow_name, execution_id)
        self._serializers = serializers
        self._entries: Dict[str, SnapshotEntry] = {}
        self._lock = threading.Lock()

    @property
    def storage_prefix(self) -> str:
        """``<storage>/lzy_runs/<workflow>/<execution>``: where this
        execution's entries, op payloads and logs live."""
        return self._prefix

    @property
    def storage_client(self) -> StorageClient:
        return self._client

    @property
    def serializers(self) -> SerializerRegistry:
        return self._serializers

    def create_entry(self, name: str, typ: Optional[Type] = None) -> SnapshotEntry:
        eid = gen_id("entry")
        entry = SnapshotEntry(id=eid, name=name, typ=typ,
                              storage_uri=join_uri(self._prefix, "data", eid))
        with self._lock:
            self._entries[eid] = entry
        return entry

    def get_entry(self, entry_id: str) -> SnapshotEntry:
        with self._lock:
            return self._entries[entry_id]

    def update_entry_uri(self, entry_id: str, uri: str) -> None:
        """Re-point an entry (e.g. at a cache hit's existing object)."""
        with self._lock:
            self._entries[entry_id].storage_uri = uri

    def put(self, entry_id: str, value: Any, *,
            cacheable: bool = True) -> SnapshotEntry:
        """Serialize into a spooled temporary stream (on disk past 64 MB),
        then stream it to storage while hashing: a checkpoint-sized value
        never holds more than one serialized copy in memory.

        ``cacheable=False`` stores the object for this execution's
        consumers but marks its sidecar so that no later execution takes
        it as a cache hit (an op's ``__lzy_result_cacheable__`` veto)."""
        entry = self.get_entry(entry_id)
        serializer = self._serializers.find_by_instance(value)
        with tempfile.SpooledTemporaryFile(max_size=64 << 20) as tmp:
            serializer.serialize(value, tmp)
            tmp.seek(0)
            reader = hashing.HashingReader(tmp)
            self._client.write(entry.storage_uri, reader)
            entry.hash = reader.hexdigest()
        entry.data_scheme = serializer.data_scheme(value)
        self._write_meta(entry, cacheable=cacheable)
        return entry

    def get(self, entry_id: str) -> Any:
        entry = self.get_entry(entry_id)
        serializer = self._resolve_serializer(entry)
        with contextlib.closing(self._client.open_read(entry.storage_uri)) as src:
            return serializer.deserialize(src, entry.typ)

    def _write_meta(self, entry: SnapshotEntry, *,
                    cacheable: bool = True) -> None:
        scheme = entry.data_scheme
        doc = {
            "hash": entry.hash,
            "data_format": scheme.data_format if scheme else None,
            "schema_content": scheme.schema_content if scheme else None,
            "meta": scheme.meta if scheme else {},
        }
        if not cacheable:
            doc["cacheable"] = False
        self._client.write_bytes(
            entry.storage_uri + ".meta", json.dumps(doc).encode("utf-8"))

    def try_restore_entry(self, entry_id: str) -> bool:
        """Rehydrate scheme and hash from the sidecar for an entry whose
        object already exists in storage (a cache hit). False if absent,
        or if the object is marked not cacheable: scheme and hash are
        restored all the same, so this execution's consumers read it."""
        entry = self.get_entry(entry_id)
        meta_uri = entry.storage_uri + ".meta"
        if not self._client.exists(entry.storage_uri) or not self._client.exists(meta_uri):
            return False
        doc = json.loads(self._client.read_bytes(meta_uri).decode("utf-8"))
        entry.hash = doc["hash"]
        if doc.get("data_format"):
            entry.data_scheme = DataScheme(
                data_format=doc["data_format"],
                schema_content=doc.get("schema_content") or "",
                meta=doc.get("meta") or {},
            )
        return doc.get("cacheable", True) is not False

    def _resolve_serializer(self, entry: SnapshotEntry):
        if entry.data_scheme is not None:
            return self._serializers.find_by_format(entry.data_scheme.data_format)
        if entry.typ is not None:
            return self._serializers.find_by_type(entry.typ)
        raise TypeError(f"entry {entry.id} has neither data scheme nor type")
