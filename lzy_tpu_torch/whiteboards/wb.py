"""Writable whiteboards and the read-side wrapper: the port's copy of
``lzy_tpu/whiteboards/wb.py``.

Assigning a proxy to a field defers the copy until the workflow barrier
has run; assigning a local value uploads it at once. On workflow exit
every field is materialized under the whiteboard's own storage prefix and
the manifest flips to FINALIZED.
"""

from __future__ import annotations

import dataclasses
import io
from typing import TYPE_CHECKING, Any, Dict, Sequence, Type

from lzy_tpu_torch.proxy.automagic import get_proxy_entry_id, is_lzy_proxy
from lzy_tpu_torch.storage.api import join_uri
from lzy_tpu_torch.types import DataScheme
from lzy_tpu_torch.utils.ids import gen_id
from lzy_tpu_torch.whiteboards.decl import whiteboard_name
from lzy_tpu_torch.whiteboards.index import WhiteboardIndex

if TYPE_CHECKING:
    from lzy_tpu_torch.core.workflow import LzyWorkflow


class WritableWhiteboard:
    _INTERNAL = ("_wf", "_typ", "_index", "_manifest", "_field_names",
                 "_assigned", "_pending_proxy", "_finalized")

    def __init__(self, workflow: "LzyWorkflow", typ: Type, *, tags: Sequence[str] = ()):
        name = whiteboard_name(typ)
        if name is None:
            raise TypeError(
                f"{typ!r} is not a whiteboard type; decorate it with @whiteboard(name)"
            )
        field_names = {f.name for f in dataclasses.fields(typ)}
        reserved = field_names & {"id", "name", "tags", "created_at"} | {
            f for f in field_names if f.startswith("_")
        }
        if reserved:
            raise TypeError(
                f"whiteboard {name!r} field names {sorted(reserved)} collide "
                "with whiteboard attributes; rename them"
            )
        object.__setattr__(self, "_wf", workflow)
        object.__setattr__(self, "_typ", typ)
        object.__setattr__(self, "_index", WhiteboardIndex.for_lzy(workflow.owner))
        object.__setattr__(self, "_field_names", field_names)
        object.__setattr__(self, "_assigned", {})
        object.__setattr__(self, "_pending_proxy", {})
        object.__setattr__(self, "_finalized", False)
        manifest = self._index.register(
            wb_id=gen_id(f"wb-{name}"), name=name, tags=tags
        )
        object.__setattr__(self, "_manifest", manifest)

    @property
    def id(self) -> str:
        return self._manifest.id

    @property
    def name(self) -> str:
        return self._manifest.name

    def __setattr__(self, key: str, value: Any) -> None:
        if key not in self._field_names:
            raise AttributeError(
                f"whiteboard {self.name!r} has no field {key!r}; "
                f"fields: {sorted(self._field_names)}"
            )
        if is_lzy_proxy(value):
            self._pending_proxy[key] = get_proxy_entry_id(value)
            self._assigned.pop(key, None)
        else:
            self._upload_field(key, value)
            self._pending_proxy.pop(key, None)

    def __getattr__(self, key: str) -> Any:
        if key in self._INTERNAL or key not in self._field_names:
            raise AttributeError(key)
        if key in self._assigned:
            return self._read_field(key)
        raise AttributeError(f"whiteboard field {key!r} not assigned yet")

    def _field_uri(self, key: str) -> str:
        return join_uri(self._manifest.base_uri, "fields", key)

    def _upload_field(self, key: str, value: Any) -> None:
        snapshot = self._wf.snapshot
        serializer = snapshot.serializers.find_by_instance(value)
        buf = io.BytesIO()
        serializer.serialize(value, buf)
        buf.seek(0)
        snapshot.storage_client.write(self._field_uri(key), buf)
        scheme = serializer.data_scheme(value)
        self._assigned[key] = {
            "uri": self._field_uri(key),
            "data_format": scheme.data_format,
            "schema_content": scheme.schema_content,
        }

    def _read_field(self, key: str) -> Any:
        info = self._assigned[key]
        snapshot = self._wf.snapshot
        serializer = snapshot.serializers.find_by_format(info["data_format"])
        data = snapshot.storage_client.read_bytes(info["uri"])
        return serializer.deserialize(io.BytesIO(data))

    def _finalize(self) -> None:
        """Copy proxy-assigned fields from their snapshot entries, then flip to
        FINALIZED (called by the workflow on successful exit)."""
        if self._finalized:
            return
        self._wf.barrier()  # make sure producers ran
        snapshot = self._wf.snapshot
        for key, entry_id in list(self._pending_proxy.items()):
            entry = snapshot.get_entry(entry_id)
            if not entry.materialized:
                snapshot.try_restore_entry(entry_id)
            src = snapshot.storage_client.open_read(entry.storage_uri)
            try:
                snapshot.storage_client.write(self._field_uri(key), src)
            finally:
                src.close()
            scheme = entry.data_scheme or DataScheme(data_format="cloudpickle",
                                                     schema_content="")
            self._assigned[key] = {
                "uri": self._field_uri(key),
                "data_format": scheme.data_format,
                "schema_content": scheme.schema_content,
            }
        missing = self._field_names - set(self._assigned)
        if missing:
            raise ValueError(
                f"whiteboard {self.name!r} finalized with unassigned fields: "
                f"{sorted(missing)}"
            )
        self._index.finalize(self.id, dict(self._assigned))
        object.__setattr__(self, "_finalized", True)


class WhiteboardWrapper:
    """Read-only lazy view over a finalized whiteboard."""

    def __init__(self, lzy, manifest):
        self._lzy = lzy
        self._manifest = manifest
        self._cache: Dict[str, Any] = {}

    @property
    def id(self) -> str:
        return self._manifest.id

    @property
    def name(self) -> str:
        return self._manifest.name

    @property
    def tags(self):
        return self._manifest.tags

    @property
    def created_at(self):
        return self._manifest.created_at

    def __getattr__(self, key: str) -> Any:
        fields = self._manifest.fields
        if key.startswith("_") or key not in fields:
            raise AttributeError(key)
        if key not in self._cache:
            info = fields[key]
            client = self._lzy.storage_registry.default_client()
            serializer = self._lzy.serializer_registry.find_by_format(info["data_format"])
            data = client.read_bytes(info["uri"])
            self._cache[key] = serializer.deserialize(io.BytesIO(data))
        return self._cache[key]

    def __repr__(self) -> str:
        return (f"WhiteboardWrapper(id={self.id!r}, name={self.name!r}, "
                f"fields={sorted(self._manifest.fields)})")
