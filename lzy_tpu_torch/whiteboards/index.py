"""Whiteboard index: register, finalize, get and query over storage
manifests. The port's copy of ``lzy_tpu/whiteboards/index.py``, without
the IAM owner scoping and the remote client, which wait for the RPC
slice.

The layout is storage-native: ``<root>/whiteboards/<id>/manifest.json``
plus one object per field. At finalize time a small index record is
written under ``.index/all/``, ``.index/name/<name>/`` and
``.index/tag/<tag>/``, its object name prefixed with the creation time.
A query lists only the narrowest index prefix, filters on the records
and loads full manifests only for matches. The reference's time-range
query waits for the slice that first calls it.
"""

from __future__ import annotations

import datetime
import json
import threading
from typing import TYPE_CHECKING, Any, Dict, List, Optional, Sequence
from urllib.parse import quote

from lzy_tpu_torch.storage.api import StorageClient, join_uri

if TYPE_CHECKING:
    from lzy_tpu_torch.core.lzy import Lzy

CREATED = "CREATED"
FINALIZED = "FINALIZED"


class WhiteboardManifest:
    def __init__(self, doc: Dict[str, Any]):
        self.doc = doc

    @property
    def id(self) -> str:
        return self.doc["id"]

    @property
    def name(self) -> str:
        return self.doc["name"]

    @property
    def status(self) -> str:
        return self.doc["status"]

    @property
    def tags(self) -> List[str]:
        return list(self.doc.get("tags", []))

    @property
    def created_at(self) -> datetime.datetime:
        return datetime.datetime.fromisoformat(self.doc["created_at"])

    @property
    def fields(self) -> Dict[str, Dict[str, Any]]:
        return self.doc.get("fields", {})

    @property
    def base_uri(self) -> str:
        return self.doc["base_uri"]


class WhiteboardIndex:
    def __init__(self, client: StorageClient, root_uri: str):
        self._client = client
        self._root = join_uri(root_uri, "whiteboards")
        # register and finalize read, modify and write objects, and object
        # storage has no compare-and-swap: serialize them in-process
        self._mutate_lock = threading.Lock()

    @classmethod
    def for_lzy(cls, lzy: "Lzy") -> "WhiteboardIndex":
        client = lzy.storage_registry.default_client()
        config = lzy.storage_registry.default_config()
        if client is None or config is None:
            raise RuntimeError("no storage registered for whiteboard index")
        return cls(client, config.uri)

    def base_uri(self, wb_id: str) -> str:
        return join_uri(self._root, wb_id)

    def _manifest_uri(self, wb_id: str) -> str:
        return join_uri(self._root, wb_id, "manifest.json")

    def register(self, *, wb_id: str, name: str,
                 tags: Sequence[str]) -> WhiteboardManifest:
        """A duplicate register (same id, name and tags) replays the
        existing manifest; anything else under that id is a conflict."""
        with self._mutate_lock:
            try:
                existing = self.get(id_=wb_id)
            except KeyError:
                existing = None
            if existing is not None:
                if existing.name == name and sorted(existing.tags) == sorted(tags):
                    return existing
                raise ValueError(
                    f"whiteboard {wb_id!r} already registered as "
                    f"name={existing.name!r} tags={existing.tags!r}; refusing "
                    f"to overwrite with name={name!r} tags={list(tags)!r}")
            doc = {
                "id": wb_id,
                "name": name,
                "status": CREATED,
                "tags": list(tags),
                "created_at": datetime.datetime.now(datetime.timezone.utc).isoformat(),
                "base_uri": self.base_uri(wb_id),
                "fields": {},
            }
            self._write(wb_id, doc)
            return WhiteboardManifest(doc)

    def finalize(self, wb_id: str, fields: Dict[str, Dict[str, Any]]) -> None:
        with self._mutate_lock:
            manifest = self.get(id_=wb_id)
            manifest.doc["fields"] = fields
            manifest.doc["status"] = FINALIZED
            self._write(wb_id, manifest.doc)
            # index records come last: a query never surfaces a whiteboard
            # whose manifest is not yet durable
            self._write_index_records(manifest.doc)

    def _write(self, wb_id: str, doc: Dict[str, Any]) -> None:
        self._client.write_bytes(
            self._manifest_uri(wb_id), json.dumps(doc, indent=1).encode("utf-8"))

    def _index_uris(self, doc: Dict[str, Any]) -> List[str]:
        # the reference's leaf name: a timestamp prefix, so object names
        # sort by creation time
        leaf = f"{doc['created_at']}_{doc['id']}.json"
        uris = [join_uri(self._root, ".index", "all", leaf),
                join_uri(self._root, ".index", "name",
                         quote(doc["name"], safe=""), leaf)]
        for tag in doc.get("tags", []):
            uris.append(join_uri(self._root, ".index", "tag",
                                 quote(tag, safe=""), leaf))
        return uris

    def _write_index_records(self, doc: Dict[str, Any]) -> None:
        record = json.dumps({
            "id": doc["id"], "name": doc["name"], "status": doc["status"],
            "tags": doc.get("tags", []), "created_at": doc["created_at"],
        }).encode("utf-8")
        for uri in self._index_uris(doc):
            self._client.write_bytes(uri, record)

    def get(self, *, id_: str) -> WhiteboardManifest:
        uri = self._manifest_uri(id_)
        if not self._client.exists(uri):
            raise KeyError(f"whiteboard not found: {id_}")
        return WhiteboardManifest(json.loads(self._client.read_bytes(uri)))

    def query(self, *, name: Optional[str] = None, tags: Sequence[str] = ()
              ) -> List[WhiteboardManifest]:
        """Newest first. Lists the narrowest index prefix (name, else the
        first tag, else all), checks every predicate on the records, reads
        manifests of matches only."""
        # the trailing "/" matters: list() is a string-prefix match, so
        # "name/foo" would also match "name/foobar/..."
        if name is not None:
            prefix = join_uri(self._root, ".index", "name", quote(name, safe=""))
        elif tags:
            prefix = join_uri(self._root, ".index", "tag", quote(tags[0], safe=""))
        else:
            prefix = join_uri(self._root, ".index", "all")
        prefix += "/"
        out = []
        for uri in self._client.list(prefix):
            record = json.loads(self._client.read_bytes(uri))
            if record.get("status") != FINALIZED:
                continue
            if name is not None and record.get("name") != name:
                continue
            if tags and not set(tags).issubset(record.get("tags", [])):
                continue
            out.append(self.get(id_=record["id"]))
        out.sort(key=lambda m: m.created_at, reverse=True)
        return out
