"""Paged-KV block transfer between replicas.

The port's copy of ``lzy_tpu/channels/kv_transfer.py``, trimmed to the
in-process path (the storage spill path waits for the port's storage
plane and serializer):

- :class:`KVBlockExport` — the host-side snapshot of one prompt prefix's
  pool blocks. Its leaves are keyed by the reference cache tree's
  keystr (``"['layer_0']['attn']['k']"``, plus ``'k_scale'``, ``'k_zp'``,
  ``'v_scale'``, ``'v_zp'`` for int8 pools), so an export crosses
  frameworks and the importer's leaf-set check still catches a
  mismatched ``kv_quant``.
- :func:`build_kv_manifest` / :func:`parse_kv_manifest` — the JSON
  manifest of the reference's wire format (dtype strings ``"float32"``,
  ``"bfloat16"``, ``"int8"``).
- :class:`InMemoryKVTransport` — the direct producer-to-consumer path of
  an in-process fleet: the consumer pulls the published export by key.

A transfer is advisory: a consumer that cannot fetch re-prefills
locally.
"""

from __future__ import annotations

import dataclasses
import json
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from lzy_tpu_torch.chaos.faults import CHAOS

KV_MANIFEST_FORMAT = "kv_block_manifest"
_MAGIC = {"format": KV_MANIFEST_FORMAT, "v": 1}


def dtype_name(arr) -> str:
    """The manifest's dtype string for a torch tensor or a numpy array
    (``"float32"``, ``"bfloat16"``, ``"int8"``)."""
    return str(arr.dtype).replace("torch.", "")


def host_tensor(arr) -> torch.Tensor:
    """A leaf as a CPU tensor: torch tensors pass through; numpy arrays
    (a reference-side export) convert in place where writable, bf16
    through its bits."""
    if isinstance(arr, torch.Tensor):
        return arr
    arr = np.ascontiguousarray(arr)
    if not arr.flags.writeable:        # a JAX array's host view
        arr = arr.copy()
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


@dataclasses.dataclass
class KVBlockExport:
    """Host-side snapshot of one prompt prefix's paged KV blocks.

    ``tokens`` is the whole-block token prefix (a multiple of
    ``page_size``); ``leaves`` maps a cache-leaf key to that leaf's block
    rows ``[n_blocks, page_size, kv_heads(, head_dim)]`` in prefix order,
    as CPU tensors (numpy arrays are accepted from a reference export).
    Block ids never travel: the importer allocates its own."""

    tokens: List[int]
    page_size: int
    leaves: Dict[str, object]
    prefilled_by: Optional[str] = None
    mesh_shape: Optional[Tuple[int, ...]] = None

    @property
    def n_blocks(self) -> int:
        return len(self.tokens) // self.page_size

    @property
    def nbytes(self) -> int:
        return sum(int(a.nbytes) for a in self.leaves.values())


def build_kv_manifest(export: KVBlockExport,
                      leaf_uris: Dict[str, str]) -> bytes:
    """The manifest document: token prefix plus per-leaf uri, dtype and
    shape."""
    leaves = {key: {"dtype": dtype_name(arr), "shape": list(arr.shape),
                    "uri": leaf_uris[key]}
              for key, arr in export.leaves.items()}
    doc = {
        **_MAGIC,
        "page_size": export.page_size,
        "tokens": [int(t) for t in export.tokens],
        "prefilled_by": export.prefilled_by,
        "leaves": leaves,
    }
    if export.mesh_shape is not None:
        doc["mesh_shape"] = [int(d) for d in export.mesh_shape]
    return json.dumps(doc).encode("utf-8")


def parse_kv_manifest(raw: bytes) -> dict:
    doc = json.loads(raw.decode("utf-8"))
    if doc.get("format") != KV_MANIFEST_FORMAT:
        raise ValueError("not a kv-block manifest")
    if doc.get("v") != 1:
        raise ValueError(f"unknown kv-block manifest version {doc.get('v')}")
    return doc


class KVTransferError(RuntimeError):
    """The producer side of a KV transfer is gone; the consumer falls
    back to re-prefill."""


# chaos boundaries: both degrade to a consumer-side re-prefill
_FP_SEND = CHAOS.register(
    "kv.publish", error=KVTransferError,
    doc="KV export leaving the producer (send side of the transfer)")
_FP_RECV = CHAOS.register(
    "kv.fetch", error=KVTransferError,
    doc="KV export arriving at the consumer (recv side of the transfer)")


class InMemoryKVTransport:
    """Direct producer-to-consumer path for in-process pools: the export
    stays in RAM and the consumer pulls it by key. ``fail_next_fetch``
    makes that many fetches raise :class:`KVTransferError` (a peer dying
    mid-stream)."""

    def __init__(self):
        self._payloads: Dict[str, KVBlockExport] = {}
        self._lock = threading.Lock()
        self.fail_next_fetch = 0
        self.published = 0
        self.fetched = 0

    def publish(self, key: str, export: KVBlockExport) -> str:
        CHAOS.hit("kv.publish")
        with self._lock:
            self._payloads[key] = export
            self.published += 1
        return key

    def fetch(self, ref: str) -> KVBlockExport:
        CHAOS.hit("kv.fetch")
        with self._lock:
            if self.fail_next_fetch > 0:
                self.fail_next_fetch -= 1
                raise KVTransferError(
                    f"kv transfer {ref} died mid-stream (injected)")
            export = self._payloads.get(ref)
            if export is None:
                raise KVTransferError(f"kv payload {ref} is gone")
            self.fetched += 1
        return export

    def discard(self, ref: str) -> None:
        with self._lock:
            self._payloads.pop(ref, None)
