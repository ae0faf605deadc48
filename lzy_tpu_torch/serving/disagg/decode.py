"""Decode-pool engine: imports transferred KV prefixes, then decodes.

The port's copy of ``lzy_tpu/serving/disagg/decode.py``. The import
queue itself (``queue_kv_import``, drained at the top of every
scheduling round, strictly before admissions) lives on the base
``PagedInferenceEngine``; this subclass counts the imports the
prefill-to-decode pipeline staged. The request is then an ordinary
submit of the FULL prompt: its prefix match hits the imported blocks,
prefill runs only the sub-block tail, and the first token comes from
this engine, as in a monolithic engine.
"""

from __future__ import annotations

from lzy_tpu_torch.serving.engine import PagedInferenceEngine
from lzy_tpu_torch.utils.metrics import REGISTRY

_IMPORTS = REGISTRY.counter(
    "lzy_disagg_kv_imports_total",
    "transferred KV prefixes folded into decode replicas, by outcome")
_IMPORT_BLOCKS = REGISTRY.counter(
    "lzy_disagg_kv_import_blocks_total",
    "KV blocks imported into decode replicas")


class DecodeEngine(PagedInferenceEngine):
    """``PagedInferenceEngine`` whose KV imports count as disagg
    transfers."""

    def _note_kv_import(self, outcome: str, blocks: int) -> None:
        _IMPORTS.inc(outcome=outcome)
        if blocks:
            _IMPORT_BLOCKS.inc(blocks)
