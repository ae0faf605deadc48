"""Disaggregated prefill/decode serving (the two-pool mode).

The port's copy of ``lzy_tpu/serving/disagg``: a prefill pool of
:class:`PrefillEngine` replicas computes each prompt's KV blocks and
exports them (:func:`export_kv`); the gateway moves the
:class:`~lzy_tpu_torch.channels.kv_transfer.KVBlockExport` to a
:class:`DecodeEngine`, which folds it into its pool (:func:`import_kv`)
before admitting the request. Every piece degrades to "the decode
replica prefills locally": a lost transfer costs FLOPs, never
correctness.
"""

from lzy_tpu_torch.serving.disagg.decode import DecodeEngine
from lzy_tpu_torch.serving.disagg.kv_export import export_kv, import_kv
from lzy_tpu_torch.serving.disagg.prefill import PrefillEngine

__all__ = ["DecodeEngine", "PrefillEngine", "export_kv", "import_kv"]
