"""Prefill-pool engine: admits prompt-only work, exports KV blocks.

The port's copy of ``lzy_tpu/serving/disagg/prefill.py``. A prefill
replica runs the same chunked, radix-cached prefill as a
``PagedInferenceEngine`` but never decodes: the request finishes once
its prompt's KV blocks are resident, with the export snapshot attached
(``request.kv_export``) for the gateway to ship to a decode replica.
The first generated token is deliberately not produced here: the decode
replica prefills the sub-block tail and picks it, as a monolithic
engine would.
"""

from __future__ import annotations

import dataclasses

from lzy_tpu_torch.serving.disagg.kv_export import export_kv
from lzy_tpu_torch.serving.engine import _REQUESTS, PagedInferenceEngine
from lzy_tpu_torch.serving.scheduler import Request
from lzy_tpu_torch.utils.log import get_logger
from lzy_tpu_torch.utils.metrics import REGISTRY

_LOG = get_logger(__name__)

_EXPORTS = REGISTRY.counter(
    "lzy_disagg_kv_exports_total",
    "prompt prefixes exported by prefill replicas")
_EXPORT_BLOCKS = REGISTRY.counter(
    "lzy_disagg_kv_export_blocks_total",
    "KV blocks exported by prefill replicas")
_PREFILL_SECONDS = REGISTRY.histogram(
    "lzy_disagg_prefill_seconds",
    "prompt admission to KV blocks resident on a prefill replica",
    buckets=(0.005, 0.02, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 10.0, 60.0))


class PrefillEngine(PagedInferenceEngine):
    """``PagedInferenceEngine`` that stops at the end of prefill;
    ``request.kv_export`` holds the prompt's whole-block KV (None for a
    sub-block prompt) and ``request.tokens`` stays empty."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._exports = 0
        self._export_blocks = 0

    def submit(self, prompt, *, request_id=None, deadline_s=None,
               tenant="default", priority=None, **_ignored) -> Request:
        # max_new_tokens=1 passes the base validation without reserving
        # decode room that is never used
        return super().submit(prompt, max_new_tokens=1,
                              request_id=request_id, deadline_s=deadline_s,
                              tenant=tenant, priority=priority)

    def _finish_prefill(self, slot: int, req: Request, first: int) -> None:
        """Snapshot the prompt's blocks while the slot still pins them
        (on this engine's thread), then finish without emitting."""
        now = self._clock.now()
        req.first_token_at = now            # "time to KV ready" here
        _PREFILL_SECONDS.observe(now - req.submitted_at)
        try:
            req.kv_export = export_kv(self, req.prompt)
        except Exception as e:  # noqa: BLE001 — export is advisory
            _LOG.warning("kv export failed for %s: %s", req.id, e)
            req.kv_export = None
        if req.kv_export is not None:
            self._exports += 1
            self._export_blocks += req.kv_export.n_blocks
            _EXPORTS.inc()
            _EXPORT_BLOCKS.inc(req.kv_export.n_blocks)
        self._finished += 1
        _REQUESTS.inc(status="ok")
        self._tenant_count(req.tenant, "requests_finished")
        self._free(slot)      # the tree keeps the prompt blocks cached
        req.finish()

    def stats(self):
        return dataclasses.replace(super().stats(),
                                   kv_exports=self._exports,
                                   kv_export_blocks=self._export_blocks)
