"""Disaggregated prefill/decode gateway: two pools, one endpoint.

The port's copy of ``lzy_tpu/gateway/disagg.py``. It extends
:class:`~lzy_tpu_torch.gateway.service.GatewayService`, whose fleet is
the **decode pool** (routing, fenced failover, health and autoscaling
apply to it unchanged), with a **prefill pool** and the staging step
that connects them. Per request:

1. route to a decode replica with the ordinary router;
2. if that replica is *expected* to hold the prompt's whole-block prefix
   already, skip the transfer (counted);
3. otherwise run the prompt through a prefill replica (its own affinity
   router: shared headers prefill once per prefill pool), take its KV
   export, move it through the transport, and queue the import on the
   decode replica;
4. submit the FULL prompt to the decode engine: its prefix match hits
   the imported blocks and only the sub-block tail prefills there.

Every failure of step 3 (prefill replica dead or refusing, transport
death, an import refused under pool pressure or a ``kv_quant``
mismatch) degrades to the decode replica prefilling locally, counted as
a re-prefill fallback; the request never fails because of the prefill
pool.
"""

from __future__ import annotations

import threading
from typing import List, Optional

from lzy_tpu_torch.channels.kv_transfer import InMemoryKVTransport
from lzy_tpu_torch.chaos.faults import CHAOS, InjectedFault
from lzy_tpu_torch.gateway.fleet import ReplicaFleet
from lzy_tpu_torch.gateway.router import PrefixAffinityRouter
from lzy_tpu_torch.gateway.service import GatewayService
from lzy_tpu_torch.serving.scheduler import AdmissionError
from lzy_tpu_torch.utils.log import get_logger
from lzy_tpu_torch.utils.metrics import REGISTRY

_LOG = get_logger(__name__)

# chaos boundary: staging is best-effort by contract; a fault here is one
# more re-prefill fallback, never a failed request
_FP_STAGE = CHAOS.register(
    "disagg.stage", error=InjectedFault,
    doc="prefill-pool KV staging for a routed decode replica")

_TRANSFERS = REGISTRY.counter(
    "lzy_disagg_transfers_total",
    "prefill->decode KV staging attempts by outcome "
    "(transferred/skipped_cache/skipped_short/fallback)")
_SKIPPED_CACHE = REGISTRY.counter(
    "lzy_disagg_transfer_skipped_by_cache_total",
    "transfers skipped because the decode replica already held the prefix")
_FALLBACKS = REGISTRY.counter(
    "lzy_disagg_reprefill_fallbacks_total",
    "requests that re-prefilled on the decode side after a prefill-pool "
    "or transfer failure")
_XFER_BYTES = REGISTRY.counter(
    "lzy_disagg_transfer_bytes_total",
    "KV bytes moved prefill->decode")
_XFER_SECONDS = REGISTRY.histogram(
    "lzy_disagg_transfer_seconds",
    "one KV staging round trip (prefill wait + transport + import queue)",
    buckets=(0.001, 0.005, 0.02, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 10.0))
_PREFILL_REPLICAS = REGISTRY.gauge(
    "lzy_disagg_prefill_replicas", "prefill pool replicas (READY)")


class DisaggGatewayService(GatewayService):
    """Two-pool serving front; replies additionally carry
    ``prefilled_by``, ``kv_staged_by``, ``kv_transfer_ms``,
    ``kv_transfer_skipped`` and ``reprefills``."""

    def __init__(
        self,
        fleet: ReplicaFleet,                 # the DECODE pool
        prefill_fleet: ReplicaFleet,
        *,
        page_size: int = 16,
        prefill_router=None,
        transport=None,
        prefill_replicas: int = 1,
        prefill_timeout_s: float = 120.0,
        **kwargs,
    ):
        super().__init__(fleet, page_size=page_size, **kwargs)
        self.prefill_fleet = prefill_fleet
        self.prefill_router = (prefill_router if prefill_router is not None
                               else PrefixAffinityRouter(page_size))
        self.transport = transport if transport is not None \
            else InMemoryKVTransport()
        self._page = page_size
        self._prefill_target = prefill_replicas
        self._prefill_timeout_s = prefill_timeout_s
        self._tls = threading.local()
        self._xfer_lock = threading.Lock()
        self._transferred = 0
        self._skipped_cache = 0
        self._skipped_short = 0
        self._fallbacks = 0
        self._xfer_bytes = 0

    # -- request surface -----------------------------------------------------

    def generate(self, prompt, **kwargs) -> dict:
        self._tls.meta = {}        # fresh per call (failovers accumulate)
        return super().generate(prompt, **kwargs)

    def _meta(self) -> dict:
        meta = getattr(self._tls, "meta", None)
        if meta is None:
            meta = self._tls.meta = {}
        return meta

    def _note_result(self, req) -> None:
        """The prefill replica whose imported KV the final attempt really
        matched (None when it re-prefilled locally)."""
        super()._note_result(req)
        self._meta()["kv_used_from"] = getattr(req, "kv_prefilled_by", None)

    def _reply_extras(self) -> dict:
        meta = self._meta()
        out = super()._reply_extras()
        out.update({
            "prefilled_by": meta.get("kv_used_from"),
            "kv_staged_by": meta.get("prefilled_by"),
            "kv_transfer_ms": meta.get("kv_transfer_ms"),
            "kv_transfer_skipped": bool(meta.get("skipped", False)),
            "reprefills": int(meta.get("reprefills", 0)),
        })
        return out

    def _pre_submit(self, replica, prompt: List[int],
                    deadline_s: Optional[float] = None,
                    tenant: str = "default") -> bool:
        """Probe the decode replica's admission gate FIRST, then stage
        (before submit, so the import is applied before any round can
        admit the request). With the global index on, a staging that
        landed nothing falls back to a decode-pool sibling's prefix."""
        if self.kv_index is not None:
            self._reset_kv_import_meta()
        engine = replica.engine
        if getattr(engine, "closed", False) or \
                engine.queue.depth() >= engine.queue.max_depth:
            return False
        self._stage_kv(replica, prompt, deadline_s=deadline_s,
                       tenant=tenant)
        if self.kv_index is not None:
            meta = self._meta()
            if not meta.get("prefilled_by") and not meta.get("skipped"):
                self._stage_kv_import(replica, prompt,
                                      deadline_s=deadline_s)
        return True

    # -- KV staging ----------------------------------------------------------

    def _stage_kv(self, replica, prompt: List[int], *,
                  deadline_s: Optional[float] = None,
                  tenant: str = "default") -> None:
        """Best-effort: land the prompt's whole-block KV prefix on the
        chosen decode replica. Never raises."""
        meta = self._meta()
        meta.pop("prefilled_by", None)      # per attempt: a failover
        meta.pop("kv_transfer_ms", None)    # restages for the new replica
        meta.pop("skipped", None)
        # only blocks the decode engine will match: it offers prompt[:-1]
        n_full = (len(prompt) - 1) // self._page
        if n_full == 0:
            self._count("skipped_short")
            return
        if self.router.match_len(replica.id, prompt) >= n_full * self._page:
            # the router EXPECTS the prefix resident; a stale expectation
            # costs one redundant prefill, never a wrong token
            meta["skipped"] = True
            self._count("skipped_cache")
            _SKIPPED_CACHE.inc()
            return
        t0 = self._clock.now()
        try:
            CHAOS.hit("disagg.stage")
            staged = self._prefill_remote(prompt, deadline_s=deadline_s,
                                          tenant=tenant)
        except InjectedFault:
            staged = None
        if staged is None:
            meta["reprefills"] = meta.get("reprefills", 0) + 1
            self._count("fallback")
            _FALLBACKS.inc()
            return
        prefilled_by, export = staged
        replica.engine.queue_kv_import(export)
        dt = self._clock.now() - t0
        with self._xfer_lock:
            self._transferred += 1
            self._xfer_bytes += export.nbytes
        _TRANSFERS.inc(outcome="transferred")
        _XFER_BYTES.inc(export.nbytes)
        _XFER_SECONDS.observe(dt)
        meta["prefilled_by"] = prefilled_by
        meta["kv_transfer_ms"] = round(1000 * dt, 3)

    def _prefill_remote(self, prompt: List[int], *,
                        deadline_s: Optional[float] = None,
                        tenant: str = "default"):
        """Run the prompt through a prefill replica and pull its export
        over the transport: ``(prefill_replica_id, export)`` or None
        (the re-prefill fallback). A prefill replica that fails accrues
        toward its health and the next candidate is tried; the client's
        remaining deadline caps every wait."""
        if deadline_s is not None and deadline_s <= 0:
            return None
        deadline_at = (None if deadline_s is None
                       else self._clock.now() + deadline_s)
        loads = dict(self.prefill_fleet.loads())
        while loads:
            left = None
            if deadline_at is not None:
                left = deadline_at - self._clock.now()
                if left <= 0:
                    return None
            wait_s = (self._prefill_timeout_s if left is None
                      else min(self._prefill_timeout_s, left))
            rid, _ = self.prefill_router.choose(prompt, loads)
            replica = self.prefill_fleet.get(rid)
            if replica is None or \
                    not self.prefill_fleet.health.try_route(rid):
                loads.pop(rid, None)
                continue
            try:
                req = replica.engine.submit(prompt, deadline_s=left,
                                            tenant=tenant)
            except AdmissionError:
                self.prefill_fleet.health.release_probe(rid)
                loads.pop(rid, None)
                continue
            except ValueError:
                # request-scoped (prompt larger than the pool)
                self.prefill_fleet.health.release_probe(rid)
                return None
            self.prefill_router.observe(rid, prompt)
            if not req.wait(timeout=wait_s):
                req.cancel()
                _LOG.warning("disagg: prefill of %s on %s timed out",
                             req.id, rid)
                self.prefill_fleet.health.release_probe(rid)
                return None
            if req.status == "cancelled":
                # the REQUEST's deadline died, not the replica
                self.prefill_fleet.health.release_probe(rid)
                return None
            if req.error:
                _LOG.warning("disagg: prefill replica %s failed (%s); "
                             "retiring from candidates", rid, req.error)
                self.prefill_fleet.health.record_failure(rid)
                self.prefill_router.forget(rid)
                self.prefill_fleet.check_health()
                loads.pop(rid, None)
                continue
            self.prefill_fleet.health.record_success(rid)
            export = getattr(req, "kv_export", None)
            if export is None:
                return None       # sub-block prompt: nothing to move
            export.prefilled_by = rid
            ref = None
            try:
                ref = self.transport.publish(f"kv-{req.id}", export)
                fetched = self.transport.fetch(ref)
            except Exception as e:  # noqa: BLE001 — mid-transfer death
                _LOG.warning("disagg: kv transfer for %s died mid-stream "
                             "(%s: %s); decode side will re-prefill",
                             req.id, type(e).__name__, e)
                return None
            finally:
                if ref is not None:
                    try:
                        self.transport.discard(ref)
                    except Exception:  # noqa: BLE001 — best-effort
                        pass
            return rid, fetched
        return None               # no live prefill replica at all

    def _count(self, outcome: str) -> None:
        with self._xfer_lock:
            if outcome == "skipped_cache":
                self._skipped_cache += 1
            elif outcome == "skipped_short":
                self._skipped_short += 1
            elif outcome == "fallback":
                self._fallbacks += 1
        _TRANSFERS.inc(outcome=outcome)

    # -- control loop --------------------------------------------------------

    def tick(self, now: Optional[float] = None) -> Optional[str]:
        """Decode-pool tick plus prefill-pool upkeep: retire dead prefill
        replicas and re-add up to the configured size, one per tick."""
        for rid in self.prefill_fleet.check_health(now=now):
            self.prefill_router.forget(rid)
        ready = len(self.prefill_fleet.replicas())
        if ready < self._prefill_target:
            _LOG.warning("disagg: %d/%d prefill replicas; re-adding",
                         ready, self._prefill_target)
            try:
                self.prefill_fleet.add_replica()
            except Exception:  # noqa: BLE001 — retried next tick
                _LOG.exception("disagg: prefill re-add failed")
        _PREFILL_REPLICAS.set(float(len(self.prefill_fleet.replicas())))
        return super().tick(now)

    def close(self) -> None:
        super().close()
        self.prefill_fleet.close()

    # -- observability -------------------------------------------------------

    def stats(self) -> dict:
        doc = super().stats()
        with self._xfer_lock:
            doc.update({
                "disagg": True,
                "prefill_replicas": len(self.prefill_fleet.replicas()),
                "kv_transfers": self._transferred,
                "kv_transfer_bytes": self._xfer_bytes,
                "kv_transfer_skipped_by_cache": self._skipped_cache,
                "kv_transfer_skipped_short": self._skipped_short,
                "reprefill_fallbacks": self._fallbacks,
            })
        return doc

    def fleet_stats(self) -> dict:
        """Per-replica rows with a ``pool`` of ``decode`` or ``prefill``."""
        doc = super().fleet_stats()
        for row in doc["replicas"]:
            row["pool"] = "decode"
        for state in ("READY", "DRAINING"):
            for replica in self.prefill_fleet.replicas(state=state):
                row = replica.engine.stats().doc()
                row.update({
                    "replica": replica.id,
                    "state": replica.state,
                    "pool": "prefill",
                    "consecutive_failures":
                        self.prefill_fleet.health.failures(replica.id),
                })
                doc["replicas"].append(row)
        doc["pools"] = {
            pool: sum(1 for r in doc["replicas"] if r["pool"] == pool)
            for pool in ("decode", "prefill")}
        return doc
