"""Replica fleet: engine lifecycle for the gateway.

The port's copy of ``lzy_tpu/gateway/fleet.py``, covering the unleased
fleet (``allocator=None`` in the reference): a replica is an inference
engine running its loop in a thread of this process. Leasing replicas
through an allocator, adopting them after a gateway restart and the
crash-recovery journal wait for their own slices.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Dict, List, Optional

from lzy_tpu_torch.gateway.health import HealthPolicy, HealthTracker
from lzy_tpu_torch.utils.clock import SYSTEM_CLOCK
from lzy_tpu_torch.utils.log import get_logger
from lzy_tpu_torch.utils.metrics import REGISTRY

_LOG = get_logger(__name__)

_REPLICAS = REGISTRY.gauge(
    "lzy_gateway_replicas", "fleet replicas by state")
_R_QUEUE = REGISTRY.gauge(
    "lzy_gateway_replica_queue_depth", "per-replica admission queue depth")
_R_BUSY = REGISTRY.gauge(
    "lzy_gateway_replica_slots_busy", "per-replica busy decode slots")
_RETIRED = REGISTRY.counter(
    "lzy_gateway_replicas_retired_total", "replicas retired by cause")

READY = "READY"
DRAINING = "DRAINING"
DEAD = "DEAD"

#: per-tenant TERMINAL counters banked on replica retirement and summed
#: fleet-wide (live fields, queue_depth and kv_blocks, die with the
#: replica)
_TENANT_COUNTERS = ("requests_finished", "tokens_generated",
                    "requests_cancelled", "requests_preempted",
                    "requests_error")

#: engine counters summed fleet-wide (key -> engine attribute), banked
#: on retirement so aggregates stay monotonic across scale-downs
_ENGINE_COUNTERS = (("spec_proposed_tokens", "spec_proposed"),
                    ("spec_accepted_tokens", "spec_accepted"),
                    ("spec_draft_truncated", "spec_draft_truncated"),
                    ("decode_steps", "decode_steps"),
                    ("decode_rows", "decode_rows"),
                    ("decode_tokens", "decode_tokens"),
                    ("kv_imports", "kv_imports"),
                    ("kv_import_blocks", "kv_import_blocks"),
                    ("kv_tier_demotions", "kv_tier_demotions"),
                    ("kv_tier_promotions", "kv_tier_promotions"),
                    ("kv_tier_dropped", "kv_tier_dropped"))


@dataclasses.dataclass
class Replica:
    id: str
    engine: object                      # InferenceEngine-compatible
    state: str = READY


class ReplicaFleet:
    """Owns replicas; the gateway routes over :meth:`loads` and calls
    :meth:`check_health` / :meth:`reap_drained` from its tick."""

    def __init__(
        self,
        engine_factory: Callable[[], object],
        *,
        health: Optional[HealthTracker] = None,
        start_engines: bool = True,
        replica_prefix: str = "replica",
        clock=None,
    ):
        self._factory = engine_factory
        self._clock = clock if clock is not None else SYSTEM_CLOCK
        self.health = health or HealthTracker(HealthPolicy(),
                                              clock=self._clock)
        self._start_engines = start_engines
        # distinct prefixes keep ids unambiguous when several fleets
        # share a front (the disagg gateway's prefill and decode pools)
        self._replica_prefix = replica_prefix
        self._replicas: Dict[str, Replica] = {}
        self._seq = 0
        self._lock = threading.RLock()
        self._closed = False
        # terminal counters of retired replicas: fleet aggregates stay
        # MONOTONIC across scale-downs and failovers
        self._retired_totals = {
            "requests_finished": 0, "tokens_generated": 0,
            "prefix_hit_tokens": 0, "prefix_lookup_tokens": 0,
            **{key: 0 for key, _ in _ENGINE_COUNTERS}}
        self._retired_tenants: Dict[str, Dict[str, int]] = {}

    # -- lifecycle -----------------------------------------------------------

    def add_replica(self) -> Replica:
        """Build and start one replica."""
        with self._lock:
            if self._closed:
                raise RuntimeError("fleet is closed")
            self._seq += 1
            rid = f"{self._replica_prefix}-{self._seq}"
        engine = self._factory()
        if self._start_engines:
            engine.start()
        replica = Replica(id=rid, engine=engine)
        with self._lock:
            unwind = self._closed
            if not unwind:
                self._replicas[rid] = replica
        if unwind:
            # the fleet closed while the engine was being built
            try:
                engine.close()
            except Exception:  # noqa: BLE001 — best-effort unwind
                pass
            raise RuntimeError("fleet is closed")
        self.health.record_success(rid)       # fresh streak
        _LOG.info("fleet: replica %s up", rid)
        self._update_gauges()
        return replica

    def drain(self, replica_id: str) -> None:
        """Stop routing to the replica; its in-flight work finishes and
        :meth:`reap_drained` retires it once idle."""
        with self._lock:
            replica = self._replicas.get(replica_id)
            if replica is None or replica.state != READY:
                return
            replica.state = DRAINING
        _LOG.info("fleet: draining %s", replica_id)
        self._update_gauges()

    def reap_drained(self) -> List[str]:
        """Retire DRAINING replicas whose engines went idle."""
        retired = []
        for replica in self.replicas(state=DRAINING):
            s = replica.engine.stats()
            if s.busy == 0 and s.queue_depth == 0:
                self._retire(replica, cause="drained")
                retired.append(replica.id)
        return retired

    def check_health(self, now: Optional[float] = None) -> List[str]:
        """Mark-and-retire dead replicas; returns their ids. A dead
        replica's engine is closed (failing whatever it still held: the
        gateway's failover fences and resubmits)."""
        dead = []
        for replica in self.replicas() + self.replicas(state=DRAINING):
            reason = self.health.verdict(
                replica.id,
                engine_closed=bool(getattr(replica.engine, "closed", False)),
                now=now)
            if reason is not None:
                dead.append((replica, reason))
        for replica, reason in dead:
            _LOG.warning("fleet: replica %s dead (%s); retiring",
                         replica.id, reason)
            self._retire(replica, cause="failed")
        return [r.id for r, _ in dead]

    def _retire(self, replica: Replica, *, cause: str) -> None:
        with self._lock:
            if self._replicas.pop(replica.id, None) is None:
                return
            replica.state = DEAD
        try:
            # bank the terminal counters BEFORE closing
            s = replica.engine.stats()
            with self._lock:
                bank = self._retired_totals
                bank["requests_finished"] += s.requests_finished
                bank["tokens_generated"] += s.tokens_generated
                for key, attr in _ENGINE_COUNTERS:
                    bank[key] += int(getattr(replica.engine, attr, 0))
                kv = getattr(replica.engine, "kv", None)
                if kv is not None:
                    bank["prefix_hit_tokens"] += kv.hit_tokens
                    bank["prefix_lookup_tokens"] += kv.lookup_tokens
                by_tenant = getattr(replica.engine, "stats_by_tenant",
                                    None)
                if by_tenant is not None:
                    for tenant, row in by_tenant().items():
                        t_bank = self._retired_tenants.setdefault(
                            tenant, {k: 0 for k in _TENANT_COUNTERS})
                        for key in _TENANT_COUNTERS:
                            t_bank[key] += int(row.get(key, 0))
        except Exception:  # noqa: BLE001 — stats from a dying engine
            pass
        try:
            replica.engine.close()
        except Exception:  # noqa: BLE001 — already-dead engines may throw
            pass
        self.health.forget(replica.id)
        _RETIRED.inc(cause=cause)
        self._update_gauges()

    def close(self) -> None:
        with self._lock:
            self._closed = True
            replicas = list(self._replicas.values())
        for replica in replicas:
            self._retire(replica, cause="shutdown")

    # -- views ---------------------------------------------------------------

    def get(self, replica_id: str) -> Optional[Replica]:
        with self._lock:
            return self._replicas.get(replica_id)

    def replicas(self, state: str = READY) -> List[Replica]:
        with self._lock:
            return [r for r in self._replicas.values() if r.state == state]

    def loads(self) -> Dict[str, int]:
        """Routable replicas -> load (queue depth + busy slots). A
        replica behind an OPEN circuit breaker is withheld from routing
        without being retired."""
        out = {}
        for replica in self.replicas():
            s = replica.engine.stats()
            _R_QUEUE.set(float(s.queue_depth), replica=replica.id)
            _R_BUSY.set(float(s.busy), replica=replica.id)
            if not self.health.routable(replica.id):
                continue
            out[replica.id] = s.queue_depth + s.busy
        return out

    def breaker_retry_after_s(self) -> Optional[float]:
        """When every replica is breaker-blocked, the soonest half-open
        among them (the shed hint for a fully tripped fleet)."""
        waits = [self.health.breaker.retry_after_s(r.id)
                 for r in self.replicas()]
        waits = [w for w in waits if w is not None]
        return min(waits) if waits else None

    def aggregate(self) -> dict:
        """Fleet-level sums over READY and DRAINING engines."""
        with self._lock:
            agg = {"replicas": 0, "queue_depth": 0, "busy": 0, "slots": 0,
                   "kv_host_tier_blocks": 0, **self._retired_totals}
        for replica in self.replicas() + self.replicas(state=DRAINING):
            s = replica.engine.stats()
            agg["replicas"] += 1
            agg["queue_depth"] += s.queue_depth
            agg["busy"] += s.busy
            agg["slots"] += s.slots
            agg["requests_finished"] += s.requests_finished
            agg["tokens_generated"] += s.tokens_generated
            for key, attr in _ENGINE_COUNTERS:
                agg[key] += int(getattr(replica.engine, attr, 0))
            kv = getattr(replica.engine, "kv", None)
            if kv is not None:
                agg["prefix_hit_tokens"] += kv.hit_tokens
                agg["prefix_lookup_tokens"] += kv.lookup_tokens
            # live occupancy (dies with the replica, not banked)
            if s.kv_host_tier_blocks is not None:
                agg["kv_host_tier_blocks"] += s.kv_host_tier_blocks
        return agg

    def aggregate_tenants(self) -> Dict[str, Dict[str, int]]:
        """Fleet-level per-tenant sums (terminal counters monotonic via
        the banked totals; queue depth and KV blocks are live sums)."""
        with self._lock:
            out = {t: dict(row) for t, row in self._retired_tenants.items()}
        for replica in self.replicas() + self.replicas(state=DRAINING):
            by_tenant = getattr(replica.engine, "stats_by_tenant", None)
            if by_tenant is None:
                continue
            for tenant, row in by_tenant().items():
                agg = out.setdefault(
                    tenant, {k: 0 for k in _TENANT_COUNTERS})
                for key, value in row.items():
                    agg[key] = agg.get(key, 0) + int(value)
        return out

    def _update_gauges(self) -> None:
        with self._lock:
            counts: Dict[str, int] = {}
            for replica in self._replicas.values():
                counts[replica.state] = counts.get(replica.state, 0) + 1
        for state in (READY, DRAINING):
            _REPLICAS.set(float(counts.get(state, 0)), state=state)
