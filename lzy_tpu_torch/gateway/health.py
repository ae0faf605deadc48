"""Replica health: heartbeat staleness, failure accrual, circuit breaking.

The port's copy of ``lzy_tpu/gateway/health.py``.

Three independent signals, one verdict + one routing gate:

- **heartbeat staleness** comes from the allocator's VM records — the
  replica's leased gang already heartbeats through the platform's
  AllocatorPrivate machinery (``service/allocator.py``), so the gateway
  reads ``Vm.heartbeat_ts`` instead of running a second prober;
- **consecutive request failures** come from the gateway's own traffic:
  a replica whose engine keeps failing requests (or whose engine loop
  died) is unhealthy even while its host still heartbeats. A success
  resets the failure streak — transient hiccups under load must not
  accumulate into an eviction; only an uninterrupted streak does.
- **windowed failure density** feeds the :class:`CircuitBreaker`: a
  FLAPPING replica (fail, succeed, fail, ...) never builds the streak
  the verdict retires on, yet every request routed to it gambles a
  failover. Once its failures within ``window_s`` cross
  ``failure_threshold`` the breaker OPENs — the fleet stops routing to
  it for ``open_s`` without retiring it (the lease is kept; the replica
  may just be rebooting its model) — then HALF_OPENs to let one probe
  request through: success closes the breaker, failure re-opens it.
"""

from __future__ import annotations

import dataclasses
import threading
from collections import deque
from typing import Dict, Optional

from lzy_tpu_torch.chaos.faults import CHAOS, DELAY, SLOW
from lzy_tpu_torch.utils.clock import SYSTEM_CLOCK
from lzy_tpu_torch.utils.metrics import REGISTRY

_TRANSITIONS = REGISTRY.counter(
    "lzy_breaker_transitions_total",
    "circuit breaker state transitions, by target state")
_OPEN = REGISTRY.gauge(
    "lzy_breaker_open_replicas",
    "replicas currently unroutable behind an open breaker")

# chaos boundary: health evaluation can only be slowed, never errored —
# its callers (the gateway tick) have no degradation path for a raising
# verdict beyond "the tick must not die"
_FP_HEALTH = CHAOS.register(
    "gateway.health", modes=(DELAY, SLOW),
    doc="one replica health verdict (slow-health-check simulation)")

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"


@dataclasses.dataclass(frozen=True)
class HealthPolicy:
    #: heartbeat older than this marks the replica's host dead (matches
    #: the allocator GC's own judgement window by default)
    heartbeat_timeout_s: float = 30.0
    #: uninterrupted request-failure streak that marks the replica dead
    max_consecutive_failures: int = 3


@dataclasses.dataclass(frozen=True)
class BreakerPolicy:
    #: failures within ``window_s`` that trip the breaker (success does
    #: NOT reset this — that is the point: it catches flapping)
    failure_threshold: int = 5
    window_s: float = 30.0
    #: how long an OPEN breaker blocks routing before the half-open probe
    open_s: float = 10.0


class CircuitBreaker:
    """Per-replica breaker states; time is injected for determinism.

    Known conservatism: outcomes are not attributed to individual
    dispatches, so a pre-trip straggler request failing while the
    breaker is HALF_OPEN is indistinguishable from the probe failing
    and re-opens the breaker (the true probe's later success then
    no-ops). The replica stays safe — never routed while suspect — at
    the cost of up to one extra ``open_s`` of recovery latency per late
    straggler; attributing outcomes would need probe tokens threaded
    through every completion path."""

    def __init__(self, policy: Optional[BreakerPolicy] = None,
                 clock=None):
        self._clock = clock if clock is not None else SYSTEM_CLOCK
        self.policy = policy or BreakerPolicy()
        self._failures: Dict[str, deque] = {}
        self._state: Dict[str, str] = {}
        self._opened_at: Dict[str, float] = {}
        #: HALF_OPEN probe claim times: only ONE request gets through a
        #: half-open breaker; a claim older than open_s is presumed lost
        #: (routed but never completed) and the next caller may re-probe
        self._probe_at: Dict[str, float] = {}
        self._lock = threading.Lock()
        self.transitions = 0

    def _set_state(self, replica_id: str, state: str) -> None:
        prev = self._state.get(replica_id, CLOSED)
        if prev == state:
            return
        self._state[replica_id] = state
        self.transitions += 1
        _TRANSITIONS.inc(to=state)
        # delta, not a recompute from THIS instance's _state: several
        # breakers share one process gauge (a disagg gateway runs one
        # per pool), and a recompute would erase the other pool's count
        if state == OPEN:
            _OPEN.add(1.0)
        elif prev == OPEN:
            _OPEN.add(-1.0)

    def record_failure(self, replica_id: str,
                       now: Optional[float] = None) -> str:
        now = now if now is not None else self._clock.now()
        with self._lock:
            state = self._state.get(replica_id, CLOSED)
            if state == HALF_OPEN:
                # the probe failed: straight back to OPEN, fresh window
                self._opened_at[replica_id] = now
                self._probe_at.pop(replica_id, None)
                self._set_state(replica_id, OPEN)
                return OPEN
            if state == OPEN:
                # stragglers routed before the trip: already accounted
                # for by the open breaker — banking them in the window
                # would hand the eventual CLOSED state a hair trigger
                return OPEN
            window = self._failures.setdefault(replica_id, deque())
            window.append(now)
            horizon = now - self.policy.window_s
            while window and window[0] < horizon:
                window.popleft()
            if state == CLOSED and \
                    len(window) >= self.policy.failure_threshold:
                self._opened_at[replica_id] = now
                self._set_state(replica_id, OPEN)
                window.clear()
            return self._state.get(replica_id, CLOSED)

    def record_success(self, replica_id: str) -> None:
        with self._lock:
            if self._state.get(replica_id) == HALF_OPEN:
                self._opened_at.pop(replica_id, None)
                self._probe_at.pop(replica_id, None)
                # a recovered replica starts with a CLEAN window: stale
                # pre-open failures must not re-trip it on one hiccup
                self._failures.pop(replica_id, None)
                self._set_state(replica_id, CLOSED)

    def state(self, replica_id: str, now: Optional[float] = None) -> str:
        now = now if now is not None else self._clock.now()
        with self._lock:
            state = self._state.get(replica_id, CLOSED)
            if state == OPEN and \
                    now - self._opened_at[replica_id] >= self.policy.open_s:
                self._set_state(replica_id, HALF_OPEN)
                state = HALF_OPEN
            return state

    def routable(self, replica_id: str,
                 now: Optional[float] = None) -> bool:
        """Side-effect-free listing gate: False while OPEN, or while
        HALF_OPEN with the probe already claimed by an in-flight
        request. Candidate ENUMERATION must not consume the probe —
        a loads() pass that ends up routing elsewhere would otherwise
        burn the claim and starve a recovered replica of traffic for
        another ``open_s``; the claim is taken by :meth:`try_route` at
        actual dispatch."""
        now = now if now is not None else self._clock.now()
        st = self.state(replica_id, now)
        if st != HALF_OPEN:
            return st != OPEN
        with self._lock:
            claimed = self._probe_at.get(replica_id)
            return claimed is None or now - claimed >= self.policy.open_s

    def try_route(self, replica_id: str,
                  now: Optional[float] = None) -> bool:
        """Dispatch-time gate: True unless OPEN, or HALF_OPEN with a
        live probe claim. In HALF_OPEN this CLAIMS the single probe —
        exactly one request rides a half-open breaker until its
        completion reports back; a claim older than ``open_s`` is
        presumed lost (routed but never completed) and the next caller
        re-probes."""
        now = now if now is not None else self._clock.now()
        st = self.state(replica_id, now)
        if st != HALF_OPEN:
            return st != OPEN
        with self._lock:
            if self._state.get(replica_id) != HALF_OPEN:
                return self._state.get(replica_id, CLOSED) != OPEN
            claimed = self._probe_at.get(replica_id)
            if claimed is not None and \
                    now - claimed < self.policy.open_s:
                return False
            self._probe_at[replica_id] = now
            return True

    def release_probe(self, replica_id: str) -> None:
        """Undo a :meth:`try_route` claim whose request was never
        actually dispatched (admission refused after the claim): without
        the release, every failed dispatch would block the recovered
        replica for another ``open_s`` with no probe in flight. No-op
        when no claim is held."""
        with self._lock:
            self._probe_at.pop(replica_id, None)

    def retry_after_s(self, replica_id: str,
                      now: Optional[float] = None) -> Optional[float]:
        """Seconds until this replica's breaker half-opens (None when
        already routable) — the shedding hint when the WHOLE fleet is
        behind open breakers."""
        now = now if now is not None else self._clock.now()
        with self._lock:
            if self._state.get(replica_id) != OPEN:
                return None
            return max(0.0, self.policy.open_s
                       - (now - self._opened_at[replica_id]))

    def forget(self, replica_id: str) -> None:
        with self._lock:
            self._failures.pop(replica_id, None)
            self._opened_at.pop(replica_id, None)
            self._probe_at.pop(replica_id, None)
            if self._state.pop(replica_id, None) == OPEN:
                _OPEN.add(-1.0)


class HealthTracker:
    """Per-replica failure accrual; the fleet consults :meth:`verdict`
    for retirement and :meth:`routable` (the breaker) for routing."""

    def __init__(self, policy: Optional[HealthPolicy] = None,
                 breaker: Optional[BreakerPolicy] = None, clock=None):
        self._clock = clock if clock is not None else SYSTEM_CLOCK
        self.policy = policy or HealthPolicy()
        self.breaker = CircuitBreaker(breaker, clock=self._clock)
        self._failures: Dict[str, int] = {}
        self._lock = threading.Lock()

    def record_success(self, replica_id: str) -> None:
        with self._lock:
            self._failures[replica_id] = 0
        self.breaker.record_success(replica_id)

    def record_failure(self, replica_id: str) -> int:
        self.breaker.record_failure(replica_id)
        with self._lock:
            self._failures[replica_id] = self._failures.get(replica_id, 0) + 1
            return self._failures[replica_id]

    def failures(self, replica_id: str) -> int:
        with self._lock:
            return self._failures.get(replica_id, 0)

    def routable(self, replica_id: str,
                 now: Optional[float] = None) -> bool:
        return self.breaker.routable(replica_id, now)

    def try_route(self, replica_id: str,
                  now: Optional[float] = None) -> bool:
        return self.breaker.try_route(replica_id, now)

    def release_probe(self, replica_id: str) -> None:
        self.breaker.release_probe(replica_id)

    def forget(self, replica_id: str) -> None:
        with self._lock:
            self._failures.pop(replica_id, None)
        self.breaker.forget(replica_id)

    def verdict(self, replica_id: str, *,
                heartbeat_ts: Optional[float] = None,
                engine_closed: bool = False,
                now: Optional[float] = None) -> Optional[str]:
        """None when healthy, else a human-readable reason the replica is
        dead. ``heartbeat_ts`` is the leased VM's last heartbeat (None
        when the replica runs unleased — then only the other signals
        apply)."""
        CHAOS.hit("gateway.health")
        if engine_closed:
            return "engine loop died"
        with self._lock:
            streak = self._failures.get(replica_id, 0)
        if streak >= self.policy.max_consecutive_failures:
            return f"{streak} consecutive request failures"
        if heartbeat_ts is not None:
            now = now if now is not None else self._clock.time()
            if now - heartbeat_ts > self.policy.heartbeat_timeout_s:
                return (f"heartbeat stale by "
                        f"{now - heartbeat_ts:.0f}s")
        return None
