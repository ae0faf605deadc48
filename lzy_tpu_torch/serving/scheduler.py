"""Request admission: a weighted fair queue over per-tenant subqueues.

The port's copy of ``lzy_tpu/serving/scheduler.py``, trimmed to what the
engines use. Every request carries a tenant and a priority tier; each
tenant owns a FIFO subqueue, and the engine admits the head with the
smallest virtual finish tag (start-time fair queuing). Cost is measured
in tokens (prompt + requested continuation) over the tenant's weight,
so tenants split a replica's token throughput by weight, and a starved
tenant's head always ages to the front (its start tag clamps to the
global virtual time). With one tenant the order is plain FIFO.

Backpressure: a global bound (``max_depth``) and a per-tenant bound
(``TenantPolicy.max_queued``), each refusing with a ``retry_after_s``
hint sized to the recent drain rate.
"""

from __future__ import annotations

import itertools
import threading
from collections import deque
from typing import Any, Dict, List, Optional, Sequence

from lzy_tpu_torch.chaos.faults import CHAOS
from lzy_tpu_torch.utils.clock import SYSTEM_CLOCK
from lzy_tpu_torch.utils.metrics import REGISTRY

_QUEUE_DEPTH = REGISTRY.gauge(
    "lzy_inference_queue_depth", "requests admitted but not yet prefilled")
_TENANT_QUEUE = REGISTRY.gauge(
    "lzy_tenant_queue_depth",
    "requests admitted but not yet prefilled, by tenant")
_REJECTED = REGISTRY.counter(
    "lzy_inference_rejected_total", "requests refused at admission")
SHED_REQUESTS = REGISTRY.counter(
    "lzy_shed_requests_total",
    "requests shed with a retry-after hint instead of queued, by reason")
TENANT_SHED = REGISTRY.counter(
    "lzy_tenant_shed_total",
    "requests shed at a tenant-scoped limit, by tenant and reason")

DEFAULT_TENANT = "default"

#: priority tier -> WFQ weight (0 interactive, 1 standard, 2 batch)
TIER_WEIGHTS = {0: 4.0, 1: 2.0, 2: 1.0}
DEFAULT_PRIORITY = 1


def tier_weight(priority: Optional[int]) -> float:
    """WFQ weight for a priority tier (out-of-range tiers clamp)."""
    if priority is None:
        priority = DEFAULT_PRIORITY
    return TIER_WEIGHTS[min(max(int(priority), 0), max(TIER_WEIGHTS))]


class AdmissionError(RuntimeError):
    """The request queue is full or the engine is shut down; retry later.
    ``retry_after_s`` is the back-off hint."""

    def __init__(self, msg: str, retry_after_s: Optional[float] = None):
        super().__init__(msg)
        self.retry_after_s = retry_after_s


class PromptTooLong(AdmissionError, ValueError):
    """The prompt can never be served (prompt + max_new_tokens exceeds
    ``max_seq_len``, or the prompt alone exceeds the pool or a quota): a
    permanent rejection raised at admission."""


class QuotaExceeded(AdmissionError):
    """A tenant-scoped limit refused the request (rate limit, queue cap
    or KV-block quota); ``retry_after_s`` follows that tenant's own
    refill/drain schedule."""

    def __init__(self, msg: str, retry_after_s: Optional[float] = None,
                 tenant: Optional[str] = None, reason: Optional[str] = None):
        super().__init__(msg, retry_after_s)
        self.tenant = tenant
        self.reason = reason


def shed_error(exc_type, msg: str, *, reason: str,
               retry_after_s: Optional[float] = None):
    """Build (and count) a load-shedding rejection: the retry-after hint
    rides both the exception attribute and the message suffix."""
    SHED_REQUESTS.inc(reason=reason)
    if retry_after_s is not None:
        msg = f"{msg} (retry_after_s={retry_after_s:.2f})"
    err = exc_type(msg)
    err.retry_after_s = retry_after_s
    return err


def quota_error(msg: str, *, tenant: str, reason: str,
                retry_after_s: Optional[float] = None,
                counted: bool = True) -> QuotaExceeded:
    """Build (and, unless ``counted=False``, count) a tenant-scoped
    refusal with the retry hint on the attribute and in the message."""
    if counted:
        SHED_REQUESTS.inc(reason=reason)
        TENANT_SHED.inc(tenant=tenant, reason=reason)
    if retry_after_s is not None:
        msg = f"{msg} (retry_after_s={retry_after_s:.2f})"
    return QuotaExceeded(msg, retry_after_s=retry_after_s,
                         tenant=tenant, reason=reason)


_ids = itertools.count(1)


class Request:
    """One generation request riding through the engine.

    ``tokens`` accumulates generated ids (no prompt echo); ``result()``
    blocks until the engine finishes the request. ``deadline_s`` (relative
    to submission) lets the engine evict the request mid-decode with the
    ``cancelled`` status. ``greedy`` overrides the engine-wide sampling
    mode for this row. ``tenant``/``priority`` are the SLO identity."""

    def __init__(self, prompt: Sequence[int], max_new_tokens: int,
                 request_id: Optional[str] = None,
                 deadline_s: Optional[float] = None,
                 greedy: Optional[bool] = None,
                 tenant: str = DEFAULT_TENANT,
                 priority: Optional[int] = None, clock=None):
        self.id = request_id or f"req-{next(_ids)}"
        self.prompt: List[int] = [int(t) for t in prompt]
        self.max_new_tokens = int(max_new_tokens)
        self.greedy = greedy
        self.tenant = str(tenant) if tenant else DEFAULT_TENANT
        self.priority = None if priority is None else int(priority)
        self.tokens: List[int] = []
        self.error: Optional[str] = None
        self.status: Optional[str] = None     # "ok" | "cancelled" | "error"
        self.cancelled = False
        self._clock = clock if clock is not None else SYSTEM_CLOCK
        self.submitted_at = self._clock.now()
        self.deadline: Optional[float] = (
            self.submitted_at + float(deadline_s)
            if deadline_s is not None else None)
        self.first_token_at: Optional[float] = None
        self.finished_at: Optional[float] = None
        #: token streaming (``channels/token_stream.attach_request``): the
        #: engine calls ``token_sink(request)`` after each emitted token,
        #: guarded, so a consumer bug never kills the decode loop
        self.token_sink = None
        self._done = self._clock.event()
        # WFQ bookkeeping (owned by RequestQueue)
        self._vstart = 0.0
        self._vfinish = 0.0
        self._qseq = 0
        self._queued = False

    def cancel(self) -> None:
        """Best-effort abandon; the engine reaps it at its next round."""
        self.cancelled = True

    @property
    def expired(self) -> bool:
        return self.deadline is not None and self._clock.now() > self.deadline

    @property
    def reapable(self) -> bool:
        return self.cancelled or self.expired

    def finish(self, error: Optional[str] = None,
               status: Optional[str] = None) -> None:
        self.error = error
        self.status = status or ("ok" if error is None else "error")
        self.finished_at = self._clock.now()
        self._done.set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._clock.wait(self._done, timeout)

    @property
    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: Optional[float] = None) -> List[int]:
        """Generated token ids; raises on engine error or timeout."""
        if not self._clock.wait(self._done, timeout):
            raise TimeoutError(
                f"request {self.id} not finished within {timeout}s")
        if self.error:
            raise RuntimeError(f"request {self.id} failed: {self.error}")
        return list(self.tokens)


#: the admission boundary: error mode refuses with the same retryable
#: AdmissionError a full queue produces
_FP_ADMIT = CHAOS.register(
    "engine.admit", error=AdmissionError,
    doc="request admission into the engine queue")


class RequestQueue:
    """Bounded weighted-fair queue; thread-safe; wakes the engine loop
    on submit. ``policies`` (a ``TenantTable``) supplies per-tenant
    weights and queue caps."""

    def __init__(self, max_depth: int = 64, policies=None, clock=None):
        self.max_depth = max_depth
        self.policies = policies
        self._clock = clock if clock is not None else SYSTEM_CLOCK
        self._subq: Dict[str, deque] = {}
        self._finish_tag: Dict[str, float] = {}
        self._vtime = 0.0
        self._seq = 0
        self._depth = 0
        #: bumped by every membership change; the engine's overlap-window
        #: admission plan commits only if the version is untouched
        self.version = 0
        self._lock = threading.Lock()
        self._last_pop: Optional[float] = None
        self._pop_interval_s = 0.05
        self.work_available = self._clock.event()

    def _retry_after_locked(self) -> float:
        est = self._pop_interval_s * max(1.0, self._depth / 2.0)
        return min(10.0, max(0.05, est))

    def _tenant_retry_locked(self, tenant: str) -> float:
        backlog = len(self._subq.get(tenant, ()))
        est = self._pop_interval_s * max(1.0, float(backlog))
        return min(10.0, max(0.05, est))

    def submit(self, request: Request) -> Request:
        CHAOS.hit("engine.admit")
        tenant = request.tenant
        policy = (self.policies.resolve(tenant)
                  if self.policies is not None else None)
        with self._lock:
            if self._depth >= self.max_depth:
                _REJECTED.inc()
                raise AdmissionError(
                    f"inference queue full ({self.max_depth} waiting); "
                    f"retry later",
                    retry_after_s=self._retry_after_locked())
            cap = getattr(policy, "max_queued", None)
            sub = self._subq.get(tenant)
            if cap is not None and sub is not None and len(sub) >= cap:
                _REJECTED.inc()
                raise quota_error(
                    f"tenant {tenant!r} already has {len(sub)} request(s) "
                    f"queued (cap {cap}); retry later",
                    tenant=tenant, reason="max_queued",
                    retry_after_s=self._tenant_retry_locked(tenant),
                    counted=False)
            weight = (policy.effective_weight(request.priority)
                      if policy is not None
                      else tier_weight(request.priority))
            start = max(self._vtime, self._finish_tag.get(tenant, 0.0))
            cost = (len(request.prompt) + request.max_new_tokens) \
                / max(weight, 1e-9)
            request._vstart = start
            request._vfinish = self._finish_tag[tenant] = start + cost
            self._seq += 1
            request._qseq = self._seq
            request._queued = True
            self._subq.setdefault(tenant, deque()).append(request)
            self._depth += 1
            self.version += 1
            _QUEUE_DEPTH.set(float(self._depth))
            _TENANT_QUEUE.set(float(len(self._subq[tenant])), tenant=tenant)
        self.work_available.set()
        return request

    def _remove_locked(self, req: Request) -> None:
        q = self._subq.get(req.tenant)
        if q is None or not req._queued:
            return
        if q and q[0] is req:
            q.popleft()
        else:
            try:
                q.remove(req)
            except ValueError:
                return
        req._queued = False
        self._depth -= 1
        self.version += 1
        _TENANT_QUEUE.set(float(len(q)), tenant=req.tenant)
        if not q:
            del self._subq[req.tenant]
            if self._finish_tag.get(req.tenant, 0.0) <= self._vtime:
                self._finish_tag.pop(req.tenant, None)
        _QUEUE_DEPTH.set(float(self._depth))

    def _note_pop_locked(self, req: Request) -> None:
        self._vtime = max(self._vtime, req._vstart)
        stale = [t for t, tag in self._finish_tag.items()
                 if tag <= self._vtime and t not in self._subq]
        for t in stale:
            del self._finish_tag[t]
        now = self._clock.now()
        if self._last_pop is not None:
            dt = now - self._last_pop
            self._pop_interval_s += 0.2 * (dt - self._pop_interval_s)
        # a pop that empties the queue ends the busy window
        self._last_pop = now if self._depth else None

    def pop_request(self, req: Request) -> bool:
        """Remove a specific queued request (the engine admits by
        candidate); False if it was no longer queued."""
        with self._lock:
            if not req._queued:
                return False
            self._remove_locked(req)
            self._note_pop_locked(req)
            return True

    def candidates(self) -> List[Request]:
        """Per-tenant head requests in WFQ dispatch order."""
        with self._lock:
            heads = [q[0] for q in self._subq.values()]
        return sorted(heads, key=lambda r: (r._vfinish, r._qseq))

    def reap_dead(self) -> List[Request]:
        """Remove every cancelled or expired queued request."""
        dead: List[Request] = []
        with self._lock:
            for q in list(self._subq.values()):
                dead.extend(r for r in q if r.reapable)
            for r in dead:
                self._remove_locked(r)
        return dead

    def depth(self) -> int:
        with self._lock:
            return self._depth

    def depth_of(self, tenant: str) -> int:
        with self._lock:
            return len(self._subq.get(tenant, ()))

    def tenants(self) -> List[str]:
        with self._lock:
            return sorted(self._subq)

    def drain(self) -> List[Request]:
        """Empty the queue (shutdown path); returns the unserved requests."""
        with self._lock:
            out: List[Request] = []
            for tenant, q in self._subq.items():
                out.extend(q)
                _TENANT_QUEUE.set(0.0, tenant=tenant)
            for r in out:
                r._queued = False
            self._subq.clear()
            self._depth = 0
            self.version += 1
            _QUEUE_DEPTH.set(0.0)
        return out


def any_to_tokens(prompt: Any) -> List[int]:
    """Normalize a caller's prompt (a list of ints) defensively."""
    if not isinstance(prompt, (list, tuple)) or not prompt:
        raise ValueError("prompt must be a non-empty list of token ids")
    return [int(t) for t in prompt]
