"""The gateway front: one ``generate`` endpoint over a fleet of engines.

The port's copy of ``lzy_tpu/gateway/service.py`` (``journal=None``; the
IAM scoping and crash-recovery journal of the reference wait for the RPC
slice). What it adds over one engine:

- **cache-aware dispatch**: each request is routed by the
  ``PrefixAffinityRouter`` (longest expected cached prefix, bounded load
  imbalance), and the router's expectation is updated on submit;
- **failover with fenced tokens**: a request that dies mid-stream on one
  replica (engine loop death, preemption, replica shutdown) is
  resubmitted to another as ``prompt + emitted``, and the reply is
  ``emitted + continuation``; request-scoped failures are not retried;
- **token streams** (``generate(stream=)``): the channel is attached at
  the fence on every attempt, so a failover resumes it byte-identically;
- **the fleet-global KV index** (``kv_index``): a routed replica about
  to miss a prefix a sibling holds, in its pool or its host tier, gets
  the sibling's blocks exported, moved over the transport and queued
  for import before the request is submitted;
- **parked conversations** (``park_conversation``): a workflow step's KV
  pinned on its replica across a tool gap, the next step hard-pinned
  there;
- **health and autoscaling tick**: a background loop (or ``tick()`` under
  test) retires dead replicas, reaps drained ones and applies the
  autoscaler's decisions.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple

from lzy_tpu_torch.chaos.faults import CHAOS
from lzy_tpu_torch.gateway.autoscale import DOWN, UP, Autoscaler
from lzy_tpu_torch.gateway.fleet import ReplicaFleet
from lzy_tpu_torch.gateway.kv_index import (
    IMPORT_BYTES, IMPORT_FALLBACKS, IMPORT_SECONDS, IMPORTS, chains_of)
from lzy_tpu_torch.gateway.router import PrefixAffinityRouter
from lzy_tpu_torch.rpc.core import Unavailable
from lzy_tpu_torch.serving.scheduler import (
    AdmissionError, DEFAULT_TENANT, PromptTooLong, QuotaExceeded,
    any_to_tokens, quota_error, shed_error)
from lzy_tpu_torch.utils.clock import SYSTEM_CLOCK
from lzy_tpu_torch.utils.log import get_logger
from lzy_tpu_torch.utils.metrics import REGISTRY

_LOG = get_logger(__name__)

#: reserved tenant speculative next-step prefills ride (uncharged)
SPECULATION_TENANT = "__wfsched__"

_FAILOVERS = REGISTRY.counter(
    "lzy_gateway_failovers_total",
    "requests resubmitted to another replica after a mid-stream failure")
_SCALE = REGISTRY.counter(
    "lzy_gateway_scale_events_total", "autoscale decisions by direction")
_REQUESTS = REGISTRY.counter(
    "lzy_gateway_requests_total", "gateway requests by outcome")

# chaos boundary: error mode refuses one candidate replica exactly like
# an AdmissionError from its engine; the routing loop tries the next one
_FP_DISPATCH = CHAOS.register(
    "gateway.dispatch", error=AdmissionError,
    doc="routed submit to one replica (degrades to the next candidate)")

#: engine-side failure prefixes that mean the REPLICA failed, not the
#: request: resubmitted elsewhere with the emitted tokens fenced
_FAILOVER_ERRORS = ("engine loop died", "preempted", "engine shutting down")
#: failover-eligible errors that are CAPACITY signals, not faults: they
#: do not accrue toward the replica's health verdict
_CAPACITY_ERRORS = ("preempted",)


class GatewayService:
    def __init__(
        self,
        fleet: ReplicaFleet,
        *,
        router=None,
        autoscaler: Optional[Autoscaler] = None,
        model_name: str = "custom",
        page_size: int = 16,
        max_waiters: int = 16,
        max_failovers: int = 3,
        tick_period_s: float = 1.0,
        slo=None,
        kv_index=None,
        kv_transport=None,
        clock=None,
        wf_park_ttl_s: float = 30.0,
    ):
        self._clock = clock if clock is not None else SYSTEM_CLOCK
        self.fleet = fleet
        self.router = router if router is not None else PrefixAffinityRouter(
            page_size)
        #: fleet-global tiered-KV prefix index (None = off): replicas
        #: advertise the prefixes they hold, by tier, and a routed replica
        #: that would miss a sibling's prefix imports it
        self.kv_index = kv_index
        if kv_index is not None and kv_transport is None:
            from lzy_tpu_torch.channels.kv_transfer import InMemoryKVTransport

            kv_transport = InMemoryKVTransport()
        self.kv_transport = kv_transport
        self._kvtier_tls = threading.local()
        self._kvtier_lock = threading.Lock()
        self._kvtier_imports = 0
        self._kvtier_import_bytes = 0
        self._kvtier_fallbacks = 0
        self._kvtier_seq = 0
        # last advertisement object per replica (tick loop only): the
        # engine memoizes by cache version, so identity means unchanged
        self._kvtier_last_adv: dict = {}
        self.autoscaler = autoscaler
        self.model_name = model_name
        #: tenant rate limits charged once per client request at the
        #: fleet front (``serving.tenancy.SloLimiter``); None = unlimited
        self.slo = slo
        self._max_failovers = max_failovers
        self._tick_period_s = tick_period_s
        self._waiters = threading.BoundedSemaphore(max_waiters)
        self._failovers = 0
        self._finished = 0
        self._shed = 0
        self._inflight = 0
        self._scale_ups = 0
        self._scale_downs = 0
        self._draining = False
        self._stop = self._clock.event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        #: workflow-aware scheduling: live fusion leases, session ->
        #: (replica_id, expires_at); the replica holds the conversation's
        #: KV parked, so the next step hard-pins there (reason "fused")
        self._wf_park_ttl = float(wf_park_ttl_s)
        self._wf_parked: Dict[str, Tuple[str, float]] = {}
        self._wf_lock = threading.Lock()

    # -- request surface -----------------------------------------------------

    def _slo_admit(self, tenant: str, prompt: List[int]):
        """Charge the tenant's rate buckets; QuotaExceeded propagates
        (counted as a shed: no replica was tried)."""
        if self.slo is None:
            return None
        try:
            return self.slo.admit(tenant, len(prompt))
        except QuotaExceeded:
            with self._lock:
                self._shed += 1
            raise

    def _max_seq_len(self) -> Optional[int]:
        for state in ("READY", "DRAINING"):
            for replica in self.fleet.replicas(state=state):
                cfg = getattr(replica.engine, "cfg", None)
                if cfg is not None:
                    return int(cfg.max_seq_len)
        return None

    def _check_prompt_len(self, prompt: List[int],
                          max_new_tokens: int) -> None:
        """Reject prompts no replica can ever serve before routing."""
        msl = self._max_seq_len()
        if msl is not None and len(prompt) + max_new_tokens > msl:
            raise PromptTooLong(
                f"prompt ({len(prompt)} tokens) + max_new_tokens "
                f"({max_new_tokens}) exceeds max_seq_len ({msl}); the "
                f"prompt can never be served")

    def generate(self, prompt, *, max_new_tokens: int = 64,
                 timeout_s: Optional[float] = None,
                 deadline_s: Optional[float] = None,
                 greedy: Optional[bool] = None,
                 tenant: Optional[str] = None,
                 priority: Optional[int] = None,
                 session: Optional[str] = None,
                 stream=None) -> dict:
        """Blocking generate over the fleet: the engine's contract plus
        route metadata (``replica``, ``routed_by``, ``failovers``) in
        the reply. Only when EVERY routable replica refuses admission
        does the caller see ``Unavailable``. ``greedy`` is carried across
        failover resubmissions; ``session`` pins a conversation to the
        replica holding its earlier steps (within the imbalance bound).

        ``stream`` (a ``channels.token_stream.TokenStreamChannel``)
        receives tokens as the engine emits them. Its position is the
        failover fence, so a mid-stream replica death resumes the channel
        byte-identically (``resumptions`` ticks). The channel is closed
        with the terminal status before this returns, or failed before it
        raises IF any token was published; an exception that never
        touched it leaves it open for the caller's retry policy."""
        try:
            if self.kv_index is not None:
                self._kvtier_tls.meta = {}   # fresh per call
            tenant = tenant or DEFAULT_TENANT
            prompt = any_to_tokens(prompt)
            self._check_prompt_len(prompt, int(max_new_tokens))
            policy = self._slo_admit(tenant, prompt)
            if policy is not None:
                priority = policy.effective_priority(priority)
            if self._draining:
                raise self._shed_error(
                    Unavailable,
                    "gateway is draining; retry another endpoint",
                    reason="draining", retry_after_s=None)
            if not self._waiters.acquire(blocking=False):
                raise self._shed_error(
                    Unavailable,
                    "all gateway waiter threads are busy; retry later",
                    reason="waiters_busy", retry_after_s=0.25)
            with self._lock:
                self._inflight += 1
            try:
                return self._generate(prompt, int(max_new_tokens),
                                      timeout_s=timeout_s or 120.0,
                                      deadline_s=deadline_s, greedy=greedy,
                                      tenant=tenant, priority=priority,
                                      session=session, stream=stream)
            finally:
                with self._lock:
                    self._inflight -= 1
                self._waiters.release()
        except BaseException as e:
            from lzy_tpu_torch.channels.token_stream import fail_if_touched

            fail_if_touched(stream, e)
            raise

    def _shed_error(self, exc_type, msg: str, *, reason: str,
                    retry_after_s: Optional[float]):
        with self._lock:
            self._shed += 1
        return shed_error(exc_type, msg, reason=reason,
                          retry_after_s=retry_after_s)

    def _finish_early(self, emitted, route, failovers, first_ttft_ms,
                      status: str, stream=None) -> dict:
        """A reply built without a terminal engine request: the deadline
        ran out between attempts (``cancelled``), or a failover landed
        exactly on the token budget (``ok``)."""
        if stream is not None:
            stream.close(status)
        _REQUESTS.inc(status=status)
        with self._lock:
            self._finished += 1
        return {"request_id": None, "tokens": emitted, "status": status,
                "ttft_ms": first_ttft_ms, "model": self.model_name,
                "replica": route[0] if route else None,
                "routed_by": route[1] if route else None,
                "failovers": failovers, **self._reply_extras()}

    def _generate(self, prompt: List[int], max_new_tokens: int, *,
                  timeout_s: float, deadline_s: Optional[float],
                  greedy: Optional[bool] = None,
                  tenant: str = DEFAULT_TENANT,
                  priority: Optional[int] = None,
                  session: Optional[str] = None,
                  stream=None) -> dict:
        t0 = self._clock.now()
        wall_deadline = t0 + timeout_s
        emitted: List[int] = []          # fenced: already emitted tokens
        failovers = 0
        tried_after_failure: set = set()
        route = None                     # (replica, reason) that SERVED it
        first_ttft_ms = None
        while True:
            remaining = max_new_tokens - len(emitted)
            if remaining <= 0:
                break
            deadline_left = self._remaining_deadline(t0, deadline_s)
            if deadline_left is not None and deadline_left <= 0:
                return self._finish_early(emitted, route, failovers,
                                          first_ttft_ms, "cancelled", stream)
            replica, routed_by, req = self._submit_routed(
                prompt + emitted, remaining, t0=t0, deadline_s=deadline_s,
                exclude=tried_after_failure, greedy=greedy, tenant=tenant,
                priority=priority, session=session)
            route = (replica.id, routed_by)
            if stream is not None:
                # this attempt's tokens land at len(emitted) + i: a resumed
                # attempt continues the channel where the dead one stopped
                from lzy_tpu_torch.channels.token_stream import attach_request

                attach_request(stream, req, len(emitted))
            if not req.wait(timeout=max(0.0,
                                        wall_deadline - self._clock.now())):
                req.cancel()
                self.fleet.health.release_probe(replica.id)
                raise TimeoutError(
                    f"request {req.id} not finished within {timeout_s}s")
            if first_ttft_ms is None and req.first_token_at is not None:
                first_ttft_ms = round(1000 * (req.first_token_at - t0), 3)
            if req.error and req.status != "cancelled":
                if not req.error.startswith(_FAILOVER_ERRORS):
                    # request-scoped: identical on every replica
                    self.fleet.health.release_probe(replica.id)
                    _REQUESTS.inc(status="error")
                    raise RuntimeError(
                        f"request {req.id} failed: {req.error}")
                # replica-scoped: fence what it emitted, resubmit elsewhere
                emitted.extend(req.tokens)
                if stream is not None:
                    stream.note_resumption()
                if not req.error.startswith(_CAPACITY_ERRORS):
                    self.fleet.health.record_failure(replica.id)
                    self.router.forget(replica.id)
                    self._drop_leases_on(replica.id)
                    self.fleet.check_health()
                    tried_after_failure.add(replica.id)
                else:
                    # a capacity preemption proves the replica works
                    self.fleet.health.release_probe(replica.id)
                failovers += 1
                self._note_failover()
                if failovers > self._max_failovers:
                    _REQUESTS.inc(status="error")
                    raise Unavailable(
                        f"request failed over {failovers} times; last "
                        f"error: {req.error}")
                _LOG.warning(
                    "gateway: failover %d for request (replica %s: %s); "
                    "%d tokens fenced", failovers, replica.id, req.error,
                    len(emitted))
                continue
            # terminal: ok or cancelled-with-partials
            self.fleet.health.record_success(replica.id)
            emitted.extend(req.tokens)
            status = req.status or "ok"
            self._note_result(req)
            if session is not None:
                # the conversation tail predicts the next step's locality
                self.router.observe(replica.id, prompt + emitted,
                                    session=session)
            if stream is not None:
                stream.close(status)
            with self._lock:
                self._finished += 1
            _REQUESTS.inc(status=status)
            return {
                "request_id": req.id,
                "tokens": emitted,
                "status": status,
                "ttft_ms": first_ttft_ms,
                "model": self.model_name,
                "replica": route[0],
                "routed_by": route[1],
                "failovers": failovers,
                **self._reply_extras(),
            }
        return self._finish_early(emitted, route, failovers, first_ttft_ms,
                                  "ok", stream)

    def _remaining_deadline(self, t0: float,
                            deadline_s: Optional[float]) -> Optional[float]:
        """The client deadline is absolute from first submission: a
        failover resubmits with what is left of it."""
        if deadline_s is None:
            return None
        return deadline_s - (self._clock.now() - t0)

    def _submit_routed(self, prompt: List[int], max_new_tokens: int, *,
                       t0: float, deadline_s: Optional[float],
                       exclude: set, greedy: Optional[bool] = None,
                       tenant: str = DEFAULT_TENANT,
                       priority: Optional[int] = None,
                       session: Optional[str] = None):
        """Route + submit with per-replica admission fallback: a replica
        refusing admission drops out of the candidate set; only an empty
        set is fleet-wide backpressure."""
        loads = {rid: load for rid, load in self.fleet.loads().items()
                 if rid not in exclude}
        last_err: Optional[Exception] = None
        pinned = self._fused_pin(session) if session is not None else None
        while loads:
            rid, reason = self.router.choose(prompt, loads,
                                             session=session,
                                             pinned=pinned)
            replica = self.fleet.get(rid)
            if replica is None or not self.fleet.health.try_route(rid):
                if rid == pinned:
                    self._drop_lease(session)
                    pinned = None
                loads.pop(rid, None)
                continue
            if not self._pre_submit(
                    replica, prompt,
                    deadline_s=self._remaining_deadline(t0, deadline_s),
                    tenant=tenant):
                self.fleet.health.release_probe(rid)
                loads.pop(rid, None)
                continue
            engine_deadline = self._remaining_deadline(t0, deadline_s)
            if engine_deadline is not None:
                engine_deadline = max(0.001, engine_deadline)
            try:
                CHAOS.hit("gateway.dispatch")
                req = replica.engine.submit(
                    prompt, max_new_tokens=max_new_tokens,
                    deadline_s=engine_deadline, greedy=greedy,
                    tenant=tenant, priority=priority)
            except PromptTooLong:
                self.fleet.health.release_probe(rid)
                raise
            except AdmissionError as e:
                last_err = e
                self.fleet.health.release_probe(rid)
                loads.pop(rid, None)
                continue
            except BaseException:
                self.fleet.health.release_probe(rid)
                raise
            self.router.observe(rid, prompt, session=session)
            return replica, reason, req
        retry_after = getattr(last_err, "retry_after_s", None)
        if retry_after is None:
            retry_after = self.fleet.breaker_retry_after_s()
        if isinstance(last_err, QuotaExceeded):
            with self._lock:
                self._shed += 1
            raise quota_error(
                f"tenant {last_err.tenant!r} over its queue cap on every "
                f"replica: {last_err}",
                tenant=last_err.tenant or tenant,
                reason=last_err.reason or "max_queued",
                retry_after_s=retry_after)
        raise self._shed_error(
            Unavailable,
            f"no replica can admit the request: "
            f"{last_err or 'no routable replicas'}",
            reason="no_replica", retry_after_s=retry_after)

    def _pre_submit(self, replica, prompt: List[int],
                    deadline_s: Optional[float] = None,
                    tenant: str = DEFAULT_TENANT) -> bool:
        """Hook between routing and submission; False drops the replica
        from this request's candidates. Here: the fleet-global import,
        staged AFTER the admission probe (staging for a replica that
        cannot admit would waste an export and a transfer)."""
        if self.kv_index is None:
            return True
        self._reset_kv_import_meta()
        engine = replica.engine
        if getattr(engine, "closed", False) or \
                engine.queue.depth() >= engine.queue.max_depth:
            return False
        self._stage_kv_import(replica, prompt, deadline_s=deadline_s)
        return True

    # -- workflow-aware scheduling -------------------------------------------

    def _fused_pin(self, session: Optional[str]) -> Optional[str]:
        """The replica a live fusion lease pins ``session`` to (lazy
        expiry: the engine-side TTL sweep is authoritative)."""
        if session is None:
            return None
        with self._wf_lock:
            lease = self._wf_parked.get(session)
            if lease is None:
                return None
            rid, expires = lease
            if self._clock.now() >= expires:
                del self._wf_parked[session]
                return None
            return rid

    def _drop_lease(self, session: Optional[str]) -> None:
        if session is None:
            return
        with self._wf_lock:
            self._wf_parked.pop(session, None)

    def _drop_leases_on(self, replica_id: str) -> None:
        """A dead or retired replica's parked KV died with it."""
        with self._wf_lock:
            for session in [s for s, (rid, _) in self._wf_parked.items()
                            if rid == replica_id]:
                del self._wf_parked[session]

    def park_conversation(self, session: str, tokens: Sequence[int],
                          ttl_s: Optional[float] = None) -> bool:
        """Park ``session``'s conversation KV (the radix chain covering
        ``tokens``) on the replica that served it for up to ``ttl_s``;
        the next step then hard-pins there ("fused" route). Advisory:
        False leaves the ordinary routed path untouched."""
        ttl = self._wf_park_ttl if ttl_s is None else float(ttl_s)
        rid = self._fused_pin(session)
        if rid is None:
            rid = self.router.session_replica(session)
        if rid is None:
            return False
        replica = self.fleet.get(rid)
        park = (getattr(replica.engine, "park_chain", None)
                if replica is not None else None)
        if park is None:
            return False
        try:
            ok = bool(park(f"conv:{session}", list(tokens), ttl_s=ttl))
        except Exception:  # noqa: BLE001 — parking is advisory
            ok = False
        if ok:
            with self._wf_lock:
                self._wf_parked[session] = (rid, self._clock.now() + ttl)
        else:
            self._drop_lease(session)
        return ok

    def unpark_conversation(self, session: str) -> bool:
        """Release ``session``'s fusion lease and its engine-side pins."""
        rid = self._fused_pin(session)
        self._drop_lease(session)
        if rid is None:
            return False
        replica = self.fleet.get(rid)
        unpark = (getattr(replica.engine, "unpark_chain", None)
                  if replica is not None else None)
        if unpark is None:
            return False
        try:
            return bool(unpark(f"conv:{session}"))
        except Exception:  # noqa: BLE001 — advisory
            return False

    def speculate_prefill(self, session: str, tokens: Sequence[int], *,
                          timeout_s: float = 30.0) -> bool:
        """While a tool op runs, prefill the KNOWN prefix of the
        conversation's next step on the leased replica (a 1-token greedy
        request at background priority, on a reserved uncharged tenant),
        then re-park so the new blocks ride the pin. Never raises."""
        from lzy_tpu_torch.llm.metrics import SPECULATIONS

        rid = self._fused_pin(session)
        replica = self.fleet.get(rid) if rid is not None else None
        if replica is None:
            self._drop_lease(session)
            SPECULATIONS.inc(outcome="no_lease")
            return False
        try:
            req = replica.engine.submit(
                [int(t) for t in tokens], max_new_tokens=1,
                deadline_s=timeout_s, greedy=True,
                tenant=SPECULATION_TENANT, priority=2)
        except Exception:  # noqa: BLE001 — speculation is advisory
            SPECULATIONS.inc(outcome="error")
            return False
        if not req.wait(timeout=timeout_s):
            req.cancel()
            SPECULATIONS.inc(outcome="timeout")
            return False
        if req.status != "ok":
            SPECULATIONS.inc(outcome="miss")
            return False
        self.park_conversation(session, tokens)
        SPECULATIONS.inc(outcome="ok")
        return True

    def _wf_parked_count(self) -> int:
        with self._wf_lock:
            return len(self._wf_parked)

    # -- fleet-global KV imports ---------------------------------------------

    def _reset_kv_import_meta(self) -> None:
        """Reset the per-attempt staging meta before the admission probe,
        so an attempt that skips staging does not report the previous
        one's."""
        meta = self._kvtier_meta()
        for key in ("kv_import_staged_from", "kv_import_tier",
                    "kv_import_ms"):
            meta.pop(key, None)

    def _stage_kv_import(self, replica, prompt: List[int],
                         deadline_s: Optional[float] = None) -> None:
        """Best-effort cross-replica prefix import: find a sibling whose
        advertised prefix is deeper than what the routed replica covers
        (radix tree plus its own tier), export on the sibling's
        scheduling thread, move the payload through the transport and
        queue it on the routed replica, which folds it in before the
        request's admission. Never raises: every failure is one counted
        fallback, and the replica re-prefills locally."""
        engine = replica.engine
        kv = getattr(engine, "kv", None)
        queue_import = getattr(engine, "queue_kv_import", None)
        if kv is None or queue_import is None:
            return
        export_timeout = 5.0
        if deadline_s is not None:
            if deadline_s < 0.05:
                return
            export_timeout = min(export_timeout, deadline_s)
        meta = self._kvtier_meta()
        page = kv.page_size
        n_full = (len(prompt) - 1) // page
        if n_full == 0:
            return
        prefix = [int(t) for t in prompt[:n_full * page]]
        tier_probe = getattr(engine, "kv_tier_match_len", None)
        local = (tier_probe(prefix) if tier_probe is not None
                 else kv.match_len(prefix))
        if local >= len(prefix):
            return
        holder = self.kv_index.best_holder(
            prefix, exclude=(replica.id,), min_depth_tokens=local)
        if holder is None:
            return
        t0 = self._clock.now()
        try:
            CHAOS.hit("kvtier.import")
            src = self.fleet.get(holder.replica_id)
            if src is None or getattr(src.engine, "request_kv_export",
                                      None) is None:
                raise LookupError(
                    f"holder {holder.replica_id} retired mid-route")
            export = src.engine.request_kv_export(
                prefix[:holder.depth_tokens], timeout_s=export_timeout)
            if export is None:
                raise LookupError(
                    f"holder {holder.replica_id} declined the export")
            if export.prefilled_by is None:
                export.prefilled_by = holder.replica_id
            with self._kvtier_lock:
                self._kvtier_seq += 1
                key = f"kvtier-{self._kvtier_seq}"
            ref = self.kv_transport.publish(key, export)
            try:
                fetched = self.kv_transport.fetch(ref)
            finally:
                try:
                    self.kv_transport.discard(ref)
                except Exception:  # noqa: BLE001 — best-effort cleanup
                    pass
            queue_import(fetched)
        except Exception as e:  # noqa: BLE001 — import is advisory
            with self._kvtier_lock:
                self._kvtier_fallbacks += 1
            IMPORT_FALLBACKS.inc()
            _LOG.info("kvtier: cross-replica import from %s failed "
                      "(%s: %s); %s will re-prefill locally",
                      holder.replica_id, type(e).__name__, e, replica.id)
            return
        dt = self._clock.now() - t0
        with self._kvtier_lock:
            self._kvtier_imports += 1
            self._kvtier_import_bytes += fetched.nbytes
        IMPORTS.inc(from_tier=holder.tier)
        IMPORT_BYTES.inc(fetched.nbytes)
        IMPORT_SECONDS.observe(dt)
        meta["kv_import_staged_from"] = holder.replica_id
        meta["kv_import_tier"] = holder.tier
        meta["kv_import_ms"] = round(1000 * dt, 3)

    def _kvtier_meta(self) -> dict:
        meta = getattr(self._kvtier_tls, "meta", None)
        if meta is None:
            meta = self._kvtier_tls.meta = {}
        return meta

    def _note_result(self, req) -> None:
        """Hook: the terminal request, before the reply is built. With
        the index on, ``kv_prefilled_by`` (set at prefix-match time)
        names the sibling whose imported KV the attempt really used."""
        if self.kv_index is not None:
            self._kvtier_meta()["kv_used_from"] = getattr(
                req, "kv_prefilled_by", None)

    def _reply_extras(self) -> dict:
        """Extra route metadata merged into every reply: with the index
        on, the import provenance (``kv_import_from`` the sibling whose
        KV was USED, ``kv_import_staged_from`` the one STAGED, the tier
        and the staging latency)."""
        if self.kv_index is None:
            return {}
        meta = self._kvtier_meta()
        return {
            "kv_import_from": meta.get("kv_used_from"),
            "kv_import_staged_from": meta.get("kv_import_staged_from"),
            "kv_import_tier": meta.get("kv_import_tier"),
            "kv_import_ms": meta.get("kv_import_ms"),
        }

    def _note_failover(self) -> None:
        with self._lock:
            self._failovers += 1
        _FAILOVERS.inc()

    # -- control loop --------------------------------------------------------

    def _forget_replica(self, rid: str) -> None:
        self.router.forget(rid)
        self._drop_leases_on(rid)
        if self.kv_index is not None:
            self.kv_index.forget(rid)
            self._kvtier_last_adv.pop(rid, None)

    def tick(self, now: Optional[float] = None) -> Optional[str]:
        """One health + autoscale round (the background loop calls it
        every ``tick_period_s``). Returns the applied scale direction."""
        now = now if now is not None else self._clock.time()
        for rid in self.fleet.check_health(now=now):
            self._forget_replica(rid)
        for rid in self.fleet.reap_drained():
            self._forget_replica(rid)
        self.refresh_kv_index()
        if self.autoscaler is None:
            return None
        ready = len(self.fleet.replicas())
        if ready < self.autoscaler.min_replicas:
            # recovery, not scaling: re-add without pressure windows
            _LOG.warning("gateway: %d/%d replicas; re-adding",
                         ready, self.autoscaler.min_replicas)
            return self._scale_up()
        agg = self.fleet.aggregate()
        decision = self.autoscaler.tick(
            now, replicas=ready, queue_depth=agg["queue_depth"],
            busy=agg["busy"], slots=agg["slots"])
        if decision is None:
            return None
        if decision.direction == UP:
            _LOG.info("gateway: scaling up (%s)", decision.reason)
            return self._scale_up()
        _LOG.info("gateway: scaling down (%s)", decision.reason)
        coldest = self._coldest_replica()
        if coldest is None:
            return None
        self.fleet.drain(coldest)
        with self._lock:
            self._scale_downs += 1
        _SCALE.inc(direction="down")
        return DOWN

    def _scale_up(self) -> Optional[str]:
        try:
            self.fleet.add_replica()
        except Exception:  # noqa: BLE001 — retried next tick
            _LOG.exception("gateway: scale-up failed")
            return None
        with self._lock:
            self._scale_ups += 1
        _SCALE.inc(direction="up")
        return UP

    def refresh_kv_index(self, force: bool = False) -> None:
        """Refresh the global prefix index from each replica's
        advertisement (pull-based, advisory); an unchanged advertisement
        (the SAME object) is skipped unless ``force``."""
        if self.kv_index is None:
            return
        for replica in self.fleet.replicas():
            chains = chains_of(replica.engine)
            if not chains:
                continue
            if not force and \
                    self._kvtier_last_adv.get(replica.id) is chains:
                continue
            self.kv_index.update_replica(replica.id, chains)
            self._kvtier_last_adv[replica.id] = chains

    def _coldest_replica(self) -> Optional[str]:
        """Drain victim: the fewest indexed prefix chains, load as the
        tie-break."""
        loads = self.fleet.loads()
        if not loads:
            return None
        chains = self.router.stats().get("indexed_chains", {})
        return min(sorted(loads),
                   key=lambda r: (chains.get(r, 0), loads[r]))

    def start(self) -> "GatewayService":
        if self._thread is not None:
            return self
        self._stop.clear()

        def loop():
            while not self._clock.wait(self._stop, self._tick_period_s):
                try:
                    self.tick()
                except Exception:  # noqa: BLE001 — the tick must not die
                    _LOG.exception("gateway tick failed")

        self._thread = threading.Thread(
            target=loop, name="gateway-tick", daemon=True)
        self._thread.start()
        return self

    def drain(self, timeout_s: float = 30.0) -> bool:
        """Stop admitting, let in-flight requests finish, then close.
        True if all finished inside the budget."""
        self._draining = True
        deadline = self._clock.now() + timeout_s
        while self._clock.now() < deadline:
            with self._lock:
                if self._inflight == 0:
                    break
            self._clock.sleep(0.02)
        with self._lock:
            drained = self._inflight == 0
        if not drained:
            _LOG.warning("gateway drain: %d request(s) still in flight "
                         "after %.1fs; closing anyway", self._inflight,
                         timeout_s)
        self.close()
        return drained

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
        self.fleet.close()

    # -- observability -------------------------------------------------------

    def stats(self) -> dict:
        """Fleet-level stats: aggregates, routing and scaling counters
        and the per-tenant breakdown (per replica: :meth:`fleet_stats`)."""
        agg = self.fleet.aggregate()
        routing = self.router.stats()
        hit_rate = 0.0
        if agg["prefix_lookup_tokens"]:
            hit_rate = agg["prefix_hit_tokens"] / agg["prefix_lookup_tokens"]
        spec_rate = spec_tps = 0.0
        if agg["spec_proposed_tokens"]:
            spec_rate = (agg["spec_accepted_tokens"]
                         / agg["spec_proposed_tokens"])
            if agg["decode_rows"]:
                spec_tps = agg["decode_tokens"] / agg["decode_rows"]
        with self._lock:
            fo, fin = self._failovers, self._finished
            ups, downs = self._scale_ups, self._scale_downs
            shed = self._shed
        doc = {
            "model": self.model_name,
            "gateway": True,
            "replicas": agg["replicas"],
            "replicas_ready": len(self.fleet.replicas()),
            "slots": agg["slots"],
            "busy": agg["busy"],
            "queue_depth": agg["queue_depth"],
            "requests_finished": fin,
            "tokens_generated": agg["tokens_generated"],
            "requests_shed": shed,
            "failovers": fo,
            "scale_ups": ups,
            "scale_downs": downs,
            "routed_total": routing["routed_total"],
            "routed_by_prefix": routing["routed_by_prefix"],
            "prefix_route_rate": routing["prefix_route_rate"],
            "fleet_prefix_hit_rate": round(hit_rate, 4),
            "spec_proposed_tokens": agg["spec_proposed_tokens"],
            "spec_accepted_tokens": agg["spec_accepted_tokens"],
            "spec_acceptance_rate": round(spec_rate, 4),
            "spec_tokens_per_step": round(spec_tps, 4),
            "spec_draft_truncated": agg["spec_draft_truncated"],
            "wf_parked_sessions": self._wf_parked_count(),
            "tenants": self.fleet.aggregate_tenants(),
        }
        if self.kv_index is not None:
            with self._kvtier_lock:
                doc.update({
                    "kvtier": True,
                    "kvtier_imports": self._kvtier_imports,
                    "kvtier_import_bytes": self._kvtier_import_bytes,
                    "kvtier_reprefill_fallbacks": self._kvtier_fallbacks,
                })
            doc.update({
                "kvtier_demotions": agg.get("kv_tier_demotions", 0),
                "kvtier_promotions": agg.get("kv_tier_promotions", 0),
                "kvtier_host_blocks": agg.get("kv_host_tier_blocks", 0),
                "kvtier_index": self.kv_index.stats(),
            })
        return doc

    def fleet_stats(self) -> dict:
        """Per-replica breakdown (engine stats plus health)."""
        rows = []
        for state in ("READY", "DRAINING"):
            for replica in self.fleet.replicas(state=state):
                doc = replica.engine.stats().doc()
                doc.update({
                    "replica": replica.id,
                    "state": replica.state,
                    "consecutive_failures":
                        self.fleet.health.failures(replica.id),
                })
                rows.append(doc)
        return {"model": self.model_name, "replicas": rows}
