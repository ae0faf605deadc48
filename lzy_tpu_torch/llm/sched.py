"""Workflow-aware serving scheduler: the fan-in plane between ``llm``
ops and the serving fleet. The port's copy of ``lzy_tpu/llm/sched.py``.

Every ``llm.generate`` body dispatches through :class:`WorkflowScheduler`,
which is serving-aware in three composing ways:

- **in-flight dedup** (:meth:`WorkflowScheduler.dispatch`): identical
  GREEDY calls in flight at the same moment (same prompt, params, tenant
  and model digest: the identity the op cache keys on) collapse to one
  engine request whose reply fans out to every waiter. Sampled and
  streaming calls never dedup: a sampled reply is a draw, and a stream's
  tokens belong to one channel. A failed or cancelled leader is its own
  outcome: its followers dispatch again.
- **op-chain fusion** (:meth:`WorkflowScheduler.note_step_done`): when a
  conversation step finishes ok, the gateway parks the conversation's
  radix chain on its replica (``park_conversation``, a TTL lease), so
  the next step of a ``generate -> tool op -> generate`` chain hard-pins
  there (routed_by ``"fused"``) and prefills only its suffix. A dead
  replica or an expired lease costs one re-prefill, never a wrong token.
- **speculative next-step prefill** (same hook): while the tool op runs,
  the KNOWN prompt prefix of the next step (the finished step's prompt
  and reply) is prefilled on the leased replica at background priority
  (``speculate_prefill``). A dispatch for a session whose speculation is
  still running waits for it briefly: the speculation is that step's
  prefill.

The reference's ``LZY_WFSCHED_*`` environment flags and its ``dedup=``,
``fuse=``, ``speculate=``, ``park_ttl_s=`` and ``max_workers=`` options
have no caller in the port and are left out: all three features are
on, the park TTL is the gateway's and the plane pool has
:data:`PLANE_WORKERS` threads.
"""

from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional

#: how long a dispatch waits for its session's in-flight speculation
#: before racing it
SPEC_AWAIT_S = 10.0
#: a follower whose leader outlives this (or its own ``timeout_s``)
#: dispatches for itself
FOLLOWER_WAIT_S = 120.0
#: threads of the batch fan-out pool
PLANE_WORKERS = 16
#: threads of the fusion and speculation pool
FUSION_WORKERS = 4


class _InFlight:
    """Leader/follower rendezvous for one dedup key."""

    __slots__ = ("done", "reply", "error", "followers")

    def __init__(self):
        self.done = threading.Event()
        self.reply: Optional[dict] = None
        self.error: Optional[BaseException] = None
        self.followers = 0


class WorkflowScheduler:
    """One per configured backend (:func:`scheduler_for`): the fan-in
    plane, the dedup table and the fusion hooks. A backend without
    ``park_conversation`` never fuses; a sampled call never dedups."""

    def __init__(self, backend: Any):
        self.backend = backend
        self._lock = threading.Lock()
        self._inflight: Dict[tuple, _InFlight] = {}
        #: session -> in-flight fusion future (park + speculative
        #: prefill); the next dispatch for that session awaits it
        self._spec: Dict[str, Any] = {}
        self._dedup_hits = 0
        self._dispatches = 0
        self._parks = 0
        self._speculations = 0
        self._closed = False
        # two pools: a saturating batch fan-out must not queue a
        # speculation behind itself and then wait on it from dispatch()
        self._pool: Optional[ThreadPoolExecutor] = None
        self._fuse_pool: Optional[ThreadPoolExecutor] = None

    # -- the plane ------------------------------------------------------------

    def _plane(self) -> ThreadPoolExecutor:
        with self._lock:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(
                    PLANE_WORKERS, thread_name_prefix="lzy-wfsched")
            return self._pool

    def _fusion_pool(self) -> ThreadPoolExecutor:
        with self._lock:
            if self._fuse_pool is None:
                self._fuse_pool = ThreadPoolExecutor(
                    FUSION_WORKERS, thread_name_prefix="lzy-wfsched-fuse")
            return self._fuse_pool

    def map(self, fn, items: List[Any]) -> List[Any]:
        """Order-preserving fan-out over the plane pool (what
        ``llm.generate_batch`` rides); each item lands back in
        :meth:`dispatch`. The first exception propagates after every row
        settles."""
        futures = [self._plane().submit(fn, item) for item in items]
        results, first_err = [], None
        for fut in futures:
            try:
                results.append(fut.result())
            except BaseException as e:  # noqa: BLE001 — re-raised below
                results.append(None)
                if first_err is None:
                    first_err = e
        if first_err is not None:
            raise first_err
        return results

    # -- admission fan-in + in-flight dedup -----------------------------------

    def dispatch(self, prompt_tokens: List[int], *,
                 max_new_tokens: int,
                 timeout_s: Optional[float] = None,
                 deadline_s: Optional[float] = None,
                 greedy: Optional[bool] = None,
                 tenant: Optional[str] = None,
                 priority: Optional[int] = None,
                 session: Optional[str] = None,
                 stream=None) -> dict:
        """One generate through the plane. Greedy, non-streaming calls
        dedup against identical in-flight twins; every other call is one
        engine request."""
        from lzy_tpu_torch.llm import metrics

        if session is not None:
            self._await_speculation(session)
        with self._lock:
            self._dispatches += 1

        def call() -> dict:
            return self.backend.generate(
                prompt_tokens, max_new_tokens=max_new_tokens,
                timeout_s=timeout_s, deadline_s=deadline_s, greedy=greedy,
                tenant=tenant, priority=priority, session=session,
                stream=stream)

        if not (greedy is True and stream is None):
            return call()
        # the op cache's identity plus the SLO identity (a follower must
        # not ride a reply another tenant paid for); deadlines are left
        # out: only complete ("ok") replies fan out
        key = (self._digest(), tuple(prompt_tokens), int(max_new_tokens),
               tenant, priority)
        while True:
            with self._lock:
                entry = self._inflight.get(key)
                leader = entry is None
                if leader:
                    entry = self._inflight[key] = _InFlight()
                else:
                    entry.followers += 1
            if leader:
                try:
                    entry.reply = call()
                except BaseException as e:
                    entry.error = e
                    raise
                finally:
                    with self._lock:
                        if self._inflight.get(key) is entry:
                            del self._inflight[key]
                        fanout = entry.followers
                    entry.done.set()
                    metrics.WFSCHED_DISPATCHES.inc(
                        role="leader" if fanout else "solo")
                return entry.reply
            if not entry.done.wait(timeout_s or FOLLOWER_WAIT_S):
                # the leader outlived our budget: dispatch for ourselves
                return call()
            reply = entry.reply
            if entry.error is None and isinstance(reply, dict) \
                    and reply.get("status") == "ok":
                with self._lock:
                    self._dedup_hits += 1
                metrics.DEDUP_HITS.inc()
                metrics.WFSCHED_DISPATCHES.inc(role="follower")
                # a fresh token list per waiter: siblings never alias
                return {**reply, "tokens": list(reply.get("tokens", []))}
            # the leader failed or was cancelled: ITS outcome, not ours;
            # loop and lead or follow again

    def note_batch_dedup(self, n: int = 1) -> None:
        """Credit for rows ``llm.generate_batch`` collapsed before they
        reached :meth:`dispatch`."""
        with self._lock:
            self._dedup_hits += int(n)

    def _digest(self) -> str:
        try:
            return self.backend.model_digest()
        except Exception:  # noqa: BLE001 — identity only needs stability
            return "unknown"

    # -- op-chain fusion + speculative next-step prefill ----------------------

    def note_step_done(self, session: Optional[str],
                       full_tokens: List[int]):
        """A conversation step finished ok: park its KV on its replica
        and, while the tool op runs, prefill the next step's known prefix
        (``full_tokens``). Returns the in-flight future, or None when
        fusion does not apply. Never blocks and never raises."""
        from lzy_tpu_torch.llm import metrics

        if session is None or self._closed:
            return None
        svc = getattr(self.backend, "service", None)
        if svc is None or not hasattr(svc, "park_conversation"):
            metrics.PARK_ATTEMPTS.inc(outcome="unsupported")
            return None
        session = str(session)
        try:
            fut = self._fusion_pool().submit(
                self._fuse_step, svc, session, [int(t) for t in full_tokens])
        except RuntimeError:          # pool shut down mid-close
            return None
        with self._lock:
            self._spec[session] = fut

        def _cleanup(f):
            with self._lock:
                if self._spec.get(session) is f:
                    del self._spec[session]

        fut.add_done_callback(_cleanup)
        return fut

    def _fuse_step(self, svc, session: str, tokens: List[int]) -> bool:
        from lzy_tpu_torch.llm import metrics

        try:
            ok = svc.park_conversation(session, tokens)
        except Exception:  # noqa: BLE001 — fusion is advisory
            ok = False
        metrics.PARK_ATTEMPTS.inc(outcome="parked" if ok else "declined")
        if not ok:
            return False
        with self._lock:
            self._parks += 1
        speculate = getattr(svc, "speculate_prefill", None)
        if speculate is None:
            return True
        try:
            spec_ok = speculate(session, tokens)
        except Exception:  # noqa: BLE001 — speculation is advisory
            spec_ok = False
        if spec_ok:
            with self._lock:
                self._speculations += 1
        return True

    def _await_speculation(self, session: str) -> None:
        with self._lock:
            fut = self._spec.get(str(session))
        if fut is None:
            return
        try:
            fut.result(timeout=SPEC_AWAIT_S)
        except Exception:  # noqa: BLE001 — advisory; the step proceeds
            pass

    def drain(self, timeout_s: float = 30.0) -> None:
        """Wait for every in-flight fusion and speculation task."""
        with self._lock:
            pending = list(self._spec.values())
        for fut in pending:
            try:
                fut.result(timeout=timeout_s)
            except Exception:  # noqa: BLE001 — advisory
                pass

    # -- lifecycle ------------------------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            return {
                "dispatches": self._dispatches,
                "dedup_hits": self._dedup_hits,
                "dedup_waiting": sum(e.followers
                                     for e in self._inflight.values()),
                "parks": self._parks,
                "speculations": self._speculations,
                "spec_inflight": len(self._spec),
            }

    def close(self) -> None:
        """Stop both pools and join their threads (a running fusion task
        finishes first: its gateway calls are bounded)."""
        with self._lock:
            self._closed = True
            pools = [p for p in (self._pool, self._fuse_pool)
                     if p is not None]
            self._pool = self._fuse_pool = None
        for pool in pools:
            pool.shutdown(wait=True)


# -- per-backend resolution ---------------------------------------------------

_lock = threading.Lock()
_scheduler: Optional[WorkflowScheduler] = None


def scheduler_for(backend: Any) -> WorkflowScheduler:
    """The process-global scheduler for ``backend``: created on first
    use, replaced (the old one closed) when the backend changes."""
    global _scheduler
    with _lock:
        if _scheduler is not None and _scheduler.backend is backend:
            return _scheduler
        old, _scheduler = _scheduler, WorkflowScheduler(backend)
        sched = _scheduler
    if old is not None:
        old.close()
    return sched


def current_scheduler() -> Optional[WorkflowScheduler]:
    """The live scheduler, if any (None before the first dispatch after
    a (re)configure)."""
    with _lock:
        return _scheduler


def reset() -> None:
    """Drop and close the process-global scheduler (``llm.configure``
    calls this, so a new backend inherits no dedup table or lease)."""
    global _scheduler
    with _lock:
        old, _scheduler = _scheduler, None
    if old is not None:
        old.close()
