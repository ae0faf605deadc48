"""Durable operation runner, the crash-safe step machine: the port's copy
of ``lzy_tpu/durable/runner.py``.

An operation is a list of named steps; each returns CONTINUE,
ALREADY_DONE, RESTART(delay) or FINISH, and its progress is persisted
after every step. A service restart reloads RUNNING ops from the store
and resumes them at the persisted step (:meth:`OperationsExecutor.
restore`). Steps must be idempotent: a crash can strike mid-step and
the step re-runs on resume.
"""

from __future__ import annotations

import dataclasses
import enum
import threading
import traceback
import typing
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from lzy_tpu_torch.durable.failures import InjectedFailures
from lzy_tpu_torch.durable.store import RUNNING, OperationStore, OpRecord
from lzy_tpu_torch.utils.clock import SYSTEM_CLOCK
from lzy_tpu_torch.utils.ids import gen_id
from lzy_tpu_torch.utils.log import get_logger

_LOG = get_logger(__name__)


class Outcome(enum.Enum):
    CONTINUE = "continue"          # step done, persist and run the next one
    ALREADY_DONE = "already_done"  # step found its work done (idempotent resume)
    FINISH = "finish"              # whole operation complete
    RESTART = "restart"            # yield; re-run the SAME step after a delay


@dataclasses.dataclass(frozen=True)
class StepResult:
    outcome: Outcome
    delay_s: float = 0.0
    result: Any = None

    # sentinels (ClassVar so dataclasses doesn't turn them into fields)
    CONTINUE: typing.ClassVar["StepResult"]
    ALREADY_DONE: typing.ClassVar["StepResult"]

    @staticmethod
    def restart(delay_s: float = 0.5) -> "StepResult":
        return StepResult(Outcome.RESTART, delay_s=delay_s)

    @staticmethod
    def finish(result: Any = None) -> "StepResult":
        return StepResult(Outcome.FINISH, result=result)


StepResult.CONTINUE = StepResult(Outcome.CONTINUE)
StepResult.ALREADY_DONE = StepResult(Outcome.ALREADY_DONE)

Step = Tuple[str, Callable[[], StepResult]]


class OperationRunner:
    """Subclass per operation kind; override ``steps()`` (and optionally
    ``on_expired``/``on_failed``). ``self.state`` is the persisted dict."""

    kind: str = ""

    def __init__(self, record: OpRecord, store: OperationStore,
                 executor: "OperationsExecutor"):
        self.record = record
        self.store = store
        self.executor = executor
        self.state: Dict[str, Any] = record.state

    def steps(self) -> Sequence[Step]:
        raise NotImplementedError

    def on_failed(self, error: BaseException) -> None:
        """Compensation hook when the op fails terminally."""

    def on_expired(self) -> None:
        """Hook when the op passes its deadline."""

    def hook(self, point: str) -> None:
        """Injected-failure hook point; name is ``<kind>.<point>``."""
        InjectedFailures.hit(f"{self.kind}.{point}")


class OperationsExecutor:
    """Runs durable operations on worker threads; schedules RESTART
    delays; restores RUNNING ops on boot."""

    WORKERS = 4

    def __init__(self, store: OperationStore):
        self._clock = SYSTEM_CLOCK
        self._store = store
        self._factories: Dict[str, Callable[..., OperationRunner]] = {}
        self._cv = threading.Condition()
        self._queue: List[Tuple[float, str]] = []  # (not_before, op_id)
        self._inflight: set = set()                # queued or being driven
        # op_id -> number of threads currently driving it. A count (not a
        # set): after a RESTART requeue the next thread can pop the op
        # before the restarting thread has exited _run_one, so two drivers
        # briefly overlap on the bookkeeping (never on the op body).
        self._driving: Dict[str, int] = {}
        self._stopped = False
        self._threads = [
            threading.Thread(target=self._worker, name=f"durable-{i}", daemon=True)
            for i in range(self.WORKERS)
        ]
        for t in self._threads:
            t.start()

    # -- registration / submission ---------------------------------------------

    def register(self, kind: str, factory: Callable[..., OperationRunner]) -> None:
        self._factories[kind] = factory

    def submit(self, kind: str, state: Dict[str, Any],
               idempotency_key: Optional[str] = None,
               deadline_s: Optional[float] = None,
               op_id: Optional[str] = None) -> str:
        if kind not in self._factories:
            raise KeyError(f"no runner registered for operation kind {kind!r}")
        record = self._store.create(
            op_id or gen_id(f"op-{kind}"), kind, state,
            idempotency_key=idempotency_key,
            deadline=(self._clock.time() + deadline_s) if deadline_s else None,
        )
        if record.status == RUNNING:
            self._enqueue(record.id, 0.0)
        return record.id

    def restore(self) -> int:
        """Re-enqueue all RUNNING ops (service-boot recovery). Returns the
        number actually re-enqueued: ops already queued or being driven
        are skipped and not counted."""
        resumed = 0
        for r in self._store.running_ops():
            if r.kind in self._factories and self._enqueue(r.id, 0.0):
                resumed += 1
        return resumed

    def shutdown(self, *, join_timeout_s: float = 5.0) -> None:
        with self._cv:
            self._stopped = True
            self._cv.notify_all()
        # drain: in-flight ops finish their current step before the caller
        # closes the store underneath them; one deadline bounds the drain
        deadline = self._clock.time() + join_timeout_s
        for t in self._threads:
            t.join(max(0.0, deadline - self._clock.time()))

    # -- internals -------------------------------------------------------------

    def _enqueue(self, op_id: str, delay_s: float, *,
                 requeue: bool = False) -> bool:
        """``requeue`` is set only by the op's own driving thread
        (RESTART); external enqueues (a duplicate idempotency key,
        restore) are dropped while the op is queued or being driven, so
        one op is never driven by two threads at once."""
        with self._cv:
            if not requeue and op_id in self._inflight:
                return False
            self._inflight.add(op_id)
            self._queue.append((self._clock.time() + delay_s, op_id))
            self._queue.sort()
            self._cv.notify()
            return True

    def _pop(self) -> Optional[str]:
        with self._cv:
            while not self._stopped:
                now = self._clock.time()
                ready = [i for i, (t, _) in enumerate(self._queue) if t <= now]
                if ready:
                    _, op_id = self._queue.pop(ready[0])
                    self._driving[op_id] = self._driving.get(op_id, 0) + 1
                    return op_id
                timeout = (self._queue[0][0] - now) if self._queue else None
                self._cv.wait(timeout=timeout)
            return None

    def _worker(self) -> None:
        while True:
            op_id = self._pop()
            if op_id is None:
                return
            try:
                self._run_one(op_id)
            except BaseException:
                _LOG.exception("unexpected error driving operation %s", op_id)
            with self._cv:
                # only the last thread out (the op neither queued nor
                # driven by another) may clear _inflight, or a duplicate
                # submit/restore could start a second concurrent driver
                left = self._driving.get(op_id, 1) - 1
                if left > 0:
                    self._driving[op_id] = left
                else:
                    self._driving.pop(op_id, None)
                if (op_id not in self._driving
                        and all(oid != op_id for _, oid in self._queue)):
                    self._inflight.discard(op_id)  # terminal or crashed

    def _run_one(self, op_id: str) -> None:
        record = self._store.load(op_id)
        if record.done:
            return
        if record.deadline is not None and self._clock.time() > record.deadline:
            runner = self._make_runner(record)
            self._store.fail(op_id, "operation deadline exceeded")
            runner.on_expired()
            return
        runner = self._make_runner(record)
        steps = list(runner.steps())
        i = record.step
        while i < len(steps):
            name, fn = steps[i]
            try:
                result = fn()
            except BaseException as e:
                if InjectedFailures.is_injected(e):
                    _LOG.warning("injected crash in %s at step %s", op_id, name)
                    return  # op stays RUNNING, exactly like a killed process
                tb = traceback.format_exc()
                _LOG.error("operation %s failed at step %s: %s", op_id, name, tb)
                self._store.fail(op_id, f"step {name}: {e!r}\n{tb}")
                runner.on_failed(e)
                return
            if result.outcome in (Outcome.CONTINUE, Outcome.ALREADY_DONE):
                i += 1
                self._store.save_progress(op_id, runner.state, i)
                continue
            if result.outcome is Outcome.RESTART:
                self._store.save_progress(op_id, runner.state, i)
                self._enqueue(op_id, result.delay_s, requeue=True)
                return
            if result.outcome is Outcome.FINISH:
                # persist the final state too: status reads it afterwards
                self._store.save_progress(op_id, runner.state, i)
                self._store.complete(op_id, result.result)
                return
        # ran off the end of steps(): implicit FINISH
        self._store.complete(op_id, None)

    def _make_runner(self, record: OpRecord) -> OperationRunner:
        factory = self._factories[record.kind]
        return factory(record, self._store, self)
