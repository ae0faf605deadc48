"""Allocator: VM lifetime management, the port's copy of
``lzy_tpu/service/allocator.py``.

Sessions with an idle timeout, pools, the VM status machine
ALLOCATING/RUNNING/IDLE/DELETING, allocate/free with a VM reuse cache
per session, the register/heartbeat private API and GC. Allocation is a
durable operation (plan, launch, await) over a pluggable ``VmBackend``;
the port's backend runs worker agents as in-process threads
(``service/backends.ThreadVmBackend``).

Trimmed to this package's pools, which are one host each: a gang is a
single VM. The reference's IAM worker tokens, disk mounts and the
blocking ``lease_gang`` of allocator-leased serving fleets are not
ported.
"""

from __future__ import annotations

import abc
import dataclasses
import threading
from typing import Any, Dict, List, Optional, Sequence

from lzy_tpu_torch.chaos.faults import CHAOS
from lzy_tpu_torch.durable import (
    InjectedFailures,
    OperationRunner,
    OperationsExecutor,
    OperationStore,
    StepResult,
)
from lzy_tpu_torch.types import PoolSpec
from lzy_tpu_torch.utils.clock import SYSTEM_CLOCK
from lzy_tpu_torch.utils.ids import gen_id
from lzy_tpu_torch.utils.log import get_logger
from lzy_tpu_torch.utils.metrics import REGISTRY

_LOG = get_logger(__name__)

# chaos boundary: a failed heartbeat stales the VM toward the GC verdict
_FP_HEARTBEAT = CHAOS.register(
    "allocator.heartbeat", error=KeyError,
    doc="worker agent heartbeat (failure stales heartbeat_ts)")

_M_ALLOCS = REGISTRY.counter(
    "lzy_allocations_total", "gang allocations by pool and source"
)
_M_ALLOC_SECONDS = REGISTRY.histogram(
    "lzy_allocation_seconds", "allocation latency (request to gang RUNNING)"
)
_M_VMS = REGISTRY.gauge("lzy_vms", "VM count by status")

ALLOCATING = "ALLOCATING"
RUNNING = "RUNNING"
IDLE = "IDLE"
DELETING = "DELETING"


def _update_vm_gauge(vms) -> None:
    counts: dict = {}
    for vm in vms:
        counts[vm.status] = counts.get(vm.status, 0) + 1
    for status in (ALLOCATING, RUNNING, IDLE, DELETING):
        _M_VMS.set(counts.get(status, 0), status=status)


@dataclasses.dataclass
class Vm:
    id: str
    session_id: str
    pool_label: str
    status: str
    gang_id: str
    host_index: int
    gang_size: int
    heartbeat_ts: float = 0.0
    idle_since: Optional[float] = None
    created_ts: float = 0.0

    def to_doc(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_doc(doc: dict) -> "Vm":
        return Vm(**doc)


@dataclasses.dataclass
class Session:
    id: str
    owner: str
    idle_timeout_s: float


class VmBackend(abc.ABC):
    """Launches/destroys the actual compute behind a Vm record."""

    @abc.abstractmethod
    def launch(self, vm: Vm, pool: PoolSpec) -> None:
        """Start the host; the worker agent must call
        ``AllocatorService.register_vm`` when up."""

    @abc.abstractmethod
    def destroy(self, vm: Vm) -> None: ...


class AllocatorService:
    HEARTBEAT_TIMEOUT_S = 30.0
    ALLOCATE_TIMEOUT_S = 120.0

    def __init__(
        self,
        store: OperationStore,
        executor: OperationsExecutor,
        backend: VmBackend,
        pools: Sequence[PoolSpec],
    ):
        self._clock = SYSTEM_CLOCK
        self._store = store
        self._executor = executor
        self._backend = backend
        self._pools: Dict[str, PoolSpec] = {p.label: p for p in pools}
        self._sessions: Dict[str, Session] = {}
        self._vms: Dict[str, Vm] = {}
        self._agents: Dict[str, Any] = {}      # vm_id -> live worker agent
        self._lock = threading.RLock()
        executor.register("allocate_gang", self._make_allocate_action)
        executor.register("delete_session", self._make_delete_session_action)
        self._restore()

    def _restore(self) -> None:
        """Boot-time recovery: reload sessions and VM records from the
        store. Live VMs re-register via heartbeat; ones that never do are
        reaped by heartbeat-timeout GC."""
        for doc in self._store.kv_list("sessions").values():
            session = Session(**doc)
            self._sessions[session.id] = session
        for doc in self._store.kv_list("vms").values():
            vm = Vm.from_doc(doc)
            vm.heartbeat_ts = self._clock.time()  # grace before GC judgement
            self._vms[vm.id] = vm

    # -- pools -----------------------------------------------------------------

    @property
    def pools(self) -> List[PoolSpec]:
        return list(self._pools.values())

    def pool(self, label: str) -> PoolSpec:
        try:
            return self._pools[label]
        except KeyError:
            raise KeyError(f"unknown pool {label!r}; known: {sorted(self._pools)}")

    # -- sessions --------------------------------------------------------------

    def create_session(self, owner: str, idle_timeout_s: float = 1260.0) -> str:
        """Default idle timeout 21 min, the reference's default."""
        session = Session(id=gen_id("session"), owner=owner,
                          idle_timeout_s=idle_timeout_s)
        with self._lock:
            self._sessions[session.id] = session
        self._store.kv_put("sessions", session.id, dataclasses.asdict(session))
        return session.id

    def delete_session(self, session_id: str) -> str:
        return self._executor.submit(
            "delete_session", {"session_id": session_id},
            idempotency_key=f"delete-session-{session_id}",
        )

    # -- allocation ------------------------------------------------------------

    def allocate(self, session_id: str, pool_label: str, *,
                 deadline_s: Optional[float] = None) -> str:
        """Start a durable allocation; returns the operation id. The op
        result is ``{"gang_id", "vm_ids": [...]}`` with every host
        RUNNING. Past ``deadline_s`` the op expires and rolls back."""
        with self._lock:
            if session_id not in self._sessions:
                raise KeyError(f"unknown session {session_id!r}")
        pool = self.pool(pool_label)
        return self._executor.submit(
            "allocate_gang",
            {"session_id": session_id, "pool_label": pool_label,
             "gang_size": pool.hosts},
            deadline_s=deadline_s or self.ALLOCATE_TIMEOUT_S,
        )

    def free(self, vm_ids: Sequence[str]) -> None:
        """Return VMs to the session cache (VM -> IDLE, reused until the
        session's idle timeout)."""
        now = self._clock.time()
        with self._lock:
            for vm_id in vm_ids:
                vm = self._vms.get(vm_id)
                if vm is not None and vm.status == RUNNING:
                    vm.status = IDLE
                    vm.idle_since = now
                    self._persist(vm)

    # -- private API (register/heartbeat) --------------------------------------

    def register_vm(self, vm_id: str, agent: Any) -> None:
        with self._lock:
            vm = self._vms.get(vm_id)
            if vm is None or vm.status == DELETING:
                raise KeyError(f"vm {vm_id!r} is not expected to register")
            self._agents[vm_id] = agent
            vm.heartbeat_ts = self._clock.time()
            if vm.status == ALLOCATING:
                vm.status = RUNNING
                self._persist(vm)

    def heartbeat(self, vm_id: str) -> None:
        """Raises KeyError for unknown VMs and for VMs with no registered
        agent."""
        CHAOS.hit("allocator.heartbeat")
        with self._lock:
            vm = self._vms.get(vm_id)
            if vm is None:
                raise KeyError(f"vm {vm_id!r} is not known to the allocator")
            if vm_id not in self._agents:
                raise KeyError(f"vm {vm_id!r} has no registered agent")
            vm.heartbeat_ts = self._clock.time()

    def agent(self, vm_id: str) -> Any:
        with self._lock:
            return self._agents[vm_id]

    def vm(self, vm_id: str) -> Vm:
        with self._lock:
            return self._vms[vm_id]

    def vms(self) -> List[Vm]:
        with self._lock:
            return list(self._vms.values())

    # -- GC --------------------------------------------------------------------

    def gc_tick(self, now: Optional[float] = None) -> List[str]:
        """Reap idle-expired and heartbeat-dead VMs; returns destroyed vm
        ids."""
        now = now if now is not None else self._clock.time()
        doomed: List[Vm] = []
        with self._lock:
            for vm in self._vms.values():
                session = self._sessions.get(vm.session_id)
                idle_limit = session.idle_timeout_s if session else 0.0
                if vm.status == IDLE and vm.idle_since is not None \
                        and now - vm.idle_since > idle_limit:
                    doomed.append(vm)
                elif vm.status == RUNNING and vm.heartbeat_ts \
                        and now - vm.heartbeat_ts > self.HEARTBEAT_TIMEOUT_S:
                    doomed.append(vm)
                elif vm.status == ALLOCATING and \
                        now - vm.created_ts > 2 * self.ALLOCATE_TIMEOUT_S:
                    # orphaned plan: the allocate op crashed before
                    # committing its step, so nothing awaits these hosts
                    doomed.append(vm)
            for vm in doomed:
                vm.status = DELETING
                self._persist(vm)
        for vm in doomed:
            self._destroy(vm)
        return [v.id for v in doomed]

    # -- internals -------------------------------------------------------------

    def _persist(self, vm: Vm) -> None:
        self._store.kv_put("vms", vm.id, vm.to_doc())
        _update_vm_gauge(self.vms())  # every status transition passes here

    def _destroy(self, vm: Vm) -> None:
        with self._lock:
            agent = self._agents.pop(vm.id, None)
        if agent is not None:
            try:
                agent.stop()
            except Exception:
                pass
        try:
            self._backend.destroy(vm)
        finally:
            with self._lock:
                self._vms.pop(vm.id, None)
            self._store.kv_del("vms", vm.id)
            _update_vm_gauge(self.vms())

    def _find_cached_gang(self, session_id: str, pool_label: str,
                          gang_size: int) -> Optional[List[Vm]]:
        with self._lock:
            by_gang: Dict[str, List[Vm]] = {}
            for vm in self._vms.values():
                if (vm.status == IDLE and vm.session_id == session_id
                        and vm.pool_label == pool_label):
                    by_gang.setdefault(vm.gang_id, []).append(vm)
            for gang in by_gang.values():
                if len(gang) == gang_size:
                    for vm in gang:
                        vm.status = RUNNING
                        vm.idle_since = None
                        vm.heartbeat_ts = self._clock.time()
                        self._persist(vm)
                    return sorted(gang, key=lambda v: v.host_index)
        return None

    # -- durable actions -------------------------------------------------------

    def _make_allocate_action(self, record, store, executor):
        return _AllocateGangAction(record, store, executor, self)

    def _make_delete_session_action(self, record, store, executor):
        return _DeleteSessionAction(record, store, executor, self)


class _AllocateGangAction(OperationRunner):
    """Steps: reuse-or-launch -> await every host registered -> finish.
    All-or-nothing: a timeout or launch failure destroys every host."""

    kind = "allocate_gang"

    def __init__(self, record, store, executor, svc: AllocatorService):
        super().__init__(record, store, executor)
        self.svc = svc

    def steps(self):
        return [
            ("plan", self._plan),
            ("launch", self._launch),
            ("await_gang", self._await_gang),
        ]

    def _plan(self):
        """Decide reuse-vs-launch and persist the chosen vm ids BEFORE any
        side effect on the backend: a crash after this step resumes with
        the same hosts instead of leaking others."""
        if self.state.get("vm_ids"):
            return StepResult.ALREADY_DONE
        session_id = self.state["session_id"]
        pool_label = self.state["pool_label"]
        gang_size = self.state["gang_size"]

        self.state.setdefault("requested_at", self.svc._clock.time())
        cached = self.svc._find_cached_gang(session_id, pool_label, gang_size)
        if cached is not None:
            _LOG.info("gang cache hit: %s", [v.id for v in cached])
            _M_ALLOCS.inc(pool=pool_label, source="cache")
            self.state["vm_ids"] = [v.id for v in cached]
            self.state["gang_id"] = cached[0].gang_id
            self.state["cached"] = True
            return StepResult.CONTINUE
        _M_ALLOCS.inc(pool=pool_label, source="launch")

        gang_id = gen_id("gang")
        vms = [Vm(id=gen_id("vm"), session_id=session_id,
                  pool_label=pool_label, status=ALLOCATING, gang_id=gang_id,
                  host_index=i, gang_size=gang_size,
                  created_ts=self.svc._clock.time())
               for i in range(gang_size)]
        with self.svc._lock:
            for vm in vms:
                self.svc._vms[vm.id] = vm
                self.svc._persist(vm)
        self.state["vm_ids"] = [v.id for v in vms]
        self.state["gang_id"] = gang_id
        self.state["cached"] = False
        return StepResult.CONTINUE

    def _launch(self):
        """Idempotent: the backend skips hosts already booting or booted,
        so a crash mid-loop re-runs safely on resume."""
        if self.state.get("cached"):
            return StepResult.ALREADY_DONE
        self.hook("launch")
        pool = self.svc.pool(self.state["pool_label"])
        vms = []
        for vm_id in self.state["vm_ids"]:
            try:
                vms.append(self.svc.vm(vm_id))
            except KeyError:
                raise RuntimeError(f"planned gang member {vm_id} disappeared")
        try:
            for vm in vms:
                self.hook("launch_each")
                self.svc._backend.launch(vm, pool)
        except BaseException as e:
            if InjectedFailures.is_injected(e):
                raise  # simulated process kill: no cleanup, resume re-launches
            _LOG.error("launch failed (%s); rolling back %d hosts", e, len(vms))
            for vm in vms:
                self.svc._destroy(vm)
            raise
        return StepResult.CONTINUE

    def _await_gang(self):
        vm_ids = self.state["vm_ids"]
        if self.state.get("cached"):
            return StepResult.finish(self._result())
        statuses = []
        for vm_id in vm_ids:
            try:
                statuses.append(self.svc.vm(vm_id).status)
            except KeyError:
                statuses.append(DELETING)
        if any(s == DELETING for s in statuses):
            self._rollback()
            raise RuntimeError(f"gang member lost during allocation: {statuses}")
        if all(s == RUNNING for s in statuses):
            requested_at = self.state.get("requested_at")
            if requested_at:
                _M_ALLOC_SECONDS.observe(
                    self.svc._clock.time() - requested_at)
            return StepResult.finish(self._result())
        return StepResult.restart(0.1)

    def _result(self):
        return {"gang_id": self.state["gang_id"], "vm_ids": self.state["vm_ids"]}

    def _rollback(self):
        for vm_id in self.state.get("vm_ids", []):
            try:
                self.svc._destroy(self.svc.vm(vm_id))
            except KeyError:
                pass

    def on_failed(self, error):
        self._rollback()

    def on_expired(self):
        self._rollback()


class _DeleteSessionAction(OperationRunner):
    kind = "delete_session"

    def __init__(self, record, store, executor, svc: AllocatorService):
        super().__init__(record, store, executor)
        self.svc = svc

    def steps(self):
        return [("delete", self._delete)]

    def _delete(self):
        session_id = self.state["session_id"]
        with self.svc._lock:
            doomed = [vm for vm in self.svc._vms.values()
                      if vm.session_id == session_id]
            for vm in doomed:
                vm.status = DELETING
        for vm in doomed:
            self.svc._destroy(vm)
        with self.svc._lock:
            self.svc._sessions.pop(session_id, None)
        self.svc._store.kv_del("sessions", session_id)
        return StepResult.finish(None)
