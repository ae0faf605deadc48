"""Graph executor: DAG -> scheduled task executions, the port's copy of
``lzy_tpu/service/graph_executor.py``.

A durable graph operation drives a ready-frontier scheduler with a
per-graph concurrency limit and a cross-graph per-user limit; each task
runs as its own durable action with the step chain allocate ->
await allocation -> execute -> await execution -> cleanup (the VM goes
back to its session's cache).

Each task action's persisted state also records where the task's time
went: ``alloc_s`` (allocate to VM ready) and, once the worker reports
DONE, its ``timings`` (inputs, body, serialize, put, bytes, device
hits); ``GraphExecutor.task_timings`` collects them per graph.

The ready frontier launches chain-hot tasks first: a task fed by a
completed ``llm_generate`` step is the tool op of a ``generate -> tool
-> generate`` chain, and its wall time is the window the workflow
scheduler's parked-KV lease must survive.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List

from lzy_tpu_torch.durable import (
    DONE,
    FAILED,
    OperationRunner,
    OperationsExecutor,
    OperationStore,
    StepResult,
)
from lzy_tpu_torch.service.allocator import AllocatorService
from lzy_tpu_torch.service.allocator import RUNNING as VM_RUNNING
from lzy_tpu_torch.service.graph import GraphDesc, TaskDesc, build_dependencies
from lzy_tpu_torch.utils.clock import SYSTEM_CLOCK
from lzy_tpu_torch.utils.log import get_logger
from lzy_tpu_torch.utils.metrics import REGISTRY

_LOG = get_logger(__name__)

_M_TASKS = REGISTRY.counter("lzy_tasks_total", "task completions by outcome")
_M_GRAPHS = REGISTRY.counter("lzy_graphs_total", "graph completions by outcome")

WAITING = "WAITING"
RUNNING = "RUNNING"
COMPLETED = "COMPLETED"
TASK_FAILED = "FAILED"


class GraphExecutor:
    """The reference's tuning keywords are constants here (its in-process
    cluster's values); an instance may still be re-tuned by attribute."""

    def __init__(
        self,
        store: OperationStore,
        executor: OperationsExecutor,
        allocator: AllocatorService,
        channels=None,
    ):
        self._store = store
        self._executor = executor
        self._allocator = allocator
        self._channels = channels
        self.max_running_tasks = 8
        self.max_running_tasks_per_user = 16
        self.poll_period_s = 0.02
        self.task_timeout_s = 86_400.0   # hard backstop per task action
        # cross-graph fairness accounting: in memory for speed, but every
        # admitted task is a RUNNING entry in its exec_graph op's persisted
        # state, so _restore_admissions() rebuilds the counts on boot
        self._user_running: Dict[str, int] = {}
        self._user_lock = threading.Lock()
        executor.register("exec_graph", self._make_graph_action)
        executor.register("exec_task", self._make_task_action)
        self._restore_admissions()

    def _restore_admissions(self) -> None:
        """Boot-time recovery of per-user running counts from the
        persisted exec_graph op states."""
        counts: Dict[str, int] = {}
        for record in self._store.running_ops():
            if record.kind != "exec_graph":
                continue
            user = record.state.get("user", "")
            running = sum(
                1 for info in record.state.get("tasks", {}).values()
                if info.get("status") == RUNNING
            )
            if running:
                counts[user] = counts.get(user, 0) + running
        with self._user_lock:
            self._user_running = counts

    def execute(self, graph: GraphDesc, session_id: str,
                user: str = "") -> str:
        build_dependencies(graph.tasks)  # validate before accepting
        return self._executor.submit(
            "exec_graph",
            {"graph": graph.to_doc(), "session_id": session_id,
             "user": user, "tasks": {}},
            idempotency_key=f"graph-{graph.id}",
        )

    # -- per-user admission ----------------------------------------------------

    def _try_admit(self, user: str) -> bool:
        with self._user_lock:
            if self._user_running.get(user, 0) >= self.max_running_tasks_per_user:
                return False
            self._user_running[user] = self._user_running.get(user, 0) + 1
            return True

    def _release(self, user: str) -> None:
        with self._user_lock:
            self._user_running[user] = max(0, self._user_running.get(user, 0) - 1)

    def status(self, graph_op_id: str) -> Dict[str, Any]:
        record = self._store.load(graph_op_id)
        return {
            "status": record.status,
            "error": record.error,
            "tasks": record.state.get("tasks", {}),
            "failed_task": record.state.get("failed_task"),
            "exception_uri": record.state.get("exception_uri"),
        }

    def task_timings(self, graph_op_id: str) -> List[Dict[str, Any]]:
        """Per task of the graph: its name, the VM it ran on, ``alloc_s``
        and the worker's ``timings``, as persisted by its action."""
        out = []
        for info in self._store.load(graph_op_id).state.get(
                "tasks", {}).values():
            if not info.get("op_id"):
                continue
            state = self._store.load(info["op_id"]).state
            out.append({"name": info["name"],
                        "vm_ids": state.get("vm_ids", []),
                        "alloc_s": state.get("alloc_s"),
                        **state.get("timings", {})})
        return out

    def stop(self, graph_op_id: str) -> None:
        """Cooperative stop via a dedicated kv flag (not the op state: the
        scheduler's own save_progress would race and overwrite it); the
        scheduler loop checks it each round."""
        self._store.kv_put("graph_stops", graph_op_id, True)

    def _make_graph_action(self, record, store, executor):
        return _ExecGraphAction(record, store, executor, self)

    def _make_task_action(self, record, store, executor):
        return _ExecTaskAction(record, store, executor, self)


class _ExecGraphAction(OperationRunner):
    """Ready-frontier scheduler as one durable polling step."""

    kind = "exec_graph"

    def __init__(self, record, store, executor, svc: GraphExecutor):
        super().__init__(record, store, executor)
        self.svc = svc

    def steps(self):
        return [
            ("init_tasks", self._init_tasks),
            ("schedule", self._schedule),
        ]

    def _init_tasks(self):
        graph = GraphDesc.from_doc(self.state["graph"])
        deps = build_dependencies(graph.tasks)
        self.state["deps"] = {tid: sorted(d) for tid, d in deps.items()}
        self.state["tasks"] = {
            t.id: {"status": WAITING, "op_id": None, "name": t.name}
            for t in graph.tasks
        }
        return StepResult.CONTINUE

    def _schedule(self):
        self.hook("schedule")
        graph = GraphDesc.from_doc(self.state["graph"])
        tasks = self.state["tasks"]
        by_id = {t.id: t for t in graph.tasks}

        # poll running task actions
        user = self.state.get("user", "")
        for tid, info in tasks.items():
            if info["status"] == RUNNING:
                record = self.store.load(info["op_id"])
                if record.status == DONE:
                    info["status"] = COMPLETED
                    self.svc._release(user)
                    _M_TASKS.inc(outcome="completed")
                elif record.status == FAILED:
                    self.svc._release(user)
                    _M_TASKS.inc(outcome="failed")
                    info["status"] = TASK_FAILED
                    self.state["failed_task"] = tid
                    self.state["exception_uri"] = record.state.get("exception_uri")
                    # persist the failure before the runner marks us FAILED:
                    # the client reads it to re-raise the original exception
                    self.store.save_progress(self.record.id, self.state,
                                             self.record.step)
                    raise RuntimeError(
                        f"task {info['name']} ({tid}) failed: {record.error}"
                    )

        if self.store.kv_get("graph_stops", self.record.id):
            raise RuntimeError("graph stopped by user")

        running = sum(1 for i in tasks.values() if i["status"] == RUNNING)
        from lzy_tpu_torch.llm.op import LLM_OP_NAME

        def chain_hot(tid: str) -> bool:
            return any(tasks[d]["status"] == COMPLETED
                       and tasks[d].get("name") == LLM_OP_NAME
                       for d in self.state["deps"][tid])

        # chain-hot first; a stable sort keeps registration order in ties
        frontier = sorted((tid for tid, info in tasks.items()
                           if info["status"] == WAITING),
                          key=lambda tid: not chain_hot(tid))
        for tid in frontier:
            info = tasks[tid]
            if running >= self.svc.max_running_tasks:
                continue
            if all(tasks[d]["status"] == COMPLETED for d in self.state["deps"][tid]):
                if not self.svc._try_admit(user):
                    break  # user at their cross-graph limit; retry next round
                info["op_id"] = self.executor.submit(
                    "exec_task",
                    {"task": by_id[tid].to_doc(),
                     "session_id": self.state["session_id"],
                     "graph_id": graph.id},
                    idempotency_key=f"task-{graph.id}-{tid}",
                    deadline_s=self.svc.task_timeout_s,
                )
                info["status"] = RUNNING
                running += 1

        if all(i["status"] == COMPLETED for i in tasks.values()):
            _M_GRAPHS.inc(outcome="completed")
            return StepResult.finish({"tasks": tasks})
        return StepResult.restart(self.svc.poll_period_s)

    def on_failed(self, error):
        # still-running tasks finish on their own (op-level granularity);
        # release every still-admitted per-user slot: this action is never
        # driven again, so unreleased slots would pin the user forever
        user = self.state.get("user", "")
        for info in self.state.get("tasks", {}).values():
            if info.get("status") == RUNNING:
                self.svc._release(user)
        _M_GRAPHS.inc(outcome="failed")
        _LOG.warning("graph %s failed: %s", self.record.id, error)


class _ExecTaskAction(OperationRunner):
    kind = "exec_task"

    def __init__(self, record, store, executor, svc: GraphExecutor):
        super().__init__(record, store, executor)
        self.svc = svc

    def steps(self):
        return [
            ("allocate", self._allocate),
            ("await_allocation", self._await_allocation),
            ("execute", self._execute),
            ("await_execution", self._await_execution),
            ("cleanup", self._cleanup),
        ]

    @property
    def task(self) -> TaskDesc:
        return TaskDesc.from_doc(self.state["task"])

    def _allocate(self):
        self.hook("allocate")
        if self.state.get("alloc_op_id"):
            return StepResult.ALREADY_DONE
        self.state["alloc_started_at"] = SYSTEM_CLOCK.now()
        self.state["alloc_op_id"] = self.svc._allocator.allocate(
            self.state["session_id"], self.task.pool_label
        )
        return StepResult.CONTINUE

    def _await_allocation(self):
        record = self.store.load(self.state["alloc_op_id"])
        if record.status == FAILED:
            raise RuntimeError(f"gang allocation failed: {record.error}")
        if record.status != DONE:
            return StepResult.restart(self.svc.poll_period_s)
        self.state["vm_ids"] = record.result["vm_ids"]
        self.state["gang_id"] = record.result["gang_id"]
        self.state["alloc_s"] = (SYSTEM_CLOCK.now()
                                 - self.state["alloc_started_at"])
        return StepResult.CONTINUE

    def _execute(self):
        self.hook("execute")
        if self.state.get("worker_op_ids"):
            return StepResult.ALREADY_DONE
        task = self.task
        vm_ids = self.state["vm_ids"]
        # an op resumed right after a control-plane restart may reach here
        # before its workers re-register
        for vm_id in vm_ids:
            try:
                self.svc._allocator.agent(vm_id)
            except KeyError:
                if self._vm_alive(vm_id):
                    return StepResult.restart(0.5)
                raise RuntimeError(f"vm {vm_id} lost before execution")
        gang = {"gang_id": self.state["gang_id"], "vm_ids": vm_ids}
        worker_ops = {}
        for rank, vm_id in enumerate(vm_ids):
            worker_ops[vm_id] = self.svc._allocator.agent(vm_id).execute(
                task, rank, gang)
        self.state["worker_op_ids"] = worker_ops
        return StepResult.CONTINUE

    def _vm_alive(self, vm_id: str) -> bool:
        """VM record present, RUNNING, heartbeat-fresh: the grace window in
        which a worker may be re-registering."""
        try:
            vm = self.svc._allocator.vm(vm_id)
        except KeyError:
            return False
        return vm.status == VM_RUNNING and (
            SYSTEM_CLOCK.time() - vm.heartbeat_ts
            < self.svc._allocator.HEARTBEAT_TIMEOUT_S
        )

    def _probe_worker(self, vm_id: str, worker_op: str) -> Dict[str, Any]:
        lost = {"status": "FAILED", "error": f"vm {vm_id} lost",
                "exception_uri": None}
        try:
            agent = self.svc._allocator.agent(vm_id)
        except KeyError:
            agent = None
        if agent is not None:
            try:
                return agent.status(worker_op)
            except KeyError:
                # a reachable worker that doesn't know the op restarted and
                # lost its op state: the work is gone, fail now
                return {"status": "FAILED",
                        "error": f"worker {vm_id} lost op state",
                        "exception_uri": None}
        if self._vm_alive(vm_id):
            return {"status": "RUNNING", "error": None, "exception_uri": None}
        return lost

    def _await_execution(self):
        task = self.task
        statuses = [self._probe_worker(vm_id, worker_op) for vm_id, worker_op
                    in self.state["worker_op_ids"].items()]
        failed = [s for s in statuses if s["status"] == "FAILED"]
        if failed:
            self.state["exception_uri"] = next(
                (s["exception_uri"] for s in failed if s.get("exception_uri")), None
            )
            # persist exception_uri before the runner marks the op FAILED
            self.store.save_progress(self.record.id, self.state, self.record.step)
            if self.svc._channels is not None:
                for out in task.outputs:
                    try:
                        self.svc._channels.transfer_failed(
                            out.id, f"task {task.name} failed"
                        )
                    except KeyError:
                        pass
            self._free()
            raise RuntimeError(f"task {task.name} failed: {failed[0]['error']}")
        if all(s["status"] == "DONE" for s in statuses):
            self.state["timings"] = statuses[0].get("timings", {})
            return StepResult.CONTINUE
        return StepResult.restart(self.svc.poll_period_s)

    def _cleanup(self):
        self._free()
        return StepResult.finish({"vm_ids": self.state.get("vm_ids", [])})

    def _free(self):
        vm_ids = self.state.get("vm_ids")
        if vm_ids:
            self.svc._allocator.free(vm_ids)

    def on_failed(self, error):
        self._free()

    def on_expired(self):
        self._free()
