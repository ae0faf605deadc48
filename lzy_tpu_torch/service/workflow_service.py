"""Workflow service, the control plane's public API: the port's copy of
``lzy_tpu/service/workflow_service.py``.

Workflow lifecycle (start, finish, abort), graph execution with the
step chain check cache -> create channels -> execute graph, graph status
and stop, pool listing, std-log reads, GC of abandoned executions, and
idempotency keys on every mutation. In-process callers invoke methods
directly (``runtime/remote.RemoteRuntime`` does).

Trimmed: no IAM (every caller is trusted, so the reference's token
arguments and per-subject key scoping are gone), no graphviz view of a
graph (``graph_dot``) and no client-version gate, which waits for a
client across an RPC boundary.
"""

from __future__ import annotations

import json
import threading
from typing import Any, Dict, List, Optional

from lzy_tpu_torch.channels.manager import ChannelManager
from lzy_tpu_torch.durable import RUNNING, OperationsExecutor, OperationStore
from lzy_tpu_torch.service.allocator import AllocatorService
from lzy_tpu_torch.service.graph import GraphDesc, build_dependencies
from lzy_tpu_torch.service.graph_executor import GraphExecutor
from lzy_tpu_torch.storage.api import StorageClient, join_uri
from lzy_tpu_torch.types import PoolSpec
from lzy_tpu_torch.utils.clock import SYSTEM_CLOCK
from lzy_tpu_torch.utils.ids import gen_id
from lzy_tpu_torch.utils.log import get_logger

_LOG = get_logger(__name__)

ACTIVE = "ACTIVE"
FINISHED = "FINISHED"
ABORTED = "ABORTED"


def _replay_error(recorded: str) -> BaseException:
    """Recorded failure ("TypeName: message") -> the matching exception
    type, so a replayed outcome raises what the original did."""
    type_name, _, message = recorded.partition(": ")
    types = {t.__name__: t for t in
             (KeyError, TimeoutError, ValueError, RuntimeError)}
    exc_type = types.get(type_name)
    if exc_type is None:
        return RuntimeError(recorded)
    return exc_type(message or recorded)


class WorkflowService:
    def __init__(
        self,
        store: OperationStore,
        executor: OperationsExecutor,
        allocator: AllocatorService,
        channels: ChannelManager,
        graph_executor: GraphExecutor,
        storage_client: StorageClient,
    ):
        self._clock = SYSTEM_CLOCK
        self._store = store
        self._executor = executor
        self._allocator = allocator
        self._channels = channels
        self._ge = graph_executor
        self._storage = storage_client

    # -- idempotent mutations --------------------------------------------------

    #: a RUNNING idempotency record older than this is an orphan (its
    #: creator crashed between create and complete) and may be reclaimed
    IDEM_INFLIGHT_TTL_S = 120.0

    def _idempotent(self, key: Optional[str], kind: str, fn,
                    wait_s: float = 10.0):
        """Run ``fn`` exactly once per idempotency key. A duplicate request
        (same key: a client retry after a lost reply) replays the
        recorded outcome instead of re-executing; a concurrent duplicate
        waits briefly for the first to finish; a record orphaned RUNNING
        by a crash is taken over (deadline CAS), so the retry after a
        restart still succeeds."""
        if key is None:
            return fn()

        def run_and_record(record_id: str, owned_deadline: float):
            # heartbeat while fn runs: a mutation slower than the TTL must
            # not look like a crash orphan; losing the CAS means someone
            # reclaimed us, and completion is left to the new owner
            stop = self._clock.event()
            deadline_box = [owned_deadline]

            def heartbeat() -> None:
                while not self._clock.wait(stop,
                                           self.IDEM_INFLIGHT_TTL_S / 3):
                    fresh = self._clock.time() + self.IDEM_INFLIGHT_TTL_S
                    if self._store.reclaim(record_id, deadline_box[0], fresh):
                        deadline_box[0] = fresh
                    else:
                        return                     # ownership lost
            beat = threading.Thread(target=heartbeat, daemon=True,
                                    name=f"idem-heartbeat-{kind}")
            beat.start()

            def settle(settle_fn) -> None:
                # quiesce the heartbeat first so deadline_box is final,
                # then settle with a CAS on the owned deadline
                stop.set()
                beat.join(5.0)
                if not settle_fn(if_deadline=deadline_box[0]):
                    _LOG.warning(
                        "idempotent %s (key %s) was reclaimed while this "
                        "executor ran; its outcome is recorded by the new "
                        "owner", kind, key)
            try:
                result = fn()
            except BaseException as e:            # noqa: BLE001 — replayed
                settle(lambda **kw: self._store.fail(
                    record_id, f"{type(e).__name__}: {e}", **kw))
                raise
            settle(lambda **kw: self._store.complete(record_id, result, **kw))
            return result

        op_id = gen_id(f"idem-{kind}")
        first_deadline = self._clock.time() + self.IDEM_INFLIGHT_TTL_S
        rec = self._store.create(op_id, f"idem.{kind}", {},
                                 idempotency_key=key,
                                 deadline=first_deadline)
        if rec.id == op_id:                       # we own the key: execute
            return run_and_record(op_id, first_deadline)
        if rec.kind != f"idem.{kind}":
            # a key reused across different methods must not replay the
            # other call's result as this call's
            raise ValueError(
                f"idempotency key {key!r} was already used for "
                f"{rec.kind.removeprefix('idem.')!r}, not {kind!r}")
        wait_deadline = self._clock.time() + wait_s
        while rec.status == RUNNING:
            if rec.deadline is not None and self._clock.time() > rec.deadline:
                takeover_deadline = self._clock.time() + self.IDEM_INFLIGHT_TTL_S
                if self._store.reclaim(rec.id, rec.deadline,
                                       takeover_deadline):
                    _LOG.warning(
                        "taking over orphaned idempotent %s (key %s)",
                        kind, key)
                    return run_and_record(rec.id, takeover_deadline)
            elif self._clock.time() > wait_deadline:
                raise RuntimeError(
                    f"request with idempotency key {key!r} still in flight")
            self._clock.sleep(0.05)
            rec = self._store.load(rec.id)
        if rec.error is not None:
            raise _replay_error(rec.error)
        _LOG.info("idempotent replay of %s (key %s)", kind, key)
        return rec.result

    # -- workflow lifecycle ----------------------------------------------------

    def start_workflow(self, user: str, workflow_name: str, storage_uri: str,
                       execution_id: Optional[str] = None, *,
                       idempotency_key: Optional[str] = None) -> str:
        return self._idempotent(
            idempotency_key, "start_workflow",
            lambda: self._start_workflow(
                user, workflow_name, storage_uri, execution_id),
        )

    def _start_workflow(self, user: str, workflow_name: str, storage_uri: str,
                        execution_id: Optional[str] = None) -> str:
        execution_id = execution_id or gen_id(f"exec-{workflow_name}")
        if self._store.kv_get("executions", execution_id) is not None:
            # a client-chosen id must not overwrite an existing execution
            raise RuntimeError(f"execution {execution_id!r} already exists")
        session_id = self._allocator.create_session(owner=user)
        self._store.kv_put("executions", execution_id, {
            "user": user,
            "workflow_name": workflow_name,
            "storage_uri": storage_uri,
            "session_id": session_id,
            "status": ACTIVE,
            "graphs": [],
            "started_at": self._clock.time(),
        })
        _LOG.info("started execution %s (session %s)", execution_id, session_id)
        return execution_id

    def finish_workflow(self, execution_id: str, *,
                        idempotency_key: Optional[str] = None) -> None:
        self._idempotent(idempotency_key, "finish_workflow",
                         lambda: self._teardown(execution_id, FINISHED))

    def abort_workflow(self, execution_id: str, *,
                       idempotency_key: Optional[str] = None) -> None:
        self._idempotent(idempotency_key, "abort_workflow",
                         lambda: self._abort(execution_id))

    def _abort(self, execution_id: str) -> None:
        exec_doc = self._execution(execution_id)
        for graph_op_id in exec_doc.get("graphs", []):
            try:
                self._ge.stop(graph_op_id)
            except KeyError:
                pass
        self._teardown(execution_id, ABORTED)

    def _teardown(self, execution_id: str, final_status: str) -> None:
        exec_doc = self._execution(execution_id)
        self._channels.destroy_all(execution_id)
        self._allocator.delete_session(exec_doc["session_id"])
        exec_doc["status"] = final_status
        exec_doc["finished_at"] = self._clock.time()
        self._store.kv_put("executions", execution_id, exec_doc)

    def _execution(self, execution_id: str) -> Dict[str, Any]:
        doc = self._store.kv_get("executions", execution_id)
        if doc is None:
            raise KeyError(f"unknown execution {execution_id!r}")
        return doc

    # -- graphs ----------------------------------------------------------------

    def execute_graph(self, execution_id: str, graph_doc: Dict[str, Any], *,
                      idempotency_key: Optional[str] = None) -> Optional[str]:
        """Compile and run a graph. Returns the graph op id, or None when
        every task was satisfied from cache."""
        return self._idempotent(
            idempotency_key, "execute_graph",
            lambda: self._execute_graph(execution_id, graph_doc),
        )

    def _execute_graph(self, execution_id: str,
                       graph_doc: Dict[str, Any]) -> Optional[str]:
        exec_doc = self._execution(execution_id)
        if exec_doc["status"] != ACTIVE:
            raise RuntimeError(f"execution {execution_id} is {exec_doc['status']}")
        graph = GraphDesc.from_doc(graph_doc)
        build_dependencies(graph.tasks)                      # cycle/dup check

        # check cache: drop tasks whose outputs are already durable
        remaining = [t for t in graph.tasks if not self._cached(t)]
        dropped = {t.id for t in graph.tasks} - {t.id for t in remaining}
        if dropped:
            _LOG.info("cache drops %d/%d tasks", len(dropped),
                      len(graph.tasks))
            llm_drops = sum(1 for t in graph.tasks if t.id in dropped
                            and t.name in ("llm_generate",
                                           "llm_generate_batch"))
            if llm_drops:
                # a cache-dropped generation never touches the fleet (the
                # llm metrics module is a leaf: no import cycle)
                from lzy_tpu_torch.llm.metrics import CACHED_HITS

                CACHED_HITS.inc(llm_drops)

        # create channels: every entry of the remaining tasks gets one;
        # channels for inputs that already exist in storage open completed
        produced = {o.id for t in remaining for o in t.outputs}
        for t in remaining:
            for ref in t.outputs + t.input_entries:
                ch = self._channels.get_or_create(execution_id, ref.id, ref.uri)
                if ref.id not in produced and not ch.completed:
                    if self._storage.exists(ref.uri):
                        self._channels.transfer_completed(ref.id)

        if not remaining:
            return None
        graph = GraphDesc(id=graph.id, execution_id=execution_id,
                          storage_uri=graph.storage_uri, tasks=remaining)
        graph_op_id = self._ge.execute(
            graph, exec_doc["session_id"], user=exec_doc.get("user", "")
        )
        exec_doc["graphs"].append(graph_op_id)
        self._store.kv_put("executions", execution_id, exec_doc)
        return graph_op_id

    def _cached(self, task) -> bool:
        """Every output and its sidecar are in storage, the sidecar
        reads, and no output is marked not cacheable (an op-vetoed
        result, such as a deadline-truncated generation)."""
        for o in task.outputs:
            if not (self._storage.exists(o.uri)
                    and self._storage.exists(o.uri + ".meta")):
                return False
            try:
                doc = json.loads(self._storage.read_bytes(o.uri + ".meta"))
            except Exception:  # noqa: BLE001 — unreadable meta: no hit
                return False
            if doc.get("cacheable", True) is False:
                return False
        return True

    def graph_status(self, execution_id: str, graph_op_id: str) -> Dict[str, Any]:
        return self._ge.status(graph_op_id)

    def stop_graph(self, execution_id: str, graph_op_id: str, *,
                   idempotency_key: Optional[str] = None) -> None:
        self._idempotent(idempotency_key, "stop_graph",
                         lambda: self._ge.stop(graph_op_id))

    # -- GC: reap abandoned executions -----------------------------------------

    def gc_tick(self, *, ttl_s: float = 86_400.0,
                idem_ttl_s: float = 86_400.0,
                now: Optional[float] = None) -> List[str]:
        """Abort ACTIVE executions older than ``ttl_s`` (clients that died
        without finish or abort); returns the reaped execution ids. Also
        purges settled idempotency records older than ``idem_ttl_s``."""
        now = now if now is not None else self._clock.time()
        purged = self._store.purge_done_ops("idem.", idem_ttl_s)
        if purged:
            _LOG.info("gc purged %d settled idempotency records", purged)
        reaped = []
        for execution_id, doc in self._store.kv_list("executions").items():
            if doc.get("status") == ACTIVE and now - doc.get("started_at", now) > ttl_s:
                _LOG.warning("gc aborting stale execution %s", execution_id)
                try:
                    self._abort(execution_id)
                    reaped.append(execution_id)
                except Exception:
                    _LOG.exception("gc failed to abort %s", execution_id)
        return reaped

    # -- pools -----------------------------------------------------------------

    def get_pool_specs(self) -> List[PoolSpec]:
        return self._allocator.pools

    # -- std logs (poll-based, with resume offsets) ----------------------------

    def read_std_logs(self, execution_id: str,
                      offsets: Optional[Dict[str, int]] = None) -> Dict[str, str]:
        """Task id -> stdout/stderr text past the caller's byte offset.
        Only the execution's own log prefix is listed and only fresh
        suffixes are read."""
        offsets = offsets or {}
        exec_doc = self._execution(execution_id)
        prefix = join_uri(
            exec_doc["storage_uri"], "lzy_runs",
            exec_doc["workflow_name"], execution_id, "logs",
        )
        out: Dict[str, str] = {}
        for uri in self._storage.list(prefix):
            if not uri.endswith(".log"):
                continue
            task_id = uri.rsplit("/", 1)[1][:-4]
            seen = offsets.get(task_id, 0)
            size = self._storage.size(uri)
            if size > seen:
                out[task_id] = self._storage.read_range(uri, seen).decode("utf-8")
        return out
