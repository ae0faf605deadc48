"""RemoteRuntime: executes the call queue through the control plane, the
port's copy of ``lzy_tpu/runtime/remote.py``.

``exec`` turns the queue into task descriptions (the pickled op, entry
assignments, the pool every op resolves to), submits the graph to the
workflow service, polls its status, streams remote std-logs with
``[LZY-REMOTE-<task>]`` prefixes and, on failure, loads the pickled
exception and re-raises it with the remote traceback attached.

The ``client`` is an object with the ``WorkflowService`` method surface:
here the in-process service itself (``service/harness.InProcessCluster.
client``). The RPC client (``RpcWorkflowClient``) and tokens wait for
the RPC control plane, and so do the client-version gate and the
reference's timeout and clock keywords. Ops pickle by module reference
(``LzyOp.__reduce__``) with ``cloudpickle`` where it is importable,
else ``pickle``.
"""

from __future__ import annotations

import pickle
import sys
from typing import TYPE_CHECKING, Dict, List, Sequence

from lzy_tpu_torch.core.workflow import RemoteCallError
from lzy_tpu_torch.env.provisioning import Provisioning
from lzy_tpu_torch.runtime.api import Runtime
from lzy_tpu_torch.serialization.basic import pickler
from lzy_tpu_torch.service.graph import EntryRef, GraphDesc, TaskDesc
from lzy_tpu_torch.storage.api import join_uri
from lzy_tpu_torch.utils.clock import SYSTEM_CLOCK
from lzy_tpu_torch.utils.ids import gen_id
from lzy_tpu_torch.utils.log import get_logger

if TYPE_CHECKING:
    from lzy_tpu_torch.core.call import LzyCall
    from lzy_tpu_torch.core.workflow import LzyWorkflow

_LOG = get_logger(__name__)


class RemoteRuntime(Runtime):
    #: a graph still running after this long is stopped and fails
    GRAPH_TIMEOUT_S = 600.0
    #: how often a running graph's status is polled
    POLL_PERIOD_S = 0.02

    def __init__(self, client, *, user: str, stream_logs: bool):
        self._clock = SYSTEM_CLOCK
        self._client = client
        self._user = user
        self._stream_logs = stream_logs
        self._printed_logs: Dict[str, int] = {}

    def auth_context(self) -> dict:
        """The session identity (never a credential)."""
        return {"user": self._user}

    # -- Runtime ---------------------------------------------------------------

    def start(self, workflow: "LzyWorkflow") -> None:
        config = workflow.owner.storage_registry.default_config()
        self._client.start_workflow(
            self._user, workflow.name, config.uri,
            execution_id=workflow.execution_id,
        )

    def finish(self, workflow: "LzyWorkflow") -> None:
        self._client.finish_workflow(workflow.execution_id)

    def abort(self, workflow: "LzyWorkflow") -> None:
        self._client.abort_workflow(workflow.execution_id)

    def exec(self, workflow: "LzyWorkflow", calls: Sequence["LzyCall"]) -> None:
        graph = self._build_graph(workflow, calls)
        self._confirm_pools(workflow, graph)
        graph_op_id = self._client.execute_graph(
            workflow.execution_id, graph.to_doc())
        if graph_op_id is None:
            _LOG.info("results of all graph operations are cached")
        else:
            self._poll_until_done(workflow, graph_op_id, calls)
        for call in calls:
            for eid in call.result_entry_ids:
                workflow.snapshot.try_restore_entry(eid)

    # -- graph build -----------------------------------------------------------

    def _build_graph(self, workflow: "LzyWorkflow",
                     calls: Sequence["LzyCall"]) -> GraphDesc:
        snapshot = workflow.snapshot
        config = workflow.owner.storage_registry.default_config()
        pool = Provisioning().resolve_pool(self._client.get_pool_specs())
        tasks: List[TaskDesc] = []
        for call in calls:
            func_uri = join_uri(snapshot.storage_prefix, "fns", call.id)
            snapshot.storage_client.write_bytes(
                func_uri, pickler().dumps(call.signature.remote_payload))

            def ref(eid: str, name: str = "") -> EntryRef:
                return EntryRef(id=eid, uri=snapshot.get_entry(eid).storage_uri,
                                name=name)

            tasks.append(TaskDesc(
                id=call.id,
                name=call.op_name,
                func_uri=func_uri,
                args=[ref(eid, n) for n, eid in
                      zip(call.signature.param_names, call.arg_entry_ids)],
                kwargs={k: ref(eid, k) for k, eid in call.kwarg_entry_ids.items()},
                outputs=[ref(eid, f"return_{i}")
                         for i, eid in enumerate(call.result_entry_ids)],
                exception=ref(call.exception_entry_id, "exception"),
                pool_label=pool.label,
                gang_size=pool.hosts,
                env_vars=dict(call.env.env_vars),
                std_logs_uri=join_uri(snapshot.storage_prefix, "logs"),
            ))
        return GraphDesc(
            id=gen_id("graph"),
            execution_id=workflow.execution_id,
            storage_uri=config.uri,
            tasks=tasks,
        )

    def _confirm_pools(self, workflow: "LzyWorkflow", graph: GraphDesc) -> None:
        """Interactive pool-mapping confirmation before spending money on
        machines. Fires only on a terminal; CI and tests never see it.
        The reference's ``workflow(interactive=False)`` opt-out comes
        back with the slice that first calls it."""
        if not sys.stdin.isatty():
            return
        lines = [f"  {t.name}: pool={t.pool_label} hosts={t.gang_size}"
                 for t in graph.tasks]
        print("About to run on:", file=sys.stderr)
        print("\n".join(lines), file=sys.stderr)
        # prompt on stderr (stdout may be redirected), default NO
        print("Proceed? (Yes/[No]) ", end="", file=sys.stderr, flush=True)
        answer = input().strip().lower()
        if answer not in ("y", "yes"):
            from lzy_tpu_torch.core.workflow import WorkflowError

            raise WorkflowError("graph execution declined by user")

    # -- polling ---------------------------------------------------------------

    def _poll_until_done(self, workflow: "LzyWorkflow", graph_op_id: str,
                         calls: Sequence["LzyCall"]) -> None:
        deadline = self._clock.time() + self.GRAPH_TIMEOUT_S
        while True:
            status = self._client.graph_status(workflow.execution_id,
                                               graph_op_id)
            if self._stream_logs:
                self._pump_logs(workflow)
            if status["status"] == "DONE":
                return
            if status["status"] == "FAILED":
                self._raise_remote(workflow, status, calls)
            if self._clock.time() > deadline:
                self._client.stop_graph(workflow.execution_id, graph_op_id)
                raise TimeoutError(
                    f"graph {graph_op_id} still running after {self.GRAPH_TIMEOUT_S}s"
                )
            self._clock.sleep(self.POLL_PERIOD_S)

    def _pump_logs(self, workflow: "LzyWorkflow") -> None:
        try:
            logs = self._client.read_std_logs(workflow.execution_id,
                                              dict(self._printed_logs))
        except Exception:
            return
        for task_id, fresh in logs.items():
            self._printed_logs[task_id] = (
                self._printed_logs.get(task_id, 0) + len(fresh.encode("utf-8"))
            )
            for line in fresh.splitlines():
                print(f"[LZY-REMOTE-{task_id}] {line}", file=sys.stderr)

    def _raise_remote(self, workflow: "LzyWorkflow", status: Dict,
                      calls: Sequence["LzyCall"]) -> None:
        exception_uri = status.get("exception_uri")
        failed_call = next(
            (c for c in calls if c.id == status.get("failed_task")), None
        )
        name = failed_call.op_name if failed_call else (status.get("failed_task") or "?")
        if exception_uri:
            client = workflow.snapshot.storage_client
            try:
                cause = pickle.loads(client.read_bytes(exception_uri))
            except Exception as load_err:
                cause = RuntimeError(
                    f"remote failure (exception not loadable: {load_err}): "
                    f"{status.get('error')}"
                )
            raise RemoteCallError(name, cause) from cause
        raise RemoteCallError(name, RuntimeError(status.get("error") or "unknown"))
