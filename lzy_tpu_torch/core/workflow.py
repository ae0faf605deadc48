"""LzyWorkflow: the ``with lzy.workflow("name"):`` context manager, the
port's copy of ``lzy_tpu/core/workflow.py``.

A workflow owns the call queue, the snapshot and the runtime session;
``barrier()`` flushes queued calls through the runtime. Before execution
the results of cacheable calls are re-pointed into the shared cache
namespace ``lzy_cache/ops/<name>/<version>/<input-key>``, so a repeated
run skips the ops whose results are already there.

The active workflow is per thread and per package: the port's slot is
its own, so a reference workflow and a port workflow never see each
other.
"""

from __future__ import annotations

import threading
from typing import TYPE_CHECKING, Any, List, Optional

from lzy_tpu_torch.core.call import LzyCall
from lzy_tpu_torch.env.environment import LzyEnvironment
from lzy_tpu_torch.snapshot import Snapshot
from lzy_tpu_torch.storage.api import join_uri
from lzy_tpu_torch.utils import hashing
from lzy_tpu_torch.utils.ids import gen_id

if TYPE_CHECKING:
    from lzy_tpu_torch.core.lzy import Lzy


class WorkflowError(RuntimeError):
    pass


class RemoteCallError(WorkflowError):
    """An op failed; carries the original exception, re-raised for the
    client with its traceback attached as a note."""

    def __init__(self, call_name: str, cause: BaseException):
        super().__init__(f"op {call_name!r} failed: {cause!r}")
        self.__cause__ = cause


class LzyWorkflow:
    # thread-local: a thread running an op body may host its own (nested)
    # workflow; only same-thread nesting is an error
    _tls = threading.local()

    def __init__(
        self,
        lzy: "Lzy",
        name: str,
        env: LzyEnvironment,
    ):
        self._lzy = lzy
        self._name = name
        self._env = env
        self._call_queue: List[LzyCall] = []
        self._started = False
        self._execution_id = gen_id(f"exec-{name}")
        self._snapshot: Optional[Snapshot] = None
        self._whiteboards: List[Any] = []

    # -- accessors -------------------------------------------------------------

    @property
    def name(self) -> str:
        return self._name

    @property
    def execution_id(self) -> str:
        return self._execution_id

    @property
    def owner(self) -> "Lzy":
        return self._lzy

    @property
    def env(self) -> LzyEnvironment:
        return self._env

    @property
    def snapshot(self) -> Snapshot:
        if self._snapshot is None:
            raise WorkflowError(f"workflow {self._name!r} is not started")
        return self._snapshot

    @classmethod
    def get_active(cls) -> Optional["LzyWorkflow"]:
        return getattr(cls._tls, "wf", None)

    # -- lifecycle -------------------------------------------------------------

    def __enter__(self) -> "LzyWorkflow":
        active = LzyWorkflow.get_active()
        if active is not None:
            raise WorkflowError(
                f"workflow {active.name!r} is already active in this thread; "
                "nested workflows must run from inside an op (their own "
                "execution context)"
            )
        storage = self._lzy.storage_registry.default_client()
        config = self._lzy.storage_registry.default_config()
        if storage is None or config is None:
            raise WorkflowError(
                "no storage registered; call lzy.storage_registry.register_storage()"
            )
        self._snapshot = Snapshot(
            workflow_name=self._name,
            execution_id=self._execution_id,
            storage_client=storage,
            storage_prefix=config.uri,
            serializers=self._lzy.serializer_registry,
        )
        self._lzy.runtime.start(self)
        self._started = True
        LzyWorkflow._tls.wf = self
        return self

    def __exit__(self, exc_type, exc_val, exc_tb) -> None:
        failed = exc_type is not None
        try:
            if not failed:
                self.barrier()
                self._finalize_whiteboards()
        except BaseException:
            failed = True  # the exit barrier itself failed: abort, not finish
            raise
        finally:
            LzyWorkflow._tls.wf = None
            self._started = False
            if failed:
                self._call_queue.clear()
                self._lzy.runtime.abort(self)
            else:
                self._lzy.runtime.finish(self)

    # -- calls -----------------------------------------------------------------

    def register_call(self, call: LzyCall) -> None:
        if not self._started:
            raise WorkflowError("cannot register a call on a finished workflow")
        self._call_queue.append(call)

    def barrier(self) -> None:
        """Execute all queued calls; returns when their results are stored."""
        if not self._call_queue:
            return
        queue, self._call_queue = self._call_queue, []
        self._assign_cache_uris(queue)
        self._lzy.runtime.exec(self, queue)

    def _assign_cache_uris(self, queue: List[LzyCall]) -> None:
        """Re-point cacheable results at ``<storage>/lzy_cache/ops/<op>/
        <version>/<key>/return_<i>``.

        The key must be identical across executions. Content hashes cover
        materialized inputs (local args, results of earlier barriers); a
        result still pending in this batch enters by its *lineage key*,
        hash(op name, version, input keys) computed in registration order,
        so a cached op stays cacheable downstream of non-cached producers
        whose output URIs are execution-scoped. The arguments a call's
        ``CacheSettings.exclude_args`` names are left out of its key."""
        snapshot = self.snapshot
        lineage: dict = {}
        for call in queue:
            parts = [call.op_name, call.cache_settings.version]
            named_inputs = list(zip(call.signature.param_names, call.arg_entry_ids))
            named_inputs += sorted(call.kwarg_entry_ids.items())
            excluded = set(call.cache_settings.exclude_args)
            named_inputs = [(n, e) for n, e in named_inputs
                            if n not in excluded]
            for name, eid in named_inputs:
                entry = snapshot.get_entry(eid)
                if entry.hash:
                    parts.append(f"{name}={entry.hash}")
                elif eid in lineage:
                    parts.append(f"{name}={lineage[eid]}")
                else:
                    parts.append(f"{name}={entry.storage_uri}")  # unknown provenance
            key = hashing.combine_hashes(parts)
            for i, eid in enumerate(call.result_entry_ids):
                lineage[eid] = f"{key}:{i}"
            if call.cache_settings.cache:
                base = join_uri(
                    self._lzy.storage_registry.default_config().uri,
                    "lzy_cache", "ops", call.op_name, call.cache_settings.version, key,
                )
                for i, eid in enumerate(call.result_entry_ids):
                    snapshot.update_entry_uri(eid, join_uri(base, f"return_{i}"))

    # -- whiteboards -----------------------------------------------------------

    def create_whiteboard(self, typ, *, tags=()):
        from lzy_tpu_torch.whiteboards.wb import WritableWhiteboard

        wb = WritableWhiteboard(self, typ, tags=tags)
        self._whiteboards.append(wb)
        return wb

    def _finalize_whiteboards(self) -> None:
        for wb in self._whiteboards:
            wb._finalize()
        self._whiteboards.clear()
