"""LocalRuntime: in-process execution of the call queue, the port's copy
of ``lzy_tpu/runtime/local.py``.

No services and no network: calls run in dependency order in the
current process, but the data path is the real one (args and results
round-trip through the snapshot's serializers and storage). An op's
exception is stored at the call's exception entry and re-raised for the
client with the original traceback attached as a note. A cache hit calls
the op's ``__lzy_on_cache_hit__`` hook, and a result the op vetoes
(``core.call.result_cacheable``) is stored marked not cacheable.
"""

from __future__ import annotations

import traceback
from typing import TYPE_CHECKING, Dict, List, Sequence, Set

from lzy_tpu_torch.core.call import result_cacheable
from lzy_tpu_torch.core.workflow import RemoteCallError
from lzy_tpu_torch.runtime.api import Runtime
from lzy_tpu_torch.utils.env import applied_env_vars
from lzy_tpu_torch.utils.log import get_logger

if TYPE_CHECKING:
    from lzy_tpu_torch.core.call import LzyCall
    from lzy_tpu_torch.core.workflow import LzyWorkflow

_LOG = get_logger(__name__)


class LocalRuntime(Runtime):
    def in_process(self) -> bool:
        return True

    def start(self, workflow: "LzyWorkflow") -> None:
        _LOG.info("local execution of %s started", workflow.execution_id)

    def finish(self, workflow: "LzyWorkflow") -> None:
        _LOG.info("local execution of %s finished", workflow.execution_id)

    def abort(self, workflow: "LzyWorkflow") -> None:
        _LOG.info("local execution of %s aborted", workflow.execution_id)

    def exec(self, workflow: "LzyWorkflow", calls: Sequence["LzyCall"]) -> None:
        for call in self._topo_order(calls):
            self._exec_one(workflow, call)

    @staticmethod
    def _topo_order(calls: Sequence["LzyCall"]) -> List["LzyCall"]:
        """Dependency (DFS post-) order. Registration order is already
        valid, since proxies only reference earlier calls; sorting keeps
        the runtime correct if callers ever reorder."""
        by_output: Dict[str, "LzyCall"] = {}
        for c in calls:
            for eid in c.result_entry_ids:
                by_output[eid] = c
        ordered: List["LzyCall"] = []
        visited: Set[str] = set()

        def visit(c: "LzyCall") -> None:
            if c.id in visited:
                return
            visited.add(c.id)
            for eid in c.input_entry_ids:
                dep = by_output.get(eid)
                if dep is not None:
                    visit(dep)
            ordered.append(c)

        for c in calls:
            visit(c)
        return ordered

    def _exec_one(self, workflow: "LzyWorkflow", call: "LzyCall") -> None:
        snapshot = workflow.snapshot
        if call.cache_settings.cache and self._cache_hit(workflow, call):
            _LOG.info("cache hit, skipping op %s", call.op_name)
            # an op that counts its skips (llm_generate) opts in through a
            # function attribute; the hook never fails the hit it reports
            hook = getattr(call.signature.func, "__lzy_on_cache_hit__",
                           None)
            if hook is not None:
                try:
                    hook()
                except Exception:  # noqa: BLE001 — observability only
                    _LOG.exception("on-cache-hit hook failed for %s",
                                   call.op_name)
            return

        args = tuple(snapshot.get(eid) for eid in call.arg_entry_ids)
        kwargs = {k: snapshot.get(eid) for k, eid in call.kwarg_entry_ids.items()}
        try:
            with applied_env_vars(call.env.env_vars):
                result = call.signature.func(*args, **kwargs)
        except BaseException as e:
            self._store_exception(workflow, call, e)
            raise RemoteCallError(call.op_name, e) from e

        outputs = (
            result
            if call.signature.output_count > 1 and isinstance(result, tuple)
            else (result,)
        )
        if len(outputs) != call.signature.output_count:
            e = ValueError(
                f"op {call.op_name}() returned {len(outputs)} values, "
                f"declared {call.signature.output_count}"
            )
            self._store_exception(workflow, call, e)
            raise RemoteCallError(call.op_name, e) from e
        cacheable = True
        if call.cache_settings.cache:
            cacheable = result_cacheable(call.signature.func, result)
        for eid, value in zip(call.result_entry_ids, outputs):
            snapshot.put(eid, value, cacheable=cacheable)

    @staticmethod
    def _cache_hit(workflow: "LzyWorkflow", call: "LzyCall") -> bool:
        """Every result object (and its sidecar) already exists at the
        cache URIs: rehydrate the entries and skip the op. Restoring the
        real content hash keeps downstream cache keys stable."""
        snapshot = workflow.snapshot
        return all(snapshot.try_restore_entry(eid) for eid in call.result_entry_ids)

    @staticmethod
    def _store_exception(workflow: "LzyWorkflow", call: "LzyCall",
                         e: BaseException) -> None:
        tb = "".join(traceback.format_exception(type(e), e, e.__traceback__))
        e.add_note(f"[remote traceback]\n{tb}")
        workflow.snapshot.put(call.exception_entry_id, e)
