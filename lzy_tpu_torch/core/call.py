"""LzyCall: one registered op invocation, the port's copy of
``lzy_tpu/core/call.py``.

A call owns the snapshot entries of its args, kwargs, results and
exception, the merged environment (``lzy.env (+) workflow.env (+)
op.env``), its cache settings, and builds the proxies of its results.
Local (non-proxy) argument values are uploaded to the snapshot at call
time, so the graph is described by entry ids alone.
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Any, Dict, Tuple

from lzy_tpu_torch.core.signatures import CallSignature
from lzy_tpu_torch.env.environment import LzyEnvironment
from lzy_tpu_torch.proxy.automagic import (
    get_proxy_entry_id, is_lzy_proxy, lzy_proxy, materialize)
from lzy_tpu_torch.utils.ids import gen_id

if TYPE_CHECKING:
    from lzy_tpu_torch.core.workflow import LzyWorkflow


@dataclasses.dataclass(frozen=True)
class CacheSettings:
    cache: bool = False
    version: str = "0.0"
    #: arg names (bound positional or keyword) left out of the cache key:
    #: operational knobs that cannot change the output (``llm.generate``
    #: threads its timeouts, deadline and stream wiring through here)
    exclude_args: Tuple[str, ...] = ()


def result_cacheable(func: Any, result: Any) -> bool:
    """Per-RESULT cache veto, asked by every runtime before a cacheable
    op's output is stored at its cache URI. An op that can return a
    degraded but valid value (a deadline-truncated generation) sets
    ``func.__lzy_result_cacheable__ = lambda result: ...``; a vetoed
    result is still stored for this execution's consumers but never
    satisfies a later cache check. A probe that fails vetoes."""
    probe = getattr(func, "__lzy_result_cacheable__", None)
    if probe is None:
        return True
    try:
        return bool(probe(result))
    except Exception:  # noqa: BLE001 — conservative: do not cache
        return False


class LzyCall:
    def __init__(
        self,
        workflow: "LzyWorkflow",
        signature: CallSignature,
        env: LzyEnvironment,
        cache: CacheSettings,
        lazy_arguments: bool = True,
    ):
        self._id = gen_id("call")
        self._wf = workflow
        self._sig = signature
        self._env = env
        self._cache = cache
        self._lazy_arguments = lazy_arguments

        snapshot = workflow.snapshot
        self._arg_entry_ids: Tuple[str, ...] = tuple(
            self._entry_for_value(f"{self.op_name}/{name}", value, typ)
            for name, value, typ in zip(
                signature.param_names, signature.args, signature.arg_types
            )
        )
        self._kwarg_entry_ids: Dict[str, str] = {
            k: self._entry_for_value(f"{self.op_name}/{k}", v, signature.kwarg_types[k])
            for k, v in signature.kwargs.items()
        }
        self._result_entry_ids: Tuple[str, ...] = tuple(
            snapshot.create_entry(f"{self.op_name}/return_{i}", typ).id
            for i, typ in enumerate(signature.output_types)
        )
        self._exception_entry_id: str = snapshot.create_entry(
            f"{self.op_name}/exception"
        ).id

    def _entry_for_value(self, name: str, value: Any, typ) -> str:
        if is_lzy_proxy(value):
            if self._lazy_arguments:
                return get_proxy_entry_id(value)
            # lazy_arguments=False: force the producer now, pass by value
            value = materialize(value)
        entry = self._wf.snapshot.create_entry(name, typ)
        self._wf.snapshot.put(entry.id, value)
        return entry.id

    # -- identity --------------------------------------------------------------

    @property
    def id(self) -> str:
        return self._id

    @property
    def op_name(self) -> str:
        return self._sig.name

    @property
    def signature(self) -> CallSignature:
        return self._sig

    @property
    def env(self) -> LzyEnvironment:
        return self._env

    @property
    def cache_settings(self) -> CacheSettings:
        return self._cache

    @property
    def workflow(self) -> "LzyWorkflow":
        return self._wf

    # -- graph edges -----------------------------------------------------------

    @property
    def arg_entry_ids(self) -> Tuple[str, ...]:
        return self._arg_entry_ids

    @property
    def kwarg_entry_ids(self) -> Dict[str, str]:
        return dict(self._kwarg_entry_ids)

    @property
    def input_entry_ids(self) -> Tuple[str, ...]:
        return self._arg_entry_ids + tuple(self._kwarg_entry_ids.values())

    @property
    def result_entry_ids(self) -> Tuple[str, ...]:
        return self._result_entry_ids

    @property
    def exception_entry_id(self) -> str:
        return self._exception_entry_id

    # -- results ---------------------------------------------------------------

    def build_results(self) -> Any:
        """Proxies per output; ``bool``/``None`` outputs materialize
        eagerly (they cannot be proxied)."""
        results = tuple(
            self._one_result(entry_id, typ)
            for entry_id, typ in zip(self._result_entry_ids, self._sig.output_types)
        )
        return results[0] if len(results) == 1 else results

    def _one_result(self, entry_id: str, typ) -> Any:
        if typ in (bool, type(None)):
            self._wf.barrier()
            return self._wf.snapshot.get(entry_id)

        def materialize_fn(eid: str = entry_id) -> Any:
            self._wf.barrier()
            return self._wf.snapshot.get(eid)

        return lzy_proxy(materialize_fn, entry_id, typ)
