"""The ``@op`` decorator: the port's copy of ``lzy_tpu/core/op.py``.

Inside an active workflow a decorated call registers lazily and returns
proxies; outside one it just runs the function. An op pickles by module
reference (``LzyOp.__reduce__``), so a remote worker needs neither a
copy of it nor ``cloudpickle``. The reference's
``tpu=`` shorthand (a TPU slice requirement) is not an option here: the
keyword is unknown and fails with ``TypeError`` until the GPU
provisioning slice gives ops an accelerator requirement.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Optional

from lzy_tpu_torch.core.call import CacheSettings, LzyCall
from lzy_tpu_torch.core.signatures import infer_and_validate_call_signature
from lzy_tpu_torch.core.workflow import LzyWorkflow
from lzy_tpu_torch.env.environment import LzyEnvironment, WithEnvironmentMixin


class LzyOp(WithEnvironmentMixin):
    """The wrapper ``@op`` produces; carries the op's environment and the
    fluent ``with_*`` modifiers."""

    def __init__(
        self,
        func: Callable,
        env: LzyEnvironment,
        *,
        cache: bool = False,
        version: str = "0.0",
        lazy_arguments: bool = True,
    ):
        functools.update_wrapper(self, func)
        self.func = func
        self.env = env
        self.cache_settings = CacheSettings(cache=cache, version=version)
        self.lazy_arguments = lazy_arguments

    def __call__(self, *args: Any, **kwargs: Any) -> Any:
        wf = LzyWorkflow.get_active()
        if wf is None:
            return self.func(*args, **kwargs)

        signature = infer_and_validate_call_signature(
            self.func, *args, payload=self, **kwargs
        )
        call = LzyCall(
            workflow=wf,
            signature=signature,
            env=wf.owner.env.combine(wf.env).combine(self.env),
            cache=self.cache_settings,
            lazy_arguments=self.lazy_arguments,
        )
        wf.register_call(call)
        return call.build_results()

    def __get__(self, instance, owner=None):
        if instance is None:
            return self
        return functools.partial(self, instance)

    def __reduce__(self):
        """Pickle by module reference when this op is a module-level
        attribute of an importable module: a worker then resolves the very
        same object (shared module state stays shared, and the payload is
        a name), and no ``cloudpickle`` is needed. Anything else pickles
        by value, through ``cloudpickle`` where it is importable.

        A ``__main__`` op (a script's) pickles by reference too, and
        resolves only in an interpreter whose ``__main__`` holds it: the
        thread workers'. The by-value copy that a process worker would
        need comes back with process workers."""
        import sys

        target = sys.modules.get(getattr(self, "__module__", None))
        try:
            for part in self.__qualname__.split("."):
                target = getattr(target, part)
        except AttributeError:
            target = None
        if target is not self:
            return super().__reduce__()
        if self.__module__ == "__main__":
            return (_resolve_main_op, (self.__qualname__,))
        return (_resolve_op, (self.__module__, self.__qualname__))


def _resolve_op(module: str, qualname: str) -> "LzyOp":
    import importlib

    obj = importlib.import_module(module)
    for part in qualname.split("."):
        obj = getattr(obj, part)
    return obj


def _resolve_main_op(qualname: str) -> "LzyOp":
    """Loader for ``__main__`` ops: the live object of this
    interpreter's ``__main__``."""
    import sys

    obj = sys.modules.get("__main__")
    try:
        for part in qualname.split("."):
            obj = getattr(obj, part)
    except AttributeError:
        obj = None
    if not (isinstance(obj, LzyOp) and obj.__qualname__ == qualname):
        raise RuntimeError(
            f"op {qualname!r} was defined in __main__ and this interpreter "
            f"does not have it; define it in an importable module")
    return obj


def op(
    func: Optional[Callable] = None,
    *,
    cache: bool = False,
    version: str = "0.0",
    lazy_arguments: bool = True,
    env: Optional[LzyEnvironment] = None,
):
    """Decorate a function as a workflow op: ``@op`` bare or
    ``@op(cache=True, version="1.1", ...)``."""

    def wrap(f: Callable) -> LzyOp:
        return LzyOp(
            f,
            env or LzyEnvironment(),
            cache=cache,
            version=version,
            lazy_arguments=lazy_arguments,
        )

    return wrap(func) if func is not None else wrap
