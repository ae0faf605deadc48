"""The ``@op`` decorator: the port's copy of ``lzy_tpu/core/op.py``.

Inside an active workflow a decorated call registers lazily and returns
proxies; outside one it just runs the function. The reference's
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
            self.func, *args, **kwargs
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
