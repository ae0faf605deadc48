"""Call-signature inference and validation: the port's copy of
``lzy_tpu/core/signatures.py``.

Bind the user's args to the op's Python signature, validate them against
annotations where present, and infer output types from the return
annotation (``tuple[A, B]`` means a two-output op, one snapshot entry per
element).
"""

from __future__ import annotations

import dataclasses
import inspect
import typing
from typing import Any, Callable, Dict, Optional, Tuple, Type

from lzy_tpu_torch.proxy.automagic import is_lzy_proxy


@dataclasses.dataclass
class CallSignature:
    func: Callable
    args: Tuple[Any, ...]
    kwargs: Dict[str, Any]
    param_names: Tuple[str, ...]            # positional arg names, bound
    arg_types: Tuple[Optional[Type], ...]
    kwarg_types: Dict[str, Optional[Type]]
    output_types: Tuple[Optional[Type], ...]
    # what a remote worker receives: the LzyOp wrapper, which pickles by
    # module reference when it is a module-level attribute
    payload: Optional[Any] = None

    @property
    def remote_payload(self) -> Any:
        return self.payload if self.payload is not None else self.func

    @property
    def name(self) -> str:
        return self.func.__name__

    @property
    def output_count(self) -> int:
        return len(self.output_types)


def _proxy_declared_type(value: Any) -> Optional[Type]:
    from lzy_tpu_torch.proxy.automagic import _TYPE  # noqa: internal

    return object.__getattribute__(value, _TYPE)


def _runtime_type(value: Any) -> Optional[Type]:
    if is_lzy_proxy(value):
        return _proxy_declared_type(value)
    return type(value)


def _normalize_annotation(ann: Any) -> Optional[Type]:
    if ann is inspect.Signature.empty or ann is None:
        return type(None) if ann is None else None
    origin = typing.get_origin(ann)
    if origin is not None:
        # Optional/Union/Annotated origins are not classes — treat as untyped
        # (validated at materialization) rather than crash issubclass
        return origin if isinstance(origin, type) else None
    return ann if isinstance(ann, type) else None


def _check(value: Any, ann: Any, where: str, func_name: str) -> None:
    expected = _normalize_annotation(ann)
    if expected is None or expected is type(None):
        return
    actual = _runtime_type(value)
    if actual is None:
        return  # untyped proxy: checked at materialization
    if not (isinstance(actual, type) and issubclass(actual, expected)) and not (
        expected is float and actual is int
    ):
        raise TypeError(
            f"op {func_name}() {where}: expected {expected.__name__}, "
            f"got {actual.__name__}"
        )


def infer_and_validate_call_signature(
    func: Callable,
    *args: Any,
    payload: Optional[Any] = None,
    **kwargs: Any,
) -> CallSignature:
    sig = inspect.signature(func)
    try:
        bound = sig.bind(*args, **kwargs)
    except TypeError as e:
        raise TypeError(f"op {func.__name__}(): {e}") from None

    arg_types = []
    param_names = []
    kwarg_types: Dict[str, Optional[Type]] = {}
    hints: Dict[str, Any] = {}
    try:
        hints = typing.get_type_hints(func)
    except Exception:
        pass
    params = sig.parameters

    for i, a in enumerate(args):
        name = _positional_name(params, i)
        param_names.append(name)
        ann = hints.get(name, inspect.Signature.empty)
        _check(a, ann, f"argument {name!r}", func.__name__)
        arg_types.append(_normalize_annotation(ann) or _runtime_type(a))
    for k, v in kwargs.items():
        ann = hints.get(k, inspect.Signature.empty)
        _check(v, ann, f"argument {k!r}", func.__name__)
        kwarg_types[k] = _normalize_annotation(ann) or _runtime_type(v)

    output_types = infer_output_types(hints.get("return", inspect.Signature.empty))

    return CallSignature(
        func=func,
        args=args,
        kwargs=kwargs,
        param_names=tuple(param_names),
        arg_types=tuple(arg_types),
        kwarg_types=kwarg_types,
        output_types=tuple(output_types),
        payload=payload,
    )


def _positional_name(params, i: int) -> str:
    names = list(params)
    pos = [n for n in names
           if params[n].kind in (inspect.Parameter.POSITIONAL_ONLY,
                                 inspect.Parameter.POSITIONAL_OR_KEYWORD)]
    if i < len(pos):
        return pos[i]
    var = [n for n in names if params[n].kind is inspect.Parameter.VAR_POSITIONAL]
    return f"{var[0]}_{i}" if var else f"arg_{i}"


def infer_output_types(return_ann: Any) -> Tuple[Optional[Type], ...]:
    if return_ann is inspect.Signature.empty:
        return (None,)
    if return_ann is None or return_ann is type(None):
        return (type(None),)
    origin = typing.get_origin(return_ann)
    if origin is tuple:
        elems = typing.get_args(return_ann)
        if elems and elems[-1] is not Ellipsis:
            return tuple(_normalize_annotation(e) for e in elems)
    return (_normalize_annotation(return_ann) or None,)
