"""Materialize-on-touch lazy proxies: the port's copy of
``lzy_tpu/proxy/automagic.py``.

An op call returns proxies at once; touching one (attribute access,
arithmetic, iteration, printing...) triggers the workflow barrier, pulls
the real value from the snapshot and forwards the operation. One
``LzyProxy`` class forwards the whole dunder surface and fakes
``__class__``, so ``isinstance`` checks pass. ``bool`` and ``None``
results cannot be proxied faithfully (``bool`` is final, ``x is None``
cannot be intercepted): the call wrapper materializes them eagerly
(``lzy_tpu_torch/core/call.py``).
"""

from __future__ import annotations

import operator
from typing import Any, Callable, Optional, Type

_MATERIALIZER = "_lzy_materialize_fn"
_CACHE = "_lzy_materialized_box"
_ENTRY_ID = "_lzy_entry_id"
_TYPE = "_lzy_declared_type"

_SELF_ATTRS = frozenset({_MATERIALIZER, _CACHE, _ENTRY_ID, _TYPE})


class LzyProxy:
    """Stand-in for a not-yet-computed op result."""

    def __init__(self, materialize_fn: Callable[[], Any], entry_id: str,
                 declared_type: Optional[Type]):
        object.__setattr__(self, _MATERIALIZER, materialize_fn)
        object.__setattr__(self, _CACHE, [])
        object.__setattr__(self, _ENTRY_ID, entry_id)
        object.__setattr__(self, _TYPE, declared_type)

    # -- core ------------------------------------------------------------------

    def _lzy_value(self) -> Any:
        box = object.__getattribute__(self, _CACHE)
        if not box:
            box.append(object.__getattribute__(self, _MATERIALIZER)())
        return box[0]

    # -- attribute surface -----------------------------------------------------

    def __getattribute__(self, name: str) -> Any:
        if name in _SELF_ATTRS or name in ("_lzy_value",):
            return object.__getattribute__(self, name)
        if name == "__class__":
            declared = object.__getattribute__(self, _TYPE)
            box = object.__getattribute__(self, _CACHE)
            if box:
                return type(box[0])
            return declared if declared is not None else LzyProxy
        return getattr(object.__getattribute__(self, "_lzy_value")(), name)

    def __setattr__(self, name: str, value: Any) -> None:
        setattr(self._lzy_value(), name, value)

    def __delattr__(self, name: str) -> None:
        delattr(self._lzy_value(), name)

    # -- representation --------------------------------------------------------

    def __repr__(self) -> str:
        return repr(self._lzy_value())

    def __str__(self) -> str:
        return str(self._lzy_value())

    def __format__(self, spec: str) -> str:
        return format(self._lzy_value(), spec)

    def __dir__(self):
        return dir(self._lzy_value())

    # -- conversions / tests ---------------------------------------------------

    def __bool__(self) -> bool:
        return bool(self._lzy_value())

    def __int__(self) -> int:
        return int(self._lzy_value())

    def __float__(self) -> float:
        return float(self._lzy_value())

    def __complex__(self):
        return complex(self._lzy_value())

    def __index__(self) -> int:
        return operator.index(self._lzy_value())

    def __hash__(self) -> int:
        return hash(self._lzy_value())

    def __len__(self) -> int:
        return len(self._lzy_value())

    def __contains__(self, item: Any) -> bool:
        return item in self._lzy_value()

    def __iter__(self):
        return iter(self._lzy_value())

    def __next__(self):
        return next(self._lzy_value())

    def __reversed__(self):
        return reversed(self._lzy_value())

    # -- container -------------------------------------------------------------

    def __getitem__(self, key: Any) -> Any:
        return self._lzy_value()[key]

    def __setitem__(self, key: Any, value: Any) -> None:
        self._lzy_value()[key] = value

    def __delitem__(self, key: Any) -> None:
        del self._lzy_value()[key]

    def __call__(self, *args: Any, **kwargs: Any) -> Any:
        return self._lzy_value()(*args, **kwargs)

    # -- pickling / copying ----------------------------------------------------

    def __reduce__(self):
        return (_identity, (self._lzy_value(),))

    def __reduce_ex__(self, protocol: int):
        return self.__reduce__()


def _identity(x: Any) -> Any:
    return x


def _binary(name: str):
    op_fn = getattr(operator, name, None)

    def fwd(self, other):
        other = materialize(other) if is_lzy_proxy(other) else other
        if op_fn is not None:
            return op_fn(self._lzy_value(), other)
        return getattr(self._lzy_value(), f"__{name}__")(other)

    return fwd


# comparison + arithmetic forwarding (operator-module names)
for _name, _sym in [
    ("eq", "eq"), ("ne", "ne"), ("lt", "lt"), ("le", "le"), ("gt", "gt"), ("ge", "ge"),
    ("add", "add"), ("sub", "sub"), ("mul", "mul"), ("truediv", "truediv"),
    ("floordiv", "floordiv"), ("mod", "mod"), ("pow", "pow"),
    ("matmul", "matmul"), ("and_", "and"), ("or_", "or"), ("xor", "xor"),
    ("lshift", "lshift"), ("rshift", "rshift"),
]:
    setattr(LzyProxy, f"__{_sym}__", _binary(_name))

for _sym in ["add", "sub", "mul", "truediv", "floordiv", "mod", "pow", "matmul",
             "and", "or", "xor", "lshift", "rshift"]:
    def _make_r(sym):
        def fwd(self, other):
            real = self._lzy_value()
            meth = getattr(real, f"__r{sym}__", None)
            if meth is not None:
                result = meth(other)
                if result is not NotImplemented:
                    return result
            # fall back to the forward op on the other operand
            import operator as _op

            fwd_name = {"and": "and_", "or": "or_"}.get(sym, sym)
            return getattr(_op, fwd_name)(other, real)

        return fwd

    setattr(LzyProxy, f"__r{_sym}__", _make_r(_sym))

for _sym in ["neg", "pos", "abs", "invert"]:
    def _make_u(sym):
        import operator as _op

        fn = {"neg": _op.neg, "pos": _op.pos, "abs": _op.abs, "invert": _op.invert}[sym]

        def fwd(self):
            return fn(self._lzy_value())

        return fwd

    setattr(LzyProxy, f"__{_sym}__", _make_u(_sym))


# -- public helpers (adapter surface, `proxy_adapter.py` parity) ----------------


def lzy_proxy(materialize_fn: Callable[[], Any], entry_id: str,
              declared_type: Optional[Type] = None) -> Any:
    return LzyProxy(materialize_fn, entry_id, declared_type)


def is_lzy_proxy(obj: Any) -> bool:
    try:
        object.__getattribute__(obj, _MATERIALIZER)
        return True
    except AttributeError:
        return False


def materialize(obj: Any) -> Any:
    if is_lzy_proxy(obj):
        return object.__getattribute__(obj, "_lzy_value")()
    return obj


def materialized(obj: Any) -> bool:
    """True if the proxy has already pulled its value (no barrier trigger)."""
    return bool(object.__getattribute__(obj, _CACHE))


def get_proxy_entry_id(obj: Any) -> str:
    return object.__getattribute__(obj, _ENTRY_ID)
