"""Primitive (JSON) and pickle-fallback serializers: the port's copy of
``lzy_tpu/serialization/basic.py``.

The fallback keeps the reference's format name, ``cloudpickle``, and
imports ``cloudpickle`` only when it writes: nothing else in the port
needs it, and tensors and trees of tensors never reach it. Where
``cloudpickle`` is not installed it writes with the standard ``pickle``
(which cannot pickle lambdas or locally defined classes); both are read
back with ``pickle``.
"""

from __future__ import annotations

import json
import pickle
import sys
from typing import Any, BinaryIO, Optional, Type

from lzy_tpu_torch.serialization.registry import Serializer
from lzy_tpu_torch.types import DataScheme

_PRIMITIVES = (int, float, str, bool, type(None))


class PrimitiveSerializer(Serializer):
    def format_name(self) -> str:
        return "primitive"

    def supports_type(self, typ: Type) -> bool:
        return typ in _PRIMITIVES

    def serialize(self, obj: Any, dest: BinaryIO) -> None:
        dest.write(json.dumps(obj).encode("utf-8"))

    def deserialize(self, src: BinaryIO, typ: Optional[Type] = None) -> Any:
        return json.loads(src.read().decode("utf-8"))


def pickler():
    """``cloudpickle`` where it is importable, else ``pickle``: the
    module the fallback, op payloads and stored exceptions are written
    with (both are read back with ``pickle``)."""
    try:
        import cloudpickle
    except ImportError:
        return pickle
    return cloudpickle


class CloudpickleSerializer(Serializer):
    """Universal fallback; its format is pinned to the producing Python
    version (recorded in the data scheme's meta)."""

    def format_name(self) -> str:
        return "cloudpickle"

    def supports_type(self, typ: Type) -> bool:
        return True

    def serialize(self, obj: Any, dest: BinaryIO) -> None:
        pickler().dump(obj, dest)

    def deserialize(self, src: BinaryIO, typ: Optional[Type] = None) -> Any:
        return pickle.load(src)

    def data_scheme(self, obj: Any) -> DataScheme:
        scheme = super().data_scheme(obj)
        scheme.meta["python"] = "%d.%d" % sys.version_info[:2]
        module = pickler()
        if module is not pickle:
            scheme.meta["cloudpickle"] = module.__version__
        return scheme
