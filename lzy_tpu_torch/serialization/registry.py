"""Serializer registry: the port's copy of
``lzy_tpu/serialization/registry.py``.

Serializers are looked up by instance or type (first match in registration
order) or by stored data format. :func:`default_registry` registers the
primitive (JSON), file, tensor and tensor-tree serializers, then the
pickle fallback last. Tensors never go through pickle: they use the
reference's raw ``LZYA`` layout (``serialization/torch_ser.py``).
"""

from __future__ import annotations

import abc
from typing import Any, BinaryIO, Dict, List, Optional, Type

from lzy_tpu_torch.types import DataScheme


class Serializer(abc.ABC):
    """One serialization format."""

    @abc.abstractmethod
    def format_name(self) -> str: ...

    @abc.abstractmethod
    def supports_type(self, typ: Type) -> bool: ...

    def supports_instance(self, obj: Any) -> bool:
        return self.supports_type(type(obj))

    @abc.abstractmethod
    def serialize(self, obj: Any, dest: BinaryIO) -> None: ...

    @abc.abstractmethod
    def deserialize(self, src: BinaryIO, typ: Optional[Type] = None) -> Any: ...

    def data_scheme(self, obj: Any) -> DataScheme:
        t = type(obj)
        return DataScheme(
            data_format=self.format_name(),
            schema_content=f"{t.__module__}.{t.__qualname__}",
        )


class SerializerRegistry:
    def __init__(self) -> None:
        self._serializers: List[Serializer] = []
        self._by_format: Dict[str, Serializer] = {}

    def register(self, serializer: Serializer) -> None:
        if serializer.format_name() in self._by_format:
            raise ValueError(f"serializer {serializer.format_name()!r} already registered")
        self._serializers.append(serializer)
        self._by_format[serializer.format_name()] = serializer

    def find_by_instance(self, obj: Any) -> Serializer:
        for s in self._serializers:
            if s.supports_instance(obj):
                return s
        raise TypeError(f"no serializer for instance of {type(obj)!r}")

    def find_by_type(self, typ: Type) -> Serializer:
        for s in self._serializers:
            if s.supports_type(typ):
                return s
        raise TypeError(f"no serializer for type {typ!r}")

    def find_by_format(self, format_name: str) -> Serializer:
        try:
            return self._by_format[format_name]
        except KeyError:
            raise TypeError(f"no serializer registered for format {format_name!r}")


def default_registry() -> SerializerRegistry:
    from lzy_tpu_torch.serialization.basic import (
        CloudpickleSerializer, PrimitiveSerializer)
    from lzy_tpu_torch.serialization.file_ser import FileSerializer
    from lzy_tpu_torch.serialization.torch_ser import (
        TensorSerializer, TensorTreeSerializer)

    reg = SerializerRegistry()
    reg.register(PrimitiveSerializer())
    reg.register(FileSerializer())
    reg.register(TensorSerializer())
    reg.register(TensorTreeSerializer())
    reg.register(CloudpickleSerializer())  # universal fallback, lowest priority
    return reg
