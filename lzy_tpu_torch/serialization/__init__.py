"""Serializers: the port's copy of ``lzy_tpu/serialization``, with
``torch_ser.py`` in place of ``jax_ser.py``."""

from lzy_tpu_torch.serialization.registry import (
    Serializer,
    SerializerRegistry,
    default_registry,
)

__all__ = ["Serializer", "SerializerRegistry", "default_registry"]
