"""Tensor serialization: the port's counterpart of
``lzy_tpu/serialization/jax_ser.py``.

Two formats, both raw C-order bytes behind a JSON header:

- ``LZYA`` (format ``torch_tensor``), one tensor, the reference's layout
  byte for byte: magic ``LZYA``, ``<I`` header length, the JSON header
  ``{"dtype", "shape", "kind"}``, then the bytes. It reads what the
  reference's ``JaxArraySerializer`` writes, and that reads what this
  writes. ``dtype`` is the numpy name, ``bfloat16`` included: the port
  moves bf16 through a view of its bits, with no ``ml_dtypes``.
- ``LZYT`` (format ``torch_tree``), dicts, lists and tuples of tensors
  and numbers (a ``state_dict``, the train step's params and losses),
  the counterpart of ``ArrayPytreeSerializer``. The reference's ``LZYP``
  carries a pickled JAX treedef, which the port cannot load, so this
  format records the structure as JSON instead (keys, container kinds,
  the leaf order) and has a magic and a format name of its own.

A tensor on the card goes to the host once; its bytes are written from a
view of that copy, never from a second one, and read straight into the
new tensor's memory. Tensors come back on the CPU: moving them to a
device is the consumer's choice. ``kind`` says what to rebuild: a
``numpy`` array stays a numpy array, a ``torch`` tensor (or the
reference's ``jax`` array, its device array) becomes a torch tensor.
"""

from __future__ import annotations

import collections
import json
import struct
from typing import Any, BinaryIO, List, Optional, Type

import numpy as np
import torch

from lzy_tpu_torch.serialization.registry import Serializer
from lzy_tpu_torch.types import DataScheme

_MAGIC_ARRAY = b"LZYA"
_MAGIC_TREE = b"LZYT"

#: numpy dtype name (the header's ``dtype``) -> torch dtype
_DTYPES = {
    "bool": torch.bool,
    "uint8": torch.uint8,
    "int8": torch.int8,
    "int16": torch.int16,
    "int32": torch.int32,
    "int64": torch.int64,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "float64": torch.float64,
}
_NAMES = {v: k for k, v in _DTYPES.items()}
_NUMBERS = (bool, int, float)


def _is_tensor(obj: Any) -> bool:
    if isinstance(obj, torch.Tensor):
        return obj.layout == torch.strided and obj.dtype in _NAMES
    if isinstance(obj, (np.ndarray, np.generic)):
        return np.asarray(obj).dtype.name in _DTYPES
    return False


def _meta(obj: Any) -> dict:
    """The header of one tensor (the reference's key order)."""
    if isinstance(obj, torch.Tensor):
        return {"dtype": _NAMES[obj.dtype], "shape": list(obj.shape),
                "kind": "torch"}
    arr = np.asarray(obj)
    return {"dtype": arr.dtype.name, "shape": list(arr.shape),
            "kind": "numpy"}


def _write_raw(dest: BinaryIO, obj: Any) -> None:
    """One host copy at most (of a card tensor, or of a non-contiguous
    one: a card tensor is made contiguous on the card); the bytes are
    written from a uint8 view of it."""
    if isinstance(obj, torch.Tensor):
        host = obj.detach().contiguous().to("cpu")
        raw = host.reshape(-1).view(torch.uint8).numpy()
    else:
        raw = np.atleast_1d(np.ascontiguousarray(obj)).reshape(-1).view(
            np.uint8)
    dest.write(memoryview(raw))


def _read_into(src: BinaryIO, buf: memoryview) -> None:
    got, n = 0, len(buf)
    readinto = getattr(src, "readinto", None)
    while got < n:
        if readinto is not None:
            k = readinto(buf[got:])
        else:
            chunk = src.read(n - got)
            k = len(chunk)
            buf[got:got + k] = chunk
        if not k:
            raise ValueError(f"truncated tensor data: {got} of {n} bytes")
        got += k


def _read_raw(src: BinaryIO, meta: dict) -> Any:
    dtype = _DTYPES.get(meta["dtype"])
    if dtype is None:
        raise TypeError(f"unsupported tensor dtype {meta['dtype']!r}")
    shape = tuple(meta["shape"])
    numel = int(np.prod(shape, dtype=np.int64))
    itemsize = torch.empty((), dtype=dtype).element_size()
    buf = torch.empty(numel * itemsize, dtype=torch.uint8)
    _read_into(src, memoryview(buf.numpy()))
    out = buf.view(dtype).reshape(shape)
    if meta.get("kind") == "numpy" and dtype != torch.bfloat16:
        return out.numpy()          # numpy has no bf16 without ml_dtypes
    return out


def _write_header(dest: BinaryIO, magic: bytes, header: dict) -> None:
    hb = json.dumps(header).encode("utf-8")
    dest.write(magic)
    dest.write(struct.pack("<I", len(hb)))
    dest.write(hb)


def _read_header(src: BinaryIO, magic: bytes) -> dict:
    got = src.read(4)
    if got != magic:
        raise ValueError(f"bad magic {got!r}, expected {magic!r}")
    (hlen,) = struct.unpack("<I", src.read(4))
    return json.loads(src.read(hlen).decode("utf-8"))


class TensorSerializer(Serializer):
    """One ``torch.Tensor`` (or numpy array or scalar) as ``LZYA``."""

    def format_name(self) -> str:
        return "torch_tensor"

    def supports_type(self, typ: Type) -> bool:
        return isinstance(typ, type) and issubclass(
            typ, (torch.Tensor, np.ndarray, np.generic))

    def supports_instance(self, obj: Any) -> bool:
        return _is_tensor(obj)

    def serialize(self, obj: Any, dest: BinaryIO) -> None:
        _write_header(dest, _MAGIC_ARRAY, _meta(obj))
        _write_raw(dest, obj)

    def deserialize(self, src: BinaryIO, typ: Optional[Type] = None) -> Any:
        return _read_raw(src, _read_header(src, _MAGIC_ARRAY))

    def data_scheme(self, obj: Any) -> DataScheme:
        meta = _meta(obj)
        return DataScheme(
            data_format=self.format_name(),
            schema_content=f"tensor[{meta['dtype']}]{tuple(meta['shape'])}")


def _encode(obj: Any, leaves: List[Any]) -> dict:
    """JSON structure of a tree; tensors are appended to ``leaves``."""
    if _is_tensor(obj):
        leaves.append(obj)
        return {"leaf": len(leaves) - 1}
    if obj is None or type(obj) in _NUMBERS:
        return {"scalar": obj}
    if type(obj) in (dict, collections.OrderedDict):
        kind = "dict" if type(obj) is dict else "ordered_dict"
        return {kind: [[k, _encode(v, leaves)] for k, v in obj.items()]}
    if type(obj) in (list, tuple):
        return {type(obj).__name__: [_encode(v, leaves) for v in obj]}
    raise TypeError(f"not a tensor tree leaf: {type(obj)!r}")


def _decode(node: dict, leaves: List[Any]) -> Any:
    (kind, body), = node.items()
    if kind == "leaf":
        return leaves[body]
    if kind == "scalar":
        return body
    if kind == "dict":
        return {k: _decode(v, leaves) for k, v in body}
    if kind == "ordered_dict":
        return collections.OrderedDict((k, _decode(v, leaves))
                                       for k, v in body)
    items = [_decode(v, leaves) for v in body]
    return items if kind == "list" else tuple(items)


def _tree_leaves(obj: Any) -> Optional[List[Any]]:
    """The leaves of a supported tree (tensors and numbers), or None."""
    if _is_tensor(obj) or type(obj) in _NUMBERS:
        return [obj]
    if obj is None:
        return []
    if type(obj) in (dict, collections.OrderedDict):
        if not all(isinstance(k, str) for k in obj):
            return None
        children = obj.values()
    elif type(obj) in (list, tuple):
        children = obj
    else:
        return None
    out: List[Any] = []
    for child in children:
        sub = _tree_leaves(child)
        if sub is None:
            return None
        out += sub
    return out


class TensorTreeSerializer(Serializer):
    """Dicts (string keys), lists and tuples whose leaves are all tensors
    or numbers (``None`` is an empty subtree, as in a JAX pytree):
    ``LZYT``, magic, ``<I`` header length, the JSON header
    ``{"tree", "leaves"}``, then each tensor's raw bytes in leaf order."""

    def format_name(self) -> str:
        return "torch_tree"

    def supports_type(self, typ: Type) -> bool:
        return False  # instance- or format-driven only

    def supports_instance(self, obj: Any) -> bool:
        if type(obj) not in (dict, collections.OrderedDict, list, tuple):
            return False
        leaves = _tree_leaves(obj)
        return bool(leaves)

    def serialize(self, obj: Any, dest: BinaryIO) -> None:
        leaves: List[Any] = []
        tree = _encode(obj, leaves)
        _write_header(dest, _MAGIC_TREE,
                      {"tree": tree, "leaves": [_meta(x) for x in leaves]})
        for leaf in leaves:         # one leaf on the host at a time
            _write_raw(dest, leaf)

    def deserialize(self, src: BinaryIO, typ: Optional[Type] = None) -> Any:
        header = _read_header(src, _MAGIC_TREE)
        leaves = [_read_raw(src, meta) for meta in header["leaves"]]
        return _decode(header["tree"], leaves)

    def data_scheme(self, obj: Any) -> DataScheme:
        return DataScheme(data_format=self.format_name(),
                          schema_content=f"tree[{len(_tree_leaves(obj))} "
                                         f"leaves]")
