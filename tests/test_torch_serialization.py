"""The port's serializers and storage (``lzy_tpu_torch.serialization``,
``lzy_tpu_torch.storage``) held to the JAX reference's, in ONE test item
that runs two named lists of cases, collects every failure and reports
them together:

- ``LZYA_CASES``: ``LZYA`` both ways. A tensor the port writes is read by
  the reference's ``JaxArraySerializer`` with equal dtype, shape and
  bytes, and the reverse, for f32, bf16, f16, int8, int32 and bool at
  0-d, empty, 2-d and non-contiguous shapes; a numpy array gives the
  same stream, byte for byte, from either package.
- ``TREE_AND_STORAGE_CASES``: the tree serializer round-trips a
  ``state_dict`` bit for bit and accepts the trees the reference's pytree
  serializer accepts; the registries pick the same format for the same
  values; the port's ``file://`` and ``mem://`` clients and its storage
  registry answer the same calls as the reference's do, and the port's
  ``mem://`` store is not the reference's.

One item only: ``--dist loadfile`` queues files by their item count, and
a one-item file queues after every seed file. Storage lives under
``tmp_path``, in the reference's ``mem://`` store (its conftest clears
it) and in the port's own, cleared by a fixture here.
"""

import io
import os
import uuid

import numpy as np
import pytest
import torch

from lzy_tpu_torch.serialization.torch_ser import (
    _DTYPES, _NAMES, TensorSerializer, TensorTreeSerializer)
from lzy_tpu_torch.storage.mem import MemStorageClient as PortMem

torch.set_num_threads(1)

DTYPES = ["float32", "bfloat16", "float16", "int8", "int32", "bool"]
SHAPES = {"0-d": (), "empty": (0, 3), "2-d": (3, 5),
          "non-contiguous": (5, 3)}


@pytest.fixture(autouse=True)
def _process_state_unchanged():
    import jax

    def snap():
        env = {k: v for k, v in os.environ.items()
               if k != "PYTEST_CURRENT_TEST"}
        return (jax.config.jax_enable_x64, env, torch.get_default_dtype(),
                torch.is_grad_enabled())

    jax.devices()       # the backend's first start sets variables of its own
    before = snap()
    yield
    PortMem.clear_all()
    assert snap() == before


def _bits(dtype, shape, seed):
    """Random contents as raw bits (bf16 included, NaN patterns too)."""
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape, dtype=np.int64))
    if dtype == "bool":
        return rng.integers(0, 2, n).astype(np.uint8).reshape(shape)
    width = {"float32": 4, "bfloat16": 2, "float16": 2, "int8": 1,
             "int32": 4}[dtype]
    return rng.integers(0, 256, n * width, dtype=np.uint8).view(
        {1: np.uint8, 2: np.uint16, 4: np.uint32}[width]).reshape(shape)


def _numpy(dtype, bits):
    import jax.numpy as jnp

    if dtype == "bool":
        return bits.astype(bool)
    return bits.view(jnp.bfloat16 if dtype == "bfloat16" else np.dtype(dtype))


def _tensor(dtype, bits, layout):
    t = torch.from_numpy(bits.copy())
    t = t.bool() if dtype == "bool" else t.view(_DTYPES[dtype])
    # the non-contiguous case: a transposed view of the [3, 5] layout
    return t.reshape(3, 5).t() if layout == "non-contiguous" else t


def _raw(x):
    """Contiguous C-order bytes of a tensor or array."""
    if isinstance(x, torch.Tensor):
        x = x.contiguous()
        return bytes(x.reshape(-1).view(torch.uint8).numpy()) if x.numel() \
            else b""
    return np.ascontiguousarray(x).tobytes()


def _split(stream):
    """(header dict, payload) of an ``LZYA`` stream."""
    import json
    import struct

    (hlen,) = struct.unpack("<I", stream[4:8])
    return json.loads(stream[8:8 + hlen]), stream[8 + hlen:]


def _lzya_case(dtype, layout, seed):
    import jax.numpy as jnp

    from lzy_tpu.serialization.jax_ser import JaxArraySerializer

    shape = (3, 5) if layout == "non-contiguous" else SHAPES[layout]
    bits = _bits(dtype, shape, seed)
    port, ref = TensorSerializer(), JaxArraySerializer()
    tensor = _tensor(dtype, bits, layout)
    want = _numpy(dtype, bits)
    want = want.T.copy() if layout == "non-contiguous" else want.copy()
    # the reference writes a 0-d array as shape [1] (``jax_ser._to_host``'s
    # ``np.ascontiguousarray``; ROADMAP queue 3); the port keeps []
    ref_shape = list(want.shape) or [1]
    fails = []

    def check(what, dtype_name, shape_, raw, want_shape):
        if dtype_name != dtype or list(shape_) != want_shape or \
                raw != want.tobytes():
            fails.append(f"{what}: dtype {dtype_name}, shape {tuple(shape_)}"
                         f", bytes equal {raw == want.tobytes()}")

    def same_stream(what, a, b, kinds):
        (ha, pa), (hb, pb) = _split(a), _split(b)
        if (ha["kind"], hb["kind"]) != kinds or ha["dtype"] != hb["dtype"] \
                or (ha["shape"], hb["shape"]) != (list(want.shape), ref_shape) \
                or pa != pb:
            fails.append(f"{what}: headers {ha} / {hb}, payloads equal "
                         f"{pa == pb}")

    # the port writes, the reference reads
    buf = io.BytesIO()
    port.serialize(tensor, buf)
    read = ref.deserialize(io.BytesIO(buf.getvalue()))
    check("port -> reference", read.dtype.name, read.shape, _raw(read),
          list(want.shape))
    # the reference writes a jax array, the port reads a tensor
    ref_buf = io.BytesIO()
    ref.serialize(jnp.asarray(want), ref_buf)
    back = port.deserialize(io.BytesIO(ref_buf.getvalue()))
    if not isinstance(back, torch.Tensor):
        fails.append(f"reference -> port: a {type(back).__name__}")
    else:
        check("reference -> port", _NAMES[back.dtype], back.shape,
              _raw(back), ref_shape)
    same_stream("tensor streams", buf.getvalue(), ref_buf.getvalue(),
                ("torch", "jax"))
    # a numpy array: the same stream from either package
    if dtype != "bfloat16":
        a, b = io.BytesIO(), io.BytesIO()
        port.serialize(want, a)
        ref.serialize(want, b)
        same_stream("numpy streams", a.getvalue(), b.getvalue(),
                    ("numpy", "numpy"))
        if shape and a.getvalue() != b.getvalue():
            fails.append("a numpy array's streams differ")
        back = port.deserialize(io.BytesIO(b.getvalue()))
        if not isinstance(back, np.ndarray) or back.dtype != want.dtype or \
                back.tobytes() != want.tobytes():
            fails.append(f"numpy round trip gave {type(back).__name__}")
    return fails


LZYA_CASES = {f"{dtype} {layout}": (dtype, layout)
              for dtype in DTYPES for layout in SHAPES}


def _state_dict_round_trip():
    from lzy_tpu_torch.models.llama import LlamaConfig, init_params

    sd = init_params(LlamaConfig.tiny(vocab_size=64), device="cpu").state_dict()
    sd["bf16_copy"] = sd["embed_tokens"].to(torch.bfloat16)
    sd["int_buffer"] = torch.arange(7, dtype=torch.int64)
    tree = {"params": sd, "losses": [4.25, 4.0, float("nan")],
            "meta": ("step", 3, None, True)[1:]}
    ser = TensorTreeSerializer()
    buf = io.BytesIO()
    ser.serialize(tree, buf)
    back = ser.deserialize(io.BytesIO(buf.getvalue()))
    fails = []
    if type(back["params"]) is not type(sd) or list(back["params"]) != list(sd):
        fails.append("state_dict type or key order changed")
    for k, v in sd.items():
        got = back["params"][k]
        if got.dtype != v.dtype or got.shape != v.shape or _raw(got) != _raw(v):
            fails.append(f"state_dict leaf {k} changed")
    if np.asarray(back["losses"]).tobytes() != np.asarray(
            tree["losses"]).tobytes() or back["meta"] != tree["meta"]:
        fails.append(f"scalars: {back['losses']} {back['meta']}")
    return fails


def _tree_acceptance():
    """The trees each package's tree serializer takes (the reference's
    pytree serializer over the same structure with numpy leaves)."""
    from lzy_tpu.serialization.jax_ser import ArrayPytreeSerializer

    t = torch.ones(2)
    a = np.ones(2, np.float32)
    trees = [([1.0, 2.0], [1.0, 2.0]), ({"w": t}, {"w": a}),
             ((t, [t, 3]), (a, [a, 3])), (["a"], ["a"]), ({}, {}),
             ([], []), ([None], [None]), ({"w": t, "s": "x"},
                                          {"w": a, "s": "x"})]
    port, ref = TensorTreeSerializer(), ArrayPytreeSerializer()
    return [f"tree {r!r}: port {port.supports_instance(p)}, reference "
            f"{ref.supports_instance(r)}" for p, r in trees
            if port.supports_instance(p) != ref.supports_instance(r)]


def _registry_formats(tmp_path):
    import jax.numpy as jnp

    from lzy_tpu.serialization import default_registry as ref_default
    from lzy_tpu.types import File as RefFile
    from lzy_tpu_torch.serialization import default_registry
    from lzy_tpu_torch.types import File

    path = tmp_path / "f.bin"
    path.write_bytes(b"abc")
    port_to_ref = {"torch_tensor": "jax_array", "torch_tree": "jax_pytree"}
    values = [(1, 1), ("s", "s"), (1.5, 1.5), (None, None), (True, True),
              (File(path), RefFile(path)),
              (torch.ones(2), jnp.ones(2)), (np.ones(2), np.ones(2)),
              ({"w": torch.ones(2)}, {"w": jnp.ones(2)}),
              (["a", "b"], ["a", "b"]), (object(), object())]
    port, ref = default_registry(), ref_default()
    fails = []
    for p, r in values:
        got = port.find_by_instance(p).format_name()
        want = ref.find_by_instance(r).format_name()
        if port_to_ref.get(got, got) != want:
            fails.append(f"{type(p).__name__}: port {got}, reference {want}")
    # the pickle fallback's bytes read back on the other side
    buf = io.BytesIO()
    port.find_by_format("cloudpickle").serialize(["a", {"b": 1}], buf)
    if ref.find_by_format("cloudpickle").deserialize(
            io.BytesIO(buf.getvalue())) != ["a", {"b": 1}]:
        fails.append("the pickle fallback's bytes do not read back")
    for reg in (port, ref):
        errs = []
        for call in (lambda: reg.find_by_format("nope"),
                     lambda: reg.register(type(reg.find_by_format(
                         "primitive"))())):
            try:
                call()
                errs.append("no error")
            except (TypeError, ValueError) as e:
                errs.append(type(e).__name__)
        if errs != ["TypeError", "ValueError"]:
            fails.append(f"{type(reg).__module__}: unknown format, duplicate "
                         f"registration: {errs}")
    return fails


def _storage_calls(client, root):
    """One fixed sequence of calls; what each returned or raised."""
    def attempt(fn):
        try:
            return fn()
        except Exception as e:  # noqa: BLE001 — the observation under test
            return type(e).__name__

    def rel(uris):
        return [u[len(root):] for u in uris]

    a, b, c = (f"{root}/dir/a.bin", f"{root}/dir/b.bin",
               f"{root}/other/c.bin")
    out = [client.write_bytes(a, b"hello world"), client.write_bytes(b, b""),
           client.write(c, io.BytesIO(b"xyz" * 1000)),
           client.read_bytes(a), client.read_range(a, 6),
           client.read_range(a, 0, 5), client.read_range(c, 2990, 100),
           client.exists(a), client.exists(f"{root}/dir/none"),
           client.size(c), rel(client.list(f"{root}/dir")),
           rel(client.list(f"{root}/dir/a")), rel(client.list(root)),
           rel(client.list(f"{root}/missing/")),
           client.open_read(a).read()]
    client.write_bytes(a, b"rewritten")
    client.delete(b)
    client.delete(b)                       # deleting twice is fine
    out += [client.read_bytes(a), client.exists(b), rel(client.list(root)),
            attempt(lambda: client.read_bytes(f"{root}/dir/none")),
            attempt(lambda: client.size(f"{root}/dir/none")),
            attempt(lambda: client.read_range(f"{root}/dir/none", 0))]
    return out


def _storage_clients(tmp_path):
    from lzy_tpu.storage import FsStorageClient as RefFs
    from lzy_tpu.storage import MemStorageClient as RefMem
    from lzy_tpu_torch.storage import FsStorageClient, MemStorageClient

    fails = []
    tag = uuid.uuid4().hex
    pairs = [("fs", FsStorageClient(), f"file://{tmp_path}/port",
              RefFs(), f"file://{tmp_path}/ref"),
             ("mem", MemStorageClient(), f"mem://port-{tag}",
              RefMem(), f"mem://ref-{tag}")]
    for name, port, proot, ref, rroot in pairs:
        got, want = _storage_calls(port, proot), _storage_calls(ref, rroot)
        if got != want:
            fails.append(f"{name}: port {got} vs reference {want}")
    # the two mem:// stores are separate dictionaries
    MemStorageClient().write_bytes(f"mem://shared-{tag}/x", b"1")
    if RefMem().exists(f"mem://shared-{tag}/x"):
        fails.append("the port's mem:// store is the reference's")
    return fails


def _storage_registry():
    from lzy_tpu.storage import DefaultStorageRegistry as RefReg
    from lzy_tpu.storage import StorageConfig as RefConfig
    from lzy_tpu_torch.storage import DefaultStorageRegistry, StorageConfig

    def drive(reg_cls, config):
        reg, seen = reg_cls(), []
        seen.append(reg.default_name())
        reg.register_storage("a", config(uri="mem://a"))
        reg.register_storage("b", config(uri="file:///tmp/b"))
        seen += [reg.default_name(), reg.config("b").uri,
                 type(reg.client("b")).__name__]
        reg.register_storage("c", config(uri="mem://c"), default=True)
        seen += [reg.default_name(), reg.default_config().uri]
        reg.unregister_storage("c")
        seen += [reg.default_name(), reg.config("c"), reg.client("c")]
        for uri in ("ftp://x", "nofscheme"):
            try:
                reg.register_storage("bad", config(uri=uri))
                seen.append("registered")
            except ValueError:
                seen.append("ValueError")
        return seen

    got, want = drive(DefaultStorageRegistry, StorageConfig), drive(
        RefReg, RefConfig)
    return [] if got == want else [f"registry: port {got} vs {want}"]


TREE_AND_STORAGE_CASES = {
    "state_dict round trip": lambda tmp_path: _state_dict_round_trip(),
    "tree acceptance": lambda tmp_path: _tree_acceptance(),
    "registry formats": _registry_formats,
    "storage clients": _storage_clients,
    "storage registry": lambda tmp_path: _storage_registry(),
}


def test_lzya_both_ways_tree_serializer_and_storage_match_reference(tmp_path):
    fails = []
    for i, (name, (dtype, layout)) in enumerate(LZYA_CASES.items()):
        fails += [f"LZYA {name}: {f}" for f in _lzya_case(dtype, layout, i)]
    for name, case in TREE_AND_STORAGE_CASES.items():
        try:
            fails += [f"{name}: {f}" for f in case(tmp_path)]
        except Exception as e:  # noqa: BLE001 — reported with the rest
            fails.append(f"{name}: raised {type(e).__name__}: {e}")
    assert not fails, "\n".join(fails)
