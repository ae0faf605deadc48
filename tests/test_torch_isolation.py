"""The port stays out of the JAX package's process-global state.

``lzy_tpu`` keeps process-wide registries that its own tests enumerate:
``tests/test_dashboard_coverage.py`` fails on any metric in
``lzy_tpu.utils.metrics.REGISTRY`` missing from the committed dashboard,
and ``tests/test_chaos.py`` arms every point of ``lzy_tpu.chaos.faults.
CHAOS``. Test files share worker processes, so a port that registered
into those registries would break those tests depending on where the
scheduler placed the files. The port therefore imports nothing of
``lzy_tpu`` (nor JAX, nor ``ml_dtypes``) and keeps registries of its
own. Every subpackage is covered, the workflow SDK's (``core``,
``runtime``, ``snapshot``, ``storage``, ``serialization``, ``proxy``,
``env``, ``whiteboards``) and the in-process cluster's (``durable``,
``service``, ``channels``) included; the SDK imports and runs without
``cloudpickle``, which the card's machine lacks, locally and through a
port cluster, whose thread workers resolve a ``__main__`` op by
reference. The registry check runs after a port cluster has been built,
driven and shut down.
"""

import ast
import importlib
import pkgutil
import subprocess
import sys
from pathlib import Path

import torch

import lzy_tpu_torch

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "ml_dtypes", "lzy_tpu")


def _port_files():
    files = sorted((REPO / "lzy_tpu_torch").rglob("*.py"))
    return files + [REPO / "chip_smoke.py"]


def _forbidden(module: str) -> bool:
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def _port_modules():
    names = ["lzy_tpu_torch"]
    for info in pkgutil.walk_packages(lzy_tpu_torch.__path__,
                                      prefix="lzy_tpu_torch."):
        names.append(info.name)
    return names


def test_no_source_imports_jax_or_the_reference():
    bad = []
    for path in _port_files():
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""] if node.level == 0 else []
            else:
                continue
            bad += [f"{path.relative_to(REPO)}:{node.lineno} {m}"
                    for m in mods if _forbidden(m)]
    assert not bad, f"port files import JAX or lzy_tpu: {bad}"


#: run in the fresh interpreter before anything else: makes importing
#: ``cloudpickle`` fail, as on a machine that does not have it
_NO_CLOUDPICKLE = (
    "import sys\n"
    "class _Absent:\n"
    "    def find_spec(self, name, path=None, target=None):\n"
    "        if name.split('.')[0] == 'cloudpickle':\n"
    "            raise ImportError('cloudpickle is absent here')\n"
    "sys.meta_path.insert(0, _Absent())\n")

#: a workflow of tensors, a tree and a number over the port's mem store
_SDK_DRIVE = (
    "import torch\n"
    "from lzy_tpu_torch import Lzy, op\n"
    "from lzy_tpu_torch.storage import DefaultStorageRegistry, StorageConfig\n"
    "reg = DefaultStorageRegistry()\n"
    "reg.register_storage('default', StorageConfig(uri='mem://isolation'))\n"
    "@op(cache=True)\n"
    "def f(x: torch.Tensor, n: int) -> tuple[dict, list]:\n"
    "    return {'w': x * n}, [float(n)]\n"
    "with Lzy(storage_registry=reg).workflow('w'):\n"
    "    tree, losses = f(torch.ones(2), 3)\n"
    "    assert losses == [3.0] and torch.equal(tree['w'], torch.full((2,), 3.))\n")

#: the same op through a port cluster (thread workers, device channels)
_CLUSTER_DRIVE = (
    "from lzy_tpu_torch.service import InProcessCluster\n"
    "c = InProcessCluster(storage_uri='mem://isolation-cluster')\n"
    "try:\n"
    "    with c.lzy().workflow('w'):\n"
    "        tree, losses = f(torch.ones(2), 4)\n"
    "        assert losses == [4.0] and torch.equal(tree['w'], torch.full((2,), 4.))\n"
    "finally:\n"
    "    c.shutdown()\n")


def _fresh(code):
    return subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)


def test_fresh_import_loads_no_jax_or_reference():
    """Importing every port module in a fresh interpreter pulls in no
    JAX and no ``lzy_tpu`` module (nothing indirect either); with
    ``cloudpickle`` absent the port still imports and runs a workflow."""
    code = (
        "import importlib, sys\n"
        f"for name in {_port_modules()!r}:\n"
        "    importlib.import_module(name)\n"
        f"bad = sorted(m for m in sys.modules if any(m == f or "
        f"m.startswith(f + '.') for f in {FORBIDDEN!r}))\n"
        "print(bad)\n")
    out = _fresh(code)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout
    out = _fresh(_NO_CLOUDPICKLE + code + _SDK_DRIVE + _CLUSTER_DRIVE +
                 "print('cloudpickle' in sys.modules)\n")
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["[]", "False"], out.stdout


def test_port_leaves_reference_registries_unchanged():
    from lzy_tpu.chaos.faults import CHAOS as REF_CHAOS
    from lzy_tpu.utils.metrics import REGISTRY as REF_REGISTRY

    metrics_before = dict(REF_REGISTRY._metrics)
    points_before = REF_CHAOS.points()
    for name in _port_modules():
        importlib.import_module(name)
    # drive the port so anything registered lazily would show up too
    from lzy_tpu_torch.service.inference import build_engine

    eng = build_engine("tiny", device="cpu", slots=1, start=False)
    req = eng.submit([1, 2, 3], max_new_tokens=2)
    for _ in range(10):
        eng.step()
    assert req.result(0)
    exec(_SDK_DRIVE + _CLUSTER_DRIVE, {})
    from lzy_tpu_torch.storage.mem import MemStorageClient

    MemStorageClient.clear_all()
    assert dict(REF_REGISTRY._metrics) == metrics_before
    assert REF_CHAOS.points() == points_before

    from lzy_tpu_torch.chaos.faults import CHAOS
    from lzy_tpu_torch.utils.metrics import REGISTRY

    assert REGISTRY is not REF_REGISTRY and CHAOS is not REF_CHAOS
    assert not set(map(id, REGISTRY._metrics.values())) & \
        set(map(id, REF_REGISTRY._metrics.values()))


def test_port_registers_only_the_slice_fault_points():
    for name in _port_modules():
        importlib.import_module(name)
    from lzy_tpu_torch.chaos.faults import CHAOS

    assert CHAOS.points() == [
        "allocator.heartbeat", "disagg.stage", "engine.admit", "engine.prefill", "engine.step",
        "gateway.dispatch", "gateway.health", "kv.fetch", "kv.publish",
        "kvtier.demote", "kvtier.import", "llm.dispatch", "slo.admit"]
