"""The port stays out of the JAX package's process-global state.

``lzy_tpu`` keeps process-wide registries that its own tests enumerate:
``tests/test_dashboard_coverage.py`` fails on any metric in
``lzy_tpu.utils.metrics.REGISTRY`` missing from the committed dashboard,
and ``tests/test_chaos.py`` arms every point of ``lzy_tpu.chaos.faults.
CHAOS``. Test files share worker processes, so a port that registered
into those registries would break those tests depending on where the
scheduler placed the files. The port therefore imports nothing of
``lzy_tpu`` (nor JAX) and keeps registries of its own.
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
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "lzy_tpu")


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


def test_fresh_import_loads_no_jax_or_reference():
    """Importing every port module in a fresh interpreter pulls in no
    JAX and no ``lzy_tpu`` module (nothing indirect either)."""
    code = (
        "import importlib, sys\n"
        f"for name in {_port_modules()!r}:\n"
        "    importlib.import_module(name)\n"
        f"bad = sorted(m for m in sys.modules if any(m == f or "
        f"m.startswith(f + '.') for f in {FORBIDDEN!r}))\n"
        "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


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

    assert CHAOS.points() == ["engine.admit", "engine.prefill",
                              "engine.step", "slo.admit"]
