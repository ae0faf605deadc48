"""Build and load the port's CUDA kernels (plain C interface, ``ctypes``).

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into a
shared library under ``lzy_tpu_torch/_build/`` (listed in
``.gitignore``), named by a hash of its source so an edited kernel is
never served from a stale build. The build happens at first use, from
the package's sources only, and never at import. A library exports
``extern "C"`` launchers that take device pointers and a stream and
return ``cudaGetLastError()``.

``python -m lzy_tpu_torch.ops.build`` builds every kernel and prints
each library's path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def sources() -> List[str]:
    """Kernel names: one per ``csrc/*.cu``."""
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and Path(root, "bin", "nvcc").exists():
            return str(Path(root, "bin", "nvcc"))
    raise RuntimeError("nvcc not found (needs the CUDA toolkit)")


def library_path(name: str) -> Path:
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _build(name: str) -> None:
    """Compile ``csrc/<name>.cu`` unless its library is current; nvcc
    writes a temporary file that is renamed into place on success."""
    out = library_path(name)
    if out.exists():
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    out.with_suffix(".log").write_text(proc.stdout)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stdout}")
    os.replace(tmp, out)


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            _build(name)
            lib = _loaded[name] = ctypes.CDLL(str(library_path(name)))
        return lib


def build_all() -> Dict[str, Path]:
    """Build and load every kernel; returns ``{name: library path}``.
    One nvcc per source, all started together."""
    names = sources()
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        list(pool.map(_build, names))
    for name in names:
        load(name)
    return {name: library_path(name) for name in names}


def build_log(name: str) -> str:
    """What nvcc printed for the current build (``-Xptxas -v``:
    registers, shared memory and spills per kernel)."""
    path = library_path(name).with_suffix(".log")
    return path.read_text() if path.exists() else ""


if __name__ == "__main__":
    for kernel, path in build_all().items():
        print(kernel, path)
