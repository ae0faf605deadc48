"""Shared value types: the port's copy of ``lzy_tpu/types.py``, trimmed
to ``File``, ``DataScheme`` and the CPU pool spec ``VmSpec``. The
accelerator pools (the reference's ``TpuPoolSpec``) wait for the GPU
provisioning slice, so ``PoolSpec`` is ``VmSpec`` alone."""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict


class File(type(Path())):
    """Marker type for file-valued op arguments and results.

    Subclasses the concrete flavour (``PosixPath``/``WindowsPath``), as
    the reference does. A ``File`` result is stored as raw bytes (no
    pickling) and comes back as a fresh local file."""


@dataclasses.dataclass(frozen=True)
class VmSpec:
    """A CPU pool, like the reference's default 4 vCPU / 32 GB pool.
    Every host of the in-process cluster is a thread VM of one."""

    label: str
    cpu_count: int
    ram_gb: int

    @property
    def hosts(self) -> int:
        return 1


PoolSpec = VmSpec


@dataclasses.dataclass(frozen=True)
class DataScheme:
    """Typed-data descriptor carried with every stored entry."""

    data_format: str              # serializer format name, e.g. "torch_tensor"
    schema_content: str           # type description (type name / dtype+shape)
    meta: Dict[str, str] = dataclasses.field(default_factory=dict)
