"""Shared value types: the port's copy of ``lzy_tpu/types.py``, trimmed
to ``File`` and ``DataScheme``. The pool specs (``TpuPoolSpec``,
``VmSpec``) wait for the GPU provisioning slice."""

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
class DataScheme:
    """Typed-data descriptor carried with every stored entry."""

    data_format: str              # serializer format name, e.g. "torch_tensor"
    schema_content: str           # type description (type name / dtype+shape)
    meta: Dict[str, str] = dataclasses.field(default_factory=dict)
