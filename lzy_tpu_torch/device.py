"""Device choice for the port's entry points.

Every entry point takes an explicit ``device=`` that defaults to
``"cuda"``: the port is written for the card, and a missing card is an
error, not a silent fall back to the CPU. Callers that want the CPU (the
tests, CPU rehearsals) pass ``device="cpu"``.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """``torch.device`` for ``device``; raises if it names CUDA and no
    CUDA device is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but CUDA is not available; "
            f"pass device='cpu' to run on the CPU")
    return dev
