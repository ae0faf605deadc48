"""Model-agnostic helpers: the port's counterpart of the parts of
``lzy_tpu/models/common.py`` that training uses."""

from __future__ import annotations

from typing import Iterable, Optional, Union

import torch
from torch import nn


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token-level CE in float32 regardless of the compute dtype;
    mask-weighted mean (a mask of all zeros gives 0, not NaN)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    label_logit = logits.gather(-1, labels.long()[..., None])[..., 0]
    nll = logz - label_logit
    if mask is not None:
        mask = mask.float()
        return (nll * mask).sum() / mask.sum().clamp_min(1.0)
    return nll.mean()


def count_params(params: Union[nn.Module, Iterable[torch.Tensor]]) -> int:
    """Number of parameter elements (a tied tensor counts once)."""
    if isinstance(params, nn.Module):
        params = params.parameters()
    seen, total = set(), 0
    for p in params:
        if id(p) not in seen:
            seen.add(id(p))
            total += p.numel()
    return total
