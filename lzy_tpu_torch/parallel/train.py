"""Training steps on one device.

The port's counterpart of ``lzy_tpu/parallel/train.py``: a
:class:`TrainState` (step, model, optimizer), :func:`make_train_step`
(loss and gradients, optional gradient accumulation, the optimizer
update, ``{"loss", "grad_norm"}`` metrics), :func:`make_eval_step` and
the MFU accounting.

The reference jits one SPMD program over a mesh with donated state;
the port runs eagerly on one card and updates the parameters and the
optimizer's moments in place (PyTorch has no donation; in place is what
halves peak memory there). Parameters stay f32 (the master copy) and the
model computes in its ``cfg.dtype``. Multi-device training is later work.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, Optional, Tuple

import torch
from torch import nn

Batch = Dict[str, torch.Tensor]


class AdamW:
    """``optax.adamw``'s update on PyTorch's multi-tensor (``_foreach``)
    ops: ``mu = b1 mu + (1 - b1) g``, ``nu = b2 nu + (1 - b2) g^2``, then
    ``p -= lr * (mu_hat / (sqrt(nu_hat) + eps) + weight_decay * p)`` with
    bias-corrected moments and the pre-update parameter, for every
    trainable parameter (norm scales included, as optax with no mask).
    Not ``torch.optim.AdamW``: constructing any ``torch.optim`` optimizer
    imports ``torch._dynamo``, and that import writes
    ``TORCHINDUCTOR_CACHE_DIR`` into ``os.environ``; the port leaves the
    process environment alone. The moments are f32 like the parameters."""

    def __init__(self, params: Iterable[nn.Parameter], *, lr: float,
                 b1: float, b2: float, eps: float, weight_decay: float):
        self.params = [p for p in params if p.requires_grad]
        self.lr, self.b1, self.b2 = lr, b1, b2
        self.eps, self.weight_decay = eps, weight_decay
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> None:
        live = [i for i, p in enumerate(self.params) if p.grad is not None]
        params = [self.params[i] for i in live]
        grads = [p.grad for p in params]
        mu = [self.mu[i] for i in live]
        nu = [self.nu[i] for i in live]
        self.count += 1
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, grads, alpha=1.0 - self.b1)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_addcmul_(nu, grads, grads, value=1.0 - self.b2)
        denom = torch._foreach_div(nu, 1.0 - self.b2 ** self.count)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        torch._foreach_mul_(params, 1.0 - self.lr * self.weight_decay)
        torch._foreach_addcdiv_(params, mu, denom,
                                value=-self.lr / (1.0 - self.b1 ** self.count))


#: params -> optimizer (the counterpart of an optax GradientTransformation)
OptimizerFactory = Callable[[Iterable[nn.Parameter]], AdamW]


def adamw(learning_rate: float = 3e-4, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 1e-4
          ) -> OptimizerFactory:
    """:class:`AdamW` with ``optax.adamw``'s defaults (``torch.optim``'s
    weight decay default is 1e-2, optax's 1e-4)."""

    def make(params):
        return AdamW(params, lr=learning_rate, b1=b1, b2=b2, eps=eps,
                     weight_decay=weight_decay)

    return make


@dataclasses.dataclass
class TrainState:
    step: int
    model: nn.Module
    optimizer: AdamW

    @staticmethod
    def create(model: nn.Module, tx: OptimizerFactory) -> "TrainState":
        return TrainState(step=0, model=model,
                          optimizer=tx(model.parameters()))


def _global_norm(params) -> torch.Tensor:
    grads = [p.grad.float() for p in params if p.grad is not None]
    return torch.sqrt(sum((g * g).sum() for g in grads))


def make_train_step(loss_fn: Callable[[nn.Module, Batch], torch.Tensor], *,
                    accum_steps: int = 1):
    """``step(state, batch) -> (state, metrics)``.

    ``loss_fn(model, batch) -> scalar``. With ``accum_steps > 1`` the
    batch's leading dim is split into that many micro-batches whose
    losses and gradients are averaged, as the reference's ``lax.scan``
    does. ``metrics`` holds the (mean) ``loss`` and the global L2
    ``grad_norm`` of the gradients before the update, as 0-dim tensors on
    the model's device (reading them is the caller's sync)."""

    def step(state: TrainState, batch: Batch
             ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        model, opt = state.model, state.optimizer
        opt.zero_grad()
        if accum_steps == 1:
            loss = loss_fn(model, batch)
            loss.backward()
            loss = loss.detach()
        else:
            micro = {k: v.reshape(accum_steps, v.shape[0] // accum_steps,
                                  *v.shape[1:]) for k, v in batch.items()}
            loss = 0.0
            for i in range(accum_steps):
                part = loss_fn(model, {k: v[i] for k, v in micro.items()})
                (part / accum_steps).backward()
                loss = loss + part.detach()
            loss = loss / accum_steps
        params = [p for p in model.parameters() if p.requires_grad]
        grad_norm = _global_norm(params)
        opt.step()
        return (dataclasses.replace(state, step=state.step + 1),
                {"loss": loss, "grad_norm": grad_norm})

    return step


def make_eval_step(metric_fn: Callable[[nn.Module, Batch], object]):
    """``eval_step(model, batch) -> dict``: ``metric_fn`` (typically the
    same loss) without gradients; a scalar comes back as ``{"loss": ..}``.
    It never touches the optimizer, so it can run between train steps."""

    def eval_step(model: nn.Module, batch: Batch):
        with torch.no_grad():
            out = metric_fn(model, batch)
        return out if isinstance(out, dict) else {"loss": out}

    return eval_step


# -- MFU accounting ------------------------------------------------------------

#: dense bf16 peak TFLOP/s per card (NVIDIA's data sheet, H100 SXM, 700 W)
PEAK_TFLOPS = {
    "h100-sxm": 989.0,
    "cpu": 0.1,          # placeholder so tests can exercise the math
}


def transformer_flops_per_token(n_params: int) -> float:
    """6ND approximation: forward + backward FLOPs per token ~ 6 x
    params (remat's re-run forward is not counted, as in the reference)."""
    return 6.0 * n_params


def mfu(tokens_per_s: float, n_params: int, n_chips: int,
        chip: str = "h100-sxm",
        flops_per_token: Optional[float] = None) -> float:
    fpt = (flops_per_token if flops_per_token is not None
           else transformer_flops_per_token(n_params))
    return tokens_per_s * fpt / (PEAK_TFLOPS[chip] * 1e12 * n_chips)
