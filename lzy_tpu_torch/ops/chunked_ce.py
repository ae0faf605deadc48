"""Chunked (logits-free) causal-LM cross-entropy.

The port's counterpart of ``lzy_tpu/ops/chunked_ce.py`` (plain ``jnp``
in the reference, not a Pallas kernel, so plain PyTorch here too): the
token-level CE of ``features @ head.T`` without ever materializing the
``[N, V]`` logits. The forward runs an online logsumexp over vocabulary
chunks; the backward recomputes each chunk's logits and feeds the two
head products (``d_features``, ``d_head``) directly. ``_ChunkedNll`` is
the ``torch.autograd.Function`` in place of the reference's
``custom_vjp``; the mask-weighted mean stays outside it, so each token's
weight reaches the backward through the incoming gradient.

Dtype discipline as in the reference: chunk logits are f32 products of
the (bf16) operands, the per-chunk ``dlogits`` are cast to the features'
dtype before the two products, ``d_features`` is carried in f32 across
chunks and ``d_head`` is cast to the head's dtype per chunk.
"""

from __future__ import annotations

from typing import Optional

import torch


def _dot_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` accumulated and returned in f32 (bf16 operands stay
    bf16 on the card: cuBLAS with an f32 output, the counterpart of
    ``preferred_element_type=float32``)."""
    if a.dtype == torch.float32:
        return a @ b
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def _chunk_size(v: int, chunk: int) -> int:
    """Largest divisor of ``v`` not above ``chunk`` — never a full-vocab
    block, which would materialize ``[N, V]``."""
    if v % chunk == 0:
        return chunk
    return next(c for c in range(min(chunk, v), 0, -1) if v % c == 0)


class _ChunkedNll(torch.autograd.Function):
    """Per-token nll ``[N]`` (f32) of ``x [N, D] @ head [V, D].T``."""

    @staticmethod
    def forward(ctx, x, head, labels, chunk):
        n = x.shape[0]
        v = head.shape[0]
        m = torch.full((n,), float("-inf"), device=x.device)
        s = torch.zeros(n, device=x.device)
        label_logit = torch.zeros(n, device=x.device)
        for off in range(0, v, chunk):
            logits = _dot_f32(x, head[off:off + chunk].t())     # [N, C]
            m_new = torch.maximum(m, logits.amax(dim=-1))
            s = s * torch.exp(m - m_new) + torch.exp(
                logits - m_new[:, None]).sum(dim=-1)
            m = m_new
            local = labels - off
            inside = (local >= 0) & (local < chunk)
            picked = logits.gather(1, local.clamp(0, chunk - 1)[:, None])
            label_logit = torch.where(inside, picked[:, 0], label_logit)
        logz = m + torch.log(s)
        ctx.save_for_backward(x, head, labels, logz)
        ctx.chunk = chunk
        return logz - label_logit

    @staticmethod
    def backward(ctx, g):
        x, head, labels, logz = ctx.saved_tensors
        chunk = ctx.chunk
        v = head.shape[0]
        g = g.float()
        dx = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        dhead = torch.empty_like(head)
        cols = torch.arange(chunk, device=x.device)
        for off in range(0, v, chunk):
            head_c = head[off:off + chunk]
            p = torch.exp(_dot_f32(x, head_c.t()) - logz[:, None])
            onehot = (cols[None, :] == (labels - off)[:, None]).float()
            dl = ((p - onehot) * g[:, None]).to(x.dtype)
            # f32 carry: V/chunk sequential bf16 additions would round
            # each step, diverging from one f32-accumulated product
            dx += _dot_f32(dl, head_c)
            dhead[off:off + chunk] = _dot_f32(dl.t(), x).to(head.dtype)
        return dx.to(x.dtype), dhead, None, None


def chunked_cross_entropy(features: torch.Tensor, head: torch.Tensor,
                          labels: torch.Tensor, *, chunk: int = 4096,
                          mask: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Mask-weighted mean nll of ``features [B, T, D]`` (or ``[N, D]``)
    against ``head [V, D]`` and integer ``labels [B, T]`` (or ``[N]``),
    equal to ``cross_entropy_loss(features @ head.T, labels, mask)`` but
    without the ``[N, V]`` intermediate. ``chunk`` falls back to the
    largest divisor of V not above it."""
    d = features.shape[-1]
    x = features.reshape(-1, d).contiguous()
    lf = labels.reshape(-1).long()
    w = (torch.ones(lf.shape, device=x.device) if mask is None
         else mask.reshape(-1).float())
    nll = _ChunkedNll.apply(x, head.contiguous(), lf,
                            _chunk_size(head.shape[0], chunk))
    return (nll * w).sum() / w.sum().clamp_min(1.0)
