"""Plain causal attention for the full-sequence (non-decode) forward.

The port's counterpart of ``lzy_tpu/ops/attention.py``
``chunked_attention`` (plain ``jnp`` in the reference, not a Pallas
kernel): f32 scores of ``q * d**-0.5`` against ``k``, a causal ``-1e30``
mask, softmax and P.V in f32, output cast back to ``q``'s dtype. It
materializes the ``[T, T]`` score matrix, which is fine for the one use
the slice has: holding full-sequence logits against the reference.
"""

from __future__ import annotations

import torch

_NEG_INF = -1e30


def causal_attention(q: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor) -> torch.Tensor:
    """``q [B, T, H, D]``, ``k``/``v [B, T, KV, D]`` (grouped heads:
    head ``h`` reads kv head ``h // (H // KV)``) -> ``[B, T, H, D]``."""
    b, t, h, d = q.shape
    reps = h // k.shape[2]
    k = k.repeat_interleave(reps, dim=2)
    v = v.repeat_interleave(reps, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * (d ** -0.5), k.float())
    causal = torch.ones(t, t, dtype=torch.bool, device=q.device).tril()
    s = s.masked_fill(~causal, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)
