"""Plain causal attention for the full-sequence (non-decode) forward.

The port's counterpart of ``lzy_tpu/ops/attention.py``
``chunked_attention`` (plain ``jnp`` in the reference, not a Pallas
kernel): f32 scores of ``q * d**-0.5`` against ``k``, a causal ``-1e30``
mask (and, with packed documents, a same-document mask), softmax and P.V
in f32, output cast back to ``q``'s dtype. It materializes the
``[T, T]`` score matrix: the model takes it when the flash kernels are
off (``LlamaConfig.use_flash_kernel``) or the sequence is not a multiple
of 128, and it is the plain path the flash path is held against.
"""

from __future__ import annotations

from typing import Optional

import torch

from lzy_tpu_torch.ops.flash_attention import document_starts

_NEG_INF = -1e30


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     segment_ids: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """``q [B, T, H, D]``, ``k``/``v [B, T, KV, D]`` (grouped heads:
    head ``h`` reads kv head ``h // (H // KV)``) -> ``[B, T, H, D]``.
    ``segment_ids [B, T]``: attention stays inside documents, a document
    being a contiguous run of equal ids (the reference's rule: ids are
    normalized to run starts before comparing)."""
    b, t, h, d = q.shape
    reps = h // k.shape[2]
    k = k.repeat_interleave(reps, dim=2)
    v = v.repeat_interleave(reps, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * (d ** -0.5), k.float())
    keep = torch.ones(t, t, dtype=torch.bool, device=q.device).tril()
    if segment_ids is not None:
        runs = document_starts(segment_ids)
        keep = keep[None] & (runs[:, :, None] == runs[:, None, :])
        keep = keep[:, None]                            # [B, 1, T, T]
    s = s.masked_fill(~keep, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)
