"""Autoregressive generation with a KV cache: the ``generate()`` oracle.

The port's counterpart of ``lzy_tpu/models/generate.py``: the prompt
runs through the model in padded bucket-width chunks
(:func:`prefill_plan`, :func:`batched_prefill`), then one decode step per
new token against a :class:`~lzy_tpu_torch.models.llama.DenseKVCache`
updated in place. Greedy output is the oracle the serving engines are
held to.

Sampling draws from an explicit ``torch.Generator``. JAX's threefry
stream cannot be reproduced, so :func:`sample_token` also takes the
Gumbel noise as an argument: fed the same noise, it picks what the
reference's ``jax.random.categorical`` picks.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from lzy_tpu_torch.models.llama import DenseKVCache, Llama, LlamaConfig


def gumbel_noise(shape, *, generator: Optional[torch.Generator] = None,
                 device=None) -> torch.Tensor:
    """Standard Gumbel noise ``-log(-log(u))`` with ``u`` uniform in
    ``[tiny, 1)`` (the reference's ``jax.random.gumbel``)."""
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand(shape, generator=generator, device=device,
                   dtype=torch.float32).clamp_(min=tiny)
    return -torch.log(-torch.log(u))


def sample_token(logits: torch.Tensor, temperature: float, *,
                 generator: Optional[torch.Generator] = None,
                 top_k: Optional[int] = None,
                 top_p: Optional[float] = None,
                 noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Next token per row from ``logits [B, V]`` -> ``[B]`` int64.
    ``temperature <= 0`` is greedy (no noise drawn). Otherwise the logits
    are scaled, cut to the ``top_k`` highest (``<= 0`` disables) and to
    the smallest nucleus of mass ``top_p`` (k first, then p), and the
    token is ``argmax(logits + gumbel)`` — ``noise`` if given, else drawn
    from ``generator``."""
    if temperature <= 0.0:
        return logits.argmax(dim=-1)
    logits = logits / temperature
    if top_k is not None and 0 < top_k < logits.shape[-1]:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    if top_p is not None and top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        # the first token at which the mass reaches p is always kept
        idx = (cum >= top_p).int().argmax(dim=-1, keepdim=True)
        cutoff = sorted_logits.gather(-1, idx)
        logits = logits.masked_fill(logits < cutoff, float("-inf"))
    if noise is None:
        noise = gumbel_noise(logits.shape, generator=generator,
                             device=logits.device)
    return (logits + noise).argmax(dim=-1)


def decode_config(cfg: LlamaConfig, **overrides) -> LlamaConfig:
    """The decode-mode variant of a config. The reference clears its
    training-only features here (remat, flash/ring/Ulysses attention);
    the port's config has none, so only ``overrides`` apply. Engines and
    ``generate`` derive their config through it."""
    return dataclasses.replace(cfg, **overrides)


#: padded prefill widths (as the reference: a bounded set of shapes)
PREFILL_BUCKETS = (8, 16, 32, 64, 128, 256)


def prefill_plan(t0: int, chunk: int, max_seq_len: int):
    """Chunk schedule for a ``t0``-token prompt: ``(start, take, width)``
    triples where ``take`` real tokens at ``start`` run as one forward
    padded to ``width`` (the smallest bucket that fits, capped so the
    padded write never spills past ``max_seq_len``)."""
    chunk = max(1, chunk)
    widths = sorted({w for w in PREFILL_BUCKETS if w <= chunk} | {chunk})
    plan = []
    start = 0
    while start < t0:
        take = min(chunk, t0 - start)
        width = next(w for w in widths if w >= take)
        plan.append((start, take, min(width, max_seq_len - start)))
        start += take
    return plan


def pad_chunk(tokens: torch.Tensor, take: int, width: int) -> torch.Tensor:
    """Right-pad a ``[B, take]`` chunk with token 0 to ``width``; pad
    positions write garbage K/V past the real tokens, which the next
    real write overwrites before any mask can see it."""
    return F.pad(tokens, (0, width - take)) if width != take else tokens


def batched_prefill(model: Llama, cache, prompt: torch.Tensor, *,
                    chunk: int = 64, max_seq_len: int,
                    start: int = 0, page_table=None) -> torch.Tensor:
    """Write ``prompt [B, T0]`` into ``cache`` at positions ``start..``
    in ``ceil(T0/chunk)`` forwards; returns the logits at the prompt's
    final position ``[B, V]``."""
    b, t0 = prompt.shape
    last = None
    for s, take, width in prefill_plan(t0, chunk, max_seq_len - start):
        tokens = pad_chunk(prompt[:, s:s + take], take, width)
        starts = torch.full((b,), start + s, dtype=torch.int32,
                            device=prompt.device)
        logits = model(tokens, cache=cache, starts=starts,
                       page_table=page_table)
        last = logits[:, take - 1]
    return last


@torch.no_grad()
def generate(model: Llama, prompt: torch.Tensor, *, max_new_tokens: int,
             temperature: float = 0.0, top_k: Optional[int] = None,
             top_p: Optional[float] = None,
             generator: Optional[torch.Generator] = None,
             eos_token: Optional[int] = None, prefill_chunk: int = 64,
             eos_check_every: int = 8, return_logits: bool = False):
    """Greedy (``temperature=0``) or sampled continuation of ``prompt``
    (``[B, T0]`` integer ids on the model's device). Returns ``[B, T0 +
    max_new_tokens]`` int64 (positions after an ``eos_token`` repeat it);
    with ``return_logits`` also the ``[B, max_new_tokens, V]`` f32 logits
    each new token was picked from (what a top-2-gap check reads)."""
    cfg = model.cfg
    b, t0 = prompt.shape
    if t0 + max_new_tokens > cfg.max_seq_len:
        raise ValueError(
            f"prompt ({t0}) + new tokens ({max_new_tokens}) exceeds "
            f"max_seq_len ({cfg.max_seq_len})")
    prompt = prompt.long()
    cache = DenseKVCache(cfg, b, model.device)
    logits = batched_prefill(model, cache, prompt, chunk=prefill_chunk,
                             max_seq_len=cfg.max_seq_len)
    cur = sample_token(logits, temperature, generator=generator,
                       top_k=top_k, top_p=top_p)
    tokens = [prompt]
    seen = []
    done = torch.zeros((b,), dtype=torch.bool, device=prompt.device)
    for n in range(max_new_tokens):
        if eos_token is not None:
            cur = torch.where(done, torch.full_like(cur, eos_token), cur)
            done = done | (cur == eos_token)
        tokens.append(cur[:, None])
        seen.append(logits)
        emitted = n + 1
        if emitted == max_new_tokens:
            break
        if (eos_token is not None and eos_check_every > 0
                and emitted % eos_check_every == 0 and bool(done.all())):
            tokens.append(torch.full((b, max_new_tokens - emitted),
                                     eos_token, dtype=prompt.dtype,
                                     device=prompt.device))
            break
        starts = torch.full((b,), t0 + n, dtype=torch.int32,
                            device=prompt.device)
        logits = model(cur[:, None], cache=cache, starts=starts)[:, -1]
        cur = sample_token(logits, temperature, generator=generator,
                           top_k=top_k, top_p=top_p)
    out = torch.cat(tokens, dim=1)
    if return_logits:
        return out, torch.stack(seen, dim=1)
    return out
