"""Llama-family decoder (RMSNorm + RoPE + GQA + SwiGLU) in PyTorch.

The port's counterpart of ``lzy_tpu/models/llama.py``, serving and
training subsets: ``LlamaConfig`` with its ``llama3_8b`` and ``tiny``
presets, ``RMSNorm``, the half-split rotary embedding, ``Attention`` with
a dense or a paged KV cache, ``Mlp``, ``DecoderLayer``, ``Llama``,
:func:`init_params` and the causal-LM loss :func:`make_loss_fn`.

Training (the full-sequence forward, no cache) follows the reference:
packed documents (``segments``) restart RoPE positions at every
document and confine attention to it; ``use_flash_kernel`` sends
sequences whose length is a multiple of 128 through
``ops.flash_attention`` (the hand-written kernels on the card), others
through the plain ``ops.attention.causal_attention``; ``remat`` re-runs
each layer's forward in the backward (:class:`_Remat`, the reference's
``remat_policy="nothing"``); ``fused_ce`` returns
``(features, head)`` for the chunked CE instead of logits.

Where the reference keeps the KV cache in a flax ``cache`` collection
with per-layer ``index`` leaves, the port passes the cache explicitly:
``Llama.forward(tokens, cache=..., starts=..., page_table=...)`` runs a
decode-mode chunk ``[B, T]`` at per-row start positions and writes its
K/V INTO the cache in place (torch has no buffer donation; the cache is
allocated once and updated where it lies). The caller owns positions
(the engines keep one ``[B]`` vector), so there is no index to rewind.

- :class:`DenseKVCache` — ``[B, max_seq_len, KV, D]`` rows per layer
  (the ``generate()`` oracle's cache and the dense engine's).
- :class:`PagedKVPool` — a shared ``[n_blocks, page, KV, D]`` pool per
  layer (int8 with f32 sidecars under ``kv_quant="int8"``), written
  through the page table and read by ``ops.paged_attention`` — the
  hand-written CUDA kernel on the card, the plain version on the CPU
  (the pool's device decides).

Weights: ``nn.Linear`` layout (``[out, in]``); ``models/convert.py``
maps the reference's param tree onto this module and back.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from lzy_tpu_torch.device import DeviceLike, resolve_device
from lzy_tpu_torch.models.common import cross_entropy_loss
from lzy_tpu_torch.ops.attention import causal_attention
from lzy_tpu_torch.ops.chunked_ce import chunked_cross_entropy
from lzy_tpu_torch.ops.flash_attention import document_starts, flash_attention
from lzy_tpu_torch.ops.paged_attention import (
    KVQuant, attend, paged_attention, quantize_kv)


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    """Model shape and dtypes. ``dtype`` is the compute dtype,
    ``param_dtype`` the stored weights'. The reference stores f32 master
    weights and computes in bf16; the port serves, so it stores bf16 too
    (16 GB at 8B). The CPU tests set both to float32."""

    vocab_size: int = 128_256
    d_model: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    d_ff: int = 14_336
    rope_theta: float = 500_000.0
    norm_eps: float = 1e-5
    max_seq_len: int = 8192
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.bfloat16
    tie_embeddings: bool = False         # Llama-3 uses an untied lm_head
    #: training: re-run each layer's forward in the backward; the only
    #: policy ported is "nothing" (keep no activation inside a layer)
    remat: bool = True
    remat_policy: str = "nothing"
    #: training: the forward returns (features, head) and the loss runs
    #: the chunked CE (ops/chunked_ce.py), never materializing [B, T, V]
    fused_ce: bool = False
    #: the full-sequence forward takes the flash kernels when T % 128 == 0
    use_flash_kernel: bool = False

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @staticmethod
    def llama3_8b() -> "LlamaConfig":
        return LlamaConfig()

    @staticmethod
    def tiny(vocab_size: int = 512) -> "LlamaConfig":
        """Test shape: same code paths, toy dims."""
        return LlamaConfig(
            vocab_size=vocab_size, d_model=64, n_layers=2, n_heads=4,
            n_kv_heads=2, d_ff=128, max_seq_len=256, remat=False,
            tie_embeddings=True)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Rotary embedding over the half-split head dim, computed in f32 and
    cast back; ``x [B, T, H, D]``, ``positions [B, T]``."""
    d = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                          device=x.device) / d))
    angles = positions[:, :, None, None].float() * freqs       # [B,T,1,D/2]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


class DenseKVCache:
    """Per-layer dense K/V rows ``[B, max_seq_len, KV, D]`` in the
    compute dtype, written in place at each row's positions."""

    def __init__(self, cfg: LlamaConfig, batch: int, device: DeviceLike):
        shape = (batch, cfg.max_seq_len, cfg.n_kv_heads, cfg.head_dim)
        dev = torch.device(device)
        self.dtype = cfg.dtype
        self.k = [torch.zeros(shape, dtype=cfg.dtype, device=dev)
                  for _ in range(cfg.n_layers)]
        self.v = [torch.zeros(shape, dtype=cfg.dtype, device=dev)
                  for _ in range(cfg.n_layers)]

    def write(self, layer: int, k, v, pos, page_table=None) -> None:
        b = k.shape[0]
        # in place; a position past the row clamps to its last slot, as
        # the reference's dynamic_update_slice clamps (only idle rows of
        # the dense engine drift that far, and nobody reads them)
        p = pos.long().clamp(max=self.k[layer].shape[1] - 1)
        rows = torch.arange(b, device=k.device)[:, None]
        self.k[layer][rows, p] = k
        self.v[layer][rows, p] = v

    def attend(self, layer: int, q, pos, page_table=None):
        return attend(q, self.k[layer], self.v[layer], pos, self.dtype)


class PagedKVPool:
    """Per-layer shared block pools ``[n_blocks, page, KV, D]``; block 0
    is the scratch block idle rows write to. ``kv_quant="int8"`` stores
    int8 codes with ``[n_blocks, page, KV]`` f32 scale/zero-point
    sidecars, quantized on write."""

    def __init__(self, cfg: LlamaConfig, n_blocks: int, page_size: int, *,
                 kv_quant: Optional[str] = None,
                 device: DeviceLike = "cuda"):
        if kv_quant not in (None, "int8"):
            raise ValueError(f"unknown kv_quant {kv_quant!r}; known: int8")
        if n_blocks < 2 or cfg.max_seq_len % page_size:
            raise ValueError(
                f"paged pool needs n_blocks >= 2 and max_seq_len "
                f"({cfg.max_seq_len}) divisible by page_size ({page_size})")
        dev = torch.device(device)
        self.dtype = cfg.dtype
        self.page = page_size
        self.kv_quant = kv_quant
        shape = (n_blocks, page_size, cfg.n_kv_heads, cfg.head_dim)
        store = torch.int8 if kv_quant else cfg.dtype
        self.k = [torch.zeros(shape, dtype=store, device=dev)
                  for _ in range(cfg.n_layers)]
        self.v = [torch.zeros(shape, dtype=store, device=dev)
                  for _ in range(cfg.n_layers)]
        self.quant: List[Optional[KVQuant]] = [None] * cfg.n_layers
        if kv_quant:
            self.quant = [KVQuant(*(torch.zeros(shape[:3], dtype=torch.float32,
                                                device=dev) for _ in range(4)))
                          for _ in range(cfg.n_layers)]

    def write(self, layer: int, k, v, pos, page_table) -> None:
        """Scatter each (row, position) into ``(table[row, pos // page],
        pos % page)``, in place. Rows own their tail blocks, so real
        positions never collide; idle rows (zeroed table) all land on the
        scratch block, where duplicate writes leave garbage by design. A
        page index past the table clamps to its last entry (the
        reference's lookup fills and drops that write; either way only
        idle rows, whose table is all scratch, get there)."""
        b, t, kv_heads, d = k.shape
        pages = page_table.shape[1]
        idx = (pos // self.page).long().clamp(max=pages - 1)
        rows = page_table.long().gather(1, idx).reshape(-1)
        offs = (pos % self.page).long().reshape(-1)
        flat_k = k.reshape(b * t, kv_heads, d)
        flat_v = v.reshape(b * t, kv_heads, d)
        side = self.quant[layer]
        if side is None:
            self.k[layer][rows, offs] = flat_k
            self.v[layer][rows, offs] = flat_v
            return
        # quantize on write: int8 of exactly what the fp pool would store
        qk, sk, zk = quantize_kv(flat_k)
        qv, sv, zv = quantize_kv(flat_v)
        self.k[layer][rows, offs] = qk
        self.v[layer][rows, offs] = qv
        for buf, vals in zip(side, (sk, zk, sv, zv)):
            buf[rows, offs] = vals

    def attend(self, layer: int, q, pos, page_table):
        return paged_attention(q, self.k[layer], self.v[layer], page_table,
                               pos, dtype=self.dtype, quant=self.quant[layer])

    def nbytes(self) -> int:
        tensors = self.k + self.v + [x for s in self.quant if s for x in s]
        return sum(x.numel() * x.element_size() for x in tensors)


def _linear(n_in: int, n_out: int, cfg: LlamaConfig, dev) -> nn.Linear:
    return nn.Linear(n_in, n_out, bias=False, dtype=cfg.param_dtype,
                     device=dev)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float, cfg: LlamaConfig, dev):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim, dtype=cfg.param_dtype,
                                             device=dev))

    def forward(self, x):
        x32 = x.float()
        var = x32.square().mean(dim=-1, keepdim=True)
        y = x32 * torch.rsqrt(var + self.eps)
        return (y * self.scale.float()).to(x.dtype)


class Attention(nn.Module):
    def __init__(self, cfg: LlamaConfig, dev):
        super().__init__()
        self.cfg = cfg
        h, kv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        self.q_proj = _linear(cfg.d_model, h * d, cfg, dev)
        self.k_proj = _linear(cfg.d_model, kv * d, cfg, dev)
        self.v_proj = _linear(cfg.d_model, kv * d, cfg, dev)
        self.o_proj = _linear(h * d, cfg.d_model, cfg, dev)

    def forward(self, x, positions, cache=None, layer: int = 0,
                page_table=None, segments=None):
        cfg = self.cfg
        dt = cfg.dtype
        b, t, _ = x.shape
        h, kv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        x = x.to(dt)
        q = F.linear(x, self.q_proj.weight.to(dt)).view(b, t, h, d)
        k = F.linear(x, self.k_proj.weight.to(dt)).view(b, t, kv, d)
        v = F.linear(x, self.v_proj.weight.to(dt)).view(b, t, kv, d)
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
        if cache is None and cfg.use_flash_kernel and t % 128 == 0:
            # GQA: repeat kv groups up to full heads, [B, H, T, D] layout
            kk, vv = (a.repeat_interleave(h // kv, dim=2) for a in (k, v))
            out = flash_attention(q.transpose(1, 2), kk.transpose(1, 2),
                                  vv.transpose(1, 2), causal=True,
                                  segment_ids=segments).transpose(1, 2)
        elif cache is None:
            out = causal_attention(q, k, v, segment_ids=segments)
        else:
            # decode-mode chunk: write this chunk's K/V first (the chunk's
            # own causal prefix must be visible to it), then attend
            cache.write(layer, k, v, positions, page_table)
            out = cache.attend(layer, q, positions, page_table)
        return F.linear(out.reshape(b, t, h * d), self.o_proj.weight.to(dt))


class Mlp(nn.Module):
    def __init__(self, cfg: LlamaConfig, dev):
        super().__init__()
        self.cfg = cfg
        self.gate_proj = _linear(cfg.d_model, cfg.d_ff, cfg, dev)
        self.up_proj = _linear(cfg.d_model, cfg.d_ff, cfg, dev)
        self.down_proj = _linear(cfg.d_ff, cfg.d_model, cfg, dev)

    def forward(self, x):
        dt = self.cfg.dtype
        x = x.to(dt)
        gate = F.linear(x, self.gate_proj.weight.to(dt))
        up = F.linear(x, self.up_proj.weight.to(dt))
        return F.linear(F.silu(gate) * up, self.down_proj.weight.to(dt))


class DecoderLayer(nn.Module):
    def __init__(self, cfg: LlamaConfig, dev):
        super().__init__()
        self.attn_norm = RMSNorm(cfg.d_model, cfg.norm_eps, cfg, dev)
        self.attn = Attention(cfg, dev)
        self.mlp_norm = RMSNorm(cfg.d_model, cfg.norm_eps, cfg, dev)
        self.mlp = Mlp(cfg, dev)

    def forward(self, x, positions, cache=None, layer: int = 0,
                page_table=None, segments=None):
        x = x + self.attn(self.attn_norm(x), positions, cache, layer,
                          page_table, segments)
        return x + self.mlp(self.mlp_norm(x))


class Llama(nn.Module):
    """The decoder stack. ``forward(tokens)`` is the full causal forward
    at positions ``0..T-1`` (``segments [B, T]``: packed documents, each
    with its own positions and attention); with ``cache`` it is a
    decode-mode chunk at per-row ``starts`` (``[B]`` int32) that writes
    K/V into the cache in place (``page_table [B, P]`` int32 for a
    :class:`PagedKVPool`). Returns f32 logits ``[B, T, vocab]``, or
    ``(features, head)`` in the compute dtype for a full-sequence forward
    under ``cfg.fused_ce``."""

    def __init__(self, cfg: LlamaConfig, device: DeviceLike = "cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.embed_tokens = nn.Parameter(torch.empty(
            cfg.vocab_size, cfg.d_model, dtype=cfg.param_dtype, device=dev))
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, dev) for _ in range(cfg.n_layers))
        self.final_norm = RMSNorm(cfg.d_model, cfg.norm_eps, cfg, dev)
        self.lm_head = None
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(torch.empty(
                cfg.vocab_size, cfg.d_model, dtype=cfg.param_dtype,
                device=dev))

    @property
    def device(self) -> torch.device:
        return self.embed_tokens.device

    def forward(self, tokens, cache=None, starts=None, page_table=None,
                segments=None):
        cfg = self.cfg
        b, t = tokens.shape
        x = F.embedding(tokens.long(), self.embed_tokens).to(cfg.dtype)
        steps = torch.arange(t, dtype=torch.int32, device=tokens.device)
        if cache is not None:
            positions = starts.to(torch.int32)[:, None] + steps[None, :]
        elif segments is not None:
            # packed documents: positions restart at every document
            positions = steps[None, :] - document_starts(segments)
        else:
            positions = steps[None, :].expand(b, t)
        remat = cache is None and cfg.remat and torch.is_grad_enabled()
        if remat and cfg.remat_policy != "nothing":
            raise ValueError(f"remat_policy {cfg.remat_policy!r} is not "
                             f"ported; known: ['nothing']")
        for i, layer in enumerate(self.layers):
            if remat:
                x = _Remat.apply(
                    lambda h, layer=layer: layer(h, positions,
                                                 segments=segments),
                    x, *layer.parameters())
            else:
                x = layer(x, positions, cache, i, page_table, segments)
        x = self.final_norm(x)
        head = self.embed_tokens if self.lm_head is None else self.lm_head
        if cfg.fused_ce and cache is None:
            return x.to(cfg.dtype), head.to(cfg.dtype)
        return F.linear(x.to(cfg.dtype), head.to(cfg.dtype)).float()


class _Remat(torch.autograd.Function):
    """Per-layer rematerialization: the forward runs the layer without
    keeping any activation, the backward runs it again under autograd and
    differentiates that (the reference's ``nn.remat`` with the
    ``nothing_saveable`` policy). The layer's parameters are inputs, so
    their gradients flow through the usual graph. Written here rather than
    taken from ``torch.utils.checkpoint``, whose first call imports
    ``torch._dynamo``, which writes ``TORCHINDUCTOR_CACHE_DIR`` into
    ``os.environ``: the port leaves the process environment alone (its
    optimizer, ``parallel.train.AdamW``, avoids the import too)."""

    @staticmethod
    def forward(ctx, fn, x, *params):
        ctx.fn, ctx.params = fn, params
        ctx.save_for_backward(x)
        with torch.no_grad():
            return fn(x)

    @staticmethod
    def backward(ctx, grad):
        x = ctx.saved_tensors[0].detach().requires_grad_()
        with torch.enable_grad():
            out = ctx.fn(x)
        live = [p for p in ctx.params if p.requires_grad]
        dx, *dparams = torch.autograd.grad(out, [x] + live, grad,
                                           allow_unused=True)
        dparams = iter(dparams)
        return (None, dx, *(next(dparams) if p.requires_grad else None
                            for p in ctx.params))


def _trunc_normal_(t: torch.Tensor, std: float, gen: torch.Generator):
    """In place: normal(0, std) truncated at two standard deviations, by
    the inverse CDF (the law of JAX's ``truncated_normal``)."""
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    hi = 0.5 * (1.0 + math.erf(2.0 / math.sqrt(2.0)))
    u = torch.empty(t.shape, dtype=torch.float32, device=t.device)
    u.uniform_(lo, hi, generator=gen)
    x = torch.erfinv(2.0 * u - 1.0).mul_(math.sqrt(2.0)).clamp_(-2.0, 2.0)
    t.copy_(x.mul_(std))


def init_params(cfg: LlamaConfig, seed: int = 0,
                device: DeviceLike = "cuda", *,
                trainable: bool = False) -> Llama:
    """A :class:`Llama` with random weights drawn from a seeded
    ``torch.Generator`` on ``device``, by the reference's init laws:
    lecun-normal dense kernels (truncated normal, std ``1/sqrt(fan_in)``
    over JAX's truncation correction 0.8796), ones for norm scales,
    normal(0.02) for the embedding and the untied head. Weights are
    frozen (``requires_grad=False``) unless ``trainable``."""
    model = Llama(cfg, device)
    gen = torch.Generator(device=model.device)
    gen.manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.requires_grad_(trainable)
        for name, p in model.named_parameters():
            if name.endswith("scale"):
                p.fill_(1.0)
            elif name in ("embed_tokens", "lm_head"):
                noise = torch.empty(p.shape, dtype=torch.float32,
                                    device=p.device)
                noise.normal_(0.0, 0.02, generator=gen)
                p.copy_(noise)
            else:
                _trunc_normal_(p, (1.0 / p.shape[1]) ** 0.5
                               / 0.87962566103423978, gen)
    return model


def make_loss_fn(cfg: LlamaConfig):
    """Causal-LM loss ``loss_fn(model, batch) -> scalar``: predict
    ``tokens[:, t + 1]`` from ``tokens[:, :t + 1]``. ``batch`` holds
    ``tokens [B, T]`` and optionally ``mask [B, T]`` (positions to
    predict from) and ``segments [B, T]`` (packed documents; a position
    whose next token starts another document predicts nothing). ``model``
    must be built from ``cfg``."""

    def loss_fn(model: Llama, batch) -> torch.Tensor:
        if model.cfg != cfg:
            raise ValueError("loss_fn's config differs from the model's")
        tokens = batch["tokens"]
        segments = batch.get("segments")
        out = model(tokens, segments=segments)
        mask = batch.get("mask")
        shifted_mask = mask[:, 1:] if mask is not None else None
        if segments is not None:
            shifted_mask = _segment_shift_mask(segments, shifted_mask)
        return _lm_loss(cfg, out, tokens, shifted_mask)

    return loss_fn


def _segment_shift_mask(segments, shifted_mask):
    """Cross-document next-token rule: a position whose next token
    belongs to a different document must not be asked to predict it."""
    same_doc = segments[:, 1:] == segments[:, :-1]
    return same_doc if shifted_mask is None \
        else shifted_mask.to(torch.bool) & same_doc


def _lm_loss(cfg: LlamaConfig, out, tokens, shifted_mask):
    """Next-token loss tail: ``out`` is logits, or ``(features, head)``
    under ``cfg.fused_ce``."""
    if cfg.fused_ce:
        features, head = out
        return chunked_cross_entropy(features[:, :-1], head, tokens[:, 1:],
                                     mask=shifted_mask)
    return cross_entropy_loss(out[:, :-1], tokens[:, 1:], shifted_mask)
