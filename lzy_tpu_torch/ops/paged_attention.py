"""Paged attention through the page table, plus int8 KV-block quantization.

The port's counterpart of ``lzy_tpu/ops/paged_attention.py``:

- :func:`quantize_kv` / :func:`dequantize_kv` — per-position, per-head
  asymmetric int8 quantization, bit-equal to the reference's, with one
  dequantization formula (f32 multiply, f32 add, cast) that every read
  path (plain and kernel) evaluates the same way;
- :func:`paged_attention_plain` — the plain PyTorch version, the
  counterpart of ``_lax_paged_attention``: gather the row's blocks into
  position order and run the dense score/mask/softmax/P.V sequence in the
  reference's op order (f32 scores, ``d**-0.5`` after the dot, ``-1e30``
  mask, probabilities cast to the compute dtype before P.V);
- :func:`paged_attention` — the public op and the wrapper of the
  hand-written Hopper kernel ``csrc/paged_attention.cu`` (the counterpart
  of ``_pallas_kernel``): on CUDA tensors it launches the kernel (or
  raises), on CPU tensors it runs the plain version. It counts its
  launches in ``paged_attention.launches``.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
#: f32 constants of the reference's lowered log2/exp2 (quantize_kv)
_LN2 = float(np.float32(np.log(2.0)))
_INV_LN2 = float(np.float32(1.0 / np.log(2.0)))


class KVQuant(NamedTuple):
    """int8 pool sidecars, each ``[n_blocks, page_size, kv_heads]`` f32:
    one scale and zero-point per written K/V vector."""

    k_scale: torch.Tensor
    k_zp: torch.Tensor
    v_scale: torch.Tensor
    v_zp: torch.Tensor


def quantize_kv(x: torch.Tensor):
    """Asymmetric int8 quantization over the head dim: ``x [..., d]`` ->
    ``(q int8 [..., d], scale [...], zp [...])`` with ``deq = q * scale +
    zp``. The scale is rounded up to (nearly) a power of two as in the
    reference's ``quantize_kv``, and ``torch.round`` rounds half to even
    like ``jnp.round``.

    The reference's ``jnp.log2``/``jnp.exp2`` lower on XLA to ``log(x) *
    (1/ln 2)`` and ``exp(k * ln 2)`` in f32, which are neither exact logs
    nor exact powers of two (``exp2(-16)`` comes out one ulp below
    ``2**-16``). This function evaluates the same formulas, with each
    transcendental in f64 rounded once to f32, so its codes and sidecars
    match the reference bit for bit, on any device."""
    x32 = x.float()
    hi = x32.amax(dim=-1)
    lo = x32.amin(dim=-1)
    zp = (hi + lo) * 0.5
    step = torch.clamp((hi - lo) / 254.0, min=1e-30)
    k = torch.ceil(torch.log(step.double()).float() * _INV_LN2)
    scale = torch.exp((k * _LN2).double()).float()
    q = torch.clamp(torch.round((x32 - zp[..., None]) / scale[..., None]),
                    -127, 127).to(torch.int8)
    return q, scale, zp


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor, zp: torch.Tensor,
                  dtype: torch.dtype) -> torch.Tensor:
    """Inverse of :func:`quantize_kv`: an f32 multiply, an f32 add (two
    roundings, never fused: the scale is not always an exact power of
    two), then the cast."""
    return (q.float() * scale[..., None] + zp[..., None]).to(dtype)


def attend(q: torch.Tensor, keys: torch.Tensor, vals: torch.Tensor,
           positions: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Dense grouped-query attention over a position-ordered cache.

    ``q [B, T, H, D]``, ``keys``/``vals [B, L, KV, D]``, ``positions
    [B, T]`` -> ``[B, T, KV, G, D]``. Slot ``l`` is visible to a query iff
    ``l <= position``; masked slots get ``-1e30`` and weigh exactly 0."""
    b, t, h, d = q.shape
    L, kv_heads = keys.shape[1], keys.shape[2]
    qg = q.reshape(b, t, kv_heads, h // kv_heads, d)
    s = torch.einsum("btkgd,blkd->bkgtl", qg.float(), keys.float()) \
        * (d ** -0.5)                                   # [B, KV, G, T, L]
    visible = (torch.arange(L, device=q.device)[None, None, None, None, :]
               <= positions[:, None, None, :, None])
    s = s.masked_fill(~visible, NEG_INF)
    p = torch.softmax(s, dim=-1).to(dtype)
    return torch.einsum("bkgtl,blkd->btkgd", p, vals.to(dtype))


def paged_attention_plain(q, k_pool, v_pool, page_table, positions, *,
                          dtype: torch.dtype,
                          quant: Optional[KVQuant] = None) -> torch.Tensor:
    """Gather-then-attend, the reference ``_lax_paged_attention``'s op
    order. Block ids are clamped into the pool like the reference's gather
    (``torch`` indexing would raise where ``jnp`` clamps)."""
    b, pages = page_table.shape
    n, page, kv_heads, d = k_pool.shape
    pt = page_table.long().clamp(0, n - 1)
    keys, vals = k_pool[pt], v_pool[pt]                 # [B, P, page, KV, D]
    if quant is not None:
        keys = dequantize_kv(keys, quant.k_scale[pt], quant.k_zp[pt], dtype)
        vals = dequantize_kv(vals, quant.v_scale[pt], quant.v_zp[pt], dtype)
    keys = keys.reshape(b, pages * page, kv_heads, d)
    vals = vals.reshape(b, pages * page, kv_heads, d)
    return attend(q, keys, vals, positions, dtype)


def _check_kernel_args(q, k_pool, v_pool, page_table, positions, dtype,
                       quant) -> None:
    b, t, h, d = q.shape
    n, page, kv_heads, d2 = k_pool.shape
    if d2 != d or v_pool.shape != k_pool.shape:
        raise ValueError(f"pool shapes {tuple(k_pool.shape)}/"
                         f"{tuple(v_pool.shape)} do not match q {tuple(q.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"paged-attention kernel supports head dims "
                         f"{HEAD_DIMS}, got {d}")
    if h % kv_heads:
        raise ValueError(f"{h} heads are not a multiple of {kv_heads} kv heads")
    if q.dtype != dtype or dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"q dtype {q.dtype} must equal the compute dtype "
                         f"{dtype} (float32 or bfloat16)")
    if (quant is None) != (k_pool.dtype != torch.int8) or \
            k_pool.dtype not in (dtype, torch.int8):
        raise ValueError(f"pool dtype {k_pool.dtype} needs quant sidecars iff "
                         f"int8, else must equal {dtype}")
    if page_table.dtype != torch.int32 or positions.dtype != torch.int32:
        raise ValueError("page_table and positions must be int32")
    if page_table.shape[0] != b or tuple(positions.shape) != (b, t):
        raise ValueError(f"page_table {tuple(page_table.shape)} / positions "
                         f"{tuple(positions.shape)} do not match q")
    tensors = [q, k_pool, v_pool, page_table, positions]
    if quant is not None:
        for side in quant:
            if side.dtype != torch.float32 or \
                    tuple(side.shape) != (n, page, kv_heads):
                raise ValueError("quant sidecars must be f32 "
                                 f"[{n}, {page}, {kv_heads}]")
        tensors += list(quant)
    for x in tensors:
        if x.device != q.device:
            raise ValueError("all paged-attention operands must share "
                             "q's device")
        if not x.is_contiguous():
            raise ValueError("paged-attention operands must be contiguous")
    if k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16:
        raise ValueError("pools must be 16-byte aligned")


_bound = None


def _launcher():
    """The kernel's C launcher, built, loaded and given its signature on
    first use."""
    global _bound
    if _bound is None:
        from lzy_tpu_torch.ops.build import load

        fn = load("paged_attention").lzy_paged_attention
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_int] * 3 + [ctypes.c_void_p] * 10
                       + [ctypes.c_int] * 7 + [ctypes.c_float,
                                               ctypes.c_void_p])
        _bound = fn
    return _bound


def paged_attention(q, k_pool, v_pool, page_table, positions, *,
                    dtype: Optional[torch.dtype] = None,
                    quant: Optional[KVQuant] = None) -> torch.Tensor:
    """Attention read directly through the page table.

    - ``q``: ``[B, T, H, D]`` post-RoPE queries (T=1 decode, T=gamma+1
      speculative verify, T=chunk prefill);
    - ``k_pool``/``v_pool``: ``[n_blocks, page_size, KV, D]`` (float, or
      int8 with ``quant`` sidecars);
    - ``page_table``: ``[B, P]`` int32 block ids in position order (0 is
      the scratch block); ``positions``: ``[B, T]`` int32 absolute
      positions (slot ``l`` visible iff ``l <= position``);
    - ``dtype``: compute/output dtype (defaults to the pool's; int8 pools
      must pass it).

    Returns ``[B, T, KV, G, D]``. CUDA tensors launch the Hopper kernel
    ``csrc/paged_attention.cu`` on the current stream (or raise: there is
    no fall back); CPU tensors run :func:`paged_attention_plain`, since
    the kernel has no CPU form. Allocates the output; never synchronizes.
    """
    if dtype is None:
        if quant is not None:
            raise ValueError("quantized pools need an explicit dtype")
        dtype = k_pool.dtype
    if not q.is_cuda:
        return paged_attention_plain(q, k_pool, v_pool, page_table,
                                     positions, dtype=dtype, quant=quant)
    _check_kernel_args(q, k_pool, v_pool, page_table, positions, dtype, quant)
    b, t, h, d = q.shape
    n, page, kv_heads, _ = k_pool.shape
    out = torch.empty((b, t, kv_heads, h // kv_heads, d), dtype=dtype,
                      device=q.device)
    if b * t == 0:
        return out
    fn = _launcher()
    side = [x.data_ptr() for x in quant] if quant is not None else [None] * 4
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(_DTYPE_CODES[dtype], _DTYPE_CODES[k_pool.dtype], d,
                q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), *side,
                page_table.data_ptr(), positions.data_ptr(), out.data_ptr(),
                b, t, h, kv_heads, n, page, page_table.shape[1],
                d ** -0.5, stream)
    if rc != 0:
        raise RuntimeError(f"paged-attention kernel launch failed (code {rc})")
    paged_attention.launches += 1
    return out


#: kernel launches on CUDA tensors (the plain CPU path does not count)
paged_attention.launches = 0
