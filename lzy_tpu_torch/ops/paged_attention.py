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
  hand-written Hopper kernels ``csrc/paged_attention.cu`` (the counterpart
  of ``_pallas_kernel``: split-K over pages in two passes): on
  CUDA tensors it launches them (or raises), on CPU tensors it runs the
  plain version. It counts its launches in ``paged_attention.launches``,
  one per call;
- :func:`split_plan` and :func:`split_pages` — how many splits of the
  page walk the wrapper asks for, and which pages each split reads: plain
  Python, the same arithmetic the kernels do on the card.
"""

from __future__ import annotations

import ctypes
import math
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
    if q.data_ptr() % 16 or k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16:
        raise ValueError("q and the pools must be 16-byte aligned")


def row_tile(rows: int) -> int:
    """Query rows per kernel tile: decode's G heads of one token take 4,
    more rows take 8 (the kernels' own rule, csrc/paged_attention.cu
    ``launch``)."""
    return 4 if rows <= 4 else 8


#: CTAs a split plan aims for, in waves of one CTA per SM: one and a half,
#: so that the long rows' splits run beside the short rows' whole walks
#: (measured at chip_smoke.py's decode shape on an NVIDIA H100 80GB HBM3 at
#: 700 W: 4 splits of 64 CTAs beat 5, 3 and 2; at its verify shape 2
#: splits of 192 CTAs beat 1)
WAVES = 1.5
#: most splits of one page walk (the kernels' ``kMaxSplits``)
MAX_SPLITS = 64


def split_plan(batch: int, kv_heads: int, rows: int, pages: int,
               n_sm: int) -> int:
    """Splits of each (batch row, KV head, row tile)'s page walk.

    ``rows`` is T x G query rows per (batch row, KV head), ``pages`` the
    page table's width, ``n_sm`` the card's SM count. With ``batch x
    kv_heads x row tiles`` CTAs already filling ``WAVES`` waves, one split;
    else enough splits for ``WAVES`` waves, at most one per page. Shapes
    only: the plan never reads the positions (no device sync)."""
    ctas = batch * kv_heads * -(-rows // row_tile(rows))
    target = math.ceil(WAVES * n_sm)
    if ctas >= target:
        return 1
    return max(1, min(pages, MAX_SPLITS, -(-target // ctas)))


def split_pages(split: int, splits: int, visible_pages: int):
    """Pages ``[p0, p1)`` that split ``split`` of ``splits`` reads out of
    a tile's ``visible_pages`` (the pages holding slots 0 .. max position
    of its rows): an even share, on page boundaries, every page exactly
    once over the splits."""
    return (split * visible_pages // splits,
            (split + 1) * visible_pages // splits)


_bound = None
_sm_counts = {}


def _launcher():
    """The kernels' C launcher, built, loaded and given its signature on
    first use."""
    global _bound
    if _bound is None:
        from lzy_tpu_torch.ops.build import load

        fn = load("paged_attention").lzy_paged_attention
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_int] * 3 + [ctypes.c_void_p] * 14
                       + [ctypes.c_int] * 8 + [ctypes.c_float,
                                               ctypes.c_void_p])
        _bound = fn
    return _bound


def _sm_count(device: torch.device) -> int:
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    if index not in _sm_counts:
        _sm_counts[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    return _sm_counts[index]


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

    Returns ``[B, T, KV, G, D]``. CUDA tensors launch the Hopper kernels
    ``csrc/paged_attention.cu`` on the current stream (or raise: there is
    no fall back), split over pages as :func:`split_plan` says; CPU
    tensors run :func:`paged_attention_plain`, since the kernels have no
    CPU form. Allocates the output and one f32 scratch buffer; never
    synchronizes. One call counts one launch in
    ``paged_attention.launches`` and issues two CUDA launches (the
    statistics pass and the P.V pass, whose last CTA per row tile sums the
    splits).
    """
    if dtype is None:
        if quant is not None:
            raise ValueError("quantized pools need an explicit dtype")
        dtype = k_pool.dtype
    if not q.is_cuda:
        return paged_attention_plain(q, k_pool, v_pool, page_table,
                                     positions, dtype=dtype, quant=quant)
    b, t, h, _ = q.shape
    kv_heads = k_pool.shape[2]
    splits = split_plan(b, kv_heads, t * (h // max(kv_heads, 1)),
                        page_table.shape[-1], _sm_count(q.device))
    return _launch(q, k_pool, v_pool, page_table, positions, dtype=dtype,
                   quant=quant, splits=splits)


def _launch(q, k_pool, v_pool, page_table, positions, *, dtype, quant,
            splits: int) -> torch.Tensor:
    """The kernels on CUDA tensors with ``splits`` splits of every page
    walk (the tests force one and many)."""
    _check_kernel_args(q, k_pool, v_pool, page_table, positions, dtype, quant)
    b, t, h, d = q.shape
    n, page, kv_heads, _ = k_pool.shape
    pages = page_table.shape[1]
    most = max(1, min(pages, MAX_SPLITS))
    if not 1 <= splits <= most:
        raise ValueError(f"splits must be in [1, {most}], got {splits}")
    out = torch.empty((b, t, kv_heads, h // kv_heads, d), dtype=dtype,
                      device=q.device)
    if b * t == 0:
        return out
    rows = t * (h // kv_heads)
    # the f32 scratch, one allocation: per split and row (max, sum); the
    # splits' partial P.V and the row tiles' tickets where the walk is
    # split; and the scores pass 1 keeps for pass 2 where a slot's T x G
    # f32 scores are fewer bytes than its K row (decode, verify: K is
    # read once)
    heads = b * kv_heads
    sizes = (heads * splits * rows * 2 * 4,
             heads * splits * rows * d * 4 if splits > 1 else 0,
             heads * pages * page * rows * 4
             if rows * 4 < d * k_pool.element_size() else 0,
             heads * -(-rows // row_tile(rows)) * 4 if splits > 1 else 0)
    offsets, at = [], 0
    for size in sizes:
        offsets.append(at)
        at += -(-size // 256) * 256
    scratch = torch.empty(at, dtype=torch.uint8, device=q.device)
    base = scratch.data_ptr()
    ml, part, scores, tickets = (base + off if size else None
                                 for off, size in zip(offsets, sizes))
    fn = _launcher()
    side = [x.data_ptr() for x in quant] if quant is not None else [None] * 4
    args = (_DTYPE_CODES[dtype], _DTYPE_CODES[k_pool.dtype], d,
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), *side,
            page_table.data_ptr(), positions.data_ptr(), out.data_ptr(),
            ml, part, scores, tickets,
            b, t, h, kv_heads, n, page, pages, splits, d ** -0.5)
    if q.device.index == torch.cuda.current_device():
        rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(q.device):
            rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"paged-attention kernel launch failed (code {rc})")
    paged_attention.launches += 1
    return out


#: kernel launches on CUDA tensors, one per call (the plain CPU path does
#: not count)
paged_attention.launches = 0
