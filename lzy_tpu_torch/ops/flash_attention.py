"""Flash attention (forward and backward) for the full-sequence forward.

The port's counterpart of ``lzy_tpu/ops/flash_attention.py``:

- :func:`document_starts` and :func:`segment_bounds` — a document is a
  contiguous run of equal segment ids (a repeated id in a later run is a
  new document); every position carries ``(id, start, end)`` of its
  document as one ``[B, T, 3]`` int32 tensor, the counterpart of the
  reference's ``segment_slab`` without its 128-lane TPU layout;
- :func:`flash_fwd` and :func:`flash_bwd` — the wrappers of the three
  hand-written Hopper kernels in ``csrc/flash_attention.cu`` (forward,
  dQ, dK/dV; the counterparts of ``_fwd_kernel``, ``_bwd_dq_kernel`` and
  ``_bwd_dkv_kernel``), through :func:`flash_bwd_dq` and
  :func:`flash_bwd_dkv`. On CUDA tensors they launch the kernels or
  raise; on CPU tensors they run the plain versions. Each kernel's
  wrapper counts its launches: ``flash_fwd.launches``,
  ``flash_bwd_dq.launches`` and ``flash_bwd_dkv.launches``;
- :func:`flash_attention_plain` and :func:`flash_attention_bwd_plain` —
  the plain PyTorch versions (the twins the kernels are held to): the
  same f32 math over the whole ``[T, T]`` score matrix at once;
- :func:`flash_attention` — the public op, ``_Flash`` (a
  ``torch.autograd.Function``, the counterpart of the ``_flash``
  ``custom_vjp``) around them.

Semantics, as in the reference: scores ``(q * scale) . k`` in f32, an
additive ``kv_mask`` bias (0 keep, ``-1e30`` drop), causal and document
masks to ``-1e30``; a query row with nothing visible has zero output,
``lse = -1e30`` and zero gradients (``lse > -1e30 / 2`` guards the
backward). ``delta = rowsum(dO * O)`` is computed outside the kernels, as
the reference's ``_bwd`` does.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

NEG_INF = -1e30
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def document_starts(segment_ids: torch.Tensor) -> torch.Tensor:
    """``[B, T]`` document ids -> ``[B, T]`` int32 start index of each
    position's document, a document being a contiguous run of equal ids
    (cummax over change points). The start uniquely names the run, so
    every attention path compares starts, never raw ids. Idempotent."""
    b, t = segment_ids.shape
    seg = segment_ids.to(torch.int32)
    idx = torch.arange(t, dtype=torch.int32, device=seg.device)
    first = torch.ones_like(seg, dtype=torch.bool)
    first[:, 1:] = seg[:, 1:] != seg[:, :-1]
    marks = torch.where(first, idx[None, :], torch.zeros_like(seg))
    return torch.cummax(marks, dim=1).values.to(torch.int32)


def segment_bounds(segment_ids: torch.Tensor) -> torch.Tensor:
    """``[B, T]`` non-decreasing document ids -> ``[B, T, 3]`` int32
    ``(id, start, end)`` per position (``end`` exclusive). Positions of one
    document share start and end, which turns the mask into loop bounds
    for the kernels."""
    b, t = segment_ids.shape
    seg = segment_ids.to(torch.int32)
    idx = torch.arange(t, dtype=torch.int32, device=seg.device)
    last = torch.ones_like(seg, dtype=torch.bool)
    last[:, :-1] = seg[:, 1:] != seg[:, :-1]
    ends = torch.where(last, idx[None, :] + 1, torch.full_like(seg, t))
    end = torch.cummin(ends.flip(1), dim=1).values.flip(1)
    return torch.stack([seg, document_starts(seg), end], dim=-1).to(
        torch.int32)


def _keep(b: int, t: int, causal: bool, bounds: Optional[torch.Tensor],
          device) -> Optional[torch.Tensor]:
    """``[B, 1, T, T]`` boolean: query row may see key column (causal and
    same document), or None when nothing is masked structurally."""
    keep = None
    if causal:
        keep = torch.ones(t, t, dtype=torch.bool, device=device).tril()
        keep = keep[None, None].expand(b, 1, t, t)
    if bounds is not None:
        ids = bounds[..., 0]
        same = (ids[:, :, None] == ids[:, None, :])[:, None]
        keep = same if keep is None else keep & same
    return keep


def _scores(q, k, bias, bounds, scale, causal):
    """f32 scores with bias and masks applied, and the keep mask."""
    b, h, t, _ = q.shape
    s = torch.matmul(q.float() * scale, k.float().transpose(-1, -2))
    if bias is not None:
        s = s + bias[:, None, None, :]
    keep = _keep(b, t, causal, bounds, q.device)
    if keep is not None:
        s = s.masked_fill(~keep, NEG_INF)
    return s, keep


def _fwd_plain(q, k, v, bias, bounds, scale, causal):
    s, keep = _scores(q, k, bias, bounds, scale, causal)
    m = s.amax(dim=-1, keepdim=True)
    m_safe = torch.where(m <= NEG_INF / 2, torch.zeros_like(m), m)
    p = torch.exp(s - m_safe)
    if keep is not None:
        p = p.masked_fill(~keep, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p, v.float()) / l.clamp_min(1e-30)
    lse = torch.where(l > 0, m + torch.log(l.clamp_min(1e-30)),
                      torch.full_like(l, NEG_INF))
    return o.to(q.dtype), lse[..., 0]


def _bwd_plain(q, k, v, bias, bounds, o, lse, do, scale, causal):
    return _bwd_plain_from_delta(q, k, v, bias, bounds, lse,
                                 flash_delta(o, do), do, scale, causal)


def _bwd_plain_from_delta(q, k, v, bias, bounds, lse, delta, do, scale,
                          causal):
    s, keep = _scores(q, k, bias, bounds, scale, causal)
    lse = lse[..., None]
    p = torch.exp(s - lse)
    # an empty row stores lse = -1e30, which would cancel a -1e30 bias
    # and resurrect p; its softmax had no mass, so its gradient is zero
    p = torch.where(lse > NEG_INF / 2, p, torch.zeros_like(p))
    if keep is not None:
        p = p.masked_fill(~keep, 0.0)
    do32 = do.float()
    dp = torch.matmul(do32, v.float().transpose(-1, -2))
    ds = p * (dp - delta[..., None]) * scale
    dq = torch.matmul(ds, k.float())
    dk = torch.matmul(ds.transpose(-1, -2), q.float())
    dv = torch.matmul(p.transpose(-1, -2), do32)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _mask_operands(q, kv_mask, segment_ids):
    """``kv_mask [B, T]`` bool -> f32 additive bias; ``segment_ids
    [B, T]`` -> ``[B, T, 3]`` bounds of the normalized runs."""
    b, _, t, _ = q.shape
    bias = bounds = None
    if kv_mask is not None:
        if tuple(kv_mask.shape) != (b, t):
            raise ValueError(f"kv_mask shape {tuple(kv_mask.shape)} != "
                             f"(batch, seq) = {(b, t)}")
        bias = torch.where(kv_mask.to(torch.bool),
                           torch.zeros((), device=q.device),
                           torch.full((), NEG_INF, device=q.device)).float()
    if segment_ids is not None:
        if tuple(segment_ids.shape) != (b, t):
            raise ValueError(f"segment_ids shape {tuple(segment_ids.shape)}"
                             f" != {(b, t)}")
        # the id the kernels compare IS the run's start, so the mask and
        # the loop bounds agree whatever ids the caller passed
        bounds = segment_bounds(document_starts(segment_ids))
    return bias, bounds


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          kv_mask: Optional[torch.Tensor] = None,
                          segment_ids: Optional[torch.Tensor] = None,
                          scale: Optional[float] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain forward: ``q/k/v [B, H, T, D]`` -> ``(o [B, H, T, D] in q's
    dtype, lse [B, H, T] f32)``."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    bias, bounds = _mask_operands(q, kv_mask, segment_ids)
    return _fwd_plain(q, k, v, bias, bounds, scale, causal)


def flash_attention_bwd_plain(q, k, v, o, lse, do, *, causal: bool = True,
                              kv_mask: Optional[torch.Tensor] = None,
                              segment_ids: Optional[torch.Tensor] = None,
                              scale: Optional[float] = None):
    """Plain backward: ``(dq, dk, dv)`` from the forward's ``o`` and
    ``lse`` and the output cotangent ``do``."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    bias, bounds = _mask_operands(q, kv_mask, segment_ids)
    return _bwd_plain(q, k, v, bias, bounds, o, lse, do, scale, causal)


# -- the kernels' wrappers -------------------------------------------------


def _check_kernel_args(tensors, bias, bounds) -> None:
    q = tensors[0]
    b, h, t, d = q.shape
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"flash kernels take float32 or bfloat16, got "
                         f"{q.dtype}")
    if d % 16 or not 16 <= d <= 128:
        raise ValueError(f"flash kernels take head dims that are multiples "
                         f"of 16 up to 128, got {d}")
    for x in tensors:
        if x.shape != q.shape or x.dtype != q.dtype:
            raise ValueError(f"flash operands must share q's shape "
                             f"{tuple(q.shape)} and dtype {q.dtype}")
    if bias is not None and (bias.dtype != torch.float32
                             or tuple(bias.shape) != (b, t)):
        raise ValueError(f"kv bias must be float32 [{b}, {t}]")
    if bounds is not None and (bounds.dtype != torch.int32
                               or tuple(bounds.shape) != (b, t, 3)):
        raise ValueError(f"segment bounds must be int32 [{b}, {t}, 3]")
    for x in list(tensors) + [x for x in (bias, bounds) if x is not None]:
        if x.device != q.device:
            raise ValueError("all flash operands must share q's device")
        if not x.is_contiguous():
            raise ValueError("flash operands must be contiguous")
        if x.data_ptr() % 16:
            raise ValueError("flash operands must be 16-byte aligned")


_bound = {}


def _launcher(name: str):
    """One of the kernels' C launchers, built, loaded and given its
    signature on first use."""
    fn = _bound.get(name)
    if fn is None:
        from lzy_tpu_torch.ops.build import load

        fn = getattr(load("flash_attention"), name)
        fn.restype = ctypes.c_int
        n_ptr = {"lzy_flash_fwd": 7, "lzy_flash_bwd_dq": 9,
                 "lzy_flash_bwd_dkv": 10}[name]
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * n_ptr
                       + [ctypes.c_int] * 5 + [ctypes.c_float,
                                               ctypes.c_void_p])
        _bound[name] = fn
    return fn


def _launch(name: str, q, ptrs, bias, bounds, causal, scale) -> None:
    b, h, t, d = q.shape
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _launcher(name)(
            _DTYPE_CODES[q.dtype], *ptrs,
            None if bias is None else bias.data_ptr(),
            None if bounds is None else bounds.data_ptr(),
            b, h, t, d, int(causal), scale, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed (code {rc})")


def flash_fwd(q, k, v, bias, bounds, *, scale: float, causal: bool):
    """Forward: ``(o, lse)``. ``bias [B, T]`` f32 or None, ``bounds
    [B, T, 3]`` int32 or None. CUDA tensors launch the forward kernel (or
    raise); CPU tensors run the plain version."""
    if not q.is_cuda:
        return _fwd_plain(q, k, v, bias, bounds, scale, causal)
    _check_kernel_args((q, k, v), bias, bounds)
    o = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    if q.numel():
        _launch("lzy_flash_fwd", q, [q.data_ptr(), k.data_ptr(),
                                     v.data_ptr(), o.data_ptr(),
                                     lse.data_ptr()],
                bias, bounds, causal, scale)
        flash_fwd.launches += 1
    return o, lse


def flash_bwd_dq(q, k, v, bias, bounds, lse, delta, do, *, scale: float,
                 causal: bool):
    """dQ: per Q tile, a loop over KV tiles. CUDA tensors launch the dQ
    kernel (or raise); CPU tensors run the plain backward."""
    if not q.is_cuda:
        return _bwd_plain_from_delta(q, k, v, bias, bounds, lse, delta, do,
                                     scale, causal)[0]
    _check_bwd_args(q, k, v, bias, bounds, lse, delta, do)
    dq = torch.empty_like(q)
    if q.numel():
        _launch("lzy_flash_bwd_dq", q,
                [q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                 lse.data_ptr(), delta.data_ptr(), dq.data_ptr()],
                bias, bounds, causal, scale)
        flash_bwd_dq.launches += 1
    return dq


def flash_bwd_dkv(q, k, v, bias, bounds, lse, delta, do, *, scale: float,
                  causal: bool):
    """(dK, dV): per KV tile, a loop over Q tiles. CUDA tensors launch the
    dK/dV kernel (or raise); CPU tensors run the plain backward."""
    if not q.is_cuda:
        return _bwd_plain_from_delta(q, k, v, bias, bounds, lse, delta, do,
                                     scale, causal)[1:]
    _check_bwd_args(q, k, v, bias, bounds, lse, delta, do)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if q.numel():
        _launch("lzy_flash_bwd_dkv", q,
                [q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                 lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
                 dv.data_ptr()],
                bias, bounds, causal, scale)
        flash_bwd_dkv.launches += 1
    return dk, dv


def _check_bwd_args(q, k, v, bias, bounds, lse, delta, do) -> None:
    _check_kernel_args((q, k, v, do), bias, bounds)
    for x in (lse, delta):
        if x.dtype != torch.float32 or x.shape != q.shape[:3] \
                or not x.is_contiguous() or x.device != q.device:
            raise ValueError("lse and delta must be contiguous float32 "
                             "[B, H, T] on q's device")


def flash_delta(o, do) -> torch.Tensor:
    """``rowsum(dO * O)`` in f32, ``[B, H, T]``: computed outside the
    kernels, as the reference's ``_bwd`` does."""
    return (do.float() * o.float()).sum(dim=-1)


def flash_bwd(q, k, v, bias, bounds, o, lse, do, *, scale: float,
              causal: bool):
    """Backward: ``(dq, dk, dv)`` from the forward's ``o`` and ``lse``.
    CUDA tensors launch the dQ and the dK/dV kernels; CPU tensors run the
    plain version."""
    if not q.is_cuda:
        return _bwd_plain(q, k, v, bias, bounds, o, lse, do, scale, causal)
    do = do.contiguous()
    delta = flash_delta(o, do)
    dq = flash_bwd_dq(q, k, v, bias, bounds, lse, delta, do, scale=scale,
                      causal=causal)
    dk, dv = flash_bwd_dkv(q, k, v, bias, bounds, lse, delta, do,
                           scale=scale, causal=causal)
    return dq, dk, dv


#: kernel launches on CUDA tensors (the plain CPU path does not count)
flash_fwd.launches = 0
flash_bwd_dq.launches = 0
flash_bwd_dkv.launches = 0


def launches() -> Tuple[int, int, int]:
    """(forward, dQ, dK/dV) kernel launches so far."""
    return flash_fwd.launches, flash_bwd_dq.launches, flash_bwd_dkv.launches


def reset_launches() -> None:
    flash_fwd.launches = 0
    flash_bwd_dq.launches = 0
    flash_bwd_dkv.launches = 0


class _Flash(torch.autograd.Function):
    """Forward saves ``o`` and ``lse``; backward runs the dQ and dK/dV
    kernels. The bias and bounds encode boolean structure and get no
    gradient."""

    @staticmethod
    def forward(ctx, q, k, v, bias, bounds, scale, causal):
        o, lse = flash_fwd(q, k, v, bias, bounds, scale=scale,
                           causal=causal)
        ctx.save_for_backward(q, k, v, bias, bounds, o, lse)
        ctx.scale, ctx.causal = scale, causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, bias, bounds, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, bias, bounds, o, lse, do,
                               scale=ctx.scale, causal=ctx.causal)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, *, causal: bool = True,
                    kv_mask: Optional[torch.Tensor] = None,
                    segment_ids: Optional[torch.Tensor] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """``q/k/v [B, H, T, D]`` -> ``[B, H, T, D]``, differentiable.

    ``kv_mask``: optional ``[B, T]`` boolean, True = attend to that KV
    position; a query row with no visible key gets zero output and zero
    gradients. ``segment_ids``: optional ``[B, T]`` ints; attention stays
    inside documents (contiguous runs of equal ids), and the kernels'
    loops skip tiles outside the query tile's documents.

    CUDA tensors run the hand-written kernels (any T; head dims that are
    multiples of 16 up to 128; float32 or bfloat16), CPU tensors the
    plain versions."""
    scale = q.shape[-1] ** -0.5 if scale is None else float(scale)
    bias, bounds = _mask_operands(q, kv_mask, segment_ids)
    q, k, v = (x.contiguous() for x in (q, k, v))
    return _Flash.apply(q, k, v, bias, bounds, scale, causal)
