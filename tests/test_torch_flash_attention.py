"""Port flash attention (lzy_tpu_torch/ops/flash_attention.py) held to the
JAX reference (lzy_tpu/ops/flash_attention.py).

- ``document_starts`` and the per-position ``(id, start, end)`` bounds
  equal the reference's ``document_starts`` and lanes 0-2 of its
  ``segment_slab``;
- the port's plain forward and backward (what ``flash_attention`` runs on
  CPU tensors, through its ``torch.autograd.Function``) against the
  reference's Pallas kernels in interpret mode (``interpret=True``, as the
  reference's own tests run them) and ``jax.vjp`` of them, at B=1, H=2,
  T=256, D=32: causal; causal with packed documents including a repeated,
  non-adjacent id; causal with a ``kv_mask`` whose first keys are masked
  (so the first query rows see nothing: zero output, zero gradients); and
  non-causal with a ``kv_mask`` that masks one batch row entirely;
- the CUDA kernels against the plain versions on the card (marker
  ``cuda``; skipped without a card). On a machine without JAX run them as
  ``python -m pytest --noconftest -m cuda tests/test_torch_flash_attention.py``.

Inputs are drawn with numpy from fixed seeds and handed to both sides.
The reference is computed once per case (module-scoped fixture).
"""

import os

import numpy as np
import pytest
import torch

from lzy_tpu_torch.ops import flash_attention as fa

torch.set_num_threads(1)

#: f32 on both sides, the same products summed in another order (XLA's
#: dot in the interpreted kernel vs torch's matmul) over D=32 and T=256;
#: outputs and gradients are O(1), a few ulp apart
ATOL = 2e-5
RTOL = 1e-5

B, H, T, D = 1, 2, 256, 32


@pytest.fixture(autouse=True)
def _process_state_unchanged():
    """No test here may change process-wide state that a JAX test sharing
    this worker would read (the card's machine has no JAX)."""
    try:
        import jax
    except ImportError:
        jax = None

    def snap():
        # pytest itself rewrites PYTEST_CURRENT_TEST at every phase
        env = {k: v for k, v in os.environ.items()
               if k != "PYTEST_CURRENT_TEST"}
        flags = None if jax is None else (
            jax.config.jax_enable_x64, jax.config.jax_default_matmul_precision)
        return (flags, env, torch.get_default_dtype(),
                torch.is_grad_enabled())

    before = snap()
    yield
    assert snap() == before


def _segments(b, t):
    """Three runs; id 0 comes back after id 1, so it is a new document."""
    seg = np.zeros((b, t), np.int32)
    seg[:, 70:150] = 1
    seg[:, 150:200] = 0
    seg[:, 200:] = 2
    return seg


def _case(name):
    """(q, k, v, do, causal, kv_mask, segment_ids) in numpy."""
    rng = np.random.default_rng(hash(name) % 2**32)
    b = 2 if name == "kv_mask_batch_row" else B
    q, k, v, do = (rng.standard_normal((b, H, T, D)).astype(np.float32)
                   for _ in range(4))
    causal, mask, seg = True, None, None
    if name == "segments":
        seg = _segments(b, T)
    elif name == "kv_mask_first_keys":
        mask = np.ones((b, T), bool)
        mask[:, :8] = False            # query rows 0..7 see nothing
    elif name == "kv_mask_batch_row":
        causal = False
        mask = rng.random((b, T)) < 0.7
        mask[1] = False                # every row of batch row 1 is empty
    return q, k, v, do, causal, mask, seg


CASES = ["causal", "segments", "kv_mask_first_keys", "kv_mask_batch_row"]


@pytest.fixture(scope="module")
def reference():
    """Reference forward and vjp per case, computed once."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    import importlib

    # the module, not the package's same-named function export
    ref = importlib.import_module("lzy_tpu.ops.flash_attention")
    out = {}
    for name in CASES:
        q, k, v, do, causal, mask, seg = _case(name)

        def f(q_, k_, v_, causal=causal, mask=mask, seg=seg):
            return ref.flash_attention(
                q_, k_, v_, causal=causal,
                kv_mask=None if mask is None else jnp.asarray(mask),
                segment_ids=None if seg is None else jnp.asarray(seg),
                interpret=True)

        o, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        grads = vjp(jnp.asarray(do))
        out[name] = [np.asarray(x) for x in (o, *grads)]
    seg = jnp.asarray(_segments(2, T))
    out["starts"] = np.asarray(ref.document_starts(seg))
    out["slab"] = np.asarray(ref.segment_slab(ref.document_starts(seg)))
    return out


def _port(name, device="cpu", dtype=torch.float32):
    q, k, v, do, causal, mask, seg = _case(name)
    tq, tk, tv = (torch.from_numpy(x).to(device, dtype).requires_grad_()
                  for x in (q, k, v))
    o = fa.flash_attention(
        tq, tk, tv, causal=causal,
        kv_mask=None if mask is None else torch.from_numpy(mask).to(device),
        segment_ids=None if seg is None else torch.from_numpy(seg).to(device))
    o.backward(torch.from_numpy(do).to(device, dtype))
    return [x.detach().float().cpu().numpy()
            for x in (o, tq.grad, tk.grad, tv.grad)]


def test_document_starts_and_bounds_match_reference(reference):
    seg = torch.from_numpy(_segments(2, T))
    starts = fa.document_starts(seg)
    np.testing.assert_array_equal(starts.numpy(), reference["starts"])
    bounds = fa.segment_bounds(starts)
    np.testing.assert_array_equal(bounds.numpy(),
                                  reference["slab"][..., :3].astype(np.int32))
    # idempotent, and a repeated id in a later run is a new document
    assert torch.equal(fa.document_starts(starts), starts)
    assert int(starts[0, 160]) == 150 and int(starts[0, 10]) == 0


@pytest.mark.parametrize("name", CASES)
def test_plain_forward_and_grads_match_reference(reference, name):
    got = _port(name)
    for label, g, want in zip(("o", "dq", "dk", "dv"), got, reference[name]):
        np.testing.assert_allclose(g, want, atol=ATOL, rtol=RTOL,
                                   err_msg=f"{name}: {label}")


def test_empty_rows_give_zero_output_and_zero_grads(reference):
    o, dq, _, _ = _port("kv_mask_first_keys")
    assert not np.abs(o[:, :, :8]).any() and not np.abs(dq[:, :, :8]).any()
    o, dq, dk, dv = _port("kv_mask_batch_row")
    for x in (o, dq, dk, dv):
        assert not np.abs(x[1]).any()
    _, lse = fa.flash_attention_plain(
        *(torch.from_numpy(x) for x in _case("kv_mask_batch_row")[:3]),
        causal=False,
        kv_mask=torch.from_numpy(_case("kv_mask_batch_row")[5]))
    assert bool((lse[1] == fa.NEG_INF).all())


def test_public_plain_backward_equals_autograd():
    """``flash_attention_bwd_plain`` from the plain forward's ``o`` and
    ``lse`` gives what autograd through ``flash_attention`` gives."""
    q, k, v, do, causal, mask, seg = _case("segments")
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    segs = torch.from_numpy(seg)
    o, lse = fa.flash_attention_plain(tq, tk, tv, causal=causal,
                                      segment_ids=segs)
    grads = fa.flash_attention_bwd_plain(tq, tk, tv, o, lse, tdo,
                                         causal=causal, segment_ids=segs)
    for g, want in zip(grads, _port("segments")[1:]):
        np.testing.assert_array_equal(g.numpy(), want)


def test_cpu_path_launches_no_kernel():
    fa.reset_launches()
    _port("causal")
    assert fa.launches() == (0, 0, 0)


def test_kernel_args_are_checked_before_launch():
    q = torch.zeros(1, 2, 8, 24)
    with pytest.raises(ValueError, match="multiples of 16"):
        fa._check_kernel_args((q, q, q), None, None)
    q = torch.zeros(1, 2, 8, 32, dtype=torch.float16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fa._check_kernel_args((q, q, q), None, None)


# -- the kernels on the card ---------------------------------------------------

#: kernel vs plain version on the same CUDA inputs, row by row (as in
#: chip_smoke.py): for each row of an output (one query's O or dQ, one key's
#: dK or dV), the L2 distance over the plain row's L2 norm, at most this
#: (a row under 1% of the rms row norm, such as the dQ of a query that
#: sees only itself, zero up to rounding, is held against that 1%; rows
#: that see nothing must be exactly zero). Per row, because
#: causal gradients are far larger in the first rows than in deep ones, so
#: a limit scaled by the largest element would pass a wrong deep row.
#: f32: both sides sum f32 products in other orders (the kernel by FMA in
#: k order, the plain version through cuBLAS). bf16: both round outputs to
#: bf16; the kernel also rounds P (and dS) to bf16 before the second
#: product, as the tensor cores need, where the plain version keeps f32
CUDA_ROW_TOL = {torch.float32: 2e-5, torch.bfloat16: 1.5e-2}

CUDA_CASES = [
    # (name, b, h, t, d, causal, mask, segments)
    ("causal", 2, 4, 512, 128, True, False, False),
    ("segments", 2, 4, 512, 128, True, False, True),
    ("kv_mask", 2, 4, 384, 64, False, True, False),
    ("ragged", 1, 3, 200, 64, True, False, False),
]
#: cases of the bf16 kernels' tiling, in one test: the long causal walk
#: (32 tiles of 128 for the last query or first key tile), a T that is not
#: a multiple of the 128-row tiles, alone and under kv_mask, head dims
#: padded with zero columns (to 64 and to 128), an odd number of 128-row
#: tiles (the middle work item pairs a tile with itself), and packed
#: documents at the train shape's T, causal and not
CUDA_TILING_CASES = [
    ("causal4096", 1, 2, 4096, 128, True, False, False),
    ("t1000", 2, 2, 1000, 128, True, False, False),
    ("t1000_kv_mask", 2, 2, 1000, 128, True, True, False),
    ("d32", 1, 2, 256, 32, True, False, False),
    ("d80", 2, 2, 384, 80, False, True, False),
    ("odd_tiles", 1, 2, 640, 128, True, False, False),
    ("segments2048", 1, 2, 2048, 128, True, False, True),
    ("segments_full", 1, 2, 768, 64, False, False, True),
]


def _cuda_inputs(case, dtype):
    name, b, h, t, d, causal, mask, seg = case
    rng = np.random.default_rng(7)
    dev = torch.device("cuda")
    q, k, v, do = (torch.from_numpy(
        rng.standard_normal((b, h, t, d)).astype(np.float32)).to(dev, dtype)
        for _ in range(4))
    kv_mask = segs = None
    if mask:
        m = rng.random((b, t)) < 0.7
        m[-1] = False
        kv_mask = torch.from_numpy(m).to(dev)
    if seg:
        s = np.zeros((b, t), np.int32)
        s[:, t // 5:t // 2] = 1
        s[:, t // 2:2 * t // 3] = 0          # a repeated, non-adjacent id
        s[:, 2 * t // 3:] = 2
        segs = torch.from_numpy(s).to(dev)
    return q, k, v, do, causal, kv_mask, segs


def _assert_close(got, want, dtype, what):
    g = got.double().reshape(-1, got.shape[-1])
    w = want.double().reshape(-1, want.shape[-1])
    err, norm = (g - w).norm(dim=-1), w.norm(dim=-1)
    floor = 1e-2 * float(norm.pow(2).mean().sqrt())
    worst = float((err / norm.clamp_min(max(floor, 1e-30))).max())
    assert worst <= CUDA_ROW_TOL[dtype], \
        f"{what}: worst row relative L2 {worst:.3e}"


def _check_kernels(case, dtype):
    """Forward, dQ and dK/dV kernels against the plain versions on one
    case, one launch of each."""
    q, k, v, do, causal, kv_mask, segs = _cuda_inputs(case, dtype)
    scale = q.shape[-1] ** -0.5
    bias, bounds = fa._mask_operands(q, kv_mask, segs)
    before = fa.launches()
    o, lse = fa.flash_fwd(q, k, v, bias, bounds, scale=scale, causal=causal)
    grads = fa.flash_bwd(q, k, v, bias, bounds, o, lse, do, scale=scale,
                         causal=causal)
    torch.cuda.synchronize()
    assert fa.launches() == tuple(x + 1 for x in before)
    want_o, want_lse = fa._fwd_plain(q, k, v, bias, bounds, scale, causal)
    _assert_close(o, want_o, dtype, "o")
    # lse: f32 logsumexp on both sides; a row that sees nothing is -1e30
    live = want_lse > -1e29
    assert torch.equal(live, lse > -1e29)
    assert float((lse - want_lse)[live].abs().max()) <= 1e-4
    # the backward from the same o and lse on both sides
    want = fa._bwd_plain(q, k, v, bias, bounds, o, lse, do, scale, causal)
    for label, g, w in zip(("dq", "dk", "dv"), grads, want):
        _assert_close(g, w, dtype, label)
    if kv_mask is not None:      # the batch row that sees no key at all
        for x in (o, *grads):
            assert not bool(x[-1].any())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("case", CUDA_CASES, ids=[c[0] for c in CUDA_CASES])
def test_cuda_kernels_match_plain(case, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _check_kernels(case, dtype)


@pytest.mark.cuda
def test_cuda_kernels_match_plain_at_tiling_edges():
    """``CUDA_TILING_CASES`` in f32 and bf16 under the limits of
    ``test_cuda_kernels_match_plain``; every case runs, and the failures
    are reported together."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    failures = []
    for case in CUDA_TILING_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            try:
                _check_kernels(case, dtype)
            except AssertionError as e:
                failures.append(f"{case[0]}-{dtype}: {e}")
    assert not failures, "\n".join(failures)
