"""Port paged attention (lzy_tpu_torch/ops/paged_attention.py) held to
the JAX reference.

- int8 ``quantize_kv``/``dequantize_kv``: codes and f32 sidecars equal
  the reference's bit for bit (power-of-two scale, round half to even).
- The plain PyTorch ``paged_attention`` against the reference's
  ``_lax_paged_attention`` (the reference's own oracle; interpreted
  Pallas is not used) over T in {1, 3, 8}, page in {4, 16}, fp and int8
  pools, non-contiguous and shared page tables, idle rows on scratch
  block 0 at the edge of the sequence, and out-of-range block ids (the
  reference's gather clamps them).
- The CUDA kernels against the plain version on the card (marker
  ``cuda``; skipped without a card), with the split plan's choice and
  with the page walk forced to one split and to many, over rows whose
  visible lengths fall on and off page and split boundaries. On a machine without JAX run it as
  ``python -m pytest --noconftest -m cuda tests/test_torch_paged_attention.py``.

Inputs are drawn with numpy from fixed seeds and handed to both sides.
"""

import numpy as np
import pytest
import torch

from lzy_tpu_torch.ops import paged_attention as pa

torch.set_num_threads(1)

#: f32 attention on both sides: the same products summed in a different
#: order (XLA's dot vs torch's einsum), a few ulp over D <= 64 and L <= 128
ATOL = 2e-5
RTOL = 1e-5


@pytest.fixture(scope="module")
def ref():
    """The reference module, imported the way its own tests run it (JAX
    on the CPU, which tests/conftest.py pins)."""
    pytest.importorskip("jax")
    import importlib

    # the module, not the package's same-named function export
    return importlib.import_module("lzy_tpu.ops.paged_attention")


def _bits(x) -> np.ndarray:
    a = np.asarray(x)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def _case(seed, *, b, t, h, kv, d, page, pages, n_blocks, quant,
          shared=False, idle_rows=(), oob=False):
    """numpy inputs: a pool, a non-contiguous page table per row, and
    per-row query positions (row i ends near the edge of its table)."""
    rng = np.random.default_rng(seed)
    L = pages * page
    q = rng.standard_normal((b, t, h, d)).astype(np.float32)
    k = rng.standard_normal((n_blocks, page, kv, d)).astype(np.float32)
    v = rng.standard_normal((n_blocks, page, kv, d)).astype(np.float32)
    table = np.zeros((b, pages), np.int32)
    for row in range(b):
        table[row] = rng.permutation(np.arange(1, n_blocks))[:pages]
    if shared and b > 1:
        table[1, :pages // 2] = table[0, :pages // 2]   # a shared prefix
    starts = rng.integers(0, L - t + 1, size=b)
    starts[0] = L - t                                   # the edge
    pos = (starts[:, None] + np.arange(t)[None, :]).astype(np.int32)
    for row in idle_rows:                               # idle: scratch block
        table[row] = 0
        pos[row] = L - t + np.arange(t)
    if oob:
        table[-1, -1] = n_blocks + 5                    # clamps to the last
    return q, k, v, table, pos, quant


def _run_both(ref, case):
    import jax.numpy as jnp

    q, k, v, table, pos, quant = case
    kq = kv_ = None
    if quant:
        kq = ref.quantize_kv(jnp.asarray(k))
        kv_ = ref.quantize_kv(jnp.asarray(v))
        side = ref.KVQuant(kq[1], kq[2], kv_[1], kv_[2])
        want = ref._lax_paged_attention(
            jnp.asarray(q), kq[0], kv_[0], jnp.asarray(table),
            jnp.asarray(pos), dtype=jnp.float32, quant=side)
        tside = pa.KVQuant(*(torch.tensor(np.asarray(x))
                             for x in (kq[1], kq[2], kv_[1], kv_[2])))
        got = pa.paged_attention(
            torch.from_numpy(q), torch.tensor(np.asarray(kq[0])),
            torch.tensor(np.asarray(kv_[0])), torch.from_numpy(table),
            torch.from_numpy(pos), dtype=torch.float32, quant=tside)
    else:
        want = ref._lax_paged_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(table), jnp.asarray(pos), dtype=jnp.float32,
            quant=None)
        got = pa.paged_attention(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            torch.from_numpy(table), torch.from_numpy(pos))
    return np.asarray(want), got.numpy()


class TestQuantizeBitExact:
    @pytest.mark.parametrize("scale_exp", [-3, 0, 4])
    def test_codes_and_sidecars_match_reference(self, ref, scale_exp):
        import jax.numpy as jnp

        rng = np.random.default_rng(7 + scale_exp)
        x = (rng.standard_normal((40, 4, 3, 32))
             * 10.0 ** scale_exp).astype(np.float32)
        x[0, 0, 0] = 1.5                  # constant vector: zero range
        x[1, 0, 0, :2] = [2.5, -2.5]      # exact halves round to even
        rq, rs, rz = ref.quantize_kv(jnp.asarray(x))
        tq, ts, tz = pa.quantize_kv(torch.from_numpy(x))
        assert np.array_equal(np.asarray(rq), tq.numpy())
        assert np.array_equal(_bits(rs), _bits(ts.numpy()))
        assert np.array_equal(_bits(rz), _bits(tz.numpy()))
        rd = ref.dequantize_kv(rq, rs, rz, jnp.float32)
        td = pa.dequantize_kv(tq, ts, tz, torch.float32)
        assert np.array_equal(_bits(rd), _bits(td.numpy()))

    def test_bf16_dequantize_matches_reference(self, ref):
        import jax.numpy as jnp

        rng = np.random.default_rng(3)
        x = rng.standard_normal((16, 4, 2, 16)).astype(np.float32)
        rq, rs, rz = ref.quantize_kv(jnp.asarray(x))
        tq, ts, tz = pa.quantize_kv(torch.from_numpy(x))
        rd = np.asarray(ref.dequantize_kv(rq, rs, rz, jnp.bfloat16)
                        .astype(jnp.float32))
        td = pa.dequantize_kv(tq, ts, tz, torch.bfloat16).float().numpy()
        assert np.array_equal(_bits(rd), _bits(td))


class TestPlainMatchesLax:
    @pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
    @pytest.mark.parametrize("page", [4, 16])
    @pytest.mark.parametrize("t", [1, 3, 8])
    def test_sweep(self, ref, t, page, quant):
        pages = 64 // page
        case = _case(100 + t + page, b=3, t=t, h=4, kv=2, d=16, page=page,
                     pages=pages, n_blocks=3 * pages + 2, quant=quant)
        want, got = _run_both(ref, case)
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)

    @pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
    def test_shared_tables_idle_rows_and_clamped_ids(self, ref, quant):
        case = _case(5, b=4, t=5, h=8, kv=2, d=32, page=4, pages=16,
                     n_blocks=40, quant=quant, shared=True, idle_rows=(2,),
                     oob=True)
        want, got = _run_both(ref, case)
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)

    def test_wrapper_runs_plain_on_cpu_and_does_not_count(self):
        case = _case(9, b=2, t=2, h=4, kv=2, d=16, page=4, pages=8,
                     n_blocks=20, quant=False)
        q, k, v, table, pos, _ = (torch.from_numpy(x) if
                                  isinstance(x, np.ndarray) else x
                                  for x in case)
        before = pa.paged_attention.launches
        got = pa.paged_attention(q, k, v, table, pos)
        want = pa.paged_attention_plain(q, k, v, table, pos,
                                        dtype=torch.float32)
        assert torch.equal(got, want)
        assert pa.paged_attention.launches == before
        side = pa.KVQuant(*(torch.zeros(k.shape[:3]) for _ in range(4)))
        with pytest.raises(ValueError):       # int8 pools need a dtype
            pa.paged_attention(q, k.to(torch.int8), v.to(torch.int8), table,
                               pos, quant=side)


#: (name, b, t, h, kv, d, page, pages, n_blocks) — 8B's head layout
#: (32 heads over 8 kv heads, d=128) at decode, verify and chunk widths,
#: one row past 1024 visible slots, and the tiny config's d=16
CUDA_CASES = [
    ("decode", 8, 1, 32, 8, 128, 16, 128, 600),
    ("verify", 4, 5, 32, 8, 128, 16, 96, 400),
    ("chunk", 2, 64, 32, 8, 128, 16, 80, 200),
    ("tiny", 3, 4, 4, 2, 16, 16, 16, 64),
]


@pytest.mark.cuda
@pytest.mark.parametrize(
    "dtype", ["float32", "bfloat16", "int8-bf16", "int8-float32"])
@pytest.mark.parametrize("case", CUDA_CASES, ids=[c[0] for c in CUDA_CASES])
def test_cuda_kernel_matches_plain(case, dtype):
    """Kernel vs plain version on the same CUDA inputs.

    f32 compute (f32 pools, or int8 pools dequantized to f32): both sides
    sum f32 products in different orders; atol 1e-5 plus rtol 1e-5 of
    |plain|. The idle row reads scratch block 0's 16 slots 128 times
    over, so its output is not averaged down (|out| up to ~1.8), and a
    2048-term f32 sum in another order moves it by ~8e-6 relative
    (measured 1.4e-5 absolute on an H100, where the plain version itself
    lands up to 1.1e-5 from an f64 evaluation).

    bf16 compute (bf16 pools, or int8 pools dequantized to bf16): the
    output is rounded to bf16 on both sides (one ulp is at most 2^-7 of
    |out|, under rtol 1e-2), and a probability whose f32 score differs
    in its last bits may round to a neighbouring bf16 value before P.V,
    moving the output by 2^-8 of that probability's share of |v|, which
    atol 2e-3 covers. Outputs are softmax-weighted means of N(0, 1)
    values, so their size falls with the visible length (about 0.05 at
    2048 slots): the limit follows |plain|, not a fixed fraction of 1."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _, b, t, h, kv, d, page, pages, n_blocks = case
    quant = dtype.startswith("int8")
    np_case = _case(11, b=b, t=t, h=h, kv=kv, d=d, page=page, pages=pages,
                    n_blocks=n_blocks, quant=quant, shared=True,
                    idle_rows=(b - 1,) if b > 2 else ())
    q, k, v, table, pos, _ = np_case
    cdt = torch.float32 if dtype.endswith("float32") else torch.bfloat16
    dev = torch.device("cuda")
    tq = torch.from_numpy(q).to(dev, cdt)
    tt = torch.from_numpy(table).to(dev)
    tp = torch.from_numpy(pos).to(dev)
    side = None
    if quant:
        kq, ks, kz = pa.quantize_kv(torch.from_numpy(k).to(dev))
        vq, vs, vz = pa.quantize_kv(torch.from_numpy(v).to(dev))
        tk, tv, side = kq, vq, pa.KVQuant(ks, kz, vs, vz)
    else:
        tk = torch.from_numpy(k).to(dev, cdt)
        tv = torch.from_numpy(v).to(dev, cdt)
    before = pa.paged_attention.launches
    got = pa.paged_attention(tq, tk, tv, tt, tp, dtype=cdt, quant=side)
    want = pa.paged_attention_plain(tq, tk, tv, tt, tp, dtype=cdt,
                                    quant=side)
    torch.cuda.synchronize()
    assert pa.paged_attention.launches == before + 1
    atol, rtol = (1e-5, 1e-5) if cdt == torch.float32 else (2e-3, 1e-2)
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


#: visible lengths on and off page (16) and split boundaries: a one-slot
#: row, a full page, one past it, a long row one short of 64 pages
SPLIT_LENGTHS = [1, 16, 17, 250, 1000, 1023, 33, 480]


def _check_split_edges(dtype, t, splits):
    """One (compute dtype, T, split choice) of
    ``test_cuda_kernel_split_edges``."""
    rng = np.random.default_rng(23)
    b, h, kv, d, page, pages = len(SPLIT_LENGTHS), 32, 8, 128, 16, 80
    lengths = [max(n, t) for n in SPLIT_LENGTHS]
    need = [-(-n // page) for n in lengths]
    n_blocks = sum(need) + 1
    dev = torch.device("cuda")
    quant = dtype.startswith("int8")
    cdt = torch.float32 if dtype.endswith("float32") else torch.bfloat16
    q = torch.from_numpy(rng.standard_normal((b, t, h, d)).astype(
        np.float32)).to(dev, cdt)
    k, v = (torch.from_numpy(rng.standard_normal(
        (n_blocks, page, kv, d)).astype(np.float32)).to(dev)
        for _ in range(2))
    perm = rng.permutation(np.arange(1, n_blocks))
    table = np.zeros((b, pages), np.int32)
    at = 0
    for row, n in enumerate(need):
        table[row, :n] = perm[at:at + n]
        at += n
    pos = (np.asarray(lengths)[:, None] - t + np.arange(t)[None, :])
    tt = torch.from_numpy(table).to(dev)
    tp = torch.from_numpy(pos.astype(np.int32)).to(dev)
    side = None
    if quant:
        kq, ks, kz = pa.quantize_kv(k)
        vq, vs, vz = pa.quantize_kv(v)
        k, v, side = kq, vq, pa.KVQuant(ks, kz, vs, vz)
    else:
        k, v = k.to(cdt), v.to(cdt)
    args = (q, k, v, tt, tp)
    before = pa.paged_attention.launches
    if splits == "plan":
        got = pa.paged_attention(*args, dtype=cdt, quant=side)
    else:
        got = pa._launch(*args, dtype=cdt, quant=side,
                         splits=1 if splits == "one" else 24)
    want = pa.paged_attention_plain(*args, dtype=cdt, quant=side)
    torch.cuda.synchronize()
    assert pa.paged_attention.launches == before + 1
    atol, rtol = (1e-5, 1e-5) if cdt == torch.float32 else (2e-3, 1e-2)
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


@pytest.mark.cuda
def test_cuda_kernel_split_edges():
    """The kernels with the page walk split as the plan says, forced to one
    split and forced to 24 (more splits than most rows have pages), at T
    in {1, 5, 64} (decode, verify, chunk), with bf16 pools and with int8
    pools in f32 compute, against the plain version under the tolerances
    of ``test_cuda_kernel_matches_plain``. 8B's heads (32 over 8, d=128),
    page 16; a row shorter than T starts at position 0. Every combination
    runs, and the failures are reported together."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    failures = []
    for dtype in ("bfloat16", "int8-float32"):
        for t in (1, 5, 64):
            for splits in ("one", "plan", "many"):
                try:
                    _check_split_edges(dtype, t, splits)
                except AssertionError as e:
                    failures.append(f"{dtype}-T{t}-{splits}: {e}")
    assert not failures, "\n".join(failures)
