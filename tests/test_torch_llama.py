"""Port Llama (lzy_tpu_torch/models/llama.py) held to the JAX reference.

Both frameworks run ``LlamaConfig.tiny`` at float32 on the CPU with the
SAME weights: the reference's ``init_params`` draws them, and the weight
bridge (``models/convert.py``) copies them into the port.

- the bridge round-trips the reference tree exactly;
- full-sequence logits match ``Llama(cfg).apply``;
- decode-mode chunks (prefill chunk, a gamma+1-wide chunk, one token)
  match the reference's decode forward with a dense per-row cache and
  with a paged pool read through the page table (fp and int8).
"""

import dataclasses

import numpy as np
import pytest
import torch

from lzy_tpu_torch.models import convert
from lzy_tpu_torch.models.llama import (
    DenseKVCache, LlamaConfig, PagedKVPool, init_params)

torch.set_num_threads(1)

VOCAB = 64
#: f32 forward through two layers on both sides: the same math with
#: matmuls and reductions summed in different orders, ~1e-6 relative
ATOL = 1e-4
#: int8 pools: K/V that differ by f32 rounding can land on different
#: sides of a quantization boundary, moving an element by one step
#: (range/254, ~1e-2 here); the logits then move by about that much
ATOL_INT8 = 5e-2


def _port_cfg():
    return dataclasses.replace(LlamaConfig.tiny(vocab_size=VOCAB),
                               dtype=torch.float32,
                               param_dtype=torch.float32)


@pytest.fixture(scope="module")
def models():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from lzy_tpu.models import llama as ref_llama, unbox

    rcfg = dataclasses.replace(ref_llama.LlamaConfig.tiny(vocab_size=VOCAB),
                               dtype=jnp.float32)
    boxed, _ = ref_llama.init_params(rcfg, jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(np.asarray, unbox(boxed))
    cfg = _port_cfg()
    model = convert.load_reference(init_params(cfg, device="cpu"), params)
    return rcfg, params, cfg, model


def _tokens(seed, b, t):
    return np.random.default_rng(seed).integers(0, VOCAB, (b, t)).astype(
        np.int32)


def test_bridge_round_trip(models):
    import jax

    _, params, cfg, model = models
    back = convert.to_reference(model.state_dict(), cfg)
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        assert np.array_equal(np.asarray(leaf), flat_b[path]), path


def test_full_sequence_logits(models):
    import jax.numpy as jnp

    from lzy_tpu.models.llama import Llama as RefLlama

    rcfg, params, _, model = models
    tokens = _tokens(0, 2, 24)
    want = np.asarray(RefLlama(rcfg).apply({"params": params},
                                           jnp.asarray(tokens)))
    with torch.no_grad():
        got = model(torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


#: decode-mode chunk widths: a prefill chunk, a gamma+1 verify chunk,
#: then single tokens
WIDTHS = (7, 4, 1, 1)


def _ref_decode(rcfg, params, tokens, starts, **paged):
    """Reference decode forward over the chunk schedule; per-row starts
    are set on the cache's index leaves."""
    import jax
    import jax.numpy as jnp

    from lzy_tpu.models.generate import decode_config, init_cache
    from lzy_tpu.models.llama import Llama as RefLlama

    b = tokens.shape[0]
    page_table = paged.pop("page_table", None)
    cfg = decode_config(rcfg, decode_slot_index=True, **paged)
    model = RefLlama(cfg)
    kw = {} if page_table is None else {"page_table": jnp.asarray(page_table)}
    cache = init_cache(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((b, 1), jnp.int32), **kw))
    cache = jax.tree_util.tree_map_with_path(
        lambda path, leaf: jnp.asarray(starts, jnp.int32)
        if any(getattr(p, "key", None) == "index" for p in path) else leaf,
        cache)
    out, at = [], 0
    for w in WIDTHS:
        logits, upd = model.apply({"params": params, "cache": cache},
                                  jnp.asarray(tokens[:, at:at + w]),
                                  mutable=["cache"], **kw)
        cache = upd["cache"]
        out.append(np.asarray(logits))
        at += w
    return out


def _port_decode(model, cache, tokens, starts, page_table=None):
    out, at = [], 0
    pos = torch.tensor(starts, dtype=torch.int32)
    pt = None if page_table is None else torch.from_numpy(page_table)
    with torch.no_grad():
        for w in WIDTHS:
            logits = model(torch.from_numpy(tokens[:, at:at + w]),
                           cache=cache, starts=pos, page_table=pt)
            out.append(logits.numpy())
            pos = pos + w
            at += w
    return out


def test_dense_decode_chunks(models):
    rcfg, params, cfg, model = models
    tokens = _tokens(1, 2, sum(WIDTHS))
    starts = [0, 5]
    want = _ref_decode(rcfg, params, tokens, starts)
    got = _port_decode(model, DenseKVCache(cfg, 2, "cpu"), tokens, starts)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=0)


@pytest.mark.parametrize("kv_quant", [None, "int8"], ids=["fp", "int8"])
def test_paged_decode_chunks(models, kv_quant):
    rcfg, params, cfg, model = models
    page, n_blocks = 4, 40
    pages = cfg.max_seq_len // page
    tokens = _tokens(2, 3, sum(WIDTHS))
    starts = [0, 9, 2]
    rng = np.random.default_rng(3)
    table = np.zeros((3, pages), np.int32)
    used = rng.permutation(np.arange(1, n_blocks))
    table[0, :6] = used[:6]
    table[1, :6] = used[6:12]
    table[2, :6] = used[:6]          # row 2 shares row 0's blocks
    table[2, 1:] = 0                 # ... only the first, then scratch
    starts[2] = 0
    tokens[2] = tokens[0]
    want = _ref_decode(rcfg, params, tokens, starts, decode_paged=True,
                       kv_page_size=page, kv_pages=n_blocks,
                       paged_attention_native=True, paged_kernel="lax",
                       kv_quant=kv_quant, page_table=table)
    pool = PagedKVPool(cfg, n_blocks, page, kv_quant=kv_quant, device="cpu")
    got = _port_decode(model, pool, tokens, starts, page_table=table)
    atol = ATOL if kv_quant is None else ATOL_INT8
    for w, g in zip(want, got):
        # row 2 writes past its one real block onto the scratch block,
        # where rows collide by design: only rows 0 and 1 are compared
        np.testing.assert_allclose(g[:2], w[:2], atol=atol, rtol=0)
