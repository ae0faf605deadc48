"""The port's disaggregated serving and KV transfer
(lzy_tpu_torch/serving/disagg, gateway/disagg.py, channels/kv_transfer.py).

Tiny config, float32, CPU, weights from the JAX reference
(``convert.load_reference``):

- disagg replies equal the ``generate()`` oracle, with the decode
  replica really matching the prefill replica's imported blocks, and a
  transfer that dies mid-stream falls back to a local re-prefill;
- a ``kv_quant`` mismatch between the pools fails closed: nothing is
  imported and the decode replica re-prefills, still equal to the
  oracle; a page size, leaf shape or mesh shape that does not match is
  refused the same way;
- the port's pools name their leaves exactly as the reference's cache
  tree does (fp and int8), and the manifest carries the reference's
  dtype strings;
- across frameworks, at f32: a JAX ``PagedInferenceEngine`` export
  (``lzy_tpu.serving.disagg.export_kv``) imported into the port's engine
  continues greedy as the JAX engine's own continuation did, and a port
  export imported into the JAX engine does the same, under the top-2
  rule of ``tests/test_torch_engine.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from lzy_tpu_torch.channels.kv_transfer import (
    KVBlockExport, build_kv_manifest, parse_kv_manifest)
from lzy_tpu_torch.gateway import DisaggGatewayService, ReplicaFleet
from lzy_tpu_torch.models import convert
from lzy_tpu_torch.models.generate import generate
from lzy_tpu_torch.models.llama import LlamaConfig, init_params
from lzy_tpu_torch.serving.disagg import (
    DecodeEngine, PrefillEngine, export_kv, import_kv)
from lzy_tpu_torch.serving.engine import PagedInferenceEngine

torch.set_num_threads(1)

VOCAB = 64
PAGE = 4
N_NEW = 8
#: the frameworks' f32 logits differ by < 1e-4; a greedy step whose top-2
#: gap is under ten times that may flip (test_torch_engine.GAP_TOL)
GAP_TOL = 1e-3
_RNG = np.random.default_rng(5)
PROMPTS = [[int(x) for x in _RNG.integers(0, VOCAB, n)] for n in (18, 23)]


@pytest.fixture(scope="module")
def models():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from lzy_tpu.models import llama as ref_llama, unbox

    rcfg = dataclasses.replace(ref_llama.LlamaConfig.tiny(vocab_size=VOCAB),
                               dtype=jnp.float32)
    boxed, _ = ref_llama.init_params(rcfg, jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(np.asarray, unbox(boxed))
    cfg = dataclasses.replace(LlamaConfig.tiny(vocab_size=VOCAB),
                              dtype=torch.float32, param_dtype=torch.float32)
    model = convert.load_reference(init_params(cfg, device="cpu"), params)
    return rcfg, params, model


def _oracle(model, prompt):
    return generate(model, torch.tensor([prompt]),
                    max_new_tokens=N_NEW)[0, len(prompt):].tolist()


def _drain(engine, reqs):
    for _ in range(400):
        if all(r.done for r in reqs):
            return [r.result(0) for r in reqs]
        engine.step()
    raise AssertionError("engine did not finish its requests")


def _disagg(model, prefill_quant=None):
    decode = ReplicaFleet(lambda: DecodeEngine(model, slots=2,
                                               page_size=PAGE),
                          replica_prefix="decode")
    prefill = ReplicaFleet(lambda: PrefillEngine(
        model, slots=2, page_size=PAGE, kv_quant=prefill_quant),
        replica_prefix="prefill")
    gw = DisaggGatewayService(decode, prefill, page_size=PAGE)
    decode.add_replica()
    prefill.add_replica()
    return gw


def test_disagg_replies_equal_oracle(models):
    model = models[2]
    gw = _disagg(model)
    try:
        replies = [gw.generate(p, max_new_tokens=N_NEW) for p in PROMPTS]
        again = gw.generate(PROMPTS[0], max_new_tokens=N_NEW)
        for prompt, reply in zip(PROMPTS + PROMPTS[:1], replies + [again]):
            assert reply["status"] == "ok"
            assert reply["tokens"] == _oracle(model, prompt)
        assert [r["prefilled_by"] for r in replies] == ["prefill-1"] * 2
        assert again["kv_transfer_skipped"] and again["reprefills"] == 0
        decode = gw.fleet.get("decode-1").engine
        assert decode.kv_imports == 2
        # the imports covered every whole block the decode side matches
        assert decode.stats().prefill_tokens_saved >= sum(
            (len(p) - 1) // PAGE * PAGE for p in PROMPTS)
        s = gw.stats()
        assert s["kv_transfers"] == 2 and s["reprefill_fallbacks"] == 0
        assert s["kv_transfer_bytes"] > 0
        # a transfer dying mid-stream: the decode side re-prefills
        gw.transport.fail_next_fetch = 1
        fresh = PROMPTS[1][::-1]
        reply = gw.generate(fresh, max_new_tokens=N_NEW)
        assert reply["tokens"] == _oracle(model, fresh)
        assert reply["reprefills"] == 1 and reply["prefilled_by"] is None
        assert gw.stats()["reprefill_fallbacks"] == 1
    finally:
        gw.close()


def test_kv_quant_mismatch_fails_closed(models):
    model = models[2]
    gw = _disagg(model, prefill_quant="int8")
    try:
        reply = gw.generate(PROMPTS[0], max_new_tokens=N_NEW)
        assert reply["tokens"] == _oracle(model, PROMPTS[0])
        assert reply["kv_staged_by"] == "prefill-1"
        assert reply["prefilled_by"] is None          # staged, not used
        decode = gw.fleet.get("decode-1").engine
        assert decode.kv_imports == 0
        assert decode.stats().prefill_tokens_saved == 0
    finally:
        gw.close()


@pytest.mark.parametrize("fault", ["page", "shape", "mesh"])
def test_import_refuses_a_payload_that_does_not_fit(models, fault):
    model = models[2]
    src = PagedInferenceEngine(model, slots=1, page_size=PAGE)
    _drain(src, [src.submit(PROMPTS[0], max_new_tokens=2)])
    export = export_kv(src, PROMPTS[0])
    if fault == "page":
        export = dataclasses.replace(export, page_size=PAGE * 2)
    elif fault == "shape":
        export.leaves = {k: v[..., :1] for k, v in export.leaves.items()}
    else:
        export.mesh_shape = (1, 2)
    dst = PagedInferenceEngine(model, slots=1, page_size=PAGE)
    free = dst.stats().kv_blocks_free
    assert import_kv(dst, export) == 0
    assert dst.stats().kv_blocks_free == free
    assert dst.kv.match_len(PROMPTS[0]) == 0


@pytest.mark.parametrize("quant", [None, "int8"])
def test_leaf_names_and_manifest_match_the_reference(models, quant):
    import jax

    from lzy_tpu.serving import PagedInferenceEngine as RefEngine

    rcfg, params, model = models
    ref = RefEngine(rcfg, params, slots=1, page_size=PAGE, kv_quant=quant,
                    native_attention=True, kernel="lax")
    flat, _ = jax.tree_util.tree_flatten_with_path(ref._cache)
    want = {jax.tree_util.keystr(p): leaf for p, leaf in flat
            if not ref._is_index(p)}
    eng = PagedInferenceEngine(model, slots=1, page_size=PAGE,
                               kv_quant=quant)
    got = dict(eng._kv_leaves())
    assert set(got) == set(want)
    assert len(got) == (12 if quant else 4)
    for key, leaf in got.items():
        assert tuple(leaf.shape[1:]) == tuple(want[key].shape[1:]), key
        assert str(leaf.dtype).replace("torch.", "") == str(want[key].dtype)
    _drain(eng, [eng.submit(PROMPTS[0], max_new_tokens=2)])
    export = export_kv(eng, PROMPTS[0])
    doc = parse_kv_manifest(build_kv_manifest(
        export, {k: f"mem://{i}" for i, k in enumerate(export.leaves)}))
    assert doc["tokens"] == export.tokens and doc["page_size"] == PAGE
    assert {k: m["dtype"] for k, m in doc["leaves"].items()} == {
        k: str(want[k].dtype) for k in want}


def _top2_compare(rcfg, params, prompt, want, got):
    """``got`` equals ``want`` up to a divergence at a step whose
    reference top-2 logit gap is below GAP_TOL; returns steps equal."""
    import jax.numpy as jnp

    from lzy_tpu.models.llama import Llama as RefLlama

    logits = np.asarray(RefLlama(rcfg).apply(
        {"params": params}, jnp.asarray([prompt + want])))[0]
    for i, (a, b) in enumerate(zip(want, got)):
        if a != b:
            top2 = np.sort(logits[len(prompt) - 1 + i])[-2:]
            assert float(top2[1] - top2[0]) < GAP_TOL, (
                f"divergence at step {i} where the reference's top-2 gap "
                f"is {float(top2[1] - top2[0])}")
            return i
    assert len(want) == len(got)
    return len(want)


def test_kv_export_crosses_frameworks_both_ways(models):
    from lzy_tpu.channels.kv_transfer import KVBlockExport as RefExport
    from lzy_tpu.serving import PagedInferenceEngine as RefEngine
    from lzy_tpu.serving.disagg import (
        export_kv as ref_export_kv, import_kv as ref_import_kv)

    rcfg, params, model = models
    ref = RefEngine(rcfg, params, slots=2, page_size=PAGE,
                    native_attention=True, kernel="lax")
    # JAX -> port: the reference serves prompt 0 and exports its blocks
    want = _drain(ref, [ref.submit(PROMPTS[0], max_new_tokens=N_NEW)])[0]
    jax_export = ref_export_kv(ref, PROMPTS[0])
    port = PagedInferenceEngine(model, slots=2, page_size=PAGE)
    port.queue_kv_import(jax_export)
    got = _drain(port, [port.submit(PROMPTS[0], max_new_tokens=N_NEW)])[0]
    assert port.kv_imports == 1
    assert port.stats().prefill_tokens_saved == \
        (len(PROMPTS[0]) - 1) // PAGE * PAGE
    assert _top2_compare(rcfg, params, PROMPTS[0], want, got) >= N_NEW // 2
    # port -> JAX: the port serves prompt 1 and exports its blocks; the
    # handoff to the reference is numpy (the manifest's wire arrays)
    got = _drain(port, [port.submit(PROMPTS[1], max_new_tokens=N_NEW)])[0]
    export = export_kv(port, PROMPTS[1])
    assert isinstance(export, KVBlockExport)
    assert set(export.leaves) == set(jax_export.leaves)
    saved = ref.stats().prefill_tokens_saved
    assert ref_import_kv(ref, RefExport(
        tokens=export.tokens, page_size=export.page_size,
        leaves={k: v.numpy() for k, v in export.leaves.items()})) == \
        len(export.tokens) // PAGE
    want = _drain(ref, [ref.submit(PROMPTS[1], max_new_tokens=N_NEW)])[0]
    assert ref.stats().prefill_tokens_saved - saved == \
        (len(PROMPTS[1]) - 1) // PAGE * PAGE
    assert _top2_compare(rcfg, params, PROMPTS[1], got, want) >= N_NEW // 2
