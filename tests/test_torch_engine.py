"""Port serving engines (lzy_tpu_torch/serving/engine.py).

Held to the port's own ``generate()`` oracle and to the JAX reference's
``PagedInferenceEngine`` on the same weights (tiny config, float32, CPU,
where the engine reads the pool through the plain paged attention):

- greedy paged (fp) and dense engine output equals the oracle;
- greedy paged output equals the JAX paged engine's, under the top-2
  rule: a divergence is accepted only at a step where the reference's
  top-2 logit gap is below ``GAP_TOL``, and the test asserts that gap;
- a shared prompt prefix is served from the radix cache;
- speculation on equals speculation off; budgeted (interleaved) chunked
  prefill equals one-shot prefill;
- each steady decode round takes exactly one device-to-host transfer;
- pool exhaustion preempts the youngest request, and int8 pools serve.
"""

import dataclasses

import numpy as np
import pytest
import torch

from lzy_tpu_torch.models import convert
from lzy_tpu_torch.models.generate import generate
from lzy_tpu_torch.models.llama import LlamaConfig, init_params
from lzy_tpu_torch.serving.engine import InferenceEngine, PagedInferenceEngine

torch.set_num_threads(1)

VOCAB = 64
#: the two frameworks' f32 logits differ by < 1e-4 (test_torch_llama);
#: a greedy step whose top-2 gap is under ten times that may flip
GAP_TOL = 1e-3

PROMPTS = [
    [5, 9, 3, 7, 2],
    [1, 2, 3, 4, 1, 2, 3, 4, 1, 2, 3, 4],
    [7] * 3 + [11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47, 53, 59, 61],
]
N_NEW = 12


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


def _oracle(model, prompt, n=N_NEW):
    out = generate(model, torch.tensor([prompt]), max_new_tokens=n)
    return out[0, len(prompt):].tolist()


def _drain(engine, reqs, rounds=600):
    for _ in range(rounds):
        if all(r.done for r in reqs):
            return
        engine.step()
    raise AssertionError("engine did not finish its requests")


def _serve(engine, prompts, n=N_NEW):
    reqs = [engine.submit(p, max_new_tokens=n) for p in prompts]
    _drain(engine, reqs)
    return [r.result(0) for r in reqs]


def _paged(model, **kw):
    kw.setdefault("slots", 2)
    kw.setdefault("page_size", 4)
    return PagedInferenceEngine(model, **kw)


@pytest.fixture(scope="module")
def oracle(models):
    return [_oracle(models[2], p) for p in PROMPTS]


def test_paged_greedy_equals_oracle(models, oracle):
    eng = _paged(models[2])
    assert eng.kernel_path == "plain"
    assert _serve(eng, PROMPTS) == oracle
    assert eng.forward_calls > 0


def test_dense_greedy_equals_oracle(models, oracle):
    eng = InferenceEngine(models[2], slots=2)
    assert _serve(eng, PROMPTS) == oracle


def test_paged_matches_jax_engine_top2_rule(models):
    import jax.numpy as jnp

    from lzy_tpu.models.llama import Llama as RefLlama
    from lzy_tpu.serving import PagedInferenceEngine as RefEngine

    rcfg, params, model = models
    ref = RefEngine(rcfg, params, slots=2, page_size=4,
                    native_attention=True, kernel="lax")
    reqs = [ref.submit(p, max_new_tokens=N_NEW) for p in PROMPTS]
    _drain(ref, reqs)
    want = [r.result(0) for r in reqs]
    got = _serve(_paged(model), PROMPTS)
    compared = 0
    for prompt, w, g in zip(PROMPTS, want, got):
        seq = jnp.asarray([prompt + w])
        logits = np.asarray(RefLlama(rcfg).apply({"params": params}, seq))[0]
        for i, (a, b) in enumerate(zip(w, g)):
            if a == b:
                compared += 1
                continue
            top2 = np.sort(logits[len(prompt) - 1 + i])[-2:]
            gap = float(top2[1] - top2[0])
            assert gap < GAP_TOL, (
                f"divergence at step {i} where the reference's top-2 gap "
                f"is {gap} (>= {GAP_TOL})")
            break
    assert compared >= len(PROMPTS) * N_NEW // 2


def test_radix_prefix_reuse(models):
    model = models[2]
    header = list(range(1, 17))                 # four full page-4 blocks
    a, b = header + [20, 21], header + [30, 31, 32]
    eng = _paged(model)
    first = _serve(eng, [a])
    before = eng.stats().prefill_tokens_saved
    second = _serve(eng, [b])
    assert eng.stats().prefill_tokens_saved - before == len(header)
    assert eng.stats().prefix_hit_rate > 0
    assert first == [_oracle(model, a)] and second == [_oracle(model, b)]


def test_spec_on_equals_spec_off(models, oracle):
    eng = _paged(models[2], spec_tokens=3)
    assert _serve(eng, PROMPTS) == oracle
    assert eng.spec_steps > 0


def test_budgeted_chunked_prefill_equals_one_shot(models):
    model = models[2]
    long = [int(t) for t in np.random.default_rng(4).integers(0, VOCAB, 40)]
    prompts = [long, PROMPTS[0]]
    one_shot = _serve(_paged(model, prefill_chunk=8), prompts)
    eng = _paged(model, prefill_chunk=8, prefill_budget=8)
    assert _serve(eng, prompts) == one_shot
    assert eng.prefill_rounds > len(prompts)


class _CountTransfers:
    """Counts device-to-host conversions on ``torch.Tensor`` (``.cpu``,
    ``.item``, ``.tolist``, ``.numpy``, ``__array__``, and Python scalar
    conversions) while installed."""

    NAMES = ("cpu", "item", "tolist", "numpy", "__array__", "__bool__",
             "__int__", "__float__", "__index__")

    def __init__(self, monkeypatch):
        self.count = 0
        for name in self.NAMES:
            orig = getattr(torch.Tensor, name)

            def counted(t, *a, _orig=orig, **kw):
                self.count += 1
                return _orig(t, *a, **kw)

            monkeypatch.setattr(torch.Tensor, name, counted)


@pytest.mark.parametrize("spec", [0, 3], ids=["decode", "verify"])
def test_one_transfer_per_decode_round(models, monkeypatch, spec):
    eng = _paged(models[2], slots=3, spec_tokens=spec)
    reqs = [eng.submit(p, max_new_tokens=40) for p in PROMPTS]
    for _ in range(200):                    # to steady decode
        if not eng._prefill_jobs and eng.queue.depth() == 0 and \
                sum(r is not None for r in eng._active) == len(reqs):
            break
        eng.step()
    shim = _CountTransfers(monkeypatch)
    fetches, rounds = eng.host_fetches, 4
    for _ in range(rounds):
        eng.step()
    monkeypatch.undo()
    assert eng.host_fetches - fetches == rounds
    assert shim.count == rounds
    _drain(eng, reqs)


def test_pool_exhaustion_preempts_youngest(models):
    model = models[2]
    # 7 usable blocks of 4 tokens; two 10-token prompts take 3 each, and
    # decode growth runs the pool dry
    eng = _paged(model, kv_blocks=8)
    reqs = [eng.submit([3] * 10, max_new_tokens=12),
            eng.submit([5] * 10, max_new_tokens=12)]
    _drain(eng, reqs)
    assert reqs[0].status == "ok"
    assert reqs[0].tokens == _oracle(model, [3] * 10, 12)
    assert reqs[1].status == "error" and "preempted" in reqs[1].error
    assert eng.stats().kv_blocks_free + eng.stats().kv_blocks_cached == 7


def test_int8_pool_serves_close_to_fp(models, oracle):
    eng = _paged(models[2], kv_quant="int8")
    got = _serve(eng, PROMPTS)
    assert eng.stats().kv_quant == "int8"
    same = sum(a == b for g, o in zip(got, oracle) for a, b in zip(g, o))
    # bounded divergence, not bit-identity (int8 K/V)
    assert same >= 0.5 * len(PROMPTS) * N_NEW


def test_background_loop_and_drain(models, oracle):
    eng = _paged(models[2]).start()
    reqs = [eng.submit(p, max_new_tokens=N_NEW) for p in PROMPTS]
    assert [r.result(timeout=60) for r in reqs] == oracle
    assert eng.drain(timeout_s=10)
    assert eng.closed
    rows = eng.stats_by_tenant()
    assert rows["default"]["requests_finished"] == len(PROMPTS)


def test_cancel_and_deadline_reap_and_free_blocks(models):
    eng = _paged(models[2])
    total = eng.stats().kv_blocks_free
    a = eng.submit(PROMPTS[1], max_new_tokens=40)
    b = eng.submit(PROMPTS[2], max_new_tokens=40, deadline_s=1e-6)
    for _ in range(3):
        eng.step()
    a.cancel()
    _drain(eng, [a, b])
    assert a.status == "cancelled" and b.status == "cancelled"
    assert "deadline" in b.error
    s = eng.stats()
    assert s.kv_blocks_free + s.kv_blocks_cached == total
    assert eng.stats_by_tenant()["default"]["requests_cancelled"] == 2


def test_prefill_fault_fails_only_that_request(models, oracle):
    from lzy_tpu_torch.chaos.faults import CHAOS, ERROR, FaultPlan

    eng = _paged(models[2])
    total = eng.stats().kv_blocks_free
    CHAOS.arm(FaultPlan(seed=0, rate=1.0, modes=(ERROR,), max_faults=1,
                        points=["engine.prefill"]))
    try:
        bad = eng.submit(PROMPTS[0], max_new_tokens=4)
        _drain(eng, [bad])
    finally:
        CHAOS.disarm()
    assert bad.status == "error" and "injected fault" in bad.error
    s = eng.stats()
    assert s.kv_blocks_free + s.kv_blocks_cached == total
    assert _serve(eng, PROMPTS) == oracle     # the engine serves on
