"""The port's serving fleet (lzy_tpu_torch/gateway) over port engines.

Tiny config, float32, CPU, weights from the JAX reference
(``convert.load_reference``), replicas sharing one model; held to the
port's ``generate()`` oracle:

- a gateway reply equals the oracle and a shared prefix sticks to one
  replica; ``build_gateway_service``'s gateway (host tier, global
  index) serves the same way;
- a sibling import through the global index is deterministic: request 1
  warms replica 1, request 2 lands cold on replica 2 (round-robin),
  imports replica 1's blocks and replies with ``kv_import_from ==
  "replica-1"`` and the oracle's tokens;
- a parked conversation hard-pins its next step (``routed_by ==
  "fused"``), and a speculative prefill of its next step extends the
  pin;
- the port's engine has every attribute the reference gateway looks up
  on an engine (the gateway treats a missing one as "feature absent");
- no thread the port started is alive after ``close()``;
- engine contracts no other port test pins: sampled serving (seeds 0
  and 1) gives dense output equal to paged output and speculation on
  equal to off; ``eos_token`` ends the reply as ``generate(...,
  eos_token=)`` does, with speculation off and on.
"""

import dataclasses
import re
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from lzy_tpu_torch.gateway import (
    GatewayService, GlobalKVIndex, PrefixAffinityRouter, ReplicaFleet,
    RoundRobinRouter)
from lzy_tpu_torch.models import convert
from lzy_tpu_torch.models.generate import generate
from lzy_tpu_torch.models.llama import LlamaConfig, init_params
from lzy_tpu_torch.serving.engine import InferenceEngine, PagedInferenceEngine

torch.set_num_threads(1)

VOCAB = 64
PAGE = 4
N_NEW = 6
REPO = Path(__file__).resolve().parents[1]
_RNG = np.random.default_rng(11)
HEADER = [int(x) for x in _RNG.integers(0, VOCAB, 16)]
PROMPTS = [HEADER + [int(x) for x in _RNG.integers(0, VOCAB, 3)]
           for _ in range(3)]


def _tiny_f32():
    return dataclasses.replace(LlamaConfig.tiny(vocab_size=VOCAB),
                               dtype=torch.float32,
                               param_dtype=torch.float32)


@pytest.fixture(scope="module")
def model():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from lzy_tpu.models import llama as ref_llama, unbox

    rcfg = dataclasses.replace(ref_llama.LlamaConfig.tiny(vocab_size=VOCAB),
                               dtype=jnp.float32)
    boxed, _ = ref_llama.init_params(rcfg, jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(np.asarray, unbox(boxed))
    return convert.load_reference(init_params(_tiny_f32(), device="cpu"),
                                  params)


def _oracle(model, prompt, n=N_NEW, **kw):
    return generate(model, torch.tensor([prompt]), max_new_tokens=n,
                    **kw)[0, len(prompt):].tolist()


@pytest.fixture
def gateway(model):
    """A factory of two-replica gateways over ``model``, each closed at
    teardown."""
    made = []

    def make(router, kv_index=None, **engine_kw):
        engine_kw.setdefault("slots", 2)
        fleet = ReplicaFleet(lambda: PagedInferenceEngine(
            model, page_size=PAGE, **engine_kw))
        gw = GatewayService(fleet, router=router, page_size=PAGE,
                            kv_index=kv_index)
        made.append(gw)
        for _ in range(2):
            fleet.add_replica()
        return gw

    yield make
    for gw in made:
        gw.close()


def test_reply_equals_oracle_and_prefix_sticks(model, gateway):
    gw = gateway(PrefixAffinityRouter(PAGE))
    replies = [gw.generate(p, max_new_tokens=N_NEW) for p in PROMPTS]
    assert [r["tokens"] for r in replies] == [_oracle(model, p)
                                              for p in PROMPTS]
    assert all(r["status"] == "ok" for r in replies)
    assert len({r["replica"] for r in replies}) == 1
    assert [r["routed_by"] for r in replies[1:]] == ["prefix", "prefix"]
    s = gw.stats()
    assert s["requests_finished"] == 3 and s["fleet_prefix_hit_rate"] > 0


def test_sibling_import_is_deterministic(model, gateway):
    gw = gateway(RoundRobinRouter(PAGE), kv_index=GlobalKVIndex(PAGE),
                 kv_host_tier_bytes=1 << 20)
    first = gw.generate(PROMPTS[0], max_new_tokens=N_NEW)
    assert first["replica"] == "replica-1"
    gw.tick()                                   # refresh the index
    second = gw.generate(PROMPTS[1], max_new_tokens=N_NEW)
    assert second["replica"] == "replica-2"
    assert second["kv_import_from"] == "replica-1"
    assert second["kv_import_staged_from"] == "replica-1"
    assert second["tokens"] == _oracle(model, PROMPTS[1])
    warm = gw.fleet.get("replica-2").engine.stats()
    assert warm.kv_imports == 1 and warm.prefill_tokens_saved == 16
    s = gw.stats()
    assert s["kvtier_imports"] == 1 and s["kvtier_reprefill_fallbacks"] == 0
    assert s["kvtier_import_bytes"] > 0


def test_parked_conversation_pins_next_step(model, gateway):
    gw = gateway(PrefixAffinityRouter(PAGE))
    step1 = gw.generate(PROMPTS[0], max_new_tokens=N_NEW, session="s")
    history = PROMPTS[0] + step1["tokens"]
    assert gw.park_conversation("s", history)
    engine = gw.fleet.get(step1["replica"]).engine
    assert engine.stats().kv_parked_chains == 1
    step2 = gw.generate(history + [1, 2], max_new_tokens=N_NEW,
                        session="s")
    assert step2["routed_by"] == "fused"
    assert step2["replica"] == step1["replica"]
    assert step2["tokens"] == _oracle(model, history + [1, 2])
    # a speculative prefill of the next step re-parks over its blocks
    history = history + [1, 2] + step2["tokens"]
    assert gw.speculate_prefill("s", history)
    assert engine.stats().kv_parked_blocks == len(history) // PAGE
    assert gw.unpark_conversation("s")
    assert engine.stats().kv_parked_chains == 0


def _gateway_engine_lookups():
    """Attribute names the reference gateway reads off an engine, by
    ``getattr(<...>engine, "name"...)`` or ``<...>engine.name``; the
    sharded-gang probes (``gang_*``) belong to an unported slice."""
    names = set()
    for path in (REPO / "lzy_tpu" / "gateway").glob("*.py"):
        text = path.read_text()
        names |= set(re.findall(r'getattr\([\w.]*engine,\s*"(\w+)"', text))
        names |= set(re.findall(r'\bengine\.(\w+)', text))
    return sorted(n for n in names if not n.startswith("gang_"))


def test_engine_has_every_method_the_gateway_looks_up(model):
    names = _gateway_engine_lookups()
    for must in ("park_chain", "unpark_chain", "queue_kv_import",
                 "request_kv_export", "kv_tier_match_len", "kv_chains"):
        assert must in names
    engine = PagedInferenceEngine(model, slots=1, page_size=PAGE)
    missing = [n for n in names if not hasattr(engine, n)]
    assert not missing, f"the port engine lacks {missing}"
    engine.close()


def test_built_gateway_serves_and_leaves_no_thread():
    from lzy_tpu_torch.service.inference import build_gateway_service

    before = set(threading.enumerate())
    gw = build_gateway_service(
        "tiny", cfg=_tiny_f32(), device="cpu", replicas=2, slots=2,
        paged=True, page_size=PAGE, kv_blocks=24,
        kv_host_tier_bytes=1 << 20, autoscale=True, start=True)
    try:
        assert gw.kv_index is not None
        model = gw.fleet.replicas()[0].engine.model
        assert all(r.engine.model is model for r in gw.fleet.replicas())
        reply = gw.generate(PROMPTS[0], max_new_tokens=N_NEW)
        assert reply["tokens"] == _oracle(model, PROMPTS[0])
        with pytest.raises(TypeError, match="journal"):
            build_gateway_service("tiny", cfg=_tiny_f32(), device="cpu",
                                  paged=True, journal=object())
    finally:
        gw.close()
    alive = [t.name for t in set(threading.enumerate()) - before
             if t.is_alive()]
    assert not alive, f"threads left running: {alive}"


def _serve(engine, prompts, n):
    reqs = [engine.submit(p, max_new_tokens=n) for p in prompts]
    for _ in range(400):
        if all(r.done for r in reqs):
            break
        engine.step()
    return [r.result(0) for r in reqs]


@pytest.mark.parametrize("seed", [0, 1])
def test_sampled_dense_equals_paged_and_spec(model, seed):
    kw = dict(slots=3, temperature=1.0, seed=seed)
    prompts = [p[-7:] for p in PROMPTS]
    dense = _serve(InferenceEngine(model, **kw), prompts, 10)
    paged = _serve(PagedInferenceEngine(model, page_size=PAGE, **kw),
                   prompts, 10)
    spec = _serve(PagedInferenceEngine(model, page_size=PAGE,
                                       spec_tokens=3, **kw), prompts, 10)
    assert dense == paged == spec
    assert len({tuple(t) for t in dense}) > 1       # really sampled


@pytest.mark.parametrize("spec", [0, 3])
def test_eos_token_ends_reply(model, spec):
    prompt = PROMPTS[0]
    greedy = _oracle(model, prompt, 12)
    eos = greedy[4]
    want = _oracle(model, prompt, 12, eos_token=eos)
    want = want[:want.index(eos) + 1]
    for engine in (InferenceEngine(model, slots=2, eos_token=eos,
                                   spec_tokens=spec),
                   PagedInferenceEngine(model, slots=2, page_size=PAGE,
                                        eos_token=eos, spec_tokens=spec)):
        assert _serve(engine, [prompt], 12) == [want]
