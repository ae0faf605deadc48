"""The port's host KV tier (lzy_tpu_torch/serving/kv_tier.py) and the
paged engine's demotion, promotion and parked chains.

Tiny config, float32, CPU, weights from the JAX reference
(``convert.load_reference``); held to the port's ``generate()`` oracle
and, after every ``step()``, to the reference's own pool auditors
(``lzy_tpu.chaos.invariants.audit_engine``, which runs
``audit_kv_tier``):

- greedy output with a host tier under a tight pool equals output
  without one and the oracle (f32), and equals the untiered int8 pool;
- a demote-then-promote round trip gives the exact bits back, at f32 and
  at int8 (twelve leaves for two layers: K, V and four sidecars each);
- the ``kvtier.demote`` and ``kvtier.import`` faults become counted
  drops and failures while the output still equals the oracle;
- ``park_chain`` pins a chain against eviction until ``unpark_chain`` or
  its TTL;
- each steady decode or verify round takes one device-to-host transfer
  with a tier configured;
- a device fault (a CUDA error) while writing the pool is engine-fatal
  (``PoolCorruption``), never request-scoped.
"""

import dataclasses

import numpy as np
import pytest
import torch

from lzy_tpu_torch.chaos.faults import CHAOS, ERROR, FaultPlan
from lzy_tpu_torch.models import convert
from lzy_tpu_torch.models.generate import generate
from lzy_tpu_torch.models.llama import LlamaConfig, init_params
from lzy_tpu_torch.serving.disagg import export_kv, kv_export
from lzy_tpu_torch.serving.engine import PagedInferenceEngine, PoolCorruption
from lzy_tpu_torch.utils.clock import SystemClock
from test_torch_engine import _CountTransfers

torch.set_num_threads(1)

VOCAB = 64
PAGE = 4
N_NEW = 6
#: six prompts over three 16-token headers: a 9-block pool holds one
#: request (7 blocks) and little else, so every header is evicted and
#: asked for again
_RNG = np.random.default_rng(7)
HEADERS = [[int(x) for x in _RNG.integers(0, VOCAB, 16)] for _ in range(3)]
PROMPTS = [h + [int(x) for x in _RNG.integers(0, VOCAB, 3)]
           for h in HEADERS + HEADERS]


@pytest.fixture(scope="module")
def model():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from lzy_tpu.models import llama as ref_llama, unbox

    rcfg = dataclasses.replace(ref_llama.LlamaConfig.tiny(vocab_size=VOCAB),
                               dtype=jnp.float32)
    boxed, _ = ref_llama.init_params(rcfg, jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(np.asarray, unbox(boxed))
    cfg = dataclasses.replace(LlamaConfig.tiny(vocab_size=VOCAB),
                              dtype=torch.float32, param_dtype=torch.float32)
    return convert.load_reference(init_params(cfg, device="cpu"), params)


@pytest.fixture(scope="module")
def oracle(model):
    return [generate(model, torch.tensor([p]),
                     max_new_tokens=N_NEW)[0, len(p):].tolist()
            for p in PROMPTS]


@pytest.fixture(autouse=True)
def _disarm():
    yield
    CHAOS.disarm()


def _engine(model, **kw):
    kw.setdefault("slots", 1)
    kw.setdefault("kv_blocks", 9)
    return PagedInferenceEngine(model, page_size=PAGE, **kw)


def _serve(engine, prompts, audit=True):
    """One request at a time (the tight pool's own pace), the reference's
    auditors after every step."""
    from lzy_tpu.chaos.invariants import audit_engine

    out = []
    for prompt in prompts:
        req = engine.submit(prompt, max_new_tokens=N_NEW)
        for _ in range(200):
            if req.done:
                break
            engine.step()
            if audit:
                audit_engine(engine)
        out.append(req.result(0))
    return out


@pytest.mark.parametrize("quant", [None, "int8"])
def test_tier_output_equals_untiered_and_oracle(model, oracle, quant):
    plain = _serve(_engine(model, kv_quant=quant), PROMPTS, audit=False)
    eng = _engine(model, kv_quant=quant, kv_host_tier_bytes=1 << 20)
    got = _serve(eng, PROMPTS)
    s = eng.stats()
    assert s.kv_tier_demotions > 0 and s.kv_tier_promotions > 0
    assert s.kv_tier_dropped == 0
    # promoted headers are not prefilled again
    assert s.prefill_tokens_saved >= 3 * 16
    assert got == plain
    if quant is None:
        assert got == oracle
    assert eng.kv_tier_gather_rounds <= eng.stats().kv_evictions
    eng.close()
    assert eng.kv_tier.stats()["host_blocks"] == 0


@pytest.mark.parametrize("quant", [None, "int8"])
def test_demote_promote_round_trip_is_bit_exact(model, quant):
    eng = _engine(model, kv_quant=quant, kv_blocks=16,
                  kv_host_tier_bytes=1 << 20)
    _serve(eng, PROMPTS[:1])
    header = PROMPTS[0][:16]
    before = export_kv(eng, header)
    assert len(before.leaves) == (12 if quant else 4)
    # take every block: the cached header is evicted, i.e. demoted
    held = eng.kv.allocate(eng.kv.available())
    assert eng.kv.match_len(header) == 0
    assert eng.kv_tier.has(tuple(header)) == "host"
    eng.kv.release(held)
    assert eng._promote_for(header) == len(header) // PAGE
    after = export_kv(eng, header)
    assert after.tokens == before.tokens
    for key, rows in before.leaves.items():
        assert rows.dtype == after.leaves[key].dtype
        assert torch.equal(rows, after.leaves[key]), key
    assert eng.kv_tier.stats()["host_blocks"] == 0   # one tier owns it


@pytest.mark.parametrize("point", ["kvtier.demote", "kvtier.import"])
def test_tier_faults_are_counted_and_harmless(model, oracle, point):
    eng = _engine(model, kv_host_tier_bytes=1 << 20)
    CHAOS.arm(FaultPlan(seed=0, rate=1.0, modes=(ERROR,), points=[point]))
    got = _serve(eng, PROMPTS)
    CHAOS.disarm()
    assert got == oracle
    s = eng.stats()
    assert s.kv_tier_promotions == 0
    if point == "kvtier.demote":
        assert s.kv_tier_demotions == 0 and s.kv_tier_dropped > 0
    else:
        assert s.kv_tier_demotions > 0
        assert eng.kv_tier_promotion_failures > 0


class _ManualClock(SystemClock):
    def __init__(self):
        self.t = 0.0

    def now(self) -> float:
        return self.t


@pytest.mark.parametrize("release", ["unpark", "ttl"])
def test_park_pins_chain_until_released(model, release):
    clock = _ManualClock()
    eng = _engine(model, kv_blocks=16, clock=clock)
    _serve(eng, PROMPTS[:1], audit=False)
    header = PROMPTS[0][:16]
    assert eng.park_chain("conv:a", header, ttl_s=10.0)
    assert eng.stats().kv_parked_blocks == len(header) // PAGE
    # pressure: everything evictable goes, the parked chain stays
    eng.kv.release(eng.kv.allocate(eng.kv.available()))
    assert eng.kv.match_len(header) == len(header)
    if release == "unpark":
        assert eng.unpark_chain("conv:a")
        assert not eng.unpark_chain("conv:a")
    else:
        clock.t = 11.0
        eng.step()                      # the TTL sweep
    assert eng.stats().kv_parked_chains == 0
    eng.kv.release(eng.kv.allocate(eng.kv.available()))
    assert eng.kv.match_len(header) == 0


@pytest.mark.parametrize("spec", [0, 3], ids=["decode", "verify"])
def test_one_transfer_per_decode_round(model, monkeypatch, spec):
    eng = _engine(model, slots=3, kv_blocks=None, spec_tokens=spec,
                  kv_host_tier_bytes=1 << 20)
    reqs = [eng.submit(p, max_new_tokens=30) for p in PROMPTS[:3]]
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


class _FaultyRows:
    """Host rows whose host-to-device copy dies with a CUDA error."""

    def to(self, *_a, **_kw):
        raise RuntimeError("CUDA error: an illegal memory access was "
                           "encountered")


@pytest.mark.parametrize("where", ["prefill", "promotion", "import"])
def test_device_fault_is_engine_fatal(model, monkeypatch, where):
    eng = _engine(model, kv_blocks=16, kv_host_tier_bytes=1 << 20)
    _serve(eng, PROMPTS[:1], audit=False)
    export = export_kv(eng, PROMPTS[0])
    eng.kv.release(eng.kv.allocate(eng.kv.available()))   # demote all

    def fault(*_a, **_kw):
        _FaultyRows().to()

    if where == "prefill":
        monkeypatch.setattr(eng, "_advance_prefill_round", fault)
    elif where == "promotion":
        monkeypatch.setattr(eng.kv, "allocate", fault)
    else:
        monkeypatch.setattr(
            kv_export, "_check_payload",
            lambda engine, _export, _n: {
                key: _FaultyRows() for key, _ in engine._kv_leaves()})
        eng.queue_kv_import(export)
    req = eng.submit(PROMPTS[0], max_new_tokens=2)
    with pytest.raises(PoolCorruption, match="device fault"):
        for _ in range(10):
            eng.step()
    assert not req.done        # the loop's death handler fails it
