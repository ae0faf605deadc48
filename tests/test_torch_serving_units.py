"""The port's copies of the reference's framework-neutral serving modules
(scheduler, tenancy, kv_cache, spec, chaos) behave as the originals do:
the same operation sequences give the same answers. Host-only, no
model."""

import numpy as np
import pytest
import torch

from lzy_tpu_torch.chaos.faults import CHAOS, ERROR, FaultPlan
from lzy_tpu_torch.serving import kv_cache, scheduler, spec, tenancy

torch.set_num_threads(1)


def _ref(name):
    import importlib

    return importlib.import_module(f"lzy_tpu.serving.{name}")


def _radix_trace(mod, seed):
    """Run one random admission/release trace; return everything the
    cache said along the way."""
    rng = np.random.default_rng(seed)
    cache = mod.RadixCache(24, 4)
    held, out = [], []
    for _ in range(60):
        op = rng.integers(0, 3)
        if op == 0 or not held:
            prefix = [int(t) for t in rng.integers(0, 3, 12)]
            blocks, n = cache.match(prefix)
            try:
                blocks += cache.allocate(3 - len(blocks))
            except mod.NoFreeBlocks:
                cache.release(blocks)
                out.append("full")
                continue
            cache.insert(prefix, blocks)
            held.append(blocks)
            out.append((tuple(blocks), n))
        else:
            cache.release(held.pop(int(rng.integers(0, len(held)))))
        s = cache.stats()
        out.append((cache.available(), s.blocks_free, s.blocks_cached,
                    s.evictions, s.prefix_hit_tokens))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_radix_cache_traces_match_reference(seed):
    assert _radix_trace(kv_cache, seed) == _radix_trace(_ref("kv_cache"),
                                                        seed)


def test_block_sizing_matches_reference():
    ref = _ref("kv_cache")
    for quant in (None, "int8"):
        kw = dict(page_size=16, n_kv_heads=8, head_dim=128, n_layers=32,
                  kv_quant=quant)
        assert kv_cache.kv_block_bytes(**kw) == \
            ref.kv_block_bytes(dtype="bfloat16", **kw)
        assert kv_cache.blocks_for_bytes(4 << 30, **kw) == \
            ref.blocks_for_bytes(4 << 30, dtype="bfloat16", **kw)
    assert kv_cache.blocks_for(33, 16) == ref.blocks_for(33, 16) == 3


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_ngram_proposals_match_reference(seed):
    ref = _ref("spec")
    rng = np.random.default_rng(seed)
    seq = [int(t) for t in rng.integers(0, 5, 80)]
    mine, theirs = spec.NgramProposer(3, 4), ref.NgramProposer(3, 4)
    idx = mine.index(seq[:10])
    for end in range(10, len(seq)):
        assert mine.propose(seq[:end]) == theirs.propose(seq[:end])
        assert idx.extend(seq[len(idx):end]).propose() == \
            theirs.propose(seq[:end])


def _wfq_order(mod, tenancy_mod):
    table = tenancy_mod.TenantTable()
    table.set_policy(tenancy_mod.TenantPolicy(tenant="a", priority=0))
    table.set_policy(tenancy_mod.TenantPolicy(tenant="b", priority=2))
    q = mod.RequestQueue(32, policies=table)
    for i in range(6):
        for t in ("a", "b", "c"):
            q.submit(mod.Request([1] * (3 + i), 4, request_id=f"{t}{i}",
                                 tenant=t))
    order = []
    while q.depth():
        head = q.candidates()[0]
        q.pop_request(head)
        order.append(head.id)
    return order


def test_wfq_dispatch_order_matches_reference():
    assert _wfq_order(scheduler, tenancy) == \
        _wfq_order(_ref("scheduler"), _ref("tenancy"))


def test_queue_caps_and_quota_errors():
    table = tenancy.TenantTable(tenancy.TenantPolicy(max_queued=1))
    q = scheduler.RequestQueue(8, policies=table)
    q.submit(scheduler.Request([1], 1, tenant="x"))
    with pytest.raises(scheduler.QuotaExceeded) as err:
        q.submit(scheduler.Request([1], 1, tenant="x"))
    assert err.value.tenant == "x" and err.value.retry_after_s > 0
    q.submit(scheduler.Request([1], 1, tenant="y"))   # other tenants fine
    full = scheduler.RequestQueue(1)
    full.submit(scheduler.Request([1], 1))
    with pytest.raises(scheduler.AdmissionError):
        full.submit(scheduler.Request([1], 1))


def test_slo_limiter_refuses_and_refunds():
    now = [0.0]
    table = tenancy.TenantTable(tenancy.TenantPolicy(
        requests_per_s=5.0, prompt_tokens_per_s=10.0, burst_s=2.0))
    slo = tenancy.SloLimiter(table, clock=lambda: now[0])
    slo.admit("t", 5)
    slo.admit("t", 5)
    with pytest.raises(scheduler.QuotaExceeded) as err:
        slo.admit("t", 15)           # token bucket refuses ...
    assert err.value.reason == "prompt_tokens_per_s"
    now[0] += 1.0                    # ... and refunded the request take
    slo.admit("t", 10)


def test_armed_fault_points_fire_in_the_port_only():
    from lzy_tpu.chaos.faults import CHAOS as REF_CHAOS

    plan = FaultPlan(seed=1, rate=1.0, modes=(ERROR,),
                     points=["engine.admit", "slo.admit"])
    CHAOS.arm(plan)
    try:
        with pytest.raises(scheduler.AdmissionError):
            scheduler.RequestQueue(4).submit(scheduler.Request([1], 1))
        with pytest.raises(scheduler.QuotaExceeded):
            tenancy.SloLimiter(tenancy.TenantTable()).admit("t", 1)
        assert REF_CHAOS.armed is None
    finally:
        CHAOS.disarm()
    assert plan.fired == 2
