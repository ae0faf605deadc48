"""Build a serving engine or a serving fleet for a named model: the
port's counterpart of ``lzy_tpu/service/inference.py``
(``_build_engine_parts``, the engine half of ``build_inference_service``,
``build_gateway_service`` and ``build_disagg_gateway_service``).

``build_engine("llama3_8b", seed=0, paged=True, ...)`` draws the named
config's weights on the device from a seeded generator (nothing is
downloaded), builds a :class:`PagedInferenceEngine` (or the dense
:class:`InferenceEngine`), warms it up and, by default, starts its loop.
``build_gateway_service`` puts N such replicas behind one
:class:`~lzy_tpu_torch.gateway.GatewayService` (prefix routing, the host
KV tier and the fleet-global index); ``build_disagg_gateway_service``
puts a prefill pool and a decode pool behind a
:class:`~lzy_tpu_torch.gateway.DisaggGatewayService`. The replicas of a
fleet share ONE model: the engines never mutate it. These are the entry
points ``chip_smoke.py`` drives; everything runs on ``cuda`` unless the
caller passes ``device="cpu"``.
"""

from __future__ import annotations

from typing import Optional, Tuple

from lzy_tpu_torch.device import DeviceLike, resolve_device
from lzy_tpu_torch.models.llama import Llama, LlamaConfig, init_params
from lzy_tpu_torch.serving.engine import InferenceEngine, PagedInferenceEngine

MODEL_CONFIGS = ("tiny", "llama3_8b")


def build_engine_parts(model: str, *, seed: int = 0,
                       device: DeviceLike = "cuda",
                       cfg: Optional[LlamaConfig] = None
                       ) -> Tuple[LlamaConfig, Llama]:
    """Config and randomly initialized model for a named config; ``cfg``
    overrides the preset (e.g. a cut depth, or float32 for a CPU run)."""
    if model not in MODEL_CONFIGS:
        raise ValueError(
            f"unknown model {model!r}; known: {', '.join(MODEL_CONFIGS)}")
    cfg = cfg if cfg is not None else getattr(LlamaConfig, model)()
    return cfg, init_params(cfg, seed, resolve_device(device))


def build_engine(
    model: str,
    *,
    seed: int = 0,
    device: DeviceLike = "cuda",
    cfg: Optional[LlamaConfig] = None,
    paged: bool = True,
    slots: int = 4,
    prefill_chunk: int = 64,
    page_size: int = 16,
    kv_pool_bytes: Optional[int] = None,
    kv_quant: Optional[str] = None,
    spec_tokens: int = 0,
    start: bool = True,
) -> InferenceEngine:
    """A warmed-up engine for ``model`` (one of :data:`MODEL_CONFIGS`).

    ``paged=True`` serves from the paged KV pool with radix prefix reuse
    (blocks of ``page_size`` tokens, as many as ``kv_pool_bytes`` of K/V
    payload buys), its attention read by the CUDA kernel on the card;
    ``kv_quant="int8"`` halves the pool's bytes. ``spec_tokens`` > 0 turns
    on n-gram speculative decoding; ``start`` runs the loop in a
    background thread. Queue caps, EOS, prefill budgets and tenants are
    options of the engine classes themselves."""
    if not paged and (kv_quant is not None or kv_pool_bytes is not None):
        raise ValueError("kv_quant / kv_pool_bytes require paged=True")
    _, llama = build_engine_parts(model, seed=seed, device=device, cfg=cfg)
    common = dict(slots=slots, prefill_chunk=prefill_chunk, seed=seed,
                  spec_tokens=spec_tokens)
    if paged:
        engine: InferenceEngine = PagedInferenceEngine(
            llama, page_size=page_size, kv_pool_bytes=kv_pool_bytes,
            kv_quant=kv_quant, **common)
    else:
        engine = InferenceEngine(llama, **common)
    engine.warmup()
    if start:
        engine.start()
    return engine


def _check_paged_only(paged: bool, *, kv_quant, kv_blocks, kv_pool_bytes,
                      kv_host_tier_bytes) -> None:
    if not paged and (kv_quant is not None or kv_blocks is not None
                      or kv_pool_bytes is not None
                      or kv_host_tier_bytes is not None):
        raise ValueError("kv_quant / kv_blocks / kv_pool_bytes / "
                         "kv_host_tier_bytes require paged=True")


def _router_cls(routing: str):
    from lzy_tpu_torch.gateway import PrefixAffinityRouter, RoundRobinRouter

    if routing not in ("prefix", "rr"):
        raise ValueError(f"unknown routing {routing!r}; use prefix or rr")
    return PrefixAffinityRouter if routing == "prefix" else RoundRobinRouter


def _fleet_parts(autoscale: bool, replicas: int,
                 min_replicas: Optional[int], max_replicas: Optional[int],
                 tenants):
    from lzy_tpu_torch.gateway import Autoscaler
    from lzy_tpu_torch.serving.tenancy import SloLimiter

    autoscaler = None
    if autoscale:
        autoscaler = Autoscaler(min_replicas=min_replicas or replicas,
                                max_replicas=max_replicas or 2 * replicas)
    slo = SloLimiter(tenants) if tenants is not None else None
    return autoscaler, slo


def build_gateway_service(
    model: str,
    *,
    replicas: int = 3,
    slots: int = 4,
    max_queue: int = 64,
    eos_token: Optional[int] = None,
    seed: int = 0,
    prefill_chunk: int = 64,
    paged: bool = False,
    page_size: int = 16,
    kv_blocks: Optional[int] = None,
    kv_pool_bytes: Optional[int] = None,
    kv_quant: Optional[str] = None,
    kv_host_tier_bytes: Optional[int] = None,
    kv_global_index: Optional[bool] = None,
    routing: str = "prefix",
    autoscale: bool = True,
    min_replicas: Optional[int] = None,
    max_replicas: Optional[int] = None,
    spec_tokens: int = 0,
    warm_start: bool = False,
    start: bool = True,
    prefill_budget: Optional[int] = None,
    tenants=None,
    device: DeviceLike = "cuda",
    cfg: Optional[LlamaConfig] = None,
    temperature: float = 0.0,
):
    """The serving fleet gateway: ``replicas`` engines over one shared
    model behind one ``generate`` endpoint, with prefix-affinity routing
    (``routing="prefix"``, or ``"rr"`` round-robin as the baseline),
    health and fenced failover, and optional autoscaling between
    ``min_replicas`` and ``max_replicas`` (defaults ``replicas`` and
    ``2 * replicas``).

    ``kv_host_tier_bytes`` puts a host KV tier of that budget behind
    every paged replica; ``kv_global_index`` turns on the fleet-global
    prefix index and cross-replica imports (default: on exactly when a
    tier is configured). ``spec_tokens`` > 0 enables speculative
    decoding; ``warm_start`` warms each replica up at boot;
    ``prefill_budget`` bounds prefill tokens per round; ``tenants`` (a
    ``TenantTable``) turns on rate limits at the gateway and WFQ, queue
    caps and KV quotas in every replica. ``device``, ``cfg`` (an
    override of the named preset) and ``temperature`` (the replicas'
    sampling temperature for requests that are not pinned greedy; 0 is
    greedy) are the port's. The reference's
    checkpoint, storage-tier, sharded-replica, allocator and journal
    options wait for their slices (ROADMAP queue 1)."""
    from lzy_tpu_torch.gateway import GatewayService, GlobalKVIndex, \
        ReplicaFleet
    from lzy_tpu_torch.llm.backend import model_digest_for

    if replicas < 1:
        raise ValueError(f"replicas must be >= 1, got {replicas}")
    router_cls = _router_cls(routing)
    _check_paged_only(paged, kv_quant=kv_quant, kv_blocks=kv_blocks,
                      kv_pool_bytes=kv_pool_bytes,
                      kv_host_tier_bytes=kv_host_tier_bytes)
    if kv_global_index is None:
        # a tier without the global index would warm only its own replica
        kv_global_index = kv_host_tier_bytes is not None
    if kv_global_index and not paged:
        raise ValueError("kv_global_index requires paged=True (there are "
                         "no KV blocks to import)")
    cfg, llama = build_engine_parts(model, seed=seed, device=device, cfg=cfg)
    common = dict(slots=slots, max_queue=max_queue, eos_token=eos_token,
                  prefill_chunk=prefill_chunk, seed=seed,
                  spec_tokens=spec_tokens, prefill_budget=prefill_budget,
                  tenants=tenants, temperature=temperature)

    def engine_factory():
        if paged:
            engine: InferenceEngine = PagedInferenceEngine(
                llama, page_size=page_size, kv_blocks=kv_blocks,
                kv_pool_bytes=kv_pool_bytes, kv_quant=kv_quant,
                kv_host_tier_bytes=kv_host_tier_bytes, **common)
        else:
            engine = InferenceEngine(llama, **common)
        if warm_start:
            engine.warmup()
        return engine

    autoscaler, slo = _fleet_parts(autoscale, replicas, min_replicas,
                                   max_replicas, tenants)
    fleet = ReplicaFleet(engine_factory)
    service = GatewayService(
        fleet, router=router_cls(page_size if paged else prefill_chunk),
        autoscaler=autoscaler, model_name=model, slo=slo,
        kv_index=GlobalKVIndex(page_size) if kv_global_index else None)
    try:
        for _ in range(replicas):
            fleet.add_replica()
    except BaseException:
        service.close()
        raise
    service.model_digest = model_digest_for(model, cfg, seed=seed)
    if start:
        service.start()
    return service


def build_disagg_gateway_service(
    model: str,
    *,
    prefill_replicas: int = 1,
    decode_replicas: int = 2,
    slots: int = 4,
    max_queue: int = 64,
    eos_token: Optional[int] = None,
    seed: int = 0,
    prefill_chunk: int = 64,
    page_size: int = 16,
    kv_blocks: Optional[int] = None,
    kv_pool_bytes: Optional[int] = None,
    kv_quant: Optional[str] = None,
    kv_host_tier_bytes: Optional[int] = None,
    routing: str = "prefix",
    autoscale: bool = True,
    min_replicas: Optional[int] = None,
    max_replicas: Optional[int] = None,
    transport=None,
    spec_tokens: int = 0,
    warm_start: bool = False,
    start: bool = True,
    prefill_budget: Optional[int] = None,
    tenants=None,
    kv_global_index: Optional[bool] = None,
    device: DeviceLike = "cuda",
    cfg: Optional[LlamaConfig] = None,
):
    """The disaggregated gateway: ``prefill_replicas``
    :class:`~lzy_tpu_torch.serving.disagg.PrefillEngine` replicas feeding
    KV blocks over ``transport`` (in-memory by default) to
    ``decode_replicas`` :class:`~lzy_tpu_torch.serving.disagg.DecodeEngine`
    replicas, all over one shared model. Both pools are paged, with the
    same ``kv_quant`` (the payload is the raw cache leaves; a mismatch
    fails closed to a re-prefill). Autoscaling applies to the decode
    pool; ``spec_tokens`` reaches only the decode pool. The other
    options are :func:`build_gateway_service`'s."""
    from lzy_tpu_torch.gateway import DisaggGatewayService, GlobalKVIndex, \
        ReplicaFleet
    from lzy_tpu_torch.llm.backend import model_digest_for
    from lzy_tpu_torch.serving.disagg import DecodeEngine, PrefillEngine

    if prefill_replicas < 1 or decode_replicas < 1:
        raise ValueError(
            f"disagg needs >= 1 replica per pool, got prefill="
            f"{prefill_replicas} decode={decode_replicas}")
    router_cls = _router_cls(routing)
    if kv_global_index is None:
        kv_global_index = kv_host_tier_bytes is not None
    cfg, llama = build_engine_parts(model, seed=seed, device=device, cfg=cfg)
    common = dict(slots=slots, max_queue=max_queue,
                  prefill_chunk=prefill_chunk, seed=seed,
                  page_size=page_size, kv_blocks=kv_blocks,
                  kv_pool_bytes=kv_pool_bytes, kv_quant=kv_quant,
                  kv_host_tier_bytes=kv_host_tier_bytes,
                  prefill_budget=prefill_budget, tenants=tenants)

    def decode_factory():
        engine = DecodeEngine(llama, eos_token=eos_token,
                              spec_tokens=spec_tokens, **common)
        if warm_start:
            engine.warmup()
        return engine

    def prefill_factory():
        return PrefillEngine(llama, **common)

    decode_fleet = ReplicaFleet(decode_factory, replica_prefix="decode")
    prefill_fleet = ReplicaFleet(prefill_factory, replica_prefix="prefill")
    autoscaler, slo = _fleet_parts(autoscale, decode_replicas,
                                   min_replicas, max_replicas, tenants)
    service = DisaggGatewayService(
        decode_fleet, prefill_fleet, page_size=page_size,
        router=router_cls(page_size), prefill_router=router_cls(page_size),
        autoscaler=autoscaler, transport=transport,
        prefill_replicas=prefill_replicas, model_name=model, slo=slo,
        kv_index=GlobalKVIndex(page_size) if kv_global_index else None)
    try:
        for _ in range(decode_replicas):
            decode_fleet.add_replica()
        for _ in range(prefill_replicas):
            prefill_fleet.add_replica()
    except BaseException:
        service.close()
        raise
    service.model_digest = model_digest_for(model, cfg, seed=seed)
    if start:
        service.start()
    return service
