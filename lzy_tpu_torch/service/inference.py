"""Build a serving engine for a named model: the port's counterpart of
``lzy_tpu/service/inference.py`` ``_build_engine_parts`` and the engine
half of ``build_inference_service``.

``build_engine("llama3_8b", seed=0, paged=True, ...)`` draws the named
config's weights on the device from a seeded generator (nothing is
downloaded), builds a :class:`PagedInferenceEngine` (or the dense
:class:`InferenceEngine`), warms it up and, by default, starts its loop.
This is the entry point ``chip_smoke.py`` drives.
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
