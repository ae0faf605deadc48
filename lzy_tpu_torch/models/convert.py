"""Weight bridge between the reference's param tree and the port.

The reference (``lzy_tpu/models/llama.py``) keeps its unboxed Flax
params as nested dicts: ``embed_tokens [V, D]``, ``layer_{i}`` with
``attn/{q,k,v}_proj/kernel [D, heads, head_dim]``, ``attn/o_proj/kernel
[H * head_dim, D]``, ``mlp/{gate,up}_proj/kernel [D, F]``,
``mlp/down_proj/kernel [F, D]``, ``{attn,mlp}_norm/scale [D]``,
``final_norm/scale`` and, untied, ``lm_head [V, D]``. The port's
``nn.Linear`` weights are the transposed ``[out, in]`` matrices.

:func:`from_reference` maps such a tree (numpy arrays, or anything
``np.asarray`` accepts) to a port state dict; :func:`to_reference` maps
back, so both frameworks compute with the same weights, and
:func:`grads_to_reference` maps the port's gradients onto the same tree.
Tied embeddings (no ``lm_head``) and f32 training params go through
unchanged: the dtype is ``cfg.param_dtype``.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from lzy_tpu_torch.models.llama import Llama, LlamaConfig

_PROJ = {"attn": ("q_proj", "k_proj", "v_proj", "o_proj"),
         "mlp": ("gate_proj", "up_proj", "down_proj")}


def from_reference(params: Any,
                   cfg: LlamaConfig) -> Dict[str, torch.Tensor]:
    """Reference param tree -> port state dict in ``cfg.param_dtype``."""
    def t(x) -> torch.Tensor:
        return torch.from_numpy(np.array(x, dtype=np.float32)).to(
            cfg.param_dtype)

    sd = {"embed_tokens": t(params["embed_tokens"]),
          "final_norm.scale": t(params["final_norm"]["scale"])}
    if not cfg.tie_embeddings:
        sd["lm_head"] = t(params["lm_head"])
    for i in range(cfg.n_layers):
        lp = params[f"layer_{i}"]
        pre = f"layers.{i}"
        for group, names in _PROJ.items():
            for name in names:
                kernel = np.asarray(lp[group][name]["kernel"], np.float32)
                # [in, *out] -> nn.Linear's [out, in]
                sd[f"{pre}.{group}.{name}.weight"] = t(
                    kernel.reshape(kernel.shape[0], -1).T)
        sd[f"{pre}.attn_norm.scale"] = t(lp["attn_norm"]["scale"])
        sd[f"{pre}.mlp_norm.scale"] = t(lp["mlp_norm"]["scale"])
    return sd


def to_reference(state: Dict[str, torch.Tensor],
                 cfg: LlamaConfig) -> Dict[str, Any]:
    """Port state dict -> reference param tree of f32 numpy arrays."""
    def a(name: str) -> np.ndarray:
        return state[name].detach().float().cpu().numpy()

    h, kv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    out_shape = {"q_proj": (h, d), "k_proj": (kv, d), "v_proj": (kv, d),
                 "o_proj": (cfg.d_model,), "gate_proj": (cfg.d_ff,),
                 "up_proj": (cfg.d_ff,), "down_proj": (cfg.d_model,)}
    params: Dict[str, Any] = {"embed_tokens": a("embed_tokens"),
                              "final_norm": {"scale": a("final_norm.scale")}}
    if not cfg.tie_embeddings:
        params["lm_head"] = a("lm_head")
    for i in range(cfg.n_layers):
        pre = f"layers.{i}"
        layer: Dict[str, Any] = {
            "attn_norm": {"scale": a(f"{pre}.attn_norm.scale")},
            "mlp_norm": {"scale": a(f"{pre}.mlp_norm.scale")}}
        for group, names in _PROJ.items():
            layer[group] = {}
            for name in names:
                w = a(f"{pre}.{group}.{name}.weight").T      # [in, out]
                layer[group][name] = {
                    "kernel": np.ascontiguousarray(
                        w.reshape(w.shape[0], *out_shape[name]))}
        params[f"layer_{i}"] = layer
    return params


def grads_to_reference(model: Llama) -> Dict[str, Any]:
    """The model's ``.grad`` tensors as a reference-shaped tree (f32
    numpy), so gradients compare leaf by leaf with ``jax.grad``'s."""
    return to_reference({name: p.grad for name, p in model.named_parameters()},
                        model.cfg)


def load_reference(model: Llama, params: Any) -> Llama:
    """Copy a reference param tree into ``model`` in place."""
    sd = from_reference(params, model.cfg)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(sd[name].to(p.device))
    return model
