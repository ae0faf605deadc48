"""The port's copy of ``lzy_tpu/llm/backend.py``'s model digest (the
backend ladder itself waits for the llm-op slice)."""

from __future__ import annotations

import hashlib
import json
from typing import Any, Optional


def model_digest_for(model_name: str, cfg: Any = None,
                     checkpoint: Optional[str] = None,
                     seed: Optional[int] = None) -> str:
    """Deterministic digest of what a plane serves: model name, config
    fields and weight provenance (checkpoint path, init seed). The
    weights themselves are not hashed."""
    doc = {"model": model_name, "checkpoint": checkpoint, "seed": seed}
    if cfg is not None:
        fields = getattr(cfg, "__dict__", None) or {}
        doc["cfg"] = {k: repr(v) for k, v in sorted(fields.items())
                      if not k.startswith("_")}
    return hashlib.sha256(
        json.dumps(doc, sort_keys=True).encode("utf-8")).hexdigest()[:16]
