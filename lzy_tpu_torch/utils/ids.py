"""ID generation: the port's copy of ``lzy_tpu/utils/ids.py``."""

from __future__ import annotations

import secrets
import time


def gen_id(prefix: str) -> str:
    """Sortable-ish unique id: ``<prefix>-<millis-hex>-<rand>``."""
    return f"{prefix}-{int(time.time() * 1000):x}-{secrets.token_hex(6)}"
