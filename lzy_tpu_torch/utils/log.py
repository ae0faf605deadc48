"""Logging for the port: one stderr handler on the ``lzy_tpu_torch``
logger tree, configured once (the port's copy of ``lzy_tpu/utils/log.py``
without the propagated-context machinery the slice does not use)."""

from __future__ import annotations

import logging
import os
import sys
import threading

_CONFIGURED = False
_CONFIG_LOCK = threading.Lock()


def get_logger(name: str) -> logging.Logger:
    global _CONFIGURED
    if not _CONFIGURED:
        with _CONFIG_LOCK:
            if not _CONFIGURED:
                level = os.environ.get("LZY_TPU_LOG_LEVEL", "WARNING").upper()
                handler = logging.StreamHandler(sys.stderr)
                handler.setFormatter(logging.Formatter(
                    "%(asctime)s %(levelname)s %(name)s %(message)s"))
                root = logging.getLogger("lzy_tpu_torch")
                root.addHandler(handler)
                root.setLevel(level)
                _CONFIGURED = True
    return logging.getLogger(name)
