"""Process-environment application for op execution: the port's copy of
``lzy_tpu/utils/env.py``.

``os.environ`` is process-global. The lock covers only the set and
restore phases, never the op body. Refcounts make nested or overlapping
applications restore the true original once the last user exits; ops
that set conflicting values for one key at once see last-set-wins, the
semantics of a process-global environment.
"""

from __future__ import annotations

import os
import threading
from typing import Dict

_ENV_LOCK = threading.Lock()
_ENV_STATE: Dict[str, list] = {}   # key -> [original value, refcount]


class applied_env_vars:
    def __init__(self, env_vars: Dict[str, str]):
        # precompute outside the lock: a bad key or value fails before
        # any mutation, never with the lock held
        self._items = [(str(k), str(v)) for k, v in (env_vars or {}).items()]

    def __enter__(self):
        with _ENV_LOCK:
            applied = []
            try:
                for k, v in self._items:
                    state = _ENV_STATE.setdefault(k, [os.environ.get(k), 0])
                    os.environ[k] = v
                    state[1] += 1
                    applied.append(k)
            except BaseException:
                for k in applied:
                    self._release(k)
                raise
        return self

    def __exit__(self, *exc):
        with _ENV_LOCK:
            for k, _ in self._items:
                self._release(k)

    @staticmethod
    def _release(k: str) -> None:
        state = _ENV_STATE.get(k)
        if state is None:
            return
        state[1] -= 1
        if state[1] <= 0:
            del _ENV_STATE[k]
            if state[0] is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = state[0]
