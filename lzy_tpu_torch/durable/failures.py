"""Injected-failure hook points: the port's copy of
``lzy_tpu/durable/failures.py``.

Tests arm a named hook; when execution passes it the durable operation
"crashes": it is left RUNNING in the store, as a killed service would
leave it, and a restart resumes it from its last persisted step. The
registry is the port's own: arming or clearing it leaves the
reference's process-global ``InjectedFailures`` alone.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Optional


class InjectedCrash(BaseException):
    """Simulated hard crash; the operation runner does NOT mark the op
    failed, it simply stops, like a killed process."""


class InjectedFailures:
    _hooks: Dict[str, Callable[[], Optional[BaseException]]] = {}
    _lock = threading.Lock()

    @classmethod
    def arm(cls, point: str, n_hits: int = 1) -> None:
        """Crash the n-th time execution reaches ``point``."""
        counter = {"left": n_hits}

        def hook() -> Optional[BaseException]:
            counter["left"] -= 1
            if counter["left"] <= 0:
                cls.disarm(point)
                return InjectedCrash(f"injected crash at {point}")
            return None

        with cls._lock:
            cls._hooks[point] = hook

    @classmethod
    def disarm(cls, point: str) -> None:
        with cls._lock:
            cls._hooks.pop(point, None)

    @classmethod
    def clear(cls) -> None:
        with cls._lock:
            cls._hooks.clear()

    @classmethod
    def armed(cls) -> list:
        """Currently-armed hook points."""
        with cls._lock:
            return sorted(cls._hooks)

    @classmethod
    def hit(cls, point: str) -> None:
        """Call at a hook point; raises InjectedCrash if armed."""
        with cls._lock:
            hook = cls._hooks.get(point)
        if hook is not None:
            err = hook()
            if err is not None:
                raise err

    @staticmethod
    def is_injected(e: BaseException) -> bool:
        return isinstance(e, InjectedCrash)
