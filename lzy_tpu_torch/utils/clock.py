"""Injectable time: the port's copy of ``lzy_tpu/utils/clock.py``.

Trimmed to the system clock the serving slice uses. Components read
time only through ``clock.now()`` and block only
through ``clock.sleep``/``clock.wait``, so a virtual clock can be
threaded in later without touching them.
"""

from __future__ import annotations

import threading
import time
from typing import Optional


class SystemClock:
    """Wall-clock time and real blocking — the production default."""

    def now(self) -> float:
        """Monotonic seconds (interval math: deadlines, TTFT)."""
        return time.monotonic()

    def sleep(self, seconds: float) -> None:
        if seconds > 0:
            time.sleep(seconds)

    def wait(self, event: threading.Event,
             timeout: Optional[float] = None) -> bool:
        return event.wait(timeout)

    def event(self) -> threading.Event:
        return threading.Event()


#: process-wide default: components constructed without a clock use this
SYSTEM_CLOCK = SystemClock()
