"""One retry/backoff law: the port's copy of ``lzy_tpu/utils/backoff.py``,
trimmed to what the llm dispatch retry calls.

Exponential backoff with **full jitter**: before retry ``n`` sleep a
uniform draw from ``[0, min(cap, base * 2^(n-1)))``, so correlated
failures do not retry in synchronized waves.
"""

from __future__ import annotations

import dataclasses
import random
import time
from typing import Callable, Optional

from lzy_tpu_torch.utils.log import get_logger

_LOG = get_logger(__name__)


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """``attempts`` counts TOTAL tries (1 = no retry); ``base_s`` is the
    first window's width, doubling per attempt up to ``cap_s``."""

    attempts: int = 3
    base_s: float = 0.25
    cap_s: float = 10.0

    def __post_init__(self):
        if self.attempts < 1:
            raise ValueError(f"attempts must be >= 1, got {self.attempts}")
        if self.base_s < 0 or self.cap_s < 0:
            raise ValueError("base_s and cap_s must be >= 0")

    def delay_s(self, attempt: int) -> float:
        """Sleep before retry number ``attempt`` (1-based: the delay
        between try N and try N+1)."""
        return random.uniform(
            0.0, min(self.cap_s, self.base_s * (2 ** (attempt - 1))))

    def call(self, fn: Callable, *, what: str = "call",
             retry_if: Optional[Callable[[BaseException], bool]] = None,
             on_retry: Optional[Callable[[int, BaseException], None]] = None):
        """Run ``fn`` under the policy. ``retry_if(exc)`` gates which
        failures are retried (default: any ``Exception``; a
        ``BaseException`` always surfaces at once). The last failure is
        re-raised unwrapped."""
        for attempt in range(1, self.attempts + 1):
            try:
                return fn()
            except Exception as e:  # noqa: BLE001 — retried, then surfaced
                if attempt >= self.attempts or \
                        (retry_if is not None and not retry_if(e)):
                    raise
                delay = self.delay_s(attempt)
                if on_retry is not None:
                    on_retry(attempt, e)
                _LOG.warning("%s failed (attempt %d/%d): %r; retrying in "
                             "%.2fs", what, attempt, self.attempts, e, delay)
                time.sleep(delay)
        raise AssertionError("unreachable")
