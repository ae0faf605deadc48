"""Autoscaling decisions: the port's copy of ``lzy_tpu/gateway/autoscale.py``.

Pure policy, no side effects: the fleet feeds observations into
:meth:`Autoscaler.tick` and applies the returned decision (lease a new
replica / drain the coldest). Time is injected so every transition is
deterministic under test.

Scale-up triggers on *sustained* aggregate queue depth — a single burst
that the current replicas will drain in a few decode rounds must not pay
a replica boot; the pressure has to persist for ``up_sustain_s``.
Scale-down triggers on a *sustained* idle fleet (no queue, low occupancy)
and removes one replica per decision, never below ``min_replicas``. Both
directions share a cooldown so the fleet cannot flap: a freshly booted
replica gets time to absorb load before the next verdict, and the lease
churn stays bounded (each lease is a durable allocator op).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

UP = "up"
DOWN = "down"


@dataclasses.dataclass(frozen=True)
class ScaleDecision:
    direction: str               # UP | DOWN
    reason: str


class Autoscaler:
    def __init__(
        self,
        *,
        min_replicas: int = 1,
        max_replicas: int = 8,
        up_queue_per_replica: float = 4.0,   # sustained queue depth / replica
        up_sustain_s: float = 5.0,
        down_busy_fraction: float = 0.25,    # fleet occupancy below this...
        down_sustain_s: float = 30.0,        # ...for this long drains one
        cooldown_s: float = 10.0,
    ):
        if min_replicas < 1 or max_replicas < min_replicas:
            raise ValueError(
                f"need 1 <= min_replicas <= max_replicas, got "
                f"{min_replicas}/{max_replicas}")
        self.min_replicas = min_replicas
        self.max_replicas = max_replicas
        self.up_queue_per_replica = up_queue_per_replica
        self.up_sustain_s = up_sustain_s
        self.down_busy_fraction = down_busy_fraction
        self.down_sustain_s = down_sustain_s
        self.cooldown_s = cooldown_s
        self._pressure_since: Optional[float] = None
        self._idle_since: Optional[float] = None
        self._last_scale_at: Optional[float] = None

    def tick(self, now: float, *, replicas: int, queue_depth: int,
             busy: int, slots: int) -> Optional[ScaleDecision]:
        """One observation of fleet state; returns a decision or None.
        ``replicas`` counts READY replicas, ``queue_depth``/``busy``/
        ``slots`` are fleet aggregates."""
        if replicas < 1:
            return None
        pressured = queue_depth >= self.up_queue_per_replica * replicas
        idle = (queue_depth == 0 and slots > 0
                and busy / slots <= self.down_busy_fraction)
        # windows track CONDITIONS continuously, even during cooldown —
        # pressure that started before the cooldown ends still counts
        self._pressure_since = (
            (self._pressure_since if self._pressure_since is not None
             else now) if pressured else None)
        self._idle_since = (
            (self._idle_since if self._idle_since is not None else now)
            if idle else None)
        if (self._last_scale_at is not None
                and now - self._last_scale_at < self.cooldown_s):
            return None
        if (pressured and replicas < self.max_replicas
                and now - self._pressure_since >= self.up_sustain_s):
            self._last_scale_at = now
            self._pressure_since = None
            return ScaleDecision(UP, (
                f"queue depth {queue_depth} >= "
                f"{self.up_queue_per_replica:g}/replica x {replicas} "
                f"sustained {self.up_sustain_s:g}s"))
        if (idle and replicas > self.min_replicas
                and now - self._idle_since >= self.down_sustain_s):
            self._last_scale_at = now
            self._idle_since = None
            return ScaleDecision(DOWN, (
                f"fleet occupancy {busy}/{slots} below "
                f"{self.down_busy_fraction:g} sustained "
                f"{self.down_sustain_s:g}s"))
        return None
