"""Seed-deterministic fault injection at named serving points.

The port's copy of ``lzy_tpu/chaos/faults.py`` with its OWN process-wide
registry (:data:`CHAOS`): the points the serving slice fires
(``engine.step``, ``engine.prefill``, ``engine.admit``, ``slo.admit``)
register here when their modules are imported, never in the JAX
package's injector.

A :class:`FaultPlan` derives one RNG per point from ``(seed, point)``
and decides fire/mode on that point's n-th hit, so a failing run replays
from its printed seed regardless of how threads interleaved across
points. Modes: ``error`` (raise the point's registered exception),
``crash`` (raise :class:`InjectedCrash`, a ``BaseException``; only at
points whose failure domain has a death handler), ``delay`` and
``slow`` (short and longer sleeps). Unarmed, ``hit()`` costs one
attribute load.
"""

from __future__ import annotations

import dataclasses
import random
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple, Type

from lzy_tpu_torch.utils.log import get_logger
from lzy_tpu_torch.utils.metrics import REGISTRY

_LOG = get_logger(__name__)

_INJECTED = REGISTRY.counter(
    "lzy_chaos_faults_injected_total",
    "chaos faults injected, by fault point and mode")
_ARMED = REGISTRY.gauge(
    "lzy_chaos_armed", "1 while a chaos fault plan is armed")

CRASH = "crash"
DELAY = "delay"
ERROR = "error"
SLOW = "slow"
MODES = (CRASH, DELAY, ERROR, SLOW)


class InjectedFault(RuntimeError):
    """Default error-mode exception for points without a more specific
    degradation type."""


class InjectedCrash(BaseException):
    """A simulated process death: a ``BaseException`` so request-scoped
    ``except Exception`` handlers cannot swallow it."""


@dataclasses.dataclass(frozen=True)
class FaultPoint:
    """One named boundary faults can be injected at."""

    name: str
    error: Type[BaseException] = InjectedFault
    crash_ok: bool = False
    modes: Tuple[str, ...] = (ERROR, DELAY, SLOW)
    doc: str = ""

    def allowed(self, mode: str) -> bool:
        if mode == CRASH:
            return self.crash_ok
        return mode in self.modes


class FaultPlan:
    """Seeded schedule of (point, hit ordinal) -> mode decisions; at most
    ``max_faults`` fire per point."""

    def __init__(self, seed: int, *, rate: float = 0.05,
                 modes: Sequence[str] = (ERROR, DELAY, CRASH),
                 delay_s: float = 0.002, slow_s: float = 0.05,
                 max_faults: Optional[int] = None,
                 points: Optional[Sequence[str]] = None):
        if not 0.0 <= rate <= 1.0:
            raise ValueError(f"rate must be in [0, 1], got {rate}")
        bad = sorted(set(modes) - set(MODES))
        if bad:
            raise ValueError(f"unknown fault modes {bad}; known: {MODES}")
        self.seed = int(seed)
        self.rate = rate
        self.modes = tuple(modes)
        self.delay_s = delay_s
        self.slow_s = slow_s
        self.max_faults = max_faults
        self.points = None if points is None else frozenset(points)
        self.fired = 0
        self._rngs: Dict[str, random.Random] = {}
        self._hits: Dict[str, int] = {}
        self._fired_at: Dict[str, int] = {}
        self._lock = threading.Lock()

    def decide(self, point: FaultPoint) -> Optional[Tuple[str, int]]:
        with self._lock:
            if self.points is not None and point.name not in self.points:
                return None
            hit_no = self._hits.get(point.name, 0) + 1
            self._hits[point.name] = hit_no
            rng = self._rngs.get(point.name)
            if rng is None:
                rng = self._rngs[point.name] = random.Random(
                    f"{self.seed}:{point.name}")
            # always draw both numbers: the stream stays a pure function
            # of (seed, hit ordinal) even once max_faults silenced a point
            fire = rng.random() < self.rate
            mode = self.modes[rng.randrange(len(self.modes))]
            if not fire or not point.allowed(mode):
                return None
            if self.max_faults is not None and \
                    self._fired_at.get(point.name, 0) >= self.max_faults:
                return None
            self._fired_at[point.name] = self._fired_at.get(point.name, 0) + 1
            self.fired += 1
            return mode, hit_no


class ChaosInjector:
    """Fault-point registry plus the armed plan."""

    def __init__(self):
        self._points: Dict[str, FaultPoint] = {}
        self._plan: Optional[FaultPlan] = None
        self._lock = threading.Lock()

    def register(self, name: str, *,
                 error: Type[BaseException] = InjectedFault,
                 crash_ok: bool = False,
                 modes: Tuple[str, ...] = (ERROR, DELAY, SLOW),
                 doc: str = "") -> FaultPoint:
        """Idempotent; re-registration with other properties raises."""
        point = FaultPoint(name=name, error=error, crash_ok=crash_ok,
                           modes=modes, doc=doc)
        with self._lock:
            existing = self._points.get(name)
            if existing is not None:
                if existing != point:
                    raise ValueError(
                        f"fault point {name!r} re-registered with different "
                        f"properties")
                return existing
            self._points[name] = point
        return point

    def points(self) -> List[str]:
        with self._lock:
            return sorted(self._points)

    def arm(self, plan: FaultPlan) -> FaultPlan:
        with self._lock:
            if self._plan is not None:
                raise RuntimeError("a fault plan is already armed")
            if plan.points is not None:
                unknown = plan.points - set(self._points)
                if unknown:
                    raise KeyError(
                        f"unknown fault points {sorted(unknown)}; "
                        f"registered: {sorted(self._points)}")
            self._plan = plan
        _ARMED.set(1.0)
        return plan

    def disarm(self) -> Optional[FaultPlan]:
        with self._lock:
            plan, self._plan = self._plan, None
        _ARMED.set(0.0)
        return plan

    @property
    def armed(self) -> Optional[FaultPlan]:
        return self._plan

    def hit(self, name: str) -> None:
        """Called at a fault point; no-op unless a plan is armed."""
        plan = self._plan
        if plan is None:
            return
        point = self._points.get(name)
        if point is None:
            raise KeyError(f"hit of unregistered fault point {name!r}")
        decision = plan.decide(point)
        if decision is None:
            return
        mode, hit_no = decision
        _INJECTED.inc(point=name, mode=mode)
        _LOG.warning("chaos: injecting %s at %s (hit %d, seed %d)",
                     mode, name, hit_no, plan.seed)
        if mode == DELAY:
            time.sleep(plan.delay_s)
        elif mode == SLOW:
            time.sleep(plan.slow_s)
        elif mode == ERROR:
            raise point.error(
                f"injected fault at {name} (hit {hit_no}, seed {plan.seed})")
        elif mode == CRASH:
            raise InjectedCrash(
                f"injected crash at {name} (hit {hit_no}, seed {plan.seed})")


#: the port's injector every serving boundary threads through
CHAOS = ChaosInjector()
