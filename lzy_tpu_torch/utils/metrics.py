"""Counters, gauges and histograms with Prometheus text exposition.

The port's own copy of ``lzy_tpu/utils/metrics.py``, trimmed to what the
serving slice uses (no HTTP endpoint yet). It keeps a registry of its
own: the port's metrics never land in the JAX package's process-global
``REGISTRY``.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Sequence, Tuple


def _label_key(labels: Dict[str, str]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted(labels.items()))


def _escape(value: str) -> str:
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _fmt_labels(key) -> str:
    if not key:
        return ""
    return "{" + ",".join(f'{k}="{_escape(v)}"' for k, v in key) + "}"


class Counter:
    def __init__(self, name: str, help_: str):
        self.name, self.help = name, help_
        self._values: Dict[tuple, float] = {}
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0, **labels: str) -> None:
        key = _label_key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def collect(self) -> List[str]:
        out = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} counter"]
        with self._lock:
            for key, v in sorted(self._values.items()):
                out.append(f"{self.name}{_fmt_labels(key)} {v}")
        return out


class Gauge:
    def __init__(self, name: str, help_: str):
        self.name, self.help = name, help_
        self._values: Dict[tuple, float] = {}
        self._lock = threading.Lock()

    def set(self, value: float, **labels: str) -> None:
        with self._lock:
            self._values[_label_key(labels)] = value

    def add(self, delta: float, **labels: str) -> None:
        """Shift the gauge by ``delta`` (several owners share one gauge,
        each contributing its own part)."""
        key = _label_key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + delta

    def collect(self) -> List[str]:
        out = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} gauge"]
        with self._lock:
            for key, v in sorted(self._values.items()):
                out.append(f"{self.name}{_fmt_labels(key)} {v}")
        return out


class Histogram:
    DEFAULT_BUCKETS = (0.005, 0.025, 0.1, 0.5, 1.0, 5.0, 30.0, 120.0, 600.0)

    def __init__(self, name: str, help_: str,
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        self.name, self.help = name, help_
        self.buckets = tuple(buckets)
        self._counts: Dict[tuple, List[int]] = {}
        self._sums: Dict[tuple, float] = {}
        self._lock = threading.Lock()

    def observe(self, value: float, **labels: str) -> None:
        key = _label_key(labels)
        with self._lock:
            counts = self._counts.setdefault(key, [0] * (len(self.buckets) + 1))
            for i, bound in enumerate(self.buckets):
                if value <= bound:
                    counts[i] += 1
            counts[-1] += 1  # +Inf
            self._sums[key] = self._sums.get(key, 0.0) + value

    def collect(self) -> List[str]:
        out = [f"# HELP {self.name} {self.help}",
               f"# TYPE {self.name} histogram"]
        with self._lock:
            for key, counts in sorted(self._counts.items()):
                for i, bound in enumerate(self.buckets):
                    lk = _fmt_labels(key + (("le", str(bound)),))
                    out.append(f"{self.name}_bucket{lk} {counts[i]}")
                lk = _fmt_labels(key + (("le", "+Inf"),))
                out.append(f"{self.name}_bucket{lk} {counts[-1]}")
                out.append(f"{self.name}_sum{_fmt_labels(key)} {self._sums[key]}")
                out.append(f"{self.name}_count{_fmt_labels(key)} {counts[-1]}")
        return out


class MetricsRegistry:
    def __init__(self) -> None:
        self._metrics: Dict[str, object] = {}
        self._lock = threading.Lock()

    def counter(self, name: str, help_: str = "") -> Counter:
        return self._get_or_create(name, lambda: Counter(name, help_), Counter)

    def gauge(self, name: str, help_: str = "") -> Gauge:
        return self._get_or_create(name, lambda: Gauge(name, help_), Gauge)

    def histogram(self, name: str, help_: str = "",
                  buckets: Sequence[float] = Histogram.DEFAULT_BUCKETS
                  ) -> Histogram:
        return self._get_or_create(
            name, lambda: Histogram(name, help_, buckets), Histogram)

    def _get_or_create(self, name, factory, expected_type):
        with self._lock:
            metric = self._metrics.get(name)
            if metric is None:
                metric = factory()
                self._metrics[name] = metric
            elif not isinstance(metric, expected_type):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(metric).__name__}")
            return metric

    def exposition(self) -> str:
        with self._lock:
            metrics = list(self._metrics.values())
        lines: List[str] = []
        for m in metrics:
            lines.extend(m.collect())
        return "\n".join(lines) + "\n"


#: the port's process-wide registry (separate from the JAX package's)
REGISTRY = MetricsRegistry()
