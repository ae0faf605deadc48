"""Multi-tenant SLO policy: priorities, quotas and admission rate limits.

The port's copy of ``lzy_tpu/serving/tenancy.py``, trimmed to what the
serving slice uses: the per-tenant metrics the engines export, the
:class:`TenantPolicy`/:class:`TenantTable` the queue and the paged
engine read (WFQ weight, queue cap, KV-block quota), and the
:class:`SloLimiter` token buckets a serving front charges before a
request reaches the engine (the ``slo.admit`` fault point).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Dict, Optional

from lzy_tpu_torch.chaos.faults import CHAOS
from lzy_tpu_torch.serving.scheduler import (
    DEFAULT_PRIORITY, DEFAULT_TENANT, QuotaExceeded, quota_error,
    tier_weight)
from lzy_tpu_torch.utils.clock import SYSTEM_CLOCK
from lzy_tpu_torch.utils.metrics import REGISTRY

TENANT_REQUESTS = REGISTRY.counter(
    "lzy_tenant_requests_total",
    "finished requests by tenant and terminal status")
TENANT_TOKENS = REGISTRY.counter(
    "lzy_tenant_tokens_total", "generated tokens by tenant")
TENANT_TTFT = REGISTRY.histogram(
    "lzy_tenant_ttft_seconds",
    "submit-to-first-token latency by tenant",
    buckets=(0.005, 0.02, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 10.0, 60.0))
TENANT_KV_BLOCKS = REGISTRY.gauge(
    "lzy_tenant_kv_blocks",
    "KV blocks resident or staged for a tenant's in-flight requests")

#: the SLO admission boundary: error mode refuses with the same
#: retryable QuotaExceeded a saturated bucket produces
_FP_SLO = CHAOS.register(
    "slo.admit", error=QuotaExceeded,
    doc="tenant rate-limit admission gate (serving front)")


@dataclasses.dataclass
class TenantPolicy:
    """One tenant's SLO contract; ``None`` limits are unenforced. A
    client-requested priority can only downgrade below the policy tier."""

    tenant: str = DEFAULT_TENANT
    priority: int = DEFAULT_PRIORITY
    weight: Optional[float] = None
    requests_per_s: Optional[float] = None
    prompt_tokens_per_s: Optional[float] = None
    burst_s: float = 2.0
    kv_block_quota: Optional[int] = None
    max_queued: Optional[int] = None

    def effective_priority(self, requested: Optional[int] = None) -> int:
        if requested is None:
            return self.priority
        return max(int(requested), self.priority)

    def effective_weight(self, requested: Optional[int] = None) -> float:
        tier = tier_weight(self.effective_priority(requested))
        if self.weight is None:
            return tier
        return min(self.weight, tier) if requested is not None \
            and requested > self.priority else self.weight


class TenantTable:
    """Thread-safe tenant -> policy map; unknown tenants resolve to a
    renamed copy of the default policy."""

    def __init__(self, default: Optional[TenantPolicy] = None):
        self._default = default if default is not None else TenantPolicy()
        self._policies: Dict[str, TenantPolicy] = {}
        self._lock = threading.Lock()

    def set_policy(self, policy: TenantPolicy) -> None:
        with self._lock:
            self._policies[policy.tenant] = policy

    def resolve(self, tenant: str) -> TenantPolicy:
        with self._lock:
            policy = self._policies.get(tenant)
        if policy is not None:
            return policy
        return dataclasses.replace(self._default, tenant=tenant)


class TokenBucket:
    """Token bucket with an injectable clock callable. ``try_take(n)``
    returns None on success or the seconds until it could succeed; takes
    above the burst capacity pass once the bucket is full and leave a
    debt."""

    def __init__(self, rate_per_s: float, burst: float,
                 clock: Optional[Callable[[], float]] = None):
        clock = clock if clock is not None else SYSTEM_CLOCK.now
        if rate_per_s <= 0:
            raise ValueError(f"rate must be > 0, got {rate_per_s}")
        self.rate = float(rate_per_s)
        self.burst = max(float(burst), 1.0)
        self._clock = clock
        self._level = self.burst
        self._t = clock()
        self._lock = threading.Lock()

    def _refill_locked(self) -> None:
        now = self._clock()
        self._level = min(self.burst,
                          self._level + (now - self._t) * self.rate)
        self._t = now

    def try_take(self, n: float = 1.0) -> Optional[float]:
        with self._lock:
            self._refill_locked()
            need = min(float(n), self.burst)
            if self._level >= need:
                self._level -= float(n)
                return None
            return (need - self._level) / self.rate

    def give_back(self, n: float) -> None:
        """Refund a provisional take a later bucket refused."""
        with self._lock:
            self._refill_locked()
            self._level = min(self.burst, self._level + float(n))


class SloLimiter:
    """Admission-time rate limiting for a serving front: one pair of
    buckets (requests/s, prompt-tokens/s) per tenant, created lazily from
    its policy. ``admit`` returns the policy or raises
    :class:`QuotaExceeded`, refunding any bucket it already debited."""

    def __init__(self, table: TenantTable,
                 clock: Optional[Callable[[], float]] = None):
        self.table = table
        self._clock = clock if clock is not None else SYSTEM_CLOCK.now
        self._buckets: Dict[str, tuple] = {}
        self._lock = threading.Lock()

    def _buckets_for(self, tenant: str, policy: TenantPolicy):
        with self._lock:
            pair = self._buckets.get(tenant)
            if pair is None:
                req_bucket = tok_bucket = None
                if policy.requests_per_s is not None:
                    req_bucket = TokenBucket(
                        policy.requests_per_s,
                        policy.requests_per_s * policy.burst_s,
                        clock=self._clock)
                if policy.prompt_tokens_per_s is not None:
                    tok_bucket = TokenBucket(
                        policy.prompt_tokens_per_s,
                        policy.prompt_tokens_per_s * policy.burst_s,
                        clock=self._clock)
                pair = self._buckets[tenant] = (req_bucket, tok_bucket)
            return pair

    def admit(self, tenant: str, prompt_tokens: int) -> TenantPolicy:
        CHAOS.hit("slo.admit")
        policy = self.table.resolve(tenant)
        req_bucket, tok_bucket = self._buckets_for(tenant, policy)
        if req_bucket is not None:
            wait = req_bucket.try_take(1.0)
            if wait is not None:
                raise quota_error(
                    f"tenant {tenant!r} over its {policy.requests_per_s:g} "
                    f"requests/s limit",
                    tenant=tenant, reason="requests_per_s",
                    retry_after_s=round(wait, 3))
        if tok_bucket is not None:
            wait = tok_bucket.try_take(float(prompt_tokens))
            if wait is not None:
                if req_bucket is not None:
                    req_bucket.give_back(1.0)
                raise quota_error(
                    f"tenant {tenant!r} over its "
                    f"{policy.prompt_tokens_per_s:g} prompt-tokens/s limit "
                    f"({prompt_tokens} requested)",
                    tenant=tenant, reason="prompt_tokens_per_s",
                    retry_after_s=round(wait, 3))
        return policy
