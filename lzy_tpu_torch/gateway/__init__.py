"""Serving fleet gateway: one ``generate`` endpoint over N engines.

The port's copy of ``lzy_tpu/gateway`` (the unleased fleet, without the
crash-recovery journal):

- ``router`` — prefix-cache-aware routing (the same page-size chunking
  as the engines' ``RadixCache``), falling back to least-loaded within a
  bounded imbalance; ``RoundRobinRouter`` is the baseline;
- ``fleet`` — replica lifecycle: engines running their loops in threads;
- ``health`` — failure accrual and the circuit breaker;
- ``autoscale`` — sustained queue depth adds a replica, a sustained idle
  fleet drains its coldest one;
- ``kv_index`` — the fleet-global prefix index replicas advertise into,
  by tier, for cross-replica KV imports;
- ``service`` — the front, with fenced-token failover;
- ``disagg`` — the two-pool (prefill, decode) front.
"""

from lzy_tpu_torch.gateway.autoscale import Autoscaler, ScaleDecision
from lzy_tpu_torch.gateway.disagg import DisaggGatewayService
from lzy_tpu_torch.gateway.fleet import (
    DEAD, DRAINING, READY, Replica, ReplicaFleet)
from lzy_tpu_torch.gateway.health import HealthPolicy, HealthTracker
from lzy_tpu_torch.gateway.kv_index import GlobalKVIndex
from lzy_tpu_torch.gateway.router import (
    PrefixAffinityRouter, RoundRobinRouter, chunk_hashes)
from lzy_tpu_torch.gateway.service import GatewayService

__all__ = [
    "Autoscaler",
    "DEAD",
    "DRAINING",
    "DisaggGatewayService",
    "GatewayService",
    "GlobalKVIndex",
    "HealthPolicy",
    "HealthTracker",
    "PrefixAffinityRouter",
    "READY",
    "Replica",
    "ReplicaFleet",
    "RoundRobinRouter",
    "ScaleDecision",
    "chunk_hashes",
]
