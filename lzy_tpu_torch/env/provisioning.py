"""Pool resolution: the port's copy of ``lzy_tpu/env/provisioning.py``,
trimmed to the CPU-pool ``Provisioning`` and ``NoPoolError``.

The environment carries no compute requirement yet, so every op
resolves as ``Provisioning().resolve_pool`` does with none set: to the
*minimum adequate* pool, here the smallest CPU pool. The requirement
fields (CPU count, RAM, zone), the ``Any`` wildcard, ``TpuProvisioning``
and the accelerator pools come back with the GPU provisioning slice,
the first to set a requirement.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

from lzy_tpu_torch.types import PoolSpec


@dataclasses.dataclass(frozen=True)
class Provisioning:
    """The requirement-free resolver: any pool is adequate."""

    def score(self, pool: PoolSpec) -> float:
        """Lower is better: waste-minimizing."""
        return pool.cpu_count + pool.ram_gb / 8.0

    def resolve_pool(self, pools: Sequence[PoolSpec]) -> PoolSpec:
        if not pools:
            raise NoPoolError(self, pools)
        return min(pools, key=self.score)


class NoPoolError(LookupError):
    def __init__(self, prov: Provisioning, pools: Sequence[PoolSpec]):
        labels = ", ".join(p.label for p in pools) or "<none>"
        super().__init__(
            f"no pool satisfies {prov!r}; available pools: {labels}"
        )
        self.provisioning = prov
        self.pools = tuple(pools)
