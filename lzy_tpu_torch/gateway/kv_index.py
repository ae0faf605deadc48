"""Fleet-global KV prefix index: who holds which prefix, at which tier.

The port's copy of ``lzy_tpu/gateway/kv_index.py``.

The ``PrefixAffinityRouter`` keeps a per-replica *expectation* of cache
contents to route new requests toward their warm prefixes. This index is
the next step: replicas **advertise** the chunk-hash chains they can
serve an import from — HBM radix-tree chains and host-RAM tier chains —
and when a routed replica would miss a prefix a sibling holds, the
gateway stages a cross-replica block import (the evict-then-import path
over ``InMemoryKVTransport``) instead of
letting the replica re-prefill work the fleet already paid for.

Hashing mirrors :func:`~lzy_tpu_torch.gateway.router.chunk_hashes` exactly
(the SAME page-size chunking as the engines' ``RadixCache``), so an
index match predicts an engine-side block hit. Like the router's index,
this one is an expectation, never authority: the exporter re-reads its
own tree/tier at export time and the importer's engine re-matches at
admission — a stale advertisement costs one pointless import attempt
that degrades to a local re-prefill, never a wrong token.

Refresh is pull-based: the gateway ``tick()`` polls each replica's
``kv_chains()`` advertisement (bounded), and ``forget`` drops a retired
replica with its cache.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from lzy_tpu_torch.gateway.router import chunk_hashes
from lzy_tpu_torch.utils.metrics import REGISTRY

IMPORTS = REGISTRY.counter(
    "lzy_kvtier_imports_total",
    "cross-replica KV prefix imports staged by the gateway, by the "
    "tier the source served them from")
IMPORT_BYTES = REGISTRY.counter(
    "lzy_kvtier_import_bytes_total",
    "KV bytes moved by cross-replica imports")
IMPORT_SECONDS = REGISTRY.histogram(
    "lzy_kvtier_import_seconds",
    "one cross-replica import staging round trip (source export + "
    "transport + import queue)",
    buckets=(0.001, 0.005, 0.02, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 10.0))
IMPORT_FALLBACKS = REGISTRY.counter(
    "lzy_kvtier_reprefill_fallbacks_total",
    "cross-replica import attempts that failed (source gone, transport "
    "death, injected fault) and degraded to a local re-prefill")
INDEX_CHAINS = REGISTRY.gauge(
    "lzy_kvtier_index_chains",
    "chunk-hash chains currently advertised in the global prefix index")

#: tier preference when several replicas hold the same depth — a direct
#: HBM gather beats a host-RAM read
_TIER_RANK = {"hbm": 0, "host": 1, "storage": 2}


@dataclasses.dataclass(frozen=True)
class Holder:
    """One lookup answer: who can export the prefix, how deep, and the
    tier its deepest advertised chunk lives at."""

    replica_id: str
    depth_tokens: int
    tier: str


class GlobalKVIndex:
    """Bounded fleet-wide map of ``chain_hash -> (depth, tier)`` per
    replica. Advertised chains are whole root-anchored token chains;
    every chunk depth of a chain is registered so a prompt's prefix walk
    matches contiguously regardless of which tier each chunk sits at."""

    def __init__(self, page_size: int, *,
                 max_chains_per_replica: int = 16384):
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.page_size = page_size
        self._cap = max_chains_per_replica
        # replica -> {chain_hash: (depth_blocks, tier)}
        self._index: Dict[str, Dict[int, Tuple[int, str]]] = {}
        self._lock = threading.Lock()

    # -- advertisement -------------------------------------------------------

    def update_replica(self, replica_id: str,
                       chains_by_tier: Dict[str, Iterable[Sequence[int]]],
                       ) -> None:
        """Replace ``replica_id``'s advertisement. ``chains_by_tier``
        maps a tier name (``hbm``/``host``/``storage``) to root-anchored
        token chains; each chain registers a hash at every chunk depth
        it covers, tier'd by the chain's own rung (the deepest entry
        wins ties toward the faster tier)."""
        fresh: Dict[int, Tuple[int, str]] = {}
        for tier, chains in chains_by_tier.items():
            for chain in chains:
                hashes = chunk_hashes(chain, self.page_size)
                for depth0, h in enumerate(hashes):
                    have = fresh.get(h)
                    if have is None or _TIER_RANK.get(tier, 9) < \
                            _TIER_RANK.get(have[1], 9):
                        fresh[h] = (depth0 + 1, tier)
                    if len(fresh) >= self._cap:
                        break
                if len(fresh) >= self._cap:
                    break
        with self._lock:
            if fresh:
                self._index[replica_id] = fresh
            else:
                self._index.pop(replica_id, None)
            INDEX_CHAINS.set(float(sum(len(i)
                                       for i in self._index.values())))

    def forget(self, replica_id: str) -> None:
        """A retired replica's cache is gone with it."""
        with self._lock:
            self._index.pop(replica_id, None)
            INDEX_CHAINS.set(float(sum(len(i)
                                       for i in self._index.values())))

    # -- lookup --------------------------------------------------------------

    def best_holder(self, tokens: Sequence[int], *,
                    exclude: Iterable[str] = (),
                    min_depth_tokens: int = 0) -> Optional[Holder]:
        """The replica advertising the deepest contiguous whole-block
        prefix of ``tokens`` (strictly deeper than
        ``min_depth_tokens``), preferring faster tiers on depth ties.
        Deterministic: ties past tier break on replica id."""
        hashes = chunk_hashes(tokens, self.page_size)
        if not hashes:
            return None
        skip = set(exclude)
        best: Optional[Holder] = None
        with self._lock:
            for rid in sorted(self._index):
                if rid in skip:
                    continue
                idx = self._index[rid]
                depth = 0
                tier = None
                for h in hashes:
                    entry = idx.get(h)
                    if entry is None:
                        break
                    depth += 1
                    tier = entry[1]
                if depth == 0:
                    continue
                depth_tokens = depth * self.page_size
                if depth_tokens <= min_depth_tokens:
                    continue
                cand = Holder(rid, depth_tokens, tier or "hbm")
                if best is None or (
                        cand.depth_tokens,
                        -_TIER_RANK.get(cand.tier, 9)) > (
                        best.depth_tokens,
                        -_TIER_RANK.get(best.tier, 9)):
                    best = cand
        return best

    def stats(self) -> dict:
        with self._lock:
            return {
                "replicas_advertising": len(self._index),
                "indexed_chains": {r: len(i)
                                   for r, i in self._index.items()},
            }


def chains_of(engine, limit: int = 4096) -> Dict[str, List[List[int]]]:
    """Pull one replica's advertisement (``engine.kv_chains``), shaped
    for :meth:`GlobalKVIndex.update_replica`; empty for engines without
    a paged cache."""
    fn = getattr(engine, "kv_chains", None)
    if fn is None:
        return {}
    try:
        return fn(limit)
    except Exception:  # noqa: BLE001 — advertisement is advisory
        return {}
