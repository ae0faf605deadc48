"""Tiered KV cache: the paged pool on the device, then pinned-budget host RAM.

The port's copy of ``lzy_tpu/serving/kv_tier.py``, holding the host rung
(the storage rung waits for the port's storage plane and serializer).

A replica's radix prefix cache (``serving/kv_cache.py``) is capped by the
device's memory: under pressure LRU eviction drops warm prefixes and the
next arrival re-pays their prefill. With a :class:`HostKVTier` behind the
pool, eviction becomes **demotion**: the engine copies the evicted
block's K/V rows (and, for int8 pools, their scale/zero-point sidecars:
they are just more cache leaves) to host memory and files them here,
keyed by the block's full token chain from the tree root, the identity a
radix prefix match needs back. The tier has its own byte budget and a
logical-clock LRU; an entry that no longer fits is dropped, counted, and
the next miss re-prefills (classic eviction).

**Promotion** is the reverse walk: at admission the engine extends its
radix match chunk by chunk from the tier, allocates fresh pool blocks,
copies the payloads in and re-inserts the chain with its provenance.

Host payloads are CPU ``torch`` tensors, which keep bf16 bits exactly.
Every tier operation is advisory: a failed demotion drops the payload, a
failed promotion re-prefills. The chaos points ``kvtier.demote`` and
``kvtier.import`` inject exactly those failures, and neither may ever
fail a request.
"""

from __future__ import annotations

import hashlib
import threading
from typing import Dict, Iterable, List, Optional, Tuple

import torch

from lzy_tpu_torch.chaos.faults import CHAOS, InjectedFault
from lzy_tpu_torch.utils.metrics import REGISTRY

DEMOTIONS = REGISTRY.counter(
    "lzy_kvtier_demotions_total",
    "KV block payloads demoted down the tier ladder, by (from_tier, "
    "to_tier)")
PROMOTIONS = REGISTRY.counter(
    "lzy_kvtier_promotions_total",
    "KV block payloads promoted back into the device radix tree, by "
    "(from_tier, to_tier)")
DROPPED = REGISTRY.counter(
    "lzy_kvtier_dropped_total",
    "tier payloads dropped (over budget, or a failed demotion): a drop "
    "degrades to classic eviction, never an error")
HOST_BLOCKS = REGISTRY.gauge(
    "lzy_kvtier_host_blocks",
    "block payloads resident in host-RAM tiers (process-wide sum)")
HOST_BYTES = REGISTRY.gauge(
    "lzy_kvtier_host_bytes",
    "bytes resident in host-RAM tiers (process-wide sum)")
GATHER_BATCHES = REGISTRY.counter(
    "lzy_kvtier_gather_batches_total",
    "batched demotion gathers (one device-to-host copy per cache leaf "
    "covers a whole eviction round's victims)")

# chaos boundaries, advisory by contract: a fault at demote costs the
# payload (classic eviction), at import/promote a local re-prefill
FP_DEMOTE = CHAOS.register(
    "kvtier.demote", error=InjectedFault,
    doc="KV block payload leaving the device pool for the host tier")
FP_IMPORT = CHAOS.register(
    "kvtier.import", error=InjectedFault,
    doc="tier/cross-replica KV promotion toward the device pool")


def chain_digest(chain: Iterable[int]) -> str:
    """Stable, collision-resistant name for a token chain (the storage
    tier's object key in the reference; the same bytes are hashed)."""
    h = hashlib.sha256()
    for t in chain:
        h.update(int(t).to_bytes(4, "little", signed=False))
    return h.hexdigest()[:32]


def tensor_nbytes(t) -> int:
    return int(t.numel() * t.element_size())


class TierEntry:
    """One demoted block: its cache-leaf rows (``key -> [page, ...]`` CPU
    tensors) plus the token chain a prefix match needs to re-admit it."""

    __slots__ = ("chain", "leaves", "nbytes", "origin", "clock", "tier")

    def __init__(self, chain: Tuple[int, ...],
                 leaves: Dict[str, torch.Tensor],
                 origin: Optional[str] = None):
        self.chain = chain
        self.leaves = leaves
        self.nbytes = sum(tensor_nbytes(a) for a in leaves.values())
        self.origin = origin
        self.clock = 0
        self.tier = None            # set by take(): which rung served it


class HostKVTier:
    """Budgeted host-RAM tier with logical-clock LRU.

    ``put`` is the demotion entry (hit by the ``kvtier.demote`` chaos
    boundary; callers catch and count a drop); ``take`` pops an entry for
    promotion (residency moves with the payload, so a block lives in
    exactly one tier); ``peek`` reads without moving (the cross-replica
    export path: the source keeps its copy). One lock guards the
    entries: ``put``/``take`` run on the engine's scheduling thread,
    ``peek``/``stats`` and the auditors may run from other threads."""

    def __init__(self, budget_bytes: int, page_size: int):
        if budget_bytes < 0:
            raise ValueError(
                f"budget_bytes must be >= 0, got {budget_bytes}")
        self.budget_bytes = int(budget_bytes)
        self.page_size = page_size
        self._entries: Dict[Tuple[int, ...], TierEntry] = {}
        self._bytes = 0
        self._clock = 0
        #: bumped whenever the entry SET changes: the advertisement
        #: cache's change detector
        self.version = 0
        self._lock = threading.Lock()
        # gauge contributions are deltas (several engines share the
        # process-wide gauges); close() withdraws them
        self._gauge_blocks = 0
        self._gauge_bytes = 0
        self._closed = False
        self.demotions = 0          # device -> host (successful puts)
        self.promotions = 0         # host -> device (landed promotions)
        self.dropped = 0

    # -- demotion ------------------------------------------------------------

    def put(self, chain: Tuple[int, ...], leaves: Dict[str, torch.Tensor],
            origin: Optional[str] = None) -> bool:
        """File one demoted block; False when it could not be kept (over
        budget: the drop IS classic eviction). LRU entries make room."""
        CHAOS.hit("kvtier.demote")
        entry = TierEntry(tuple(chain), leaves, origin=origin)
        dropped = 0
        with self._lock:
            self._clock += 1
            entry.clock = self._clock
            old = self._entries.pop(entry.chain, None)
            if old is not None:
                self._bytes -= old.nbytes
            kept = entry.nbytes <= self.budget_bytes and not self._closed
            if kept:
                self._entries[entry.chain] = entry
                self._bytes += entry.nbytes
                self.demotions += 1
                while self._bytes > self.budget_bytes:
                    victim = min(self._entries.values(),
                                 key=lambda e: e.clock)
                    del self._entries[victim.chain]
                    self._bytes -= victim.nbytes
                    dropped += 1
            else:
                dropped += 1
            self.dropped += dropped
            self._sync_gauges_locked()
        if kept:
            DEMOTIONS.inc(from_tier="hbm", to_tier="host")
        if dropped:
            DROPPED.inc(float(dropped), tier="host")
        return kept

    def note_dropped(self, tier: str = "hbm") -> None:
        """Count a payload that never made it into the tier (the engine's
        demotion failed before or inside ``put``)."""
        with self._lock:
            self.dropped += 1
        DROPPED.inc(tier=tier)

    def restore(self, entry: TierEntry) -> None:
        """Re-file an entry a failed promotion popped (not a new
        demotion); one that no longer fits is a counted drop."""
        with self._lock:
            if entry.chain in self._entries:
                return
            fits = (self._bytes + entry.nbytes <= self.budget_bytes
                    and not self._closed)
            if fits:
                self._clock += 1
                entry.clock = self._clock
                self._entries[entry.chain] = entry
                self._bytes += entry.nbytes
                self._sync_gauges_locked()
            else:
                self.dropped += 1
        if not fits:
            DROPPED.inc(tier="host")

    # -- promotion / lookup --------------------------------------------------

    def take(self, chain: Tuple[int, ...]) -> Optional[TierEntry]:
        """Pop a chain's entry for promotion; None on a miss."""
        with self._lock:
            entry = self._entries.pop(tuple(chain), None)
            if entry is None:
                return None
            self._bytes -= entry.nbytes
            self._sync_gauges_locked()
        entry.tier = "host"
        return entry

    def note_promoted(self, tier: str = "host") -> None:
        """Count ONE landed promotion (after the radix insert, never at
        ``take``: a promotion that fails downstream restores its entry)."""
        with self._lock:
            self.promotions += 1
        PROMOTIONS.inc(from_tier=tier, to_tier="hbm")

    def peek(self, chain: Tuple[int, ...]) -> Optional[TierEntry]:
        with self._lock:
            return self._entries.get(tuple(chain))

    def discard(self, chain: Tuple[int, ...]) -> None:
        """Drop the entry of a chain that just became device-resident
        again (the tree copy is authoritative)."""
        with self._lock:
            entry = self._entries.pop(tuple(chain), None)
            if entry is not None:
                self._bytes -= entry.nbytes
                self._sync_gauges_locked()

    def has(self, chain: Tuple[int, ...]) -> Optional[str]:
        """``"host"`` when this tier could promote the chain now."""
        with self._lock:
            return "host" if tuple(chain) in self._entries else None

    def chains(self) -> List[Tuple[int, ...]]:
        """Resident chains (for the gateway's global prefix index)."""
        with self._lock:
            return list(self._entries)

    # -- observability -------------------------------------------------------

    def _sync_gauges_locked(self) -> None:
        self.version += 1
        blocks = 0 if self._closed else len(self._entries)
        nbytes = 0 if self._closed else self._bytes
        HOST_BLOCKS.add(float(blocks - self._gauge_blocks))
        HOST_BYTES.add(float(nbytes - self._gauge_bytes))
        self._gauge_blocks, self._gauge_bytes = blocks, nbytes

    def stats(self) -> dict:
        with self._lock:
            return {
                "host_blocks": len(self._entries),
                "host_bytes": self._bytes,
                "host_budget_bytes": self.budget_bytes,
                "demotions": self.demotions,
                "promotions": self.promotions,
                "dropped": self.dropped,
            }

    def close(self) -> None:
        """Free the payloads and withdraw this tier's gauge share."""
        with self._lock:
            self._closed = True
            self._entries.clear()
            self._bytes = 0
            self._sync_gauges_locked()
