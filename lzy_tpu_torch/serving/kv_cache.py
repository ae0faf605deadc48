"""Paged KV-cache block pool with radix prefix caching.

The port's copy of ``lzy_tpu/serving/kv_cache.py`` (the host-side block
bookkeeping; the K/V data lives on the device, in the engine's pools):

- :class:`BlockPool` — a fixed pool of ``page_size``-token blocks with
  refcounts. Block 0 is the reserved scratch page: idle decode rows and
  padded positions write there, and nothing reads it.
- :class:`RadixCache` — the pool plus a ref-counted radix tree over
  full-block token chunks. A request reuses every matched block of its
  prompt (prefill skips those tokens); full prompt blocks are inserted
  after prefill; unreferenced leaves are evicted LRU (a logical clock,
  so eviction order is deterministic). Nodes carry the producer of
  imported KV (``origin``); the eviction and insertion hooks are what
  the host KV tier (``serving/kv_tier.py``) demotes and discards
  through.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from lzy_tpu_torch.utils.metrics import REGISTRY

_BLOCKS = REGISTRY.gauge(
    "lzy_kv_blocks", "KV block pool capacity (scratch block included)")
_FREE = REGISTRY.gauge(
    "lzy_kv_blocks_free", "KV blocks on the free list")
_CACHED = REGISTRY.gauge(
    "lzy_kv_blocks_cached",
    "unreferenced blocks held by the prefix tree (reusable, evictable)")
_EVICTIONS = REGISTRY.counter(
    "lzy_kv_evictions_total", "prefix-tree blocks evicted under pressure")
_HIT_TOKENS = REGISTRY.counter(
    "lzy_kv_prefix_hit_tokens_total",
    "prompt tokens served from cached prefix blocks (prefill skipped)")
_LOOKUP_TOKENS = REGISTRY.counter(
    "lzy_kv_prefix_lookup_tokens_total",
    "prompt tokens offered to the prefix tree at admission")


class NoFreeBlocks(RuntimeError):
    """The pool cannot satisfy an allocation even after evicting every
    unreferenced cached block."""


@dataclasses.dataclass
class KVCacheStats:
    blocks_total: int          # pool capacity minus the scratch block
    blocks_free: int
    blocks_cached: int
    evictions: int
    prefix_hit_tokens: int
    prefix_lookup_tokens: int

    @property
    def prefill_tokens_saved(self) -> int:
        return self.prefix_hit_tokens

    @property
    def hit_rate(self) -> float:
        if self.prefix_lookup_tokens == 0:
            return 0.0
        return self.prefix_hit_tokens / self.prefix_lookup_tokens


class BlockPool:
    """Fixed pool of block ids with refcounts (block 0 = scratch)."""

    def __init__(self, n_blocks: int, page_size: int):
        if n_blocks < 2:
            raise ValueError(
                f"pool needs >= 2 blocks (1 scratch + 1 usable), got "
                f"{n_blocks}")
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.n_blocks = n_blocks
        self.page_size = page_size
        self._free: List[int] = list(range(n_blocks - 1, 0, -1))
        self._ref = [0] * n_blocks

    def free_count(self) -> int:
        return len(self._free)

    def alloc(self) -> int:
        if not self._free:
            raise NoFreeBlocks("kv block pool exhausted")
        block = self._free.pop()
        self._ref[block] = 1
        return block

    def incref(self, block: int) -> int:
        self._ref[block] += 1
        return self._ref[block]

    def decref(self, block: int) -> int:
        if self._ref[block] <= 0:
            raise AssertionError(f"decref of unreferenced block {block}")
        self._ref[block] -= 1
        return self._ref[block]

    def refcount(self, block: int) -> int:
        return self._ref[block]

    def release_to_free(self, block: int) -> None:
        if self._ref[block] != 0:
            raise AssertionError(
                f"freeing block {block} with refcount {self._ref[block]}")
        self._free.append(block)


class _Node:
    __slots__ = ("chunk", "block", "children", "parent", "last_access",
                 "origin")

    def __init__(self, chunk: Optional[Tuple[int, ...]], block: Optional[int],
                 parent: Optional["_Node"]):
        self.chunk = chunk
        self.block = block
        self.children: Dict[Tuple[int, ...], "_Node"] = {}
        self.parent = parent
        self.last_access = 0
        # the remote producer (a disagg prefill replica, a sibling) of an
        # imported block's KV; None = computed here
        self.origin: Optional[str] = None


class RadixCache:
    """Block pool + ref-counted radix tree over token-id chunks.

    Per request: :meth:`match` at prefill (matched blocks are incref'd),
    :meth:`allocate` for the suffix and decode growth (evicting LRU
    unreferenced leaves), :meth:`insert` after prefill, :meth:`release`
    on finish/cancel/preempt."""

    def __init__(self, n_blocks: int, page_size: int):
        self.pool = BlockPool(n_blocks, page_size)
        self.page_size = page_size
        self._root = _Node(None, None, None)
        self._node_of: Dict[int, _Node] = {}
        self._clock = 0
        # bumped only when the TREE changes shape (a node created or
        # evicted): the gateway's advertisement cache keys on it
        self.structure_version = 0
        self.evictions = 0
        self.hit_tokens = 0
        self.lookup_tokens = 0
        # tier hooks: ``on_evict_batch([(chain, block, origin), ...])``
        # sees one eviction round's victims BEFORE their blocks return to the free
        # list, so the engine can copy their K/V out; ``on_insert(chain)``
        # fires per newly created node (the engine drops a demoted copy
        # of that chain). Guarded: a hook failure degrades to classic
        # eviction, never a broken tree.
        self.on_evict_batch = None
        self.on_insert = None
        self._update_gauges()

    def _chunks(self, tokens: Sequence[int]) -> List[Tuple[int, ...]]:
        page = self.page_size
        return [tuple(tokens[i:i + page])
                for i in range(0, len(tokens) - len(tokens) % page, page)]

    def _walk(self, tokens: Sequence[int]) -> List[_Node]:
        node = self._root
        out: List[_Node] = []
        for chunk in self._chunks(tokens):
            child = node.children.get(chunk)
            if child is None:
                break
            out.append(child)
            node = child
        return out

    def match(self, tokens: Sequence[int]) -> Tuple[List[int], int]:
        """Longest cached whole-block prefix: ``(block_ids, n_tokens)``,
        one reference taken per returned block."""
        self._clock += 1
        blocks: List[int] = []
        for child in self._walk(tokens):
            child.last_access = self._clock
            blocks.append(child.block)
        for b in blocks:
            self.pool.incref(b)
        self.hit_tokens += len(blocks) * self.page_size
        self.lookup_tokens += len(tokens)
        _HIT_TOKENS.inc(len(blocks) * self.page_size)
        _LOOKUP_TOKENS.inc(len(tokens))
        self._update_gauges()
        return blocks, len(blocks) * self.page_size

    def lookup(self, tokens: Sequence[int]) -> Tuple[List[int], int]:
        """:meth:`match` without the hit accounting or the LRU bump: the
        blocks are pinned (one reference each) for an export or a park,
        which must not distort the stats or the eviction order."""
        blocks = [child.block for child in self._walk(tokens)]
        for b in blocks:
            self.pool.incref(b)
        return blocks, len(blocks) * self.page_size

    def match_len(self, tokens: Sequence[int]) -> int:
        """Read-only probe: cached whole-block prefix length in tokens
        (no refs, no metrics, no LRU bump)."""
        return len(self._walk(tokens)) * self.page_size

    def insert(self, tokens: Sequence[int], blocks: Sequence[int],
               origin: Optional[str] = None) -> int:
        """Register full-chunk ``blocks`` under ``tokens``; returns how
        many nodes were created (existing chunks keep their block and
        their provenance; ``origin`` tags the new ones)."""
        self._clock += 1
        node = self._root
        created = 0
        chain: List[int] = []
        for chunk, block in zip(self._chunks(tokens), blocks):
            chain.extend(chunk)
            child = node.children.get(chunk)
            if child is None:
                child = _Node(chunk, block, node)
                child.origin = origin
                node.children[chunk] = child
                self._node_of[block] = child
                created += 1
                if self.on_insert is not None:
                    try:
                        self.on_insert(tuple(chain))
                    except Exception:  # noqa: BLE001 — advisory hook
                        pass
            child.last_access = self._clock
            node = child
        if created:
            self.structure_version += 1
        self._update_gauges()
        return created

    def chain_origin(self, tokens: Sequence[int]) -> Optional[str]:
        """The first imported node's producer along ``tokens``' cached
        prefix, if any (read-only)."""
        for child in self._walk(tokens):
            if child.origin is not None:
                return child.origin
        return None

    def allocate(self, n: int) -> List[int]:
        """``n`` fresh blocks (refcount 1), evicting LRU unreferenced
        leaves as needed; raises :class:`NoFreeBlocks` before taking any
        block if the pool cannot cover it. The evictions of one call are
        one round: every victim is detached, the demotion hook sees them
        all at once, and only then do their blocks return to the free
        list."""
        if n > self.available():
            raise NoFreeBlocks(
                f"need {n} blocks, only {self.available()} available "
                f"(free + evictable)")
        victims: List[_Node] = []
        while self.pool.free_count() + len(victims) < n:
            victims.append(self._detach_victim())
        if victims:
            self._offer_demotions(victims)
            for victim in victims:
                self.pool.release_to_free(victim.block)
                self.evictions += 1
                _EVICTIONS.inc()
        out = [self.pool.alloc() for _ in range(n)]
        self._update_gauges()
        return out

    def _offer_demotions(self, victims: List[_Node]) -> None:
        """One eviction round's victims to the demotion hook (guarded)."""
        if self.on_evict_batch is None:
            return
        try:
            self.on_evict_batch([(self.chain_tokens(v), v.block, v.origin)
                                 for v in victims])
        except Exception:  # noqa: BLE001 — demotion is advisory
            pass

    def _detach_victim(self) -> _Node:
        """Unlink the LRU unreferenced leaf from the tree without freeing
        its block (its parents stay intact, so its chain stays readable)."""
        victim = min(self._evictable_leaves(),
                     key=lambda node: node.last_access)
        del victim.parent.children[victim.chunk]
        del self._node_of[victim.block]
        self.structure_version += 1
        return victim

    def chain_tokens(self, node: _Node) -> List[int]:
        """The root-to-``node`` token chain: the tier identity of the
        node's block."""
        chunks: List[Tuple[int, ...]] = []
        while node is not None and node is not self._root:
            chunks.append(node.chunk)
            node = node.parent
        return [t for chunk in reversed(chunks) for t in chunk]

    def release(self, blocks: Sequence[int]) -> None:
        """Drop one reference per block; unreferenced blocks outside the
        tree return to the free list, those inside stay cached."""
        for b in blocks:
            if self.pool.decref(b) == 0 and b not in self._node_of:
                self.pool.release_to_free(b)
        self._update_gauges()

    def _evictable_leaves(self) -> List[_Node]:
        out: List[_Node] = []

        def walk(node: _Node) -> None:
            for child in node.children.values():
                if child.children:
                    walk(child)
                elif self.pool.refcount(child.block) == 0:
                    out.append(child)

        walk(self._root)
        return out

    def available(self) -> int:
        """Free blocks plus every block of a fully unreferenced subtree."""

        def count(node: _Node) -> Tuple[int, bool]:
            n_evictable, all_free = 0, True
            for child in node.children.values():
                c_n, c_free = count(child)
                n_evictable += c_n
                all_free = all_free and c_free
            if node is self._root:
                return n_evictable, all_free
            if all_free and self.pool.refcount(node.block) == 0:
                return n_evictable + 1, True
            return n_evictable, False

        return self.pool.free_count() + count(self._root)[0]

    def cached_count(self) -> int:
        # list(): a gateway thread may read stats while the engine's
        # thread changes the tree
        return sum(1 for b in list(self._node_of)
                   if self.pool.refcount(b) == 0)

    def _update_gauges(self) -> None:
        _BLOCKS.set(float(self.pool.n_blocks))
        _FREE.set(float(self.pool.free_count()))
        _CACHED.set(float(self.cached_count()))

    def stats(self) -> KVCacheStats:
        return KVCacheStats(
            blocks_total=self.pool.n_blocks - 1,
            blocks_free=self.pool.free_count(),
            blocks_cached=self.cached_count(),
            evictions=self.evictions,
            prefix_hit_tokens=self.hit_tokens,
            prefix_lookup_tokens=self.lookup_tokens,
        )


def blocks_for(n_tokens: int, page_size: int) -> int:
    """Blocks needed to hold ``n_tokens`` cache positions."""
    return -(-n_tokens // page_size)


def kv_block_bytes(*, page_size: int, n_kv_heads: int, head_dim: int,
                   n_layers: int = 1, elem_bytes: int = 2,
                   kv_quant: Optional[str] = None) -> int:
    """Device payload bytes one pool block commits across the model: K
    and V for every layer (int8 stores one byte per element). The int8
    sidecars are metadata outside this budget."""
    elem = 1 if kv_quant == "int8" else elem_bytes
    return 2 * n_layers * page_size * n_kv_heads * head_dim * elem


def blocks_for_bytes(pool_bytes: int, *, page_size: int, n_kv_heads: int,
                     head_dim: int, n_layers: int = 1, elem_bytes: int = 2,
                     kv_quant: Optional[str] = None) -> int:
    """Pool size (block count, scratch included) a payload byte budget
    buys."""
    per = kv_block_bytes(page_size=page_size, n_kv_heads=n_kv_heads,
                         head_dim=head_dim, n_layers=n_layers,
                         elem_bytes=elem_bytes, kv_quant=kv_quant)
    return max(2, pool_bytes // per)
