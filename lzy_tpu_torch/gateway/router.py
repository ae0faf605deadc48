"""Prefix-cache-aware request routing.

The port's copy of ``lzy_tpu/gateway/router.py``.

The engine-side radix cache (``serving/kv_cache.py``) makes a prompt's
cached prefix worth real prefill FLOPs — but only on the replica that
holds it. A load balancer that ignores cache locality spreads a shared
system prompt over every replica, each one paying the full prefill and
none accumulating a deep cached prefix. The router here keeps a
gateway-side *expectation* of every replica's cache contents and sends
each request where its prefix most likely already lives.

Mechanics: prompts are split into ``page_size``-token chunks — the SAME
chunking the engine's ``RadixCache`` uses, so a gateway-side chunk match
predicts an engine-side block hit — and each chunk chain is folded into a
rolling hash. Per replica the router keeps a bounded, LRU-evicted set of
chain hashes it has routed there; matching a new prompt against that set
costs O(chunks), not a tree walk over token ids (the gateway never needs
the tokens back, so hashes suffice and bound memory regardless of prompt
length).

The index is an expectation, not ground truth — the engine may have
evicted a block the router still remembers. That is safe by construction:
a wrong route costs one redundant prefill, never a wrong token (the
engine re-matches against its own radix tree and prefills whatever is
actually missing).

Affinity is bounded: when the best-matching replica is already
``max_imbalance`` requests deeper (queue + busy slots) than the least
loaded one, the router routes by load instead — cache affinity must not
let one replica melt while the rest idle.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple

from lzy_tpu_torch.utils.metrics import REGISTRY

_ROUTED = REGISTRY.counter(
    "lzy_gateway_routed_total",
    "gateway routing decisions by reason (prefix/load/round_robin)")
_PREFIX_RATE = REGISTRY.gauge(
    "lzy_gateway_prefix_route_rate",
    "cumulative share of requests routed by prefix affinity")
_IMBALANCE = REGISTRY.gauge(
    "lzy_gateway_load_imbalance",
    "max - min replica load (queue depth + busy slots) at the last route")

_SESSION_RATE = None


def _session_rate_gauge():
    """Lazy-cached ``lzy_llm_conversation_affinity_rate`` gauge: the
    metric lives in the llm leaf module (the gateway must not import the
    llm package at module scope — the llm backend layer imports gateway
    surfaces), resolved at most once, never under the router lock."""
    global _SESSION_RATE
    if _SESSION_RATE is None:
        from lzy_tpu_torch.llm.metrics import CONVERSATION_AFFINITY_RATE

        _SESSION_RATE = CONVERSATION_AFFINITY_RATE
    return _SESSION_RATE


def chunk_hashes(tokens: Sequence[int], page_size: int) -> List[int]:
    """Rolling hashes of the prompt's full ``page_size``-token chunks:
    ``h[i]`` identifies the whole chain ``chunks[0..i]``, mirroring a
    radix-tree path (a chain hash can only match if every ancestor chunk
    matched too)."""
    out: List[int] = []
    h = 0
    for i in range(0, len(tokens) - len(tokens) % page_size, page_size):
        h = hash((h, tuple(tokens[i:i + page_size])))
        out.append(h)
    return out


class PrefixAffinityRouter:
    """Route to the replica with the longest expected cached prefix.

    ``max_imbalance``: how many requests deeper (queue + busy) the
    affinity winner may be than the least-loaded replica before load wins.
    ``index_chains_per_replica`` bounds the per-replica hash index; least
    recently matched chains evict first (an approximation of the engine's
    own LRU, so expectations age out roughly when blocks do).
    """

    def __init__(self, page_size: int, *, max_imbalance: int = 4,
                 index_chains_per_replica: int = 4096,
                 max_sessions: int = 4096):
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.page_size = page_size
        self.max_imbalance = max_imbalance
        self._cap = index_chains_per_replica
        # replica -> {chain_hash: last_touch_clock}
        self._index: Dict[str, Dict[int, int]] = {}
        # conversation pinning: session id -> (replica, last_touch clock).
        # A session is the STABLE routing hint a multi-step conversation
        # carries (llm.Conversation): step N+1's prompt extends step N's
        # prompt + response, so the replica that served steps 1..N holds
        # the deepest RadixCache prefix — pin unless the imbalance bound
        # says otherwise. Bounded LRU like the chain index.
        self._sessions: Dict[str, Tuple[str, int]] = {}
        self._session_cap = max_sessions
        self._session_routed = 0
        self._session_hits = 0
        self._clock = 0
        self._routed = 0
        self._routed_prefix = 0
        self._fused_routed = 0
        self._lock = threading.Lock()

    # -- index ---------------------------------------------------------------

    def observe(self, replica_id: str, tokens: Sequence[int],
                session: Optional[str] = None) -> None:
        """Record that ``tokens`` were routed to ``replica_id`` — its
        engine will now hold (or refresh) those prefix blocks.
        ``session`` additionally pins that conversation to the replica."""
        # hash OUTSIDE the lock: chunk_hashes is a pure function of the
        # prompt, and observe runs on every routed request — O(prompt)
        # hashing under the fleet-global router lock would serialize
        # every concurrent route behind it
        hashes = chunk_hashes(tokens, self.page_size)
        with self._lock:
            self._clock += 1
            if session is not None:
                self._sessions[session] = (replica_id, self._clock)
                if len(self._sessions) > self._session_cap:
                    victim = min(self._sessions,
                                 key=lambda s: self._sessions[s][1])
                    del self._sessions[victim]
            idx = self._index.setdefault(replica_id, {})
            for depth, h in enumerate(hashes):
                idx[h] = (self._clock, depth)
            if len(idx) > self._cap + self._cap // 4:
                # evict oldest chains, DEEPEST first within one prompt:
                # matching walks ancestor-to-descendant, so evicting an
                # ancestor before its descendants would strand
                # permanently-unmatchable orphans in the index (the
                # engine's own radix tree evicts leaves first for the
                # same reason). Eviction runs in BATCHES (25% hysteresis
                # above the cap, then trim to cap): sorting the whole
                # index on every observe once it reaches its cap was an
                # O(cap log cap) tax under the router lock on EVERY
                # routed request — a per-request latency cliff the load
                # harness caught at one simulated hour of traffic.
                # Amortized, the batch sort costs O(log cap) per insert;
                # memory stays bounded at 1.25x the configured cap.
                victims = sorted(idx.items(),
                                 key=lambda kv: (kv[1][0], -kv[1][1]))
                for h, _ in victims[:len(idx) - self._cap]:
                    del idx[h]

    def forget(self, replica_id: str) -> None:
        """Drop a removed/dead replica's index (its cache is gone) and
        unpin every conversation that lived on it (the next step re-pins
        wherever it lands)."""
        with self._lock:
            self._index.pop(replica_id, None)
            for session in [s for s, (rid, _) in self._sessions.items()
                            if rid == replica_id]:
                del self._sessions[session]

    def session_replica(self, session: str) -> Optional[str]:
        """The replica a conversation is currently pinned to (probe —
        no LRU bump)."""
        with self._lock:
            pin = self._sessions.get(session)
            return pin[0] if pin is not None else None

    def match_len(self, replica_id: str, tokens: Sequence[int]) -> int:
        """Expected cached prefix on ``replica_id``, in tokens.
        Read-only: probing must not keep an expectation hot — only an
        actual route does (``observe`` refreshes the chosen replica's
        chains), so entries on losing replicas age out as designed."""
        hashes = chunk_hashes(tokens, self.page_size)   # outside the lock
        with self._lock:
            return self._match_locked(replica_id, hashes)

    def _match_locked(self, replica_id: str,
                      hashes: Sequence[int]) -> int:
        idx = self._index.get(replica_id)
        if not idx:
            return 0
        n = 0
        for h in hashes:
            if h not in idx:
                break
            n += 1
        return n * self.page_size

    # -- choice --------------------------------------------------------------

    def choose(self, tokens: Sequence[int], loads: Dict[str, int],
               session: Optional[str] = None,
               pinned: Optional[str] = None) -> Tuple[Optional[str], str]:
        """Pick a replica from ``loads`` (replica_id -> queue+busy).
        Returns ``(replica_id, reason)`` with reason ``"fused"``,
        ``"session"``, ``"prefix"`` or ``"load"``; ``(None, "empty")``
        when no candidates exist. ``session`` (a conversation id)
        prefers the pinned replica — subject to the SAME imbalance bound
        as prefix affinity, so a hot conversation cannot melt one
        replica. ``pinned`` is a HARD pin (reason ``"fused"``): the
        workflow scheduler holds that replica's conversation KV parked
        resident across a tool gap, so the imbalance bound does not
        apply — the parked blocks are worth more than a balanced queue,
        and the pin is already bounded by the park TTL. Ignored when the
        replica left the candidate set. The caller must :meth:`observe`
        the prompt on the chosen replica once the request is actually
        submitted."""
        if not loads:
            return None, "empty"
        if pinned is not None and pinned in loads:
            with self._lock:
                self._routed += 1
                self._fused_routed += 1
                _ROUTED.inc(reason="fused")
                _IMBALANCE.set(float(max(loads.values())
                                     - min(loads.values())))
                session_rate = self._affinity_rate_locked()
            # a fused route is a pinned conversation route that kept its
            # pin: the gauge counts it (the reference's counts only
            # "session" routes, so with fusion on it is never set)
            _session_rate_gauge().set(session_rate)
            return pinned, "fused"
        session_rate = None
        # hash the prompt ONCE, before taking the lock: under routing
        # contention every concurrent choose() used to serialize its
        # O(chunks) hashing behind the fleet-global lock. A session-
        # pinned route now pays a hash it may not use — off the lock,
        # in parallel — which is the right trade for a shared hot path.
        hashes = chunk_hashes(tokens, self.page_size)
        with self._lock:
            min_load = min(loads.values())
            choice = reason = None
            if session is not None:
                pin = self._sessions.get(session)
                # the rate counts only routes where a pin EXISTED: a
                # conversation's first step cannot hit, and counting it
                # as a miss would structurally deflate the gauge (a
                # fleet of perfectly-pinned 2-step conversations would
                # read 0.5)
                if pin is not None:
                    self._session_routed += 1
                    if pin[0] in loads and \
                            loads[pin[0]] <= min_load + self.max_imbalance:
                        choice, reason = pin[0], "session"
                        self._session_hits += 1
                    session_rate = self._affinity_rate_locked()
            if choice is None:
                best_id, best_match = None, 0
                for rid in loads:
                    m = self._match_locked(rid, hashes)
                    if m > best_match:
                        best_id, best_match = rid, m
                if (best_id is not None
                        and loads[best_id] <= min_load
                        + self.max_imbalance):
                    choice, reason = best_id, "prefix"
                else:
                    # least loaded; ties break on replica id for
                    # determinism
                    choice = min(sorted(loads), key=lambda r: loads[r])
                    reason = "load"
            self._routed += 1
            if reason in ("prefix", "session"):
                self._routed_prefix += 1
            _ROUTED.inc(reason=reason)
            _PREFIX_RATE.set(self._routed_prefix / self._routed)
            _IMBALANCE.set(float(max(loads.values()) - min_load))
        if session_rate is not None:
            # outside the lock: the first set() imports the llm metrics
            # leaf through its package __init__, which must not stall
            # every concurrent route behind the router lock
            _session_rate_gauge().set(session_rate)
        return choice, reason

    def _affinity_rate_locked(self) -> float:
        """Share of pinned conversation routes that kept their pin:
        session hits and fused routes over session routes and fused
        routes."""
        return ((self._session_hits + self._fused_routed)
                / (self._session_routed + self._fused_routed))

    def stats(self) -> dict:
        with self._lock:
            return {
                "routed_total": self._routed,
                "routed_by_prefix": self._routed_prefix,
                "prefix_route_rate": (
                    round(self._routed_prefix / self._routed, 4)
                    if self._routed else 0.0),
                "indexed_chains": {r: len(i)
                                   for r, i in self._index.items()},
                "sessions_pinned": len(self._sessions),
                "fused_routed": self._fused_routed,
                "session_routed": self._session_routed,
                "session_affinity_rate": (
                    round(self._session_hits / self._session_routed, 4)
                    if self._session_routed else 0.0),
            }


class RoundRobinRouter:
    """Cache-oblivious baseline (and the ``--gateway-routing rr`` mode):
    cycles through the candidates in replica-id order. Exists so the
    prefix-affinity win is measurable — same fleet, same workload, only
    the routing policy differs."""

    def __init__(self, page_size: int = 1, **_ignored):
        self.page_size = page_size
        self._next = 0
        self._routed = 0
        self._fused_routed = 0
        self._lock = threading.Lock()

    def observe(self, replica_id: str, tokens: Sequence[int],
                session: Optional[str] = None) -> None:
        pass

    def forget(self, replica_id: str) -> None:
        pass

    def match_len(self, replica_id: str, tokens: Sequence[int]) -> int:
        return 0

    def session_replica(self, session: str) -> Optional[str]:
        return None

    def choose(self, tokens: Sequence[int], loads: Dict[str, int],
               session: Optional[str] = None,
               pinned: Optional[str] = None) -> Tuple[Optional[str], str]:
        if not loads:
            return None, "empty"
        if pinned is not None and pinned in loads:
            with self._lock:
                self._routed += 1
                self._fused_routed += 1
                _ROUTED.inc(reason="fused")
            return pinned, "fused"
        with self._lock:
            order = sorted(loads)
            choice = order[self._next % len(order)]
            self._next += 1
            self._routed += 1
            _ROUTED.inc(reason="round_robin")
        return choice, "round_robin"

    def stats(self) -> dict:
        with self._lock:
            return {"routed_total": self._routed, "routed_by_prefix": 0,
                    "prefix_route_rate": 0.0, "indexed_chains": {},
                    "sessions_pinned": 0,
                    "fused_routed": self._fused_routed,
                    "session_routed": 0,
                    "session_affinity_rate": 0.0}
