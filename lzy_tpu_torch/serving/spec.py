"""Draft-free speculative decoding: n-gram prompt-lookup proposals.

The port's copy of ``lzy_tpu/serving/spec.py``. The draft is the
request's own history: if the last *n* tokens occurred earlier, whatever
followed that occurrence is proposed (up to ``gamma`` tokens). The
engines verify every row's proposal in ONE ``[B, gamma+1]`` forward
(the same chunked decode path prefill uses; the paged-attention kernel
at ``T = gamma+1``) and accept the longest prefix matching the model's
own argmax, so greedy output is bit-identical to plain decoding.
"""

from __future__ import annotations

from typing import List, Sequence

from lzy_tpu_torch.utils.metrics import REGISTRY

PROPOSED = REGISTRY.counter(
    "lzy_spec_proposed_tokens_total",
    "speculative tokens proposed by prompt lookup")
ACCEPTED = REGISTRY.counter(
    "lzy_spec_accepted_tokens_total",
    "proposed tokens accepted (matched the model's own argmax)")
VERIFY_STEPS = REGISTRY.counter(
    "lzy_spec_verify_steps_total",
    "multi-position verify forwards (vs one-token decode steps)")
ACCEPT_RATE = REGISTRY.gauge(
    "lzy_spec_acceptance_rate",
    "cumulative accepted / proposed speculative tokens")
DRAFT_TRUNCATED = REGISTRY.counter(
    "lzy_spec_draft_truncated_total",
    "speculative drafts cut short because the KV pool's free list could "
    "not back every proposed position")
TOKENS_PER_STEP = REGISTRY.gauge(
    "lzy_spec_tokens_per_step",
    "mean generated tokens per decode step (1.0 = no speculation win)")


class NgramProposer:
    """Prompt-lookup draft: propose the continuation of the most recent
    earlier occurrence of the current suffix n-gram.

    For ``n`` from ``max_ngram`` down to ``min_ngram``, the last ``n``
    tokens of the sequence are searched for their most recent earlier
    occurrence whose continuation window is FULL (else the longest
    window seen); on a hit, up to ``gamma`` tokens following it are
    proposed. No hit at any ``n`` proposes nothing (the row decodes one
    token as usual). Recency keeps the draft in the current local
    context; the full-window preference matters on a repeating tail (the
    canonical hit: a constant or short-cycle run), where the nearest
    occurrences overlap the suffix and offer only 1-2 continuation
    tokens — a slightly older occurrence of the same cycle proposes the
    whole gamma window, which is what turns a run into gamma+1 tokens
    per step.

    Two entry points with identical results: :meth:`propose` is the
    stateless one-shot scan (tests, offline scoring); :meth:`index`
    returns a per-request :class:`NgramIndex` the engines keep per slot
    — positions are indexed once and extended per emitted token, so a
    proposal is O(occurrences-of-suffix), not O(history), and a 4k-token
    free-form history that never matches costs a dict miss instead of a
    full rescan every decode round.
    """

    def __init__(self, max_ngram: int = 3, gamma: int = 4,
                 min_ngram: int = 1):
        if gamma < 1:
            raise ValueError(f"gamma must be >= 1, got {gamma}")
        if not 1 <= min_ngram <= max_ngram:
            raise ValueError(
                f"need 1 <= min_ngram <= max_ngram, got "
                f"{min_ngram}..{max_ngram}")
        self.max_ngram = max_ngram
        self.min_ngram = min_ngram
        self.gamma = gamma

    def propose(self, tokens: Sequence[int]) -> List[int]:
        """Up to ``gamma`` predicted continuation tokens of ``tokens``
        (the row's ``prompt + emitted`` history); ``[]`` when no suffix
        n-gram recurs earlier in the history. One-shot: builds a
        throwaway index — use :meth:`index` on a hot path."""
        return self.index(tokens).propose()

    def index(self, tokens: Sequence[int]) -> "NgramIndex":
        """Incremental per-request lookup state seeded with ``tokens``;
        extend with :meth:`NgramIndex.extend` as the row emits."""
        return NgramIndex(self, tokens)


class NgramIndex:
    """Positions of every (n, chunk) n-gram of one row's history.

    ``extend`` appends tokens and registers the n-grams they complete
    (O(max_ngram) per token); ``propose`` looks the current suffix up
    directly and walks its occurrence list latest-first, stopping at the
    first full-gamma window — the same answer the stateless scan gives,
    without re-reading the history.
    """

    __slots__ = ("proposer", "seq", "_where")

    def __init__(self, proposer: NgramProposer, tokens: Sequence[int]):
        self.proposer = proposer
        self.seq: List[int] = []
        self._where: dict = {}          # (n, chunk) -> [start, ...]
        self.extend(tokens)

    def __len__(self) -> int:
        return len(self.seq)

    def extend(self, tokens: Sequence[int]) -> "NgramIndex":
        seq, where = self.seq, self._where
        lo, hi = self.proposer.min_ngram, self.proposer.max_ngram
        for t in tokens:
            seq.append(int(t))
            total = len(seq)
            for n in range(lo, min(hi, total) + 1):
                where.setdefault(
                    (n, tuple(seq[total - n:])), []).append(total - n)
        return self

    def propose(self) -> List[int]:
        seq = self.seq
        total = len(seq)
        gamma = self.proposer.gamma
        for n in range(min(self.proposer.max_ngram, total - 1),
                       self.proposer.min_ngram - 1, -1):
            occs = self._where.get((n, tuple(seq[total - n:])))
            if not occs:
                continue
            best: List[int] = []
            for start in reversed(occs):
                if start == total - n:
                    continue    # the suffix matching itself
                cont = seq[start + n:start + n + gamma]
                if len(cont) > len(best):
                    best = cont
                if len(best) == gamma:
                    break
            if best:
                return list(best)
        return []
