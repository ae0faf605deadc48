"""``lzy_llm_*`` / ``lzy_wfsched_*`` metrics: the port's copy of
``lzy_tpu/llm/metrics.py``, in the port's own registry.

A leaf module (it imports only the registry): the counters are shared by
layers that must not import each other (the llm op body, the token
stream, the gateway router, the workflow service), so each of them
imports THIS module lazily and no cycle can form.
"""

from __future__ import annotations

from lzy_tpu_torch.utils.metrics import REGISTRY

#: generations executed through the llm op surface, by terminal status
#: (a cache hit never reaches the op body: it counts under CACHED_HITS)
GENERATIONS = REGISTRY.counter(
    "lzy_llm_generations_total",
    "llm_op generations executed against the serving plane, by status")

#: tokens produced through the llm op surface
GENERATED_TOKENS = REGISTRY.counter(
    "lzy_llm_generated_tokens_total",
    "tokens generated through the llm_op surface")

#: llm_op calls satisfied from the workflow result cache (no dispatch)
CACHED_HITS = REGISTRY.counter(
    "lzy_llm_cached_hits_total",
    "llm_op calls satisfied from the op result cache (no fleet dispatch)")

#: token streams resumed at the fence after a mid-stream replica death
STREAM_RESUMPTIONS = REGISTRY.counter(
    "lzy_llm_stream_resumptions_total",
    "token streams resumed byte-identically after a mid-stream failover")

#: share of PINNED session routes that landed on the conversation's
#: pinned replica (a conversation's first step has no pin and does not
#: count)
CONVERSATION_AFFINITY_RATE = REGISTRY.gauge(
    "lzy_llm_conversation_affinity_hit_rate",
    "cumulative share of pinned conversation routes that kept their "
    "pinned replica (first steps, which cannot hit, are not counted)")

#: retries of the llm dispatch boundary (the ``llm.dispatch`` fault point
#: and real transient refusals both land here)
DISPATCH_RETRIES = REGISTRY.counter(
    "lzy_llm_dispatch_retries_total",
    "llm_op dispatch attempts retried after a transient dispatch error")

#: every generate through the workflow scheduler, by role: "leader"
#: carried a request followers adopted, "solo" had no twin, "follower"
#: adopted a leader's reply (no engine request of its own)
WFSCHED_DISPATCHES = REGISTRY.counter(
    "lzy_wfsched_dispatches_total",
    "generates through the workflow fan-in plane, by role "
    "(role=leader|solo|follower)")

#: identical in-flight greedy calls collapsed onto one engine request
DEDUP_HITS = REGISTRY.counter(
    "lzy_wfsched_dedup_hits_total",
    "in-flight identical greedy generates collapsed to one engine "
    "request")

#: fused op-chain park attempts after a conversation step, by outcome
PARK_ATTEMPTS = REGISTRY.counter(
    "lzy_wfsched_park_attempts_total",
    "conversation park attempts after an ok step, by outcome "
    "(outcome=parked|declined|unsupported)")

#: speculative next-step prefills, by outcome
SPECULATIONS = REGISTRY.counter(
    "lzy_wfsched_speculations_total",
    "speculative next-step prefills, by outcome "
    "(outcome=ok|miss|timeout|error|no_lease)")
