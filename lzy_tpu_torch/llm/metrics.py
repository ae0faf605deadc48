"""``lzy_llm_*`` / ``lzy_wfsched_*`` metrics the gateway reads: the
port's copy of ``lzy_tpu/llm/metrics.py``, trimmed to those two. A leaf
module (it imports only the registry)."""

from __future__ import annotations

from lzy_tpu_torch.utils.metrics import REGISTRY

#: share of PINNED session routes that landed on the conversation's
#: pinned replica (a conversation's first step has no pin and does not
#: count)
CONVERSATION_AFFINITY_RATE = REGISTRY.gauge(
    "lzy_llm_conversation_affinity_hit_rate",
    "cumulative share of pinned conversation routes that kept their "
    "pinned replica (first steps, which cannot hit, are not counted)")

#: speculative next-step prefills, by outcome
SPECULATIONS = REGISTRY.counter(
    "lzy_wfsched_speculations_total",
    "speculative next-step prefills, by outcome "
    "(outcome=ok|miss|timeout|error|no_lease)")
