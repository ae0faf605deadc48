"""Whiteboard integration: generations as versioned, queryable records.
The port's copy of ``lzy_tpu/llm/wb.py``.

Every record is one more version under the ``llm_generation`` name,
queryable by conversation and step tags
(``lzy.whiteboards(name=..., tags=[...])``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

from lzy_tpu_torch.llm.op import Conversation, Generation
from lzy_tpu_torch.whiteboards.decl import whiteboard

#: the whiteboard name every generation records under
GENERATION_WB_NAME = "llm_generation"


@whiteboard(GENERATION_WB_NAME)
@dataclasses.dataclass
class GenerationRecord:
    """One generation: the inputs that determine it (prompt, params,
    model digest), the output token ids and the per-step provenance
    (replica, routing reason, failovers, KV producer, conversation and
    step, latency)."""

    prompt: list
    params: dict
    model: str
    model_digest: str
    tokens: list
    provenance: dict


def record_generation(workflow, generation: Generation, *,
                      tags: Sequence[str] = (),
                      conversation: Optional[Conversation] = None):
    """Record ``generation`` (or its lazy proxy, which this materializes)
    as a whiteboard of ``workflow``, tagged with its conversation and
    step. Returns the writable whiteboard (its ``id`` is the version)."""
    tags = list(tags)
    conv_id = conversation.id if conversation is not None \
        else generation.conversation_id
    if conv_id:
        tags.append(f"conversation:{conv_id}")
    if generation.step is not None:
        tags.append(f"step:{generation.step}")
    wb = workflow.create_whiteboard(GenerationRecord, tags=tags)
    wb.prompt = list(generation.prompt)
    wb.params = dict(generation.params)
    wb.model = generation.model
    wb.model_digest = generation.model_digest
    wb.tokens = list(generation.tokens)
    wb.provenance = generation.provenance()
    return wb
