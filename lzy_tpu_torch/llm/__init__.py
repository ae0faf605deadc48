"""Workflow-native LLM inference (``lzy_tpu_torch.llm``): the port's copy
of ``lzy_tpu/llm``.

The join of the dataflow SDK (``@op``, workflows, whiteboards) and the
serving fleet (engines, gateways): ``llm.generate`` is an op factory
whose results flow through the graph as typed :class:`Generation`
values, with conversation affinity, op-chain fusion, in-flight dedup,
token streaming, op-cache semantics and whiteboard provenance.

Typical use::

    from lzy_tpu_torch import llm

    llm.configure(gateway_service)          # once per process
    conv = llm.Conversation("support-123")
    with lzy.workflow("agent") as wf:
        g1 = llm.generate(prompt, greedy=True, conversation=conv)
        p2 = build_followup(g1)             # a plain @op
        g2 = llm.generate(p2, greedy=True, conversation=conv)
        llm.record_generation(wf, g2, conversation=conv)
"""

from lzy_tpu_torch.llm.backend import (
    EngineBackend, LlmBackendError, ServiceBackend, configure,
    model_digest_for, resolve_backend)
from lzy_tpu_torch.llm.op import (
    Conversation, DISPATCH_RETRIES_POLICY, Generation, LLM_OP_NAME,
    LlmDispatchError, generate, generate_batch, llm_generate,
    llm_generate_batch)
from lzy_tpu_torch.llm.sched import (
    WorkflowScheduler, current_scheduler, scheduler_for)
from lzy_tpu_torch.llm.wb import (
    GENERATION_WB_NAME, GenerationRecord, record_generation)

__all__ = [
    "Conversation",
    "DISPATCH_RETRIES_POLICY",
    "EngineBackend",
    "GENERATION_WB_NAME",
    "Generation",
    "GenerationRecord",
    "LLM_OP_NAME",
    "LlmBackendError",
    "LlmDispatchError",
    "ServiceBackend",
    "WorkflowScheduler",
    "configure",
    "current_scheduler",
    "generate",
    "generate_batch",
    "llm_generate",
    "llm_generate_batch",
    "model_digest_for",
    "record_generation",
    "resolve_backend",
    "scheduler_for",
]
