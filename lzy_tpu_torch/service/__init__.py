"""The control plane (the port's copy of ``lzy_tpu/service``): the
allocator, thread VMs and their worker agents, graph descriptions, the
graph executor, the workflow service and the in-process cluster that
wires them; and ``inference.py``, the builders that turn a model name
into a started serving engine or gateway."""

from lzy_tpu_torch.service.allocator import AllocatorService, Vm, VmBackend
from lzy_tpu_torch.service.backends import ThreadVmBackend
from lzy_tpu_torch.service.graph import EntryRef, GraphDesc, GraphValidationError, TaskDesc
from lzy_tpu_torch.service.graph_executor import GraphExecutor
from lzy_tpu_torch.service.harness import DEFAULT_POOLS, InProcessCluster
from lzy_tpu_torch.service.worker import WorkerAgent, current_gang
from lzy_tpu_torch.service.workflow_service import WorkflowService

__all__ = [
    "AllocatorService",
    "Vm",
    "VmBackend",
    "ThreadVmBackend",
    "EntryRef",
    "GraphDesc",
    "GraphValidationError",
    "TaskDesc",
    "GraphExecutor",
    "DEFAULT_POOLS",
    "InProcessCluster",
    "WorkerAgent",
    "current_gang",
    "WorkflowService",
]
