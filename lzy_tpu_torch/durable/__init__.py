"""Durable execution: the port's copy of ``lzy_tpu/durable`` (the SQLite
operation store, the step runner and executor, injected failures)."""

from lzy_tpu_torch.durable.store import DONE, FAILED, RUNNING, OperationStore, OpRecord
from lzy_tpu_torch.durable.runner import (
    OperationRunner,
    OperationsExecutor,
    Outcome,
    StepResult,
)
from lzy_tpu_torch.durable.failures import InjectedCrash, InjectedFailures

__all__ = [
    "DONE",
    "FAILED",
    "RUNNING",
    "OperationStore",
    "OpRecord",
    "OperationRunner",
    "OperationsExecutor",
    "Outcome",
    "StepResult",
    "InjectedCrash",
    "InjectedFailures",
]
