"""The workflow SDK's core: the port's copy of ``lzy_tpu/core``."""

from lzy_tpu_torch.core.op import LzyOp, op
from lzy_tpu_torch.core.lzy import Lzy, lzy_auth
from lzy_tpu_torch.core.workflow import LzyWorkflow, RemoteCallError, WorkflowError
from lzy_tpu_torch.core.call import CacheSettings, LzyCall

__all__ = [
    "LzyOp",
    "op",
    "Lzy",
    "lzy_auth",
    "LzyWorkflow",
    "RemoteCallError",
    "WorkflowError",
    "CacheSettings",
    "LzyCall",
]
