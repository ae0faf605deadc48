from lzy_tpu_torch.runtime.api import Runtime
from lzy_tpu_torch.runtime.local import LocalRuntime

__all__ = ["Runtime", "LocalRuntime"]
