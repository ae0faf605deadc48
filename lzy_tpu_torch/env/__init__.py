"""Execution environment: the port's copy of ``lzy_tpu/env``, trimmed to
``LzyEnvironment`` (environment variables), its fluent mixin and the
CPU-pool ``Provisioning``. Containers, Python-environment capture and
accelerator requirements wait for the GPU provisioning slice."""

from lzy_tpu_torch.env.environment import LzyEnvironment, WithEnvironmentMixin
from lzy_tpu_torch.env.provisioning import NoPoolError, Provisioning

__all__ = ["LzyEnvironment", "WithEnvironmentMixin", "NoPoolError",
           "Provisioning"]
