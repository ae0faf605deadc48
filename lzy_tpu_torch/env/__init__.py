"""Execution environment: the port's copy of ``lzy_tpu/env``, trimmed to
``LzyEnvironment`` (environment variables) and its fluent mixin.
Containers, Python-environment capture and provisioning wait for the GPU
provisioning slice."""

from lzy_tpu_torch.env.environment import LzyEnvironment, WithEnvironmentMixin

__all__ = ["LzyEnvironment", "WithEnvironmentMixin"]
