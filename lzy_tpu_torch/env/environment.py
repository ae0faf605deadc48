"""Composable execution environment: the port's copy of
``lzy_tpu/env/environment.py``, with the fields that ``op``, ``call`` and
``workflow`` read: environment variables, merged
``Lzy.env (+) workflow.env (+) op.env`` key by key, the right-hand side
winning. The reference's ``provisioning``, ``python_env`` and
``container`` fields wait for the GPU provisioning slice.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping


@dataclasses.dataclass(frozen=True)
class LzyEnvironment:
    env_vars: Dict[str, str] = dataclasses.field(default_factory=dict)

    def combine(self, other: "LzyEnvironment") -> "LzyEnvironment":
        return LzyEnvironment(env_vars={**self.env_vars, **other.env_vars})

    def with_env_vars(self, env_vars: Mapping[str, str]) -> "LzyEnvironment":
        return dataclasses.replace(self, env_vars={**self.env_vars, **env_vars})


class WithEnvironmentMixin:
    """Fluent environment modifiers shared by ``Lzy`` and ``@op``
    wrappers: each returns a modified copy."""

    env: LzyEnvironment

    def _replace_env(self, env: LzyEnvironment):
        clone = self.__class__.__new__(self.__class__)
        clone.__dict__.update(self.__dict__)
        clone.env = env
        return clone

    def with_env(self, env: LzyEnvironment):
        return self._replace_env(env)

    def with_env_vars(self, env_vars: Mapping[str, str]):
        return self._replace_env(self.env.with_env_vars(env_vars))
