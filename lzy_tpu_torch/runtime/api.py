"""Runtime interface: the port's copy of ``lzy_tpu/runtime/api.py``.

The strategy a workflow uses to execute its call queue: the in-process
``LocalRuntime``, or ``RemoteRuntime`` through the control plane of an
in-process cluster (``service/harness.InProcessCluster``).
"""

from __future__ import annotations

import abc
from typing import TYPE_CHECKING, Sequence

if TYPE_CHECKING:
    from lzy_tpu_torch.core.call import LzyCall
    from lzy_tpu_torch.core.workflow import LzyWorkflow


class Runtime(abc.ABC):
    @abc.abstractmethod
    def start(self, workflow: "LzyWorkflow") -> None:
        """Begin an execution session for the workflow."""

    @abc.abstractmethod
    def exec(self, workflow: "LzyWorkflow", calls: Sequence["LzyCall"]) -> None:
        """Execute a batch of calls; must not return until every call's
        results (or its exception) are stored. Raises RemoteCallError on
        op failure."""

    @abc.abstractmethod
    def finish(self, workflow: "LzyWorkflow") -> None:
        """Graceful teardown after a successful workflow exit."""

    @abc.abstractmethod
    def abort(self, workflow: "LzyWorkflow") -> None:
        """Teardown after a failed workflow."""

    def auth_context(self) -> dict:
        """The identity this runtime executes as: ``{"user": ...}`` for a
        remote session, ``{}`` locally. Call factories that thread the
        identity into op inputs (``llm.generate``'s tenant) read it at
        registration time."""
        return {}

    def in_process(self) -> bool:
        """True when op bodies run in the client's thread, where live
        objects registered there (a token-stream channel) reach them.
        ``llm.generate`` rejects a live channel on any other runtime."""
        return False
