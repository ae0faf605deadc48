"""VM backends: the port's copy of ``lzy_tpu/service/backends.py``,
trimmed to ``ThreadVmBackend``.

A "VM" is a worker agent running as threads of this process (the
reference's ``ThreadVmAllocator`` test pattern promoted to a local
backend): ``launch`` boots it on a thread of its own, which registers
the agent with the allocator; ``destroy`` stops it. The backend keeps
every thread it started, and those of every agent it booted, so that
:meth:`ThreadVmBackend.join` can wait for all of them at shutdown. The
reference's process and GKE backends are not ported.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

from lzy_tpu_torch.channels.manager import ChannelManager
from lzy_tpu_torch.serialization import SerializerRegistry
from lzy_tpu_torch.service.allocator import Vm, VmBackend
from lzy_tpu_torch.service.worker import WorkerAgent
from lzy_tpu_torch.storage.api import StorageClient
from lzy_tpu_torch.types import PoolSpec


class ThreadVmBackend(VmBackend):
    def __init__(
        self,
        channels: ChannelManager,
        storage_client: StorageClient,
        serializers: Optional[SerializerRegistry] = None,
    ):
        self._channels = channels
        self._storage = storage_client
        self._serializers = serializers
        self._agents: Dict[str, Optional[WorkerAgent]] = {}
        # every boot thread and every agent ever booted (destroyed ones
        # may still run a straggler task), pruned once finished
        self._boot_threads: List[threading.Thread] = []
        self._retired: List[WorkerAgent] = []
        self._lock = threading.Lock()
        self.allocator = None             # wired by the harness after both exist

    def launch(self, vm: Vm, pool: PoolSpec) -> None:
        # idempotent: a durable-op resume may re-request hosts already booting
        with self._lock:
            if vm.id in self._agents:
                return
            self._agents[vm.id] = None  # booking marker

        def boot() -> None:
            agent = WorkerAgent(
                vm.id,
                allocator=self.allocator,
                channels=self._channels,
                storage_client=self._storage,
                serializers=self._serializers,
            )
            with self._lock:
                self._agents[vm.id] = agent
            try:
                agent.start()
            except KeyError:
                # allocation was rolled back while booting
                agent.stop()
                with self._lock:
                    self._agents.pop(vm.id, None)
                    self._retired.append(agent)

        thread = threading.Thread(target=boot, name=f"boot-{vm.id}",
                                  daemon=True)
        with self._lock:
            self._boot_threads = [t for t in self._boot_threads
                                  if t.is_alive()] + [thread]
            thread.start()

    def destroy(self, vm: Vm) -> None:
        with self._lock:
            agent = self._agents.pop(vm.id, None)
            if agent is not None:
                self._retired = [a for a in self._retired
                                 if not a.join(0.0)] + [agent]
        if agent is not None:
            agent.stop()

    def join(self, timeout_s: float) -> bool:
        """Wait for every boot thread, and every heartbeat and task thread
        of the agents this backend booted, to end (after ``destroy`` of
        each VM); returns whether all of them did."""
        deadline = time.monotonic() + timeout_s
        with self._lock:
            threads = list(self._boot_threads)
        for t in threads:
            t.join(max(0.0, deadline - time.monotonic()))
        with self._lock:
            agents = self._retired + [a for a in self._agents.values()
                                      if a is not None]
        done = [a.join(max(0.0, deadline - time.monotonic()))
                for a in agents]
        return all(done) and not any(t.is_alive() for t in threads)
