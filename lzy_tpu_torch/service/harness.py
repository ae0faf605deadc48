"""In-process cluster: the port's copy of ``lzy_tpu/service/harness.py``.

Every control-plane service in one process: one metadata store, the
durable executor, the allocator over thread VMs, the channel manager,
the graph executor and the workflow service, and an ``lzy()`` factory
returning an SDK facade on the ``RemoteRuntime``. It is the local
single-machine deployment mode as well as a test rig: ops run on worker
threads of this process, on its CUDA device, and values pass between
them through device-resident channels.

Trimmed to thread workers. The reference's RPC serving (``serve()``),
process workers, the leader lease, IAM, disks, the native p2p spill and
the inference service are not ported; their keywords are unknown here,
and so are the reference's tuning keywords (pools, worker count, task
limits, poll periods, the execution TTL), which take the values below.
``shutdown`` stops and joins every thread the cluster started (the
executor's, each VM's boot, heartbeat and task threads, the GC thread)
and evicts every device-resident value.
"""

from __future__ import annotations

import threading
from typing import List, Optional

from lzy_tpu_torch.channels.manager import ChannelManager
from lzy_tpu_torch.core.lzy import Lzy
from lzy_tpu_torch.durable import OperationsExecutor
from lzy_tpu_torch.durable.pg_store import store_for
from lzy_tpu_torch.serialization import default_registry
from lzy_tpu_torch.service.allocator import AllocatorService
from lzy_tpu_torch.service.backends import ThreadVmBackend
from lzy_tpu_torch.service.graph_executor import GraphExecutor
from lzy_tpu_torch.service.workflow_service import WorkflowService
from lzy_tpu_torch.storage import DefaultStorageRegistry, StorageConfig
from lzy_tpu_torch.storage.registry import client_for
from lzy_tpu_torch.types import PoolSpec, VmSpec
from lzy_tpu_torch.utils.log import get_logger

_LOG = get_logger(__name__)

DEFAULT_POOLS: List[PoolSpec] = [
    # the reference's CPU pools; its TPU pools wait for GPU provisioning
    VmSpec(label="cpu-small", cpu_count=4, ram_gb=32),
    VmSpec(label="cpu-large", cpu_count=16, ram_gb=128),
]

#: the user every ``lzy()`` facade submits as
USER = "test-user"
#: the age at which GC aborts an ACTIVE execution (a client that died)
EXECUTION_TTL_S = 86_400.0


class InProcessCluster:
    def __init__(
        self,
        *,
        storage_uri: str = "mem://cluster",
        db_path: str = ":memory:",
        gc_period_s: Optional[float] = None,   # background GC timer
    ):
        self.storage_uri = storage_uri
        self.store = store_for(db_path)
        self.executor = OperationsExecutor(self.store)
        self.channels = ChannelManager(store=self.store)
        self.serializers = default_registry()
        self.storage_client = client_for(StorageConfig(uri=storage_uri))
        self.backend = ThreadVmBackend(
            self.channels, self.storage_client, self.serializers)
        self.allocator = AllocatorService(
            self.store, self.executor, self.backend, DEFAULT_POOLS)
        self.backend.allocator = self.allocator
        self.graph_executor = GraphExecutor(
            self.store, self.executor, self.allocator, self.channels)
        self.workflow_service = WorkflowService(
            self.store, self.executor, self.allocator, self.channels,
            self.graph_executor, self.storage_client,
        )
        # background GC, only when its period is given
        self._gc_stop = threading.Event()
        self._gc_thread = None
        if gc_period_s is not None:
            def gc_loop():
                while not self._gc_stop.wait(gc_period_s):
                    try:
                        self.allocator.gc_tick()
                        self.workflow_service.gc_tick(ttl_s=EXECUTION_TTL_S)
                    except Exception:  # noqa: BLE001 — GC must never die
                        _LOG.exception("gc tick failed")

            self._gc_thread = threading.Thread(target=gc_loop,
                                               name="cluster-gc", daemon=True)
            self._gc_thread.start()

    @property
    def client(self) -> WorkflowService:
        """The in-process 'stub': the method surface an RPC client has."""
        return self.workflow_service

    def lzy(self, *, stream_logs: bool = False) -> Lzy:
        from lzy_tpu_torch.runtime.remote import RemoteRuntime  # import cycle

        storage = DefaultStorageRegistry()
        storage.register_storage(
            "default", StorageConfig(uri=self.storage_uri), default=True
        )
        return Lzy(
            runtime=RemoteRuntime(
                self.client, user=USER, stream_logs=stream_logs,
            ),
            storage_registry=storage,
            serializer_registry=self.serializers,
        )

    def resume_pending_operations(self) -> int:
        """Crash-recovery entry: re-enqueue every RUNNING durable op."""
        return self.executor.restore()

    def shutdown(self, *, join_timeout_s: float = 30.0) -> None:
        # stop AND join GC first: an in-flight tick must not race VM
        # destruction below or outlive the store it reads
        self._gc_stop.set()
        if self._gc_thread is not None:
            self._gc_thread.join(join_timeout_s)
        for vm in list(self.allocator.vms()):
            try:
                self.backend.destroy(vm)
            except Exception:  # noqa: BLE001 — best-effort teardown
                pass
        self.executor.shutdown(join_timeout_s=join_timeout_s)
        if not self.backend.join(join_timeout_s):
            _LOG.warning("worker threads still running after %.0f s",
                         join_timeout_s)
        self.channels.device.clear()
        self.store.close()
