"""Worker agent, the on-VM execution engine: the port's copy of
``lzy_tpu/service/worker.py``.

``execute`` starts the task on a thread of its own and returns an op id
at once; the graph executor polls ``status``. A task reads its inputs
from channels (the device-resident peer first, then the storage peer),
runs the op, writes every output to the device peer and, serialized, to
the storage peer with its ``.meta`` sidecar, and stores an exception
(with the remote traceback as a note) where the client reads it. Lines
the op prints are routed to the task's log, which lands in storage for
the client's log pump. A heartbeat thread keeps the VM alive with the
allocator.

Each op's status also carries where its time went (``timings``): reading
inputs, the body, serializing and storing outputs, the bytes stored and
the inputs served by the device peer.

Trimmed to in-process thread workers: every task runs on gang rank 0
(pools are one host), and the reference's process-worker options
(python-env overlays, containers, module sync, disk mounts, the native
p2p slot spill, the sharded global-array spill) are not ported. Outputs
go through the port's ``StorageClient`` in place of the reference's
transfer engine (``storage/transfer.upload_bytes``).
"""

from __future__ import annotations

import contextvars
import io
import json
import pickle
import sys
import threading
import time
import traceback
from typing import Any, Dict, List, Optional

from lzy_tpu_torch.channels.manager import (
    CONSUMER, PRODUCER, ChannelFailed, ChannelManager)
from lzy_tpu_torch.core.call import result_cacheable
from lzy_tpu_torch.serialization import SerializerRegistry, default_registry
from lzy_tpu_torch.serialization.basic import pickler
from lzy_tpu_torch.service.graph import TaskDesc
from lzy_tpu_torch.storage.api import StorageClient, join_uri
from lzy_tpu_torch.utils import hashing
from lzy_tpu_torch.utils.env import applied_env_vars
from lzy_tpu_torch.utils.log import get_logger

_LOG = get_logger(__name__)

# gang context visible to op bodies through current_gang()
_GANG: contextvars.ContextVar[Optional[Dict[str, Any]]] = contextvars.ContextVar(
    "lzy_gang", default=None
)


def current_gang() -> Optional[Dict[str, Any]]:
    """``{"rank", "size", "gang_id", "vm_ids"}`` of the executing op;
    None outside a worker."""
    return _GANG.get()


class _StdRouter(io.TextIOBase):
    """Thread-safe stdout/stderr tee: lines from a task thread go to that
    task's log buffer (and the real stream); other threads pass through.
    Installed once per process."""

    _route: contextvars.ContextVar = contextvars.ContextVar("lzy_stdroute", default=None)

    def __init__(self, real):
        self._real = real

    def write(self, s: str) -> int:
        buf = self._route.get()
        if buf is not None:
            buf.write(s)
        return self._real.write(s)

    def flush(self) -> None:
        self._real.flush()

    @classmethod
    def install(cls) -> None:
        if not isinstance(sys.stdout, cls):
            sys.stdout = cls(sys.stdout)
        if not isinstance(sys.stderr, cls):
            sys.stderr = cls(sys.stderr)


class WorkerAgent:
    """One per VM. ``execute`` returns an operation id immediately; the
    graph executor polls ``status``."""

    HEARTBEAT_PERIOD_S = 1.0

    def __init__(
        self,
        vm_id: str,
        *,
        allocator,                        # AllocatorService (register/heartbeat)
        channels: ChannelManager,
        storage_client: StorageClient,
        serializers: Optional[SerializerRegistry] = None,
    ):
        self.vm_id = vm_id
        self._allocator = allocator
        self._channels = channels
        self._storage = storage_client
        self._serializers = serializers or default_registry()
        self._ops: Dict[str, Dict[str, Any]] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._hb_thread = threading.Thread(
            target=self._heartbeat_loop, args=(self.HEARTBEAT_PERIOD_S,),
            name=f"hb-{vm_id}", daemon=True,
        )
        self._task_threads: List[threading.Thread] = []

    # -- lifecycle -------------------------------------------------------------

    def start(self) -> None:
        self._allocator.register_vm(self.vm_id, self)
        self._hb_thread.start()

    def stop(self) -> None:
        self._stop.set()

    def join(self, timeout_s: float) -> bool:
        """Wait for the heartbeat and task threads to end (call after
        ``stop``); returns whether all of them did."""
        deadline = time.monotonic() + timeout_s
        with self._lock:
            threads = list(self._task_threads)
        if self._hb_thread.ident is not None:
            threads.append(self._hb_thread)
        for t in threads:
            t.join(max(0.0, deadline - time.monotonic()))
        return not any(t.is_alive() for t in threads)

    def _heartbeat_loop(self, period_s: float) -> None:
        failures = 0
        while not self._stop.wait(period_s):
            try:
                self._allocator.heartbeat(self.vm_id)
                failures = 0
            except Exception:
                failures += 1
                _LOG.warning("heartbeat failed for %s (%d consecutive)",
                             self.vm_id, failures)

    # -- Execute ---------------------------------------------------------------

    def execute(self, task: TaskDesc, gang_rank: int, gang: Dict[str, Any]) -> str:
        # deterministic op id -> idempotent: a crashed graph-executor step
        # that re-requests execution after resume gets the running op back
        op_id = f"workerop-{task.id}-r{gang_rank}"
        with self._lock:
            if op_id in self._ops:
                return op_id
            self._ops[op_id] = {"status": "RUNNING", "error": None,
                                "exception_uri": None, "timings": {}}
            thread = threading.Thread(
                target=self._run, args=(op_id, task, gang_rank, gang),
                name=f"task-{task.name}-r{gang_rank}", daemon=True,
            )
            self._task_threads = [t for t in self._task_threads
                                  if t.is_alive()] + [thread]
            thread.start()   # under the lock: join() never sees it unstarted
        return op_id

    def status(self, op_id: str) -> Dict[str, Any]:
        with self._lock:
            out = dict(self._ops[op_id])
            out["timings"] = dict(out["timings"])
            return out

    # -- execution -------------------------------------------------------------

    def _run(self, op_id: str, task: TaskDesc, gang_rank: int,
             gang: Dict[str, Any]) -> None:
        _StdRouter.install()
        log_buf = io.StringIO()
        token_route = _StdRouter._route.set(log_buf)
        token_gang = _GANG.set({"rank": gang_rank, "size": task.gang_size, **gang})
        try:
            self._execute_task(task, self._ops[op_id]["timings"])
            with self._lock:
                self._ops[op_id]["status"] = "DONE"
        except BaseException as e:
            tb = traceback.format_exc()
            _LOG.error("task %s failed on %s: %s", task.id, self.vm_id, tb)
            exception_uri = None
            if not isinstance(e, ChannelFailed):
                exception_uri = self._store_exception(task, e, tb)
                for out in task.outputs:
                    try:
                        self._channels.transfer_failed(out.id, repr(e))
                    except KeyError:
                        pass
            with self._lock:
                self._ops[op_id].update(
                    status="FAILED", error=repr(e), exception_uri=exception_uri
                )
        finally:
            _GANG.reset(token_gang)
            _StdRouter._route.reset(token_route)
            self._flush_logs(task, log_buf.getvalue())

    def _execute_task(self, task: TaskDesc, timings: Dict[str, Any]) -> None:
        for ref in task.input_entries:
            self._channels.bind(ref.id, CONSUMER, task.id)
        for ref in task.outputs:
            self._channels.bind(ref.id, PRODUCER, task.id)

        timings.update(device_hits=0, serialize_s=0.0, put_s=0.0,
                       bytes_written=0)
        t0 = time.perf_counter()
        on_device: List[str] = []
        args = [self._read_entry(ref, timings, on_device)
                for ref in task.args]
        kwargs = {k: self._read_entry(ref, timings, on_device)
                  for k, ref in task.kwargs.items()}
        func = self._load_func(task.func_uri)
        t1 = time.perf_counter()
        with applied_env_vars(task.env_vars):
            result = func(*args, **kwargs)
        t2 = time.perf_counter()
        # the inputs it was handed by reference must come back unchanged
        for entry_id in on_device:
            self._channels.device.check_unchanged(entry_id)
        timings.update(read_s=t1 - t0, body_s=t2 - t1, body_start=t1,
                       body_end=t2)

        n_out = len(task.outputs)
        outputs = (result if n_out > 1 and isinstance(result, tuple)
                   else (result,))
        if len(outputs) != n_out:
            raise ValueError(
                f"op {task.name}() returned {len(outputs)} values, "
                f"declared {n_out}"
            )
        cacheable = result_cacheable(func, result)
        for ref, value in zip(task.outputs, outputs):
            self._write_entry(ref, value, timings, cacheable=cacheable)
            self._channels.transfer_completed(ref.id)

    # -- data plane ------------------------------------------------------------

    def _read_entry(self, ref, timings: Dict[str, Any],
                    on_device: List[str]) -> Any:
        self._channels.wait_available(ref.id)
        device_value = self._channels.device.take(ref.id)
        if device_value is not None:
            timings["device_hits"] += 1
            on_device.append(ref.id)
            return device_value  # the producer's value, never left the card
        meta = self._read_meta(ref.uri)
        serializer = self._serializers.find_by_format(meta["data_format"])
        src = self._storage.open_read(ref.uri)
        try:
            return serializer.deserialize(src)
        finally:
            src.close()

    def _write_entry(self, ref, value: Any, timings: Dict[str, Any], *,
                     cacheable: bool = True) -> None:
        """Offer the value to the device peer, then serialize it and write
        the storage peer and the ``.meta`` sidecar (every output, device
        resident or not: the storage copy is the durable one). A result
        its op vetoed (``core.call.result_cacheable``) is marked so in
        the sidecar: stored for this execution, never a cache hit."""
        self._channels.device.offer(ref.id, value)
        t0 = time.perf_counter()
        serializer = self._serializers.find_by_instance(value)
        buf = io.BytesIO()
        serializer.serialize(value, buf)
        data = buf.getvalue()
        t1 = time.perf_counter()
        self._storage.write_bytes(ref.uri, data)
        scheme = serializer.data_scheme(value)
        meta = {
            "hash": hashing.hash_bytes(data),
            "data_format": scheme.data_format,
            "schema_content": scheme.schema_content,
            "meta": scheme.meta,
        }
        if not cacheable:
            meta["cacheable"] = False
        doc = json.dumps(meta).encode("utf-8")
        self._storage.write_bytes(ref.uri + ".meta", doc)
        timings["serialize_s"] += t1 - t0
        timings["put_s"] += time.perf_counter() - t1
        timings["bytes_written"] += len(data) + len(doc)

    def _read_meta(self, uri: str) -> Dict[str, Any]:
        return json.loads(self._storage.read_bytes(uri + ".meta").decode("utf-8"))

    def _load_func(self, func_uri: str):
        obj = pickle.loads(self._storage.read_bytes(func_uri))
        # an LzyOp wrapper (shipped by reference for module-level ops)
        # unwraps to its function: there is no active workflow here, so
        # the wrapper would run eagerly anyway
        func = getattr(obj, "func", None)
        return func if callable(func) else obj

    def _store_exception(self, task: TaskDesc, e: BaseException, tb: str) -> str:
        e.add_note(f"[remote traceback from {self.vm_id}]\n{tb}")
        module = pickler()
        try:
            payload = module.dumps(e)
        except Exception:
            payload = module.dumps(RuntimeError(f"{e!r} (unpicklable)\n{tb}"))
        self._storage.write_bytes(task.exception.uri, payload)
        return task.exception.uri

    def _flush_logs(self, task: TaskDesc, text: str) -> None:
        if not text or not task.std_logs_uri:
            return
        uri = join_uri(task.std_logs_uri, f"{task.id}.log")
        try:
            self._storage.write_bytes(uri, text.encode("utf-8"))
        except Exception:
            _LOG.warning("failed to flush logs for task %s", task.id)
