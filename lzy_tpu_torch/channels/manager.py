"""Channel manager: typed data rendezvous between ops, the port's copy of
``lzy_tpu/channels/manager.py``.

A channel is the meeting point of one producer and N consumers for one
data entry; the *storage peer* is always the durable default consumer,
so every value lands in storage and any consumer can read it even after
the producer is gone.

Beside the storage peer a channel can hold a **device-resident peer**:
when producer and consumer share the process (thread workers), the
producer's value, a CUDA tensor or a tree of them (a ``state_dict``),
is handed to each consumer by reference, the very same device memory,
with no copy through the host. The serialized storage copy is still
made for durability. Since a torch tensor, unlike a ``jax.Array``, can
be changed in place, the peer checks each tensor's version counter and
fails the consumer that changed one (:class:`DeviceValueChanged`). Device values live until their execution is torn
down (:meth:`ChannelManager.destroy_all`) or the cluster shuts down.
The reference's native p2p slot peer is not ported.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Dict, List, Optional, Tuple

import torch

from lzy_tpu_torch.utils.clock import SYSTEM_CLOCK
from lzy_tpu_torch.utils.log import get_logger

_LOG = get_logger(__name__)

PRODUCER = "PRODUCER"
CONSUMER = "CONSUMER"


@dataclasses.dataclass
class Channel:
    id: str                      # == entry id
    execution_id: str
    storage_uri: str             # durable rendezvous (the storage peer)
    producer_task: Optional[str] = None
    consumer_tasks: List[str] = dataclasses.field(default_factory=list)
    completed: bool = False      # storage peer has full data
    failed: Optional[str] = None


def _tensor_versions(value: Any) -> List[Tuple[torch.Tensor, int]]:
    """Every tensor of a value (a tensor, or dicts, lists and tuples of
    them) with its in-place version counter."""
    if isinstance(value, torch.Tensor):
        return [(value, value._version)]
    if isinstance(value, dict):
        value = list(value.values())
    if isinstance(value, (list, tuple)):
        return [tv for item in value for tv in _tensor_versions(item)]
    return []


class DeviceValueChanged(RuntimeError):
    """A consumer changed a device-resident value in place. Unlike the
    reference's immutable ``jax.Array``, a torch tensor handed over by
    reference is shared by the producer's storage copy and every other
    consumer, so such a change is a fault of the op, never ignored."""

    def __init__(self, entry_id: str, changed: int):
        super().__init__(
            f"entry {entry_id}: {changed} device-resident tensor(s) were "
            f"changed in place by a consumer; an op must not modify its "
            f"inputs (clone an input before changing it)")
        self.entry_id = entry_id
        self.changed = changed

    def __reduce__(self):
        # travels to the client pickled, with its remote traceback note
        return (type(self), (self.entry_id, self.changed), self.__dict__)


class DeviceResidency:
    """Process-wide registry of live values keyed by entry id. Values are
    kept at most once, with the version counter of each tensor at offer
    time: a read of a value whose tensors moved, and a consumer that
    moved them, fail with :class:`DeviceValueChanged`. Eviction is
    explicit (execution teardown) and drops the registry's reference,
    so device memory is freed once the consumers' own references are
    gone."""

    def __init__(self) -> None:
        self._values: Dict[str, Any] = {}
        self._versions: Dict[str, List[Tuple[torch.Tensor, int]]] = {}
        self._lock = threading.Lock()

    def offer(self, entry_id: str, value: Any) -> None:
        versions = _tensor_versions(value)
        with self._lock:
            self._values[entry_id] = value
            self._versions[entry_id] = versions

    def take(self, entry_id: str) -> Optional[Any]:
        with self._lock:
            value = self._values.get(entry_id)
        if value is not None:
            self.check_unchanged(entry_id)
        return value

    def check_unchanged(self, entry_id: str) -> None:
        """Raise :class:`DeviceValueChanged` if a tensor of the entry's
        value moved since its offer (nothing to check once evicted)."""
        with self._lock:
            versions = self._versions.get(entry_id, [])
        changed = sum(t._version != v for t, v in versions)
        if changed:
            raise DeviceValueChanged(entry_id, changed)

    def evict_execution(self, entry_ids) -> None:
        with self._lock:
            for eid in entry_ids:
                self._values.pop(eid, None)
                self._versions.pop(eid, None)

    def clear(self) -> None:
        with self._lock:
            self._values.clear()
            self._versions.clear()

    def __contains__(self, entry_id: str) -> bool:
        with self._lock:
            return entry_id in self._values

    def __len__(self) -> int:
        with self._lock:
            return len(self._values)


class ChannelManager:
    """Channel state is mirrored into the metadata store (when one is
    given), so a restarted service resumes mid-graph data flow. Device
    residency stays process-local by nature."""

    def __init__(self, store=None) -> None:
        self._clock = SYSTEM_CLOCK
        self._channels: Dict[str, Channel] = {}
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._store = store
        self._io_lock = threading.Lock()
        self._seq: Dict[str, int] = {}           # per-channel mutation seq
        self._written_seq: Dict[str, int] = {}
        self._tombstones: Dict[str, float] = {}  # destroyed id -> expiry ts
        self.device = DeviceResidency()
        if store is not None:
            for doc in store.kv_list("channels").values():
                ch = Channel(**doc)
                self._channels[ch.id] = ch

    def _snapshot(self, ch: Channel):
        """Call under the main lock: returns (seq, doc) for
        _write_outside."""
        if self._store is None:
            return None
        self._seq[ch.id] = self._seq.get(ch.id, 0) + 1
        return self._seq[ch.id], dataclasses.asdict(ch)

    def _write_outside(self, ch_id: str, snap) -> None:
        """Call WITHOUT the main lock: sqlite commits must not serialize
        the data plane. Per-channel seq ordering drops stale racing
        writes."""
        if snap is None:
            return
        seq, doc = snap
        with self._io_lock:
            if ch_id in self._tombstones:
                return  # destroyed while this write was in flight
            if self._written_seq.get(ch_id, -1) >= seq:
                return
            self._written_seq[ch_id] = seq
            self._store.kv_put("channels", ch_id, doc)

    # -- private API (per-execution lifecycle) ---------------------------------

    def get_or_create(self, execution_id: str, entry_id: str, storage_uri: str) -> Channel:
        snap = None
        with self._lock:
            ch = self._channels.get(entry_id)
            if ch is None:
                ch = Channel(id=entry_id, execution_id=execution_id,
                             storage_uri=storage_uri)
                self._channels[entry_id] = ch
                snap = self._snapshot(ch)
        self._write_outside(entry_id, snap)
        return ch

    def destroy_all(self, execution_id: str) -> None:
        with self._lock:
            dead = [cid for cid, ch in self._channels.items()
                    if ch.execution_id == execution_id]
            for cid in dead:
                del self._channels[cid]
                self._seq.pop(cid, None)
        if self._store is not None:
            now = self._clock.time()
            with self._io_lock:
                for cid in dead:
                    # tombstone: an in-flight _write_outside that
                    # snapshotted before destruction must not resurrect
                    # the row; tombstones expire after a grace period
                    self._written_seq.pop(cid, None)
                    self._tombstones[cid] = now + 60.0
                    self._store.kv_del("channels", cid)
                for cid in [c for c, exp in self._tombstones.items()
                            if exp < now]:
                    del self._tombstones[cid]
        self.device.evict_execution(dead)

    def _live(self, entry_id: str) -> Channel:
        """Lookup with a diagnosable miss: a missing channel here almost
        always means the execution was torn down while a straggler task
        was still running."""
        try:
            return self._channels[entry_id]
        except KeyError:
            raise KeyError(
                f"channel {entry_id!r} unknown or already destroyed — was "
                f"its execution torn down while this task was running?"
            ) from None

    # -- public API (bind / transfer lifecycle) --------------------------------

    def bind(self, entry_id: str, role: str, task_id: str) -> Channel:
        with self._lock:
            ch = self._live(entry_id)
            if role == PRODUCER:
                ch.producer_task = task_id
            elif task_id not in ch.consumer_tasks:
                # idempotent: a task re-executed after crash-resume re-binds
                ch.consumer_tasks.append(task_id)
            snap = self._snapshot(ch)
        self._write_outside(entry_id, snap)
        return ch

    def transfer_completed(self, entry_id: str) -> None:
        """Producer finished writing the storage peer; wake waiting
        consumers."""
        with self._cv:
            ch = self._channels.get(entry_id)
            if ch is None:
                # a straggler finishing after its execution's teardown:
                # the data landed durably and nobody is left to read it
                _LOG.warning("transfer_completed for unknown channel %s "
                             "(execution torn down?)", entry_id)
                return
            ch.completed = True
            snap = self._snapshot(ch)
            self._cv.notify_all()
        self._write_outside(entry_id, snap)

    def transfer_failed(self, entry_id: str, error: str) -> None:
        with self._cv:
            ch = self._channels.get(entry_id)
            if ch is None:
                _LOG.warning("transfer_failed for unknown channel %s "
                             "(execution torn down?): %s", entry_id, error)
                return
            if ch.completed:
                return  # durable data already landed; late failure is moot
            ch.failed = error
            snap = self._snapshot(ch)
            self._cv.notify_all()
        self._write_outside(entry_id, snap)

    def wait_available(self, entry_id: str,
                       timeout_s: Optional[float] = 300.0) -> Channel:
        """Block a consumer until the channel's data is durably available,
        or a device-resident value exists. ``timeout_s=None`` waits
        indefinitely."""
        deadline = None if timeout_s is None else \
            self._clock.time() + timeout_s
        with self._cv:
            while True:
                ch = self._live(entry_id)
                if ch.failed:
                    raise ChannelFailed(entry_id, ch.failed)
                if ch.completed or entry_id in self.device:
                    return ch
                if deadline is None:
                    self._cv.wait(1.0)
                    continue
                remaining = deadline - self._clock.time()
                if remaining <= 0:
                    raise TimeoutError(f"channel {entry_id} not available after {timeout_s}s")
                self._cv.wait(min(remaining, 1.0))


class ChannelFailed(RuntimeError):
    def __init__(self, entry_id: str, error: str):
        super().__init__(f"channel {entry_id} failed: {error}")
        self.entry_id = entry_id
