"""Metadata store: durable operation records, the port's copy of
``lzy_tpu/durable/store.py``.

One embedded SQLite file (WAL mode, one connection shared by every
thread of the process behind one re-entrant lock) holds the operations
table with its unique idempotency index, and a key-value namespace for
service state (VMs, sessions, channels, executions). Trimmed to what
the in-process cluster calls: the control-plane leader lease and the
server backend's dialect hook are not ported.
"""

from __future__ import annotations

import dataclasses
import json
import sqlite3
import threading
from typing import Any, Dict, List, Optional

from lzy_tpu_torch.utils.clock import SYSTEM_CLOCK

RUNNING = "RUNNING"
DONE = "DONE"
FAILED = "FAILED"

_SCHEMA = """
CREATE TABLE IF NOT EXISTS operations (
    id TEXT PRIMARY KEY,
    kind TEXT NOT NULL,
    status TEXT NOT NULL,
    step INTEGER NOT NULL DEFAULT 0,
    state TEXT NOT NULL,
    result TEXT,
    error TEXT,
    idempotency_key TEXT UNIQUE,
    deadline REAL,
    created_at REAL NOT NULL,
    updated_at REAL NOT NULL
);
CREATE INDEX IF NOT EXISTS idx_operations_status ON operations(status);
CREATE TABLE IF NOT EXISTS kv (
    ns TEXT NOT NULL,
    k TEXT NOT NULL,
    v TEXT NOT NULL,
    PRIMARY KEY (ns, k)
);
"""


@dataclasses.dataclass
class OpRecord:
    id: str
    kind: str
    status: str
    step: int
    state: Dict[str, Any]
    result: Optional[Any] = None
    error: Optional[str] = None
    idempotency_key: Optional[str] = None
    deadline: Optional[float] = None

    @property
    def done(self) -> bool:
        return self.status in (DONE, FAILED)


class OperationStore:
    """Thread-safe durable op records plus a generic KV namespace."""

    def __init__(self, path: str = ":memory:"):
        self._clock = SYSTEM_CLOCK
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._conn.execute("PRAGMA journal_mode=WAL")
        self._conn.executescript(_SCHEMA)
        self._lock = threading.RLock()

    def close(self) -> None:
        with self._lock:
            self._conn.close()

    # -- operations ------------------------------------------------------------

    def create(self, op_id: str, kind: str, state: Dict[str, Any],
               idempotency_key: Optional[str] = None,
               deadline: Optional[float] = None) -> OpRecord:
        """Insert a RUNNING op; an existing op with the same idempotency
        key is returned instead."""
        now = self._clock.time()
        with self._lock:
            if idempotency_key is not None:
                row = self._conn.execute(
                    "SELECT id FROM operations WHERE idempotency_key = ?",
                    (idempotency_key,),
                ).fetchone()
                if row is not None:
                    return self.load(row[0])
            self._conn.execute(
                "INSERT INTO operations (id, kind, status, step, state, "
                "idempotency_key, deadline, created_at, updated_at) "
                "VALUES (?, ?, ?, 0, ?, ?, ?, ?, ?)",
                (op_id, kind, RUNNING, json.dumps(state),
                 idempotency_key, deadline, now, now),
            )
            self._conn.commit()
        return self.load(op_id)

    def load(self, op_id: str) -> OpRecord:
        with self._lock:
            row = self._conn.execute(
                "SELECT id, kind, status, step, state, result, error, "
                "idempotency_key, deadline FROM operations WHERE id = ?",
                (op_id,),
            ).fetchone()
        if row is None:
            raise KeyError(f"operation {op_id!r} not found")
        return OpRecord(
            id=row[0], kind=row[1], status=row[2], step=row[3],
            state=json.loads(row[4]),
            result=json.loads(row[5]) if row[5] else None,
            error=row[6], idempotency_key=row[7], deadline=row[8],
        )

    def save_progress(self, op_id: str, state: Dict[str, Any], step: int) -> None:
        """One transaction per completed step: the crash-safety contract
        of the operation runner."""
        with self._lock:
            self._conn.execute(
                "UPDATE operations SET state = ?, step = ?, updated_at = ? "
                "WHERE id = ? AND status = ?",
                (json.dumps(state), step, self._clock.time(), op_id, RUNNING),
            )
            self._conn.commit()

    def complete(self, op_id: str, result: Any = None,
                 if_deadline: Optional[float] = ...) -> bool:
        """Settle a RUNNING op as DONE. ``if_deadline`` (when passed)
        makes it a CAS on the ownership deadline, mirroring
        :meth:`reclaim`. Returns whether THIS call settled the row."""
        return self._settle("result", DONE, json.dumps(result), op_id,
                            if_deadline)

    def fail(self, op_id: str, error: str,
             if_deadline: Optional[float] = ...) -> bool:
        """Settle a RUNNING op as FAILED; ``if_deadline`` as in
        :meth:`complete`."""
        return self._settle("error", FAILED, error, op_id, if_deadline)

    def _settle(self, column: str, status: str, value: str, op_id: str,
                if_deadline) -> bool:
        sql = (f"UPDATE operations SET status = ?, {column} = ?, "
               "updated_at = ? WHERE id = ? AND status = ?")
        params = [status, value, self._clock.time(), op_id, RUNNING]
        if if_deadline is not ...:
            sql += " AND deadline IS ?"
            params.append(if_deadline)
        with self._lock:
            cur = self._conn.execute(sql, params)
            self._conn.commit()
            return cur.rowcount == 1

    def reclaim(self, op_id: str, old_deadline: Optional[float],
                new_deadline: float) -> bool:
        """Atomically take over a RUNNING op whose deadline passed:
        compare-and-swap on the deadline, so exactly one contender
        wins."""
        with self._lock:
            cur = self._conn.execute(
                "UPDATE operations SET deadline = ?, updated_at = ? "
                "WHERE id = ? AND status = ? AND deadline IS ?",
                (new_deadline, self._clock.time(), op_id, RUNNING, old_deadline),
            )
            self._conn.commit()
            return cur.rowcount == 1

    def purge_done_ops(self, kind_prefix: str, older_than_s: float) -> int:
        """Delete DONE/FAILED ops of the kind prefix not updated for
        ``older_than_s``; returns rows deleted."""
        cutoff = self._clock.time() - older_than_s
        with self._lock:
            cur = self._conn.execute(
                "DELETE FROM operations WHERE kind LIKE ? "
                "AND status IN (?, ?) AND updated_at < ?",
                (kind_prefix + "%", DONE, FAILED, cutoff),
            )
            self._conn.commit()
            return cur.rowcount

    def running_ops(self) -> List[OpRecord]:
        with self._lock:
            rows = self._conn.execute(
                "SELECT id FROM operations WHERE status = ? ORDER BY created_at",
                (RUNNING,),
            ).fetchall()
        return [self.load(r[0]) for r in rows]

    # -- kv --------------------------------------------------------------------

    def kv_put(self, ns: str, key: str, value: Any) -> None:
        with self._lock:
            self._conn.execute(
                "INSERT INTO kv (ns, k, v) VALUES (?, ?, ?) "
                "ON CONFLICT(ns, k) DO UPDATE SET v = excluded.v",
                (ns, key, json.dumps(value)),
            )
            self._conn.commit()

    def kv_get(self, ns: str, key: str, default: Any = None) -> Any:
        with self._lock:
            row = self._conn.execute(
                "SELECT v FROM kv WHERE ns = ? AND k = ?", (ns, key)
            ).fetchone()
        return json.loads(row[0]) if row else default

    def kv_del(self, ns: str, key: str) -> None:
        with self._lock:
            self._conn.execute("DELETE FROM kv WHERE ns = ? AND k = ?", (ns, key))
            self._conn.commit()

    def kv_list(self, ns: str) -> Dict[str, Any]:
        with self._lock:
            rows = self._conn.execute(
                "SELECT k, v FROM kv WHERE ns = ?", (ns,)
            ).fetchall()
        return {k: json.loads(v) for k, v in rows}

