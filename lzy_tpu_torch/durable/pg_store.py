"""The store factory: the port's copy of ``lzy_tpu/durable/pg_store.py``,
trimmed to :func:`store_for`. Only the SQLite route is ported; the
reference's Postgres backend waits for the RPC control plane that
shares a store between planes."""

from __future__ import annotations

from typing import Optional

from lzy_tpu_torch.durable.store import OperationStore


def store_for(path_or_dsn: Optional[str]) -> OperationStore:
    """A SQLite path (in memory when empty); a ``postgresql://`` DSN
    raises ``ValueError``."""
    if path_or_dsn and path_or_dsn.startswith(("postgresql://",
                                               "postgres://")):
        raise ValueError(
            f"no Postgres backend in this package: {path_or_dsn!r}; "
            f"give a SQLite path")
    return OperationStore(path_or_dsn or ":memory:")
