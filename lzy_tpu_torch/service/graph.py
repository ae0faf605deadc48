"""Graph and task descriptions and dataflow validation: the port's copy
of ``lzy_tpu/service/graph.py``.

Plain dicts in the metadata store. Trimmed to the fields this package
fills: module archives, the captured Python environment and the
container wait for the provisioning slice, and ``gang_size`` is always
1 (every pool is one host).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Set


@dataclasses.dataclass(frozen=True)
class EntryRef:
    id: str
    uri: str
    name: str = ""

    def to_doc(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_doc(doc: dict) -> "EntryRef":
        return EntryRef(**doc)


@dataclasses.dataclass
class TaskDesc:
    id: str
    name: str
    func_uri: str                       # the pickled op in storage
    args: List[EntryRef]
    kwargs: Dict[str, EntryRef]
    outputs: List[EntryRef]
    exception: EntryRef
    pool_label: str
    gang_size: int = 1
    env_vars: Dict[str, str] = dataclasses.field(default_factory=dict)
    std_logs_uri: str = ""              # where the worker writes <task>.log

    @property
    def input_entries(self) -> List[EntryRef]:
        return list(self.args) + list(self.kwargs.values())

    def to_doc(self) -> dict:
        return {
            "id": self.id,
            "name": self.name,
            "func_uri": self.func_uri,
            "args": [a.to_doc() for a in self.args],
            "kwargs": {k: v.to_doc() for k, v in self.kwargs.items()},
            "outputs": [o.to_doc() for o in self.outputs],
            "exception": self.exception.to_doc(),
            "pool_label": self.pool_label,
            "gang_size": self.gang_size,
            "env_vars": dict(self.env_vars),
            "std_logs_uri": self.std_logs_uri,
        }

    @staticmethod
    def from_doc(doc: dict) -> "TaskDesc":
        return TaskDesc(
            id=doc["id"],
            name=doc["name"],
            func_uri=doc["func_uri"],
            args=[EntryRef.from_doc(a) for a in doc["args"]],
            kwargs={k: EntryRef.from_doc(v) for k, v in doc["kwargs"].items()},
            outputs=[EntryRef.from_doc(o) for o in doc["outputs"]],
            exception=EntryRef.from_doc(doc["exception"]),
            pool_label=doc["pool_label"],
            gang_size=doc.get("gang_size", 1),
            env_vars=doc.get("env_vars", {}),
            std_logs_uri=doc.get("std_logs_uri", ""),
        )


@dataclasses.dataclass
class GraphDesc:
    id: str
    execution_id: str
    storage_uri: str                    # storage config prefix for this run
    tasks: List[TaskDesc]

    def to_doc(self) -> dict:
        return {
            "id": self.id,
            "execution_id": self.execution_id,
            "storage_uri": self.storage_uri,
            "tasks": [t.to_doc() for t in self.tasks],
        }

    @staticmethod
    def from_doc(doc: dict) -> "GraphDesc":
        return GraphDesc(
            id=doc["id"],
            execution_id=doc["execution_id"],
            storage_uri=doc["storage_uri"],
            tasks=[TaskDesc.from_doc(t) for t in doc["tasks"]],
        )


class GraphValidationError(ValueError):
    pass


def build_dependencies(tasks: List[TaskDesc]) -> Dict[str, Set[str]]:
    """task id -> ids of the tasks it depends on (entry producer and
    consumer relations), with duplicate-producer and cycle checks."""
    producer_of: Dict[str, str] = {}
    for t in tasks:
        for out in t.outputs:
            if out.id in producer_of:
                raise GraphValidationError(
                    f"entry {out.id} produced by both {producer_of[out.id]} "
                    f"and {t.id}"
                )
            producer_of[out.id] = t.id
    deps: Dict[str, Set[str]] = {t.id: set() for t in tasks}
    for t in tasks:
        for inp in t.input_entries:
            producer = producer_of.get(inp.id)
            if producer is not None and producer != t.id:
                deps[t.id].add(producer)

    # Kahn cycle check
    remaining = {tid: set(d) for tid, d in deps.items()}
    ready = [tid for tid, d in remaining.items() if not d]
    seen = 0
    while ready:
        tid = ready.pop()
        seen += 1
        for other, d in remaining.items():
            if tid in d:
                d.discard(tid)
                if not d:
                    ready.append(other)
    if seen != len(tasks):
        cyclic = sorted(tid for tid, d in remaining.items() if d)
        raise GraphValidationError(f"dataflow graph has a cycle through {cyclic}")
    return deps
