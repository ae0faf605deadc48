"""``@whiteboard`` declaration decorator: the port's copy of
``lzy_tpu/whiteboards/decl.py``. Marks a dataclass as a whiteboard
schema with a durable name."""

from __future__ import annotations

import dataclasses
from typing import Optional, Type

WB_NAME_ATTR = "__lzy_wb_name__"


def whiteboard(name: str):
    """``@whiteboard("best_model")`` above a ``@dataclass``."""
    if not name or not isinstance(name, str):
        raise ValueError("whiteboard name must be a non-empty string")

    def wrap(cls: Type) -> Type:
        if not dataclasses.is_dataclass(cls):
            cls = dataclasses.dataclass(cls)
        setattr(cls, WB_NAME_ATTR, name)
        return cls

    return wrap


def whiteboard_name(typ: Type) -> Optional[str]:
    return getattr(typ, WB_NAME_ATTR, None)
