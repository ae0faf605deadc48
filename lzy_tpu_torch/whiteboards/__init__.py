"""Whiteboards: the port's copy of ``lzy_tpu/whiteboards``."""

from lzy_tpu_torch.whiteboards.decl import whiteboard, whiteboard_name
from lzy_tpu_torch.whiteboards.index import WhiteboardIndex, WhiteboardManifest
from lzy_tpu_torch.whiteboards.wb import WhiteboardWrapper, WritableWhiteboard

__all__ = [
    "whiteboard",
    "whiteboard_name",
    "WhiteboardIndex",
    "WhiteboardManifest",
    "WhiteboardWrapper",
    "WritableWhiteboard",
]
