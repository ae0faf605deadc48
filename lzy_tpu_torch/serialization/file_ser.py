"""Raw-bytes serializer for ``File`` values: the port's copy of
``lzy_tpu/serialization/file_ser.py``. The file's bytes go to storage as
they are and come back as a fresh local file."""

from __future__ import annotations

import shutil
import tempfile
from typing import Any, BinaryIO, Optional, Type

from lzy_tpu_torch.serialization.registry import Serializer
from lzy_tpu_torch.types import File


class FileSerializer(Serializer):
    def format_name(self) -> str:
        return "raw_file"

    def supports_type(self, typ: Type) -> bool:
        return isinstance(typ, type) and issubclass(typ, File)

    def serialize(self, obj: Any, dest: BinaryIO) -> None:
        with open(obj, "rb") as f:
            shutil.copyfileobj(f, dest)

    def deserialize(self, src: BinaryIO, typ: Optional[Type] = None) -> Any:
        fd = tempfile.NamedTemporaryFile(prefix="lzy_file_", delete=False)
        with fd:
            shutil.copyfileobj(src, fd)
        return File(fd.name)
