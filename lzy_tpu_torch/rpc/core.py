"""The port's copy of ``lzy_tpu/rpc/core.py``, trimmed to the transient
error the gateways raise (the transport itself is not ported yet)."""

from __future__ import annotations


class Unavailable(ConnectionError):
    """Transient refusal (gRPC UNAVAILABLE on the wire): the request was
    not served; retry later or elsewhere."""
