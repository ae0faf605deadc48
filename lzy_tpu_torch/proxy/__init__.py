from lzy_tpu_torch.proxy.automagic import (
    LzyProxy,
    get_proxy_entry_id,
    is_lzy_proxy,
    lzy_proxy,
    materialize,
    materialized,
)

__all__ = [
    "LzyProxy",
    "get_proxy_entry_id",
    "is_lzy_proxy",
    "lzy_proxy",
    "materialize",
    "materialized",
]
