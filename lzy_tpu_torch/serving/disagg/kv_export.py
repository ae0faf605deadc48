"""KV block export/import between paged engines.

The port's copy of ``lzy_tpu/serving/disagg/kv_export.py``. Both
directions speak :class:`~lzy_tpu_torch.channels.kv_transfer.KVBlockExport`:

- **Export** pins the radix tree's blocks for a whole-block token prefix
  (``RadixCache.lookup``) while it gathers their rows from every cache
  leaf (``leaf[ids]``, one gather per leaf) and copies them to host
  memory, so no eviction on the exporting pool can free a block
  mid-read. Block ids never leave the pool.
- **Import** checks the payload against the pool first and fails closed
  (returns 0: the request re-prefills locally) on a page size, leaf set,
  shape, dtype or mesh shape that does not match; a leaf set that
  differs is how a ``kv_quant`` mismatch shows, and scattering int8
  codes into a float pool would serve garbage with no error. Then it
  allocates FRESH blocks (evicting LRU unreferenced ones: resident
  requests' blocks are pinned by refcount), copies the rows in
  (``leaf[ids] = rows``), registers the prefix in the tree and drops its
  references, so the blocks sit cached exactly like a local prefill's.

Both run on the engine's scheduling thread (the loop, or whoever calls
``step()``, between calls): the pool is updated in place, and another
thread's prefill writing it at the same time would race silently.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from lzy_tpu_torch.channels.kv_transfer import KVBlockExport, host_tensor
from lzy_tpu_torch.serving.engine import PoolCorruption, _device_fault
from lzy_tpu_torch.serving.kv_cache import NoFreeBlocks
from lzy_tpu_torch.utils.log import get_logger

_LOG = get_logger(__name__)


@torch.no_grad()
def export_kv(engine, tokens: Sequence[int], *,
              on_pinned: Optional[Callable[[], None]] = None,
              ) -> Optional[KVBlockExport]:
    """Snapshot the cached blocks covering ``tokens``' whole-block prefix
    from a paged engine; None when no full block of it is cached.
    ``on_pinned`` runs while the blocks are pinned (a test hook)."""
    page = engine._page
    n_full = len(tokens) // page
    if n_full == 0:
        return None
    prefix = [int(t) for t in tokens[:n_full * page]]
    blocks, matched = engine.kv.lookup(prefix)
    if matched == 0:
        return None
    try:
        ids = torch.tensor(blocks, dtype=torch.long, device=engine.device)
        leaves = {key: leaf[ids].cpu() for key, leaf in engine._kv_leaves()}
        if on_pinned is not None:
            on_pinned()
        return KVBlockExport(tokens=prefix[:matched], page_size=page,
                             leaves=leaves)
    finally:
        engine.kv.release(blocks)


def _check_payload(engine, export, n: int) -> dict:
    """The export's leaves as host tensors, or ValueError when they do
    not describe exactly this pool's cache leaves."""
    if export.mesh_shape is not None:
        raise ValueError(
            f"kv export mesh_shape {tuple(export.mesh_shape)} does not "
            f"match the importing pool's (unsharded): sharded imports are "
            f"geometry-exact (fail closed)")
    pool = dict(engine._kv_leaves())
    if set(export.leaves) != set(pool):
        odd = sorted(set(export.leaves) ^ set(pool))
        raise ValueError(
            f"kv payload leaves do not match the pool's cache leaves "
            f"(off by {odd[:4]}...): mismatched kv_quant between the "
            f"exporting and importing pools?")
    out = {}
    for key, leaf in pool.items():
        data = host_tensor(export.leaves[key])
        if (data.shape[0] != n or tuple(data.shape[1:]) != tuple(
                leaf.shape[1:]) or data.dtype != leaf.dtype):
            raise ValueError(
                f"kv leaf {tuple(data.shape)}/{data.dtype} does not fit "
                f"pool leaf {tuple(leaf.shape)}/{leaf.dtype} (mismatched "
                f"kv_quant?)")
        out[key] = data
    return out


@torch.no_grad()
def import_kv(engine, export) -> int:
    """Fold a transferred prefix into a paged engine's pool and radix
    tree; returns the blocks imported (0 = skipped: page-size mismatch,
    prefix already cached, malformed or mismatched payload, or a pool
    too hot even after evicting everything evictable). Never touches a
    block a resident request references, and raises only
    ``PoolCorruption``: a device fault while writing the pool is
    engine-fatal, as it is for a promotion."""
    if export.page_size != engine._page:
        _LOG.warning("kv import skipped: page_size %d != engine %d",
                     export.page_size, engine._page)
        return 0
    tokens = [int(t) for t in export.tokens]
    n = export.n_blocks
    if n == 0 or len(tokens) % export.page_size:
        return 0
    if engine.kv.match_len(tokens) >= len(tokens):
        return 0                      # already cached end to end
    try:
        leaves = _check_payload(engine, export, n)
    except Exception as e:  # noqa: BLE001 — a bad payload must not land
        _LOG.warning("kv import refused (%s: %s); falling back to local "
                     "prefill", type(e).__name__, e)
        return 0
    try:
        blocks = engine.kv.allocate(n)     # evict-then-import
    except NoFreeBlocks:
        _LOG.info("kv import skipped: pool too hot for %d blocks", n)
        return 0
    try:
        ids = torch.tensor(blocks, dtype=torch.long, device=engine.device)
        for key, leaf in engine._kv_leaves():
            leaf[ids] = leaves[key].to(leaf.device)
    except Exception as e:  # noqa: BLE001 — the blocks were ours alone
        if _device_fault(e):
            raise PoolCorruption(
                f"kv import died with a device fault: "
                f"{type(e).__name__}: {e}") from e
        engine.kv.release(blocks)     # refcount 1, outside the tree: freed
        _LOG.warning("kv import failed (%s: %s); falling back to local "
                     "prefill", type(e).__name__, e)
        return 0
    # provenance rides the tree: a request whose prefix match hits these
    # nodes records who really produced its KV
    engine.kv.insert(tokens, blocks,
                     origin=getattr(export, "prefilled_by", None))
    engine.kv.release(blocks)         # stays cached-unreferenced
    return n
