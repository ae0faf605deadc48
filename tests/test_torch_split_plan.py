"""The paged-attention kernels' split plan (lzy_tpu_torch/ops/
paged_attention.py ``split_plan`` and ``split_pages``), on the CPU: every
visible page of every row is read by exactly one split, on page
boundaries, and the page walk is not split where the rows already fill the
card. The kernels do the same arithmetic on the card
(csrc/paged_attention.cu ``place``)."""

import os

import pytest
import torch

from lzy_tpu_torch.ops import paged_attention as pa

torch.set_num_threads(1)

#: the H100 SXM's SM count
N_SM = 132


@pytest.fixture(autouse=True)
def _process_state_unchanged():
    """No test here may change process-wide state that a JAX test sharing
    this worker would read."""
    try:
        import jax
    except ImportError:
        jax = None

    def snap():
        # pytest itself rewrites PYTEST_CURRENT_TEST at every phase
        env = {k: v for k, v in os.environ.items()
               if k != "PYTEST_CURRENT_TEST"}
        flags = None if jax is None else (
            jax.config.jax_enable_x64, jax.config.jax_default_matmul_precision)
        return (flags, env, torch.get_default_dtype(),
                torch.is_grad_enabled())

    before = snap()
    yield
    assert snap() == before


def test_split_plan_covers_every_visible_page_once():
    page, width = 16, 512                      # 8192 slots per table row
    # the serving shapes (8 slots, 32 heads over 8 KV heads): decode and
    # verify rows leave the card idle unless split; the prefill chunk's
    # 64 x 4 rows per (row, KV head) already fill it
    decode = pa.split_plan(8, 8, 1 * 4, width, N_SM)
    verify = pa.split_plan(8, 8, 5 * 4, width, N_SM)
    assert pa.split_plan(2, 8, 64 * 4, width, N_SM) == 1
    for batch, rows, splits in ((8, 4, decode), (8, 20, verify)):
        tiles = -(-rows // pa.row_tile(rows))
        assert splits > 1
        assert batch * 8 * tiles * splits >= pa.WAVES * N_SM
    assert pa.split_plan(1, 1, 1, 3, N_SM) == 3   # never more than pages
    for splits in sorted({1, 2, 3, decode, verify, 24, width}):
        for visible in (1, 15, 16, 17, 250, 1023, 1500, 8192):
            pages = -(-visible // page)
            slots = []
            for s in range(splits):
                p0, p1 = pa.split_pages(s, splits, pages)
                assert 0 <= p0 <= p1 <= pages
                # the slots the kernel reads: whole pages, cut at `visible`
                slots.extend(range(p0 * page, min(p1 * page, visible)))
            assert slots == list(range(visible)), (splits, visible)
