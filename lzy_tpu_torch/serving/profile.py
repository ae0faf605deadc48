"""Where a decode round's time goes, on the card.

``python -m lzy_tpu_torch.serving.profile`` builds the Llama-3-8B paged
engine as ``chip_smoke.py`` does (bf16, random weights from a seed, 8
slots, page 16, 16 GiB pool), brings 8 requests to
steady decode, then runs ``--rounds`` decode rounds under
``torch.profiler`` (driving ``step()`` from this thread) and prints one
JSON object: the round's wall time, the device's busy and idle shares,
and the CUDA kernels by device time (the paged-attention kernel, the
GEMMs, the rest). The round time is taken over the same number of
rounds run just before without the profiler, whose per-op host cost
inflates the profiled window (reported as ``round_ms_profiled``).
``--spec-tokens 4`` profiles verify rounds instead. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from lzy_tpu_torch.service.inference import build_engine


def _device_time(evt) -> float:
    """Self device time (us) of a profiler entry, across torch versions."""
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--spec-tokens", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    eng = build_engine("llama3_8b", seed=args.seed, slots=8, page_size=16,
                       kv_pool_bytes=16 << 30, spec_tokens=args.spec_tokens,
                       start=False)
    rng = np.random.default_rng(args.seed)
    lengths = [128, 192, 256, 320, 384, 512, 300, 420]
    reqs = [eng.submit([int(x) for x in rng.integers(0, eng.cfg.vocab_size,
                                                     n)],
                       max_new_tokens=64 + 2 * args.rounds) for n in lengths]
    while eng._prefill_jobs or eng.queue.depth() or \
            sum(r is not None for r in eng._active) < len(reqs):
        eng.step()
    for _ in range(2):
        eng.step()                       # steady state before the window
    torch.cuda.synchronize()
    # the same number of rounds without the profiler first: its per-op
    # host cost inflates the profiled rounds' wall time
    steps0 = eng.decode_steps
    t0 = time.monotonic()
    for _ in range(args.rounds):
        eng.step()
    torch.cuda.synchronize()
    plain_ms = (time.monotonic() - t0) * 1e3 / max(
        eng.decode_steps - steps0, 1)
    steps0 = eng.decode_steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for _ in range(args.rounds):
            eng.step()
        torch.cuda.synchronize()
        wall_us = (time.monotonic() - t0) * 1e6
    rounds = eng.decode_steps - steps0
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(_device_time(e) for e in kernels)
    top = sorted(kernels, key=_device_time, reverse=True)[:12]
    busy_ms = busy_us / max(rounds, 1) / 1e3
    out = {
        "device": torch.cuda.get_device_name(0),
        "rounds": rounds, "round_ms": plain_ms,
        "round_ms_profiled": wall_us / max(rounds, 1) / 1e3,
        "device_busy_ms_per_round": (busy_ms if busy_us
                                     else "not measured"),
        # busy time from the profiled window over the unprofiled round
        "device_idle_share": (1.0 - busy_ms / plain_ms
                              if busy_us else "not measured"),
        "kernels": [{"name": e.key[:90], "calls": e.count,
                     "ms_per_round": _device_time(e) / max(rounds, 1) / 1e3,
                     "share_of_busy": (_device_time(e) / busy_us
                                       if busy_us else None)}
                    for e in top],
    }
    print(json.dumps(out))
    eng.close()
    for r in reqs:
        r.cancel()
    return out


if __name__ == "__main__":
    main()
