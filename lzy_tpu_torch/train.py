"""Train-step MFU of the port on one card.

``python -m lzy_tpu_torch.train [--device cuda|cpu] [--profile]``: the
counterpart of ``bench.py``'s train measurement (``bench.py`` stays the
JAX package's). It trains the ~350M-parameter Llama that the repo's
headline metric measures — :func:`pick_config`, a copy of
``bench.py``'s: vocab 32768, d_model 1024, 20 layers, 8 heads of 128,
d_ff 4096, tied embeddings, per-layer remat, fused chunked CE, flash
attention kernels — on batch 16 x seq 2048 of synthetic tokens from a
seeded generator, with f32 master params, bf16 compute and AdamW. After
3 warmup steps it times a few more and prints one JSON line: ``metric``
``llama_train_step_mfu``, ``value`` (6ND model FLOPs per second over the
card's dense bf16 peak), ``unit``, ``vs_baseline`` (against the repo's
0.40 target), ``step_ms``, ``tokens_per_s`` and the card's name and
power limit. ``--device cpu`` runs the tiny config as a rehearsal; a
CPU run's numbers are not the card's. ``--profile`` then traces one more
step with ``torch.profiler`` and prints a second line: the step's wall
time, the device's busy time and idle share, and device time by kernel
group (flash kernels, GEMMs, the rest).

Llama-3-8B does not train this way on one card: its f32 params,
gradients and two AdamW moments alone are ~128 GB, over the card's 80.

Importing this module does nothing: all work is under ``__main__``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import time
from typing import Dict, List

import torch

METRIC = "llama_train_step_mfu"
#: the repo's MFU target (BASELINE.md), the denominator of vs_baseline
TARGET_MFU = 0.40


def pick_config(device_type: str):
    """``(cfg, batch_size, seq_len, steps, warmup)``, as ``bench.py``'s
    ``pick_config`` sizes them: the ~350M Llama on the card, the tiny
    config on the CPU."""
    from lzy_tpu_torch.models.llama import LlamaConfig

    if device_type == "cuda":
        cfg = LlamaConfig(
            vocab_size=32_768, d_model=1024, n_layers=20, n_heads=8,
            n_kv_heads=8, d_ff=4096, max_seq_len=2048,
            dtype=torch.bfloat16, param_dtype=torch.float32,
            remat=True, remat_policy="nothing", fused_ce=True,
            tie_embeddings=True, use_flash_kernel=True)
        return cfg, 16, 2048, 10, 3
    cfg = dataclasses.replace(LlamaConfig.tiny(vocab_size=2048),
                              param_dtype=torch.float32)
    return cfg, 4, 128, 3, 1


@dataclasses.dataclass
class TrainRun:
    cfg: object
    state: object
    step: object
    loss_fn: object
    batch: Dict[str, torch.Tensor]
    n_params: int
    steps: int
    warmup: int


def setup(device="cuda", seed: int = 0) -> TrainRun:
    """Model with random weights from ``seed``, AdamW at optax's defaults,
    the train step and one batch of synthetic tokens (the same batch every
    step, as ``bench.py`` does)."""
    from lzy_tpu_torch.device import resolve_device
    from lzy_tpu_torch.models.common import count_params
    from lzy_tpu_torch.models.llama import init_params, make_loss_fn
    from lzy_tpu_torch.parallel.train import (
        TrainState, adamw, make_train_step)

    dev = resolve_device(device)
    cfg, batch_size, seq_len, steps, warmup = pick_config(dev.type)
    model = init_params(cfg, seed, dev, trainable=True)
    loss_fn = make_loss_fn(cfg)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    tokens = torch.randint(0, cfg.vocab_size, (batch_size, seq_len),
                           generator=gen, device=dev, dtype=torch.int32)
    return TrainRun(cfg=cfg, state=TrainState.create(model, adamw(3e-4)),
                    step=make_train_step(loss_fn), loss_fn=loss_fn,
                    batch={"tokens": tokens}, n_params=count_params(model),
                    steps=steps, warmup=warmup)


def run_steps(run: TrainRun, n: int) -> List[float]:
    """``n`` train steps; returns their losses (one sync, at the end)."""
    losses = []
    for _ in range(n):
        run.state, metrics = run.step(run.state, run.batch)
        losses.append(metrics["loss"])
    return [float(x) for x in losses]


def card() -> str:
    """``name, power limit`` as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def measure(run: TrainRun) -> dict:
    """Time the run's steps after its warmup; the result line."""
    from lzy_tpu_torch.parallel.train import mfu

    dev = run.batch["tokens"].device
    first = run_steps(run, run.warmup)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    steps = run.steps
    t0 = time.perf_counter()
    losses = run_steps(run, steps)        # ends on a host read: synced
    dt = time.perf_counter() - t0
    b, t = run.batch["tokens"].shape
    tokens_per_s = b * t * steps / dt
    chip = "h100-sxm" if dev.type == "cuda" else "cpu"
    value = mfu(tokens_per_s, run.n_params, 1, chip=chip)
    return {"metric": METRIC, "value": value, "unit": "mfu_fraction",
            "vs_baseline": value / TARGET_MFU,
            "step_ms": 1e3 * dt / steps, "tokens_per_s": tokens_per_s,
            "params": run.n_params, "batch": b, "seq_len": t,
            "losses": first + losses, "peak": chip,
            "card": card() if dev.type == "cuda" else "cpu"}


def _group(kernel: str) -> str:
    name = kernel.lower()
    if "flash_fwd" in name or "fwd_kernel" in name or "fwd_wgmma" in name:
        return "flash forward"
    if "dq_kernel" in name:
        return "flash dQ"
    if "dkv_kernel" in name:
        return "flash dK/dV"
    if "gemm" in name or "nvjet" in name or "cutlass" in name \
            or "splitk" in name:
        return "GEMM"
    if "multi_tensor_apply" in name:     # the _foreach ops of AdamW
        return "optimizer"
    return "other"


def profile_step(run: TrainRun) -> dict:
    """One traced step (after ``measure``'s warmup): device time by
    kernel group, device busy time, wall time and the idle share."""
    from torch.profiler import ProfilerActivity, profile

    dev = run.batch["tokens"].device
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_steps(run, 1)
        wall = time.perf_counter() - t0
    groups: Dict[str, float] = {}
    other: Dict[str, float] = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", 0.0)
        if us and ev.device_type == torch.autograd.DeviceType.CUDA:
            group = _group(ev.key)
            groups[group] = groups.get(group, 0.0) + us
            if group == "other":
                other[ev.key[:80]] = other.get(ev.key[:80], 0.0) + us
    busy_ms = sum(groups.values()) / 1e3
    top = sorted(other.items(), key=lambda kv: -kv[1])[:12]
    return {"profile": {"wall_ms": wall * 1e3, "device_busy_ms": busy_ms,
                        "idle_share": 1.0 - busy_ms / (wall * 1e3),
                        "device_ms_by_group": {k: v / 1e3 for k, v in
                                               sorted(groups.items())},
                        "top_other_ms": {k: v / 1e3 for k, v in top}}}


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(prog="python -m lzy_tpu_torch.train",
                                     description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--profile", action="store_true",
                        help="then trace one step (on the card)")
    args = parser.parse_args(argv)
    if args.profile and args.device == "cpu":
        parser.error("--profile measures the card: it needs --device cuda")
    run = setup(args.device)
    print(json.dumps(measure(run)), flush=True)
    if args.profile:
        print(json.dumps(profile_step(run)), flush=True)


if __name__ == "__main__":
    main()
