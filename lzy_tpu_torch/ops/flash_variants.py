"""Time the bf16 flash backward kernels for ``csrc/flash_attention.cu``
and variants of it, in turns on one card.

    python -m lzy_tpu_torch.ops.flash_variants base= name=SPEC ...

Each ``SPEC`` is a comma-separated list of nvcc flags (``-DNAME=VALUE``)
and at most one alternative source (``@path/to/file.cu``); ``base=`` is
the committed source as it is. Every variant is built at once (one nvcc
each, under ``lzy_tpu_torch/_build/variants/``) and its ptxas lines for
the wgmma dQ and dK/dV kernels (registers, spills) are printed. Then each
variant runs in a child process with a timeout, so that a kernel that
never finishes cannot hold the card, in the order given and again in
reverse: it holds dQ, dK and dV to the plain version on masked cases and
at the train step's shape (16 x 8 heads, T 2048, d 128, causal; worst
row relative L2), runs them twice for equal bits, and times them with
CUDA events after a 128 MB L2 flush (``chip_smoke.py``'s timer). One
``RESULT`` JSON line per run. Needs a CUDA card and nvcc; nothing runs at
import.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

CHILD_TIMEOUT_S = 200

CHILD = r'''
import ctypes, json, sys
import torch
from lzy_tpu_torch.ops import build, flash_attention as fa

lib = ctypes.CDLL(sys.argv[1])
build.load = lambda name: lib
dev = "cuda"


def worst_row(got, want):
    d = got.shape[-1]
    g, w = got.double().reshape(-1, d), want.double().reshape(-1, d)
    err, norm = (g - w).norm(dim=-1), w.norm(dim=-1)
    floor = 1e-2 * float(norm.pow(2).mean().sqrt())
    return float((err / norm.clamp_min(max(floor, 1e-30))).max())


def inputs(b, h, t, d, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn((b, h, t, d), generator=g, device=dev)
            .to(torch.bfloat16) for _ in range(4)], g


worst = 0.0
for b, h, t, d, causal, mask, seg in [(2, 2, 640, 128, False, True, True),
                                      (2, 2, 1000, 128, True, False, False),
                                      (1, 2, 384, 64, False, True, False),
                                      (2, 2, 512, 128, True, False, True)]:
    (q, k, v, do), g = inputs(b, h, t, d, 3)
    km = sg = None
    if mask:
        km = torch.rand((b, t), generator=g, device=dev) < 0.7
        km[-1] = False
    if seg:
        sg = torch.zeros((b, t), dtype=torch.int32, device=dev)
        sg[:, t // 5:t // 2] = 1
        sg[:, 2 * t // 3:] = 2
    bias, bounds = fa._mask_operands(q, km, sg)
    kw = dict(scale=d ** -0.5, causal=causal)
    o, lse = fa.flash_fwd(q, k, v, bias, bounds, **kw)
    delta = fa.flash_delta(o, do)
    got = (fa.flash_bwd_dq(q, k, v, bias, bounds, lse, delta, do, **kw),
           *fa.flash_bwd_dkv(q, k, v, bias, bounds, lse, delta, do, **kw))
    want = fa._bwd_plain_from_delta(q, k, v, bias, bounds, lse, delta, do,
                                    kw["scale"], causal)
    worst = max(worst, *(worst_row(x, w) for x, w in zip(got, want)))

(q, k, v, do), _ = inputs(16, 8, 2048, 128, 0)
kw = dict(scale=128 ** -0.5, causal=True)
o, lse = fa.flash_fwd(q, k, v, None, None, **kw)
delta = fa.flash_delta(o, do)
args = (q, k, v, None, None, lse, delta, do)


def both():
    return (fa.flash_bwd_dq(*args, **kw), *fa.flash_bwd_dkv(*args, **kw))


def time_ms(fn, iters=20):
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    marks = []
    for _ in range(iters):
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        e.record()
        marks.append((a, e))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(e) for a, e in marks) / iters


first, second = both(), both()
want = fa._bwd_plain_from_delta(*(x[:2] for x in args[:3]), None, None,
                                lse[:2], delta[:2], do[:2], kw["scale"],
                                True)
worst = max(worst, *(worst_row(x[:2], w) for x, w in zip(first, want)))
print("RESULT", json.dumps(dict(
    worst_row=worst,
    repeat=all(torch.equal(a, b) for a, b in zip(first, second)),
    dq=time_ms(lambda: fa.flash_bwd_dq(*args, **kw)),
    dkv=time_ms(lambda: fa.flash_bwd_dkv(*args, **kw)))))
'''


def _parse(argv):
    variants = {}
    for arg in argv:
        name, _, spec = arg.partition("=")
        variants[name] = [f for f in spec.split(",") if f]
    return variants


def _compile(name, spec, out_dir):
    from lzy_tpu_torch.ops import build

    sources = [f[1:] for f in spec if f.startswith("@")]
    flags = [f for f in spec if not f.startswith("@")]
    src = sources[0] if sources else str(
        build.CSRC_DIR / "flash_attention.cu")
    lib = out_dir / f"lib_{name}.so"
    proc = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, *flags, "-o",
                           str(lib), src], stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    return lib, proc.returncode, proc.stdout


def _ptxas_lines(log):
    lines = log.splitlines()
    for i, ln in enumerate(lines):
        if "rror" in ln or "C751" in ln:
            yield ln[:300]
        if "Compiling entry" in ln and ("dq_wgmma" in ln
                                        or "dkv_wgmma" in ln):
            kernel = "dq" if "dq_wgmma" in ln else "dkv"
            dp = "128" if "ILi128E" in ln else "64"
            yield (f"{kernel}<{dp}>: "
                   + " | ".join(x.strip() for x in lines[i + 1:i + 3]))


def main(argv):
    from lzy_tpu_torch.ops import build

    variants = _parse(argv) or {"base": []}
    out_dir = build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.monotonic()
    with ThreadPoolExecutor(len(variants)) as pool:
        built = dict(zip(variants, pool.map(
            lambda item: _compile(*item, out_dir), variants.items())))
    print(f"built {len(built)} variant(s) in {time.monotonic() - t0:.1f} s",
          flush=True)
    runnable = []
    for name, (lib, rc, log) in built.items():
        print(f"== {name}: nvcc rc {rc}")
        for ln in _ptxas_lines(log):
            print("  ", ln)
        if rc == 0:
            runnable.append((name, lib))
    sys.stdout.flush()
    repo = str(build.PKG_DIR.parent)
    for name, lib in runnable + runnable[::-1]:
        try:
            proc = subprocess.run([sys.executable, "-c", CHILD, str(lib)],
                                  cwd=repo, timeout=CHILD_TIMEOUT_S,
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True,
                                  env={**os.environ, "PYTHONPATH": repo})
            found = [ln for ln in proc.stdout.splitlines()
                     if ln.startswith("RESULT")]
            print(f"{name}: rc {proc.returncode} "
                  f"{found[0] if found else proc.stdout[-2000:]}",
                  flush=True)
        except subprocess.TimeoutExpired:
            print(f"{name}: timed out after {CHILD_TIMEOUT_S} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
