#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``lzy_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. Phases, each
failing the run (non-zero exit, no result line) on a miss:

1. device — needs CUDA; prints ``nvidia-smi``'s name and power limit;
2. build — compiles every kernel under ``lzy_tpu_torch/csrc`` with nvcc;
3. kernels — the paged-attention kernel against its plain PyTorch
   version on the card at the main path's shapes (Llama-3-8B heads,
   page 16, bf16 and int8 pools, f32 compute over f32 and int8 pools for
   a tight check, T in {1,
   gamma+1, 64}, a row past 1024 visible slots), with the tolerance
   stated per case; then times at the decode shape: the kernel, the
   plain version, ``scaled_dot_product_attention`` over K/V pre-gathered
   to the dense layout (a yardstick the port never calls) and the bound;
4. serving — ``service.inference.build_engine("llama3_8b")`` at full
   width and depth (bf16, random weights from a seed) answers 8 requests
   (128-512-token prompts, two sharing a 256-token prefix, 32 new tokens
   each) through ``PagedInferenceEngine``; the kernel's launch count is
   reset just before and read just after. Checks: every reply ok, the
   radix cache reused the shared prefix, launches == layers x forwards,
   and for every request: its greedy tokens equal the ``generate()``
   oracle up to the first step whose oracle top-2 logit gap is below
   ``GAP_TOL_BF16`` (the logits finite), and at each of its steps the
   token it emitted is within ``GAP_TOL_BF16`` of the best logit of the
   oracle's dense path fed the same tokens (teacher forcing);
5. small — the tiny config in f32 on the card: engine (through the
   kernel) against the oracle, under the same rule at ``GAP_TOL_F32``.

Prints a ``{"kernels": [...]}`` line, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``. Long detail goes to stderr.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent

#: H100 SXM published peaks (NVIDIA data sheet; dense, 700 W)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12

SEED = 0
SLOTS = 8
PAGE = 16
GAMMA = 4
KV_POOL_BYTES = 16 << 30
N_NEW = 32
#: greedy oracle rule, bf16 at 8B: the dense oracle (batch 1) and the
#: paged engine (batch 8, T=64 prefill chunks) run different GEMM shapes,
#: whose bf16 roundings move logits by up to ~0.1 here; a step whose
#: top-2 gap is below this may legitimately flip
GAP_TOL_BF16 = 0.25
#: the same rule in f32 (tiny config): sums in other orders, ~1e-5
GAP_TOL_F32 = 1e-3


def log(*args):
    print(*args, file=sys.stderr, flush=True)


def fail(msg):
    log(f"chip_smoke: FAIL: {msg}")
    sys.exit(1)


def device_phase(torch):
    if not torch.cuda.is_available():
        fail("CUDA is not available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    line = smi.stdout.strip().splitlines()[0]
    log(f"device: {torch.cuda.get_device_name(0)} ({line}); torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    return line


def build_phase():
    from lzy_tpu_torch.ops import build

    t0 = time.monotonic()
    libs = build.build_all()
    log(f"build: {len(libs)} kernel(s) in {time.monotonic() - t0:.1f} s")
    for name in libs:
        for ln in build.build_log(name).splitlines():
            if "registers" in ln or "spill" in ln:
                log(f"  {name}: {ln.strip()}")
    return libs


# -- kernel phase ----------------------------------------------------------


def _kernel_inputs(torch, *, t, dtype, quant, lengths, n_blocks, seed):
    """Llama-3-8B attention shapes: q [B, T, 32, 128], pools [N, 16, 8,
    128], per-row page tables over distinct random blocks (scattered
    through the pool), positions ending at ``lengths``."""
    from lzy_tpu_torch.ops import paged_attention as pa

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    b, h, kv, d = len(lengths), 32, 8, 128
    pages = 8192 // PAGE
    cdt = torch.float32 if dtype == "float32" else torch.bfloat16
    q = torch.randn((b, t, h, d), generator=gen, device=dev).to(cdt)
    k = torch.randn((n_blocks, PAGE, kv, d), generator=gen, device=dev)
    v = torch.randn((n_blocks, PAGE, kv, d), generator=gen, device=dev)
    perm = torch.randperm(n_blocks - 1, generator=gen, device=dev) + 1
    table = torch.zeros((b, pages), dtype=torch.int32, device=dev)
    at = 0
    for row, n in enumerate(lengths):
        need = -(-n // PAGE)
        table[row, :need] = perm[at:at + need].to(torch.int32)
        at += need
    pos = (torch.tensor(lengths, device=dev)[:, None] - t
           + torch.arange(t, device=dev)[None, :]).to(torch.int32)
    side = None
    if quant:
        kq, ks, kz = pa.quantize_kv(k)
        vq, vs, vz = pa.quantize_kv(v)
        k, v, side = kq, vq, pa.KVQuant(ks, kz, vs, vz)
    else:
        k, v = k.to(cdt), v.to(cdt)
    return dict(q=q, k=k, v=v, table=table, pos=pos, side=side, cdt=cdt)


def _tolerance(dtype):
    """``(atol, rtol)`` against ``|plain|``. f32 compute (f32 pools, or
    int8 pools dequantized to f32): both sides sum f32 products in
    different orders. bf16 compute (bf16 pools, or int8 pools dequantized
    to bf16): the output is rounded to bf16 on both sides (one ulp is at
    most 2^-7 of |out|, under rtol 1e-2), and a probability whose f32
    score differs in its last bits may round to a neighbouring bf16 value
    before P.V, moving the output by 2^-8 of that probability's share of
    |v| (under atol 2e-3). Outputs are softmax-weighted means of N(0, 1)
    values, about 0.04 at 1500 visible slots, so the limit must follow
    |plain|: a fixed 2e-2 would pass a wrong mask or dequantization."""
    return (1e-5, 1e-5) if dtype == "float32" else (2e-3, 1e-2)


def _time_ms(torch, fn, iters=20):
    """Mean device time per call by CUDA events, with a 128 MiB write
    between calls so every call finds K/V cold in L2 (as a decode layer
    does: 32 layers' pools do not fit the 50 MB L2)."""
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        times.append((a, b))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in times) / iters


def _bound_ms(inp, lengths):
    """Least time for the work: the visible K/V bytes (each token's K and
    V once, plus int8 sidecars), q, the output, page-table entries and
    positions, over HBM bandwidth — or the QK and PV flops over the peak
    rate for the compute dtype, whichever is larger."""
    q, k = inp["q"], inp["k"]
    b, t, h, d = q.shape
    kv = k.shape[2]
    elem = k.element_size()
    tokens = sum(lengths)
    kv_bytes = tokens * kv * d * 2 * elem
    if inp["side"] is not None:
        kv_bytes += tokens * kv * 4 * 4
    io = 2 * q.numel() * q.element_size()
    meta = sum(-(-n // PAGE) for n in lengths) * 4 + b * t * 4
    nbytes = kv_bytes + io + meta
    # per query row (b, t): positions 0..pos visible, QK and PV 2 flops
    # per multiply-add over d, for all h heads
    pos = inp["pos"].cpu()
    flops = 4 * h * d * int((pos.long() + 1).sum())
    peak = F32_FLOPS if q.element_size() == 4 else BF16_FLOPS
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(by_bytes, by_ops) * 1e3, ("bytes" if by_bytes >= by_ops
                                         else "operations")


def _library_call(torch, inp, lengths):
    """``scaled_dot_product_attention`` on the same inputs with K/V
    gathered to the dense layout beforehand (the gather is not timed)."""
    import torch.nn.functional as F

    from lzy_tpu_torch.ops.paged_attention import dequantize_kv

    q, k, v, table, pos = (inp[x] for x in ("q", "k", "v", "table", "pos"))
    L = max(lengths)
    pages = -(-L // PAGE)
    pt = table[:, :pages].long()
    keys, vals = k[pt], v[pt]
    if inp["side"] is not None:
        s = inp["side"]
        keys = dequantize_kv(keys, s.k_scale[pt], s.k_zp[pt], inp["cdt"])
        vals = dequantize_kv(vals, s.v_scale[pt], s.v_zp[pt], inp["cdt"])
    b = q.shape[0]
    keys = keys.reshape(b, pages * PAGE, *k.shape[2:])[:, :L]
    vals = vals.reshape(b, pages * PAGE, *k.shape[2:])[:, :L]
    qh = q.transpose(1, 2).contiguous()              # [B, H, T, D]
    kh = keys.transpose(1, 2).contiguous()           # [B, KV, L, D]
    vh = vals.transpose(1, 2).contiguous()
    mask = (torch.arange(L, device=q.device)[None, None, None, :]
            <= pos[:, None, :, None])                # [B, 1, T, L]
    return lambda: F.scaled_dot_product_attention(
        qh, kh, vh, attn_mask=mask, enable_gqa=True)


KERNEL_CASES = [
    # (name, T, dtype, int8 pool, visible lengths per row)
    ("decode-bf16", 1, "bfloat16", False,
     [1500, 700, 320, 1100, 150, 410, 980, 530]),
    ("decode-int8", 1, "bfloat16", True,
     [1500, 700, 320, 1100, 150, 410, 980, 530]),
    ("decode-f32", 1, "float32", False,
     [1500, 700, 320, 1100, 150, 410, 980, 530]),
    ("decode-int8-f32", 1, "float32", True,
     [1500, 700, 320, 1100, 150, 410, 980, 530]),
    ("verify-bf16", GAMMA + 1, "bfloat16", False,
     [1300, 600, 260, 900, 180, 450, 700, 333]),
    ("verify-int8", GAMMA + 1, "bfloat16", True,
     [1300, 600, 260, 900, 180, 450, 700, 333]),
    ("chunk-bf16", 64, "bfloat16", False, [1100, 512]),
    ("chunk-int8", 64, "bfloat16", True, [1100, 512]),
    ("chunk-f32", 64, "float32", False, [1100, 512]),
]


def kernel_phase(torch):
    from lzy_tpu_torch.ops import paged_attention as pa

    torch.backends.cuda.matmul.allow_tf32 = False     # full f32 reference
    torch.backends.cudnn.allow_tf32 = False
    n_blocks = 1024
    worst = 0.0
    rows = []
    decode = None
    for i, (name, t, dtype, quant, lengths) in enumerate(KERNEL_CASES):
        inp = _kernel_inputs(torch, t=t, dtype=dtype, quant=quant,
                             lengths=lengths, n_blocks=n_blocks, seed=i)
        args = (inp["q"], inp["k"], inp["v"], inp["table"], inp["pos"])
        kw = dict(dtype=inp["cdt"], quant=inp["side"])
        got = pa.paged_attention(*args, **kw)
        want = pa.paged_attention_plain(*args, **kw)
        torch.cuda.synchronize()
        if not torch.isfinite(got).all():
            fail(f"kernel {name}: non-finite output")
        err = (got.float() - want.float()).abs()
        atol, rtol = _tolerance(dtype)
        limit = atol + rtol * want.float().abs()
        max_err = float(err.max())
        ok = bool((err <= limit).all())
        log(f"kernel {name}: max_abs_err {max_err:.3e} (tol {atol:g} + "
            f"{rtol:g}*|plain|) {'ok' if ok else 'MISS'}")
        if not ok:
            fail(f"kernel {name} disagrees with its plain version")
        worst = max(worst, max_err)
        ms = _time_ms(torch, lambda: pa.paged_attention(*args, **kw))
        plain_ms = _time_ms(torch,
                            lambda: pa.paged_attention_plain(*args, **kw),
                            iters=5)
        lib_ms = _time_ms(torch, _library_call(torch, inp, lengths))
        bound, by = _bound_ms(inp, lengths)
        row = dict(case=name, T=t, rows=len(lengths), ms=ms,
                   plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound,
                   bound_by=by, max_abs_err=max_err)
        rows.append(row)
        log("  " + json.dumps(row))
        if name == "decode-bf16":
            decode = row
    return worst, decode, rows


# -- serving phase ---------------------------------------------------------


def _prompts(vocab, rng):
    """8 prompts of 128-512 tokens; the last two share a 256-token
    prefix."""
    lengths = [128, 192, 256, 320, 384, 512, 300, 420]
    prompts = [[int(x) for x in rng.integers(0, vocab, n)] for n in lengths]
    shared = prompts[6][:256]
    prompts[7] = shared + prompts[7][256:]
    return prompts, 256


def _top2_rule(oracle_tokens, tokens, logits, tol):
    """Steps compared: those agreed before a divergence, plus the
    divergence, which must sit where the oracle's top-2 logit gap is
    below ``tol``."""
    for i, (a, b) in enumerate(zip(oracle_tokens, tokens)):
        if a != b:
            top2 = logits[i].topk(2).values
            gap = float(top2[0] - top2[1])
            if gap >= tol:
                fail(f"greedy tokens diverge from the oracle at step {i} "
                     f"where the oracle's top-2 gap is {gap:.4g} >= {tol}")
            log(f"  divergence at step {i}, oracle top-2 gap "
                f"{gap:.4g} < {tol}")
            return i + 1
    return len(tokens)


def _teacher_forced(torch, model, prompt, tokens, tol):
    """Every step of one reply, after its first divergence too: the
    oracle's dense path (batch 1, a dense cache) runs the prompt and then
    the reply's own tokens as one chunk, giving the logits each emitted
    token was chosen from. A greedy engine's token must be within ``tol``
    of the best of them (engine and oracle logits differ by rounding
    only). Returns (steps whose token is not the oracle's argmax, the
    largest shortfall below the best logit)."""
    from lzy_tpu_torch.models.generate import batched_prefill
    from lzy_tpu_torch.models.llama import DenseKVCache

    cfg = model.cfg
    emitted = torch.tensor([tokens], device="cuda")
    with torch.no_grad():
        cache = DenseKVCache(cfg, 1, "cuda")
        first = batched_prefill(model, cache, prompt, chunk=64,
                                max_seq_len=cfg.max_seq_len)
        start = torch.tensor([prompt.shape[1]], dtype=torch.int32,
                             device="cuda")
        rest = model(emitted[:, :-1], cache=cache, starts=start)
    logits = torch.cat([first[:, None], rest], dim=1)[0]    # [steps, V]
    if not torch.isfinite(logits).all():
        fail("teacher-forced oracle logits are not finite")
    chosen = logits.gather(1, emitted[0][:, None])[:, 0]
    short = logits.max(dim=1).values - chosen
    worst = float(short.max())
    if worst >= tol:
        step = int(short.argmax())
        fail(f"step {step}: the emitted token's logit is {worst:.4g} below "
             f"the oracle's best (>= {tol})")
    return int((short > 0).sum()), worst


def _logit_spread(torch, eng, prompt, want):
    """What backs ``GAP_TOL_BF16``: the checked prompt's first-token
    logits through the oracle's dense path at batch 8 (other GEMM
    shapes) and through a paged pool read by the kernel, each against
    the oracle's batch-1 dense logits ``want``."""
    from lzy_tpu_torch.models.generate import batched_prefill
    from lzy_tpu_torch.models.llama import DenseKVCache, PagedKVPool

    cfg, n = eng.cfg, prompt.shape[1]
    with torch.no_grad():
        l8 = batched_prefill(eng.model, DenseKVCache(cfg, 8, "cuda"),
                             prompt.expand(8, -1), chunk=64,
                             max_seq_len=cfg.max_seq_len)
        blocks = -(-n // PAGE)
        pool = PagedKVPool(cfg, blocks + 1, PAGE, device="cuda")
        table = torch.zeros((1, cfg.max_seq_len // PAGE), dtype=torch.int32,
                            device="cuda")
        table[0, :blocks] = torch.arange(1, blocks + 1, dtype=torch.int32)
        lp = batched_prefill(eng.model, pool, prompt, chunk=64,
                             max_seq_len=cfg.max_seq_len, page_table=table)
    return {"dlogit_batch8": float((l8 - want).abs().max()),
            "dlogit_paged": float((lp[0] - want).abs().max())}


def serving_phase(torch, np):
    from lzy_tpu_torch.models.generate import generate
    from lzy_tpu_torch.ops import paged_attention as pa
    from lzy_tpu_torch.service.inference import build_engine

    t0 = time.monotonic()
    eng = build_engine("llama3_8b", seed=SEED, device="cuda", slots=SLOTS,
                       page_size=PAGE, kv_pool_bytes=KV_POOL_BYTES,
                       spec_tokens=GAMMA, prefill_chunk=64, start=True)
    cfg = eng.cfg
    log(f"serving: Llama-3-8B ({cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, vocab {cfg.vocab_size}) built and warmed in "
        f"{time.monotonic() - t0:.1f} s; pool {eng._kv_blocks} blocks "
        f"({eng._cache.nbytes() / 2**30:.2f} GiB), kernel "
        f"{eng.kernel_path}")
    if eng.kernel_path != "cuda":
        fail(f"engine resolved kernel {eng.kernel_path!r}, not the kernel")
    prompts, shared = _prompts(cfg.vocab_size, np.random.default_rng(SEED))

    pa.paged_attention.launches = 0
    calls0 = eng.forward_calls
    t_submit = time.monotonic()
    reqs = [eng.submit(p, max_new_tokens=N_NEW, request_id=f"r{i}")
            for i, p in enumerate(prompts)]
    for r in reqs:
        if not r.wait(600):
            fail(f"request {r.id} did not finish in 600 s")
    wall = time.monotonic() - t_submit
    launches = pa.paged_attention.launches
    forwards = eng.forward_calls - calls0

    for r in reqs:
        if r.status != "ok" or len(r.tokens) != N_NEW:
            fail(f"request {r.id}: status {r.status} error {r.error} "
                 f"tokens {len(r.tokens)}")
    stats = eng.stats()
    if stats.prefill_tokens_saved < shared - PAGE:
        fail(f"radix cache saved {stats.prefill_tokens_saved} prefill "
             f"tokens; the shared prefix is {shared}")
    if launches <= 0 or launches != cfg.n_layers * forwards:
        fail(f"kernel launches {launches} != {cfg.n_layers} layers x "
             f"{forwards} forwards")
    ttft = [r.first_token_at - r.submitted_at for r in reqs]
    decode_tps = eng.decode_tokens / eng.decode_seconds
    result = dict(
        requests=len(reqs), new_tokens=N_NEW * len(reqs), wall_s=wall,
        decode_tokens_per_s=decode_tps, decode_rounds=eng.decode_steps,
        verify_rounds=eng.spec_steps, spec_accepted=eng.spec_accepted,
        ttft_mean_s=sum(ttft) / len(ttft), ttft_max_s=max(ttft),
        prefill_tokens_saved=stats.prefill_tokens_saved,
        forwards=forwards, launches=launches)
    log("serving: " + json.dumps(result))

    # every request against the generate() oracle, then teacher-forced
    compared, off_argmax, shortfall = 0, 0, 0.0
    for r in reqs:
        prompt = torch.tensor([r.prompt], device="cuda")
        out, logits = generate(eng.model, prompt, max_new_tokens=N_NEW,
                               return_logits=True)
        if out.shape != (1, len(r.prompt) + N_NEW):
            fail(f"oracle output shape {tuple(out.shape)}")
        if not torch.isfinite(logits).all():
            fail("oracle logits are not finite")
        steps = _top2_rule(out[0, len(r.prompt):].tolist(), r.tokens,
                           logits[0], GAP_TOL_BF16)
        off, worst = _teacher_forced(torch, eng.model, prompt, r.tokens,
                                     GAP_TOL_BF16)
        log(f"serving: request {r.id}: {steps}/{N_NEW} steps compared "
            f"with generate(); teacher-forced, {off}/{N_NEW} tokens off "
            f"the oracle's argmax, at most {worst:.4g} below it")
        compared += steps
        off_argmax += off
        shortfall = max(shortfall, worst)
    result.update(oracle_steps_compared=compared,
                  teacher_forced_steps=N_NEW * len(reqs),
                  teacher_forced_off_argmax=off_argmax,
                  teacher_forced_max_shortfall=shortfall)
    result.update(_logit_spread(torch, eng, prompt, logits[0, 0]))
    if max(result["dlogit_batch8"], result["dlogit_paged"]) >= GAP_TOL_BF16:
        fail(f"bf16 logit spread {result} is not below GAP_TOL_BF16")
    log(f"serving: first-token logit spread vs the oracle: batch 8 "
        f"{result['dlogit_batch8']:.4g}, paged kernel path "
        f"{result['dlogit_paged']:.4g} (GAP_TOL_BF16 {GAP_TOL_BF16})")
    eng.close()
    return launches, result


def small_phase(torch):
    """Tiny config in f32 on the card: engine through the kernel against
    the oracle (the kernel at head dim 16)."""
    import dataclasses

    from lzy_tpu_torch.models.generate import generate
    from lzy_tpu_torch.models.llama import LlamaConfig
    from lzy_tpu_torch.service.inference import build_engine

    cfg = dataclasses.replace(LlamaConfig.tiny(vocab_size=512),
                              dtype=torch.float32, param_dtype=torch.float32)
    eng = build_engine("tiny", cfg=cfg, seed=SEED, device="cuda", slots=3,
                       page_size=4, spec_tokens=GAMMA, start=False)
    prompts = [[5, 9, 3, 7, 2], list(range(1, 40)), [7] * 30]
    reqs = [eng.submit(p, max_new_tokens=24) for p in prompts]
    for _ in range(500):
        if all(r.done for r in reqs):
            break
        eng.step()
    for prompt, r in zip(prompts, reqs):
        if r.status != "ok":
            fail(f"small: request {r.id} {r.status} {r.error}")
        out, logits = generate(eng.model, torch.tensor([prompt],
                                                       device="cuda"),
                               max_new_tokens=24, return_logits=True)
        steps = _top2_rule(out[0, len(prompt):].tolist(), r.tokens,
                           logits[0], GAP_TOL_F32)
        log(f"small: prompt of {len(prompt)}: {steps}/24 steps compared")


def main():
    if not (REPO / "lzy_tpu_torch" / "csrc").is_dir():
        fail(f"no lzy_tpu_torch/ next to {Path(__file__).name}: run it "
             f"from a checkout of the repository")
    sys.path.insert(0, str(REPO))
    import numpy as np
    import torch

    smi = device_phase(torch)
    build_phase()
    worst, decode, rows = kernel_phase(torch)
    launches, serving = serving_phase(torch, np)
    small_phase(torch)
    kernels = {"kernels": [{
        "name": "paged_attention", "route": "cuda",
        "source": "lzy_tpu_torch/csrc/paged_attention.cu",
        "replaces": "lzy_tpu/ops/paged_attention.py:199",
        "launches": launches, "max_abs_err": worst,
        "ms": decode["ms"], "plain_ms": decode["plain_ms"],
        "bound_ms": decode["bound_ms"], "bound_by": decode["bound_by"],
        "library_ms": decode["library_ms"]}]}
    log("kernel cases: " + json.dumps(rows))
    print(json.dumps({"serving": serving}))
    print(json.dumps(kernels))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
