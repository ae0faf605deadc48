"""The port's train step (lzy_tpu_torch/models/llama.make_loss_fn,
lzy_tpu_torch/parallel/train.py) held to the JAX reference.

``LlamaConfig.tiny`` at f32 on the CPU, the same weights on both sides
(the reference's ``init_params`` draws them, ``models/convert.py`` copies
them into the port):

- loss and every gradient leaf (mapped back through
  ``convert.grads_to_reference``) against ``jax.value_and_grad`` of the
  reference's ``make_loss_fn(cfg)`` — called with no mesh and no
  donation; the reference's ``make_train_step`` is never built — for the
  plain attention path, ``fused_ce``, packed segments with a mask, and
  ``use_flash_kernel`` at T=128 (the reference's Pallas kernels in
  interpret mode, the port's plain flash versions);
- per-layer remat gives exactly the result of no remat;
- three AdamW steps of the port's ``make_train_step`` against optax's
  ``adamw`` ``update`` and ``apply_updates`` applied to the reference's
  gradients; gradient accumulation against the mean of the micro-batches;
- ``mfu`` and ``count_params`` against the reference's.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from lzy_tpu_torch.models import convert
from lzy_tpu_torch.models.common import count_params
from lzy_tpu_torch.models.llama import LlamaConfig, init_params, make_loss_fn
from lzy_tpu_torch.parallel import train

torch.set_num_threads(1)

VOCAB = 64
#: f32 forward and backward through two layers on both sides: the same
#: math with products and reductions summed in other orders. The loss is
#: ~4.2 and gradient leaves are up to ~0.15 in magnitude; measured: loss
#: within 1e-6, gradient leaves within 1.3e-7
ATOL = 5e-6
RTOL = 1e-5
#: parameters after three AdamW steps (lr 3e-4): the update divides by
#: sqrt(v_hat), so a relative gradient error of ~1e-6 moves an update by
#: about as much relative to lr (measured: within 8e-7)
PARAM_ATOL = 2e-6

#: name -> (port config changes, batch, seq len, segments, mask)
CASES = {
    "plain": (dict(), 2, 64, False, False),
    "fused_ce": (dict(fused_ce=True), 2, 64, False, False),
    "segments": (dict(), 2, 64, True, True),
    "flash": (dict(use_flash_kernel=True, fused_ce=True), 2, 128, True,
              False),
}


@pytest.fixture(autouse=True)
def _process_state_unchanged():
    """No test here may change process-wide state that a JAX test sharing
    this worker would read."""
    import jax

    def snap():
        # pytest itself rewrites PYTEST_CURRENT_TEST at every phase
        env = {k: v for k, v in os.environ.items()
               if k != "PYTEST_CURRENT_TEST"}
        return (jax.config.jax_enable_x64,
                jax.config.jax_default_matmul_precision, env,
                torch.get_default_dtype(), torch.is_grad_enabled())

    before = snap()
    yield
    assert snap() == before


def _batch(b, t, segmented, masked):
    rng = np.random.default_rng(b * 1000 + t + 10 * segmented + masked)
    batch = {"tokens": rng.integers(0, VOCAB, (b, t)).astype(np.int32)}
    if segmented:
        seg = np.zeros((b, t), np.int32)
        seg[:, t // 4:t // 2] = 1
        seg[:, t // 2:3 * t // 4] = 0        # a repeated, non-adjacent id
        seg[:, 3 * t // 4:] = 2
        batch["segments"] = seg
    if masked:
        batch["mask"] = rng.random((b, t)) < 0.8
    return batch


def _port_cfg(**changes):
    return dataclasses.replace(LlamaConfig.tiny(vocab_size=VOCAB),
                               dtype=torch.float32,
                               param_dtype=torch.float32, **changes)


def _ref_cfg(ref_llama, changes):
    import jax.numpy as jnp

    return dataclasses.replace(ref_llama.LlamaConfig.tiny(vocab_size=VOCAB),
                               dtype=jnp.float32, **changes)


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _port_model(cfg, params):
    return convert.load_reference(init_params(cfg, device="cpu",
                                              trainable=True), params)


@pytest.fixture(scope="module")
def ref():
    """Reference weights, and per case the loss and gradients, computed
    once; plus three optax AdamW steps on the plain case."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    import optax

    from lzy_tpu.models import llama as ref_llama, unbox

    base = _ref_cfg(ref_llama, {})
    boxed, _ = ref_llama.init_params(base, jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(np.asarray, unbox(boxed))
    out = {"params": params, "ref_llama": ref_llama, "cases": {}}
    for name, (changes, b, t, seg, mask) in CASES.items():
        batch = {k: jnp.asarray(v) for k, v in _batch(b, t, seg, mask).items()}
        loss_fn = ref_llama.make_loss_fn(_ref_cfg(ref_llama, changes))
        loss, grads = jax.value_and_grad(loss_fn)(params, batch)
        out["cases"][name] = (float(loss),
                              jax.tree_util.tree_map(np.asarray, grads))

    # three AdamW steps, optax applied directly (no make_train_step)
    loss_fn = jax.jit(jax.value_and_grad(ref_llama.make_loss_fn(base)))
    batch = {k: jnp.asarray(v) for k, v in _batch(2, 64, False, False).items()}
    tx = optax.adamw(3e-4)
    p = jax.tree_util.tree_map(jnp.asarray, params)
    opt_state = tx.init(p)
    losses = []
    for _ in range(3):
        loss, grads = loss_fn(p, batch)
        updates, opt_state = tx.update(grads, opt_state, p)
        p = optax.apply_updates(p, updates)
        losses.append(float(loss))
    out["adamw"] = (losses, jax.tree_util.tree_map(np.asarray, p))

    # gradient accumulation: the mean over two micro-batches of one
    batch = _batch(4, 64, False, False)
    micro = [{k: jnp.asarray(v[i * 2:(i + 1) * 2]) for k, v in batch.items()}
             for i in range(2)]
    results = [loss_fn(params, mb) for mb in micro]
    grads = jax.tree_util.tree_map(lambda a, b: (a + b) / 2,
                                   results[0][1], results[1][1])
    out["accum"] = (float(sum(r[0] for r in results) / 2),
                    float(optax.global_norm(grads)))
    return out


def _assert_tree_close(got, want, atol, rtol, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for key in want:
            _assert_tree_close(got[key], want[key], atol, rtol,
                               f"{path}/{key}")
        return
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=rtol, err_msg=path)


@pytest.mark.parametrize("name", list(CASES))
def test_loss_and_grads_match_reference(ref, name):
    changes, b, t, seg, mask = CASES[name]
    cfg = _port_cfg(**changes)
    model = _port_model(cfg, ref["params"])
    loss = make_loss_fn(cfg)(model, _torch_batch(_batch(b, t, seg, mask)))
    loss.backward()
    want_loss, want_grads = ref["cases"][name]
    assert abs(float(loss.detach()) - want_loss) <= ATOL, float(loss.detach())
    _assert_tree_close(convert.grads_to_reference(model), want_grads,
                       ATOL, RTOL)


@pytest.mark.parametrize("name", ["plain", "flash"])
def test_remat_gives_exactly_the_same_result(ref, name):
    changes, b, t, seg, mask = CASES[name]
    batch = _torch_batch(_batch(b, t, seg, mask))
    results = []
    for remat in (False, True):
        cfg = _port_cfg(**changes, remat=remat)
        model = _port_model(cfg, ref["params"])
        loss = make_loss_fn(cfg)(model, batch)
        loss.backward()
        results.append((loss.detach(), [p.grad.clone()
                                        for p in model.parameters()]))
    (l0, g0), (l1, g1) = results
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))


def test_unported_remat_policy_is_refused(ref):
    cfg = _port_cfg(remat=True, remat_policy="dots")
    model = _port_model(cfg, ref["params"])
    with pytest.raises(ValueError, match="not ported"):
        make_loss_fn(cfg)(model, _torch_batch(_batch(2, 64, False, False)))


def test_three_adamw_steps_match_optax(ref):
    cfg = _port_cfg()
    model = _port_model(cfg, ref["params"])
    state = train.TrainState.create(model, train.adamw())
    step = train.make_train_step(make_loss_fn(cfg))
    batch = _torch_batch(_batch(2, 64, False, False))
    losses = []
    for _ in range(3):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    want_losses, want_params = ref["adamw"]
    np.testing.assert_allclose(losses, want_losses, atol=ATOL)
    assert state.step == 3
    _assert_tree_close(convert.to_reference(model.state_dict(), cfg),
                       want_params, PARAM_ATOL, 0.0)


def test_adamw_hyperparameters_are_optax_defaults():
    opt = train.adamw()([torch.nn.Parameter(torch.zeros(2))])
    assert (opt.lr, opt.b1, opt.b2, opt.eps, opt.weight_decay) == \
        (3e-4, 0.9, 0.999, 1e-8, 1e-4)


def test_grad_accumulation_matches_mean_of_micro_batches(ref):
    cfg = _port_cfg()
    model = _port_model(cfg, ref["params"])
    state = train.TrainState.create(model, train.adamw())
    step = train.make_train_step(make_loss_fn(cfg), accum_steps=2)
    _, metrics = step(state, _torch_batch(_batch(4, 64, False, False)))
    want_loss, want_norm = ref["accum"]
    assert abs(float(metrics["loss"]) - want_loss) <= ATOL
    assert abs(float(metrics["grad_norm"]) - want_norm) <= ATOL


def test_eval_step_is_the_loss_without_gradients(ref):
    cfg = _port_cfg()
    model = _port_model(cfg, ref["params"])
    batch = _torch_batch(_batch(2, 64, False, False))
    out = train.make_eval_step(make_loss_fn(cfg))(model, batch)
    assert abs(float(out["loss"]) - ref["cases"]["plain"][0]) <= ATOL
    assert all(p.grad is None for p in model.parameters())


def test_train_entry_point_rehearses_on_the_cpu(capsys):
    """``python -m lzy_tpu_torch.train --device cpu``: the tiny config,
    one JSON line with the metric, its unit and the step's numbers, and a
    loss that falls (the same batch every step)."""
    import json

    from lzy_tpu_torch import train as entry

    entry.main(["--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["metric"] == "llama_train_step_mfu"
    assert line["unit"] == "mfu_fraction" and line["peak"] == "cpu"
    assert line["step_ms"] > 0 and line["tokens_per_s"] > 0
    assert len(line["losses"]) == 4 and line["losses"][-1] < line["losses"][0]


def test_train_path_leaves_the_process_environment_alone():
    """A fresh process takes two train steps with remat, fused CE and the
    port's AdamW: nothing is written to ``os.environ`` and
    ``torch._dynamo`` (whose import writes ``TORCHINDUCTOR_CACHE_DIR``)
    is never imported."""
    import subprocess
    import sys
    from pathlib import Path

    code = """
import dataclasses, os, sys, torch
torch.set_num_threads(1)
before = dict(os.environ)
from lzy_tpu_torch.models.llama import LlamaConfig, init_params, make_loss_fn
from lzy_tpu_torch.parallel import train
cfg = dataclasses.replace(LlamaConfig.tiny(vocab_size=64), remat=True,
                          param_dtype=torch.float32, fused_ce=True)
model = init_params(cfg, device="cpu", trainable=True)
state = train.TrainState.create(model, train.adamw())
step = train.make_train_step(make_loss_fn(cfg))
tokens = torch.randint(0, 64, (2, 32), generator=torch.Generator().manual_seed(0))
for _ in range(2):
    state, metrics = step(state, {"tokens": tokens})
assert torch.isfinite(metrics["loss"])
assert dict(os.environ) == before, set(os.environ) ^ set(before)
assert "torch._dynamo" not in sys.modules
"""
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   cwd=Path(__file__).resolve().parents[1])


def test_mfu_and_param_count_match_reference(ref):
    from lzy_tpu.models import count_params as ref_count
    from lzy_tpu.parallel import train as ref_train

    model = _port_model(_port_cfg(), ref["params"])
    assert count_params(model) == ref_count(ref["params"])
    n = count_params(model)
    assert train.transformer_flops_per_token(n) == \
        ref_train.transformer_flops_per_token(n)
    for args in ((1234.5, n, 1), (9.9e4, 350_000_000, 4)):
        assert train.mfu(*args, chip="cpu") == pytest.approx(
            ref_train.mfu(*args, chip="cpu"), rel=1e-12)
    assert train.PEAK_TFLOPS["h100-sxm"] == 989.0
