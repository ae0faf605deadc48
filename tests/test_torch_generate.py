"""Port generate() oracle (lzy_tpu_torch/models/generate.py) held to the
JAX reference on the same weights (tiny config, float32, CPU).

- greedy ``generate`` tokens equal the reference's under the top-2 rule
  (a divergence is accepted only where the reference's top-2 logit gap
  is below ``GAP_TOL``, and the test asserts that gap), with and
  without an eos token;
- ``sample_token``'s temperature/top-k/top-p cuts pick what the
  reference's ``sample_token`` picks when both see the same Gumbel
  noise (the reference's ``categorical`` is ``argmax(logits + gumbel)``);
- the prefill chunk schedule equals the reference's.
"""

import dataclasses

import numpy as np
import pytest
import torch

from lzy_tpu_torch.models import convert
from lzy_tpu_torch.models.generate import generate, prefill_plan, sample_token
from lzy_tpu_torch.models.llama import LlamaConfig, init_params

torch.set_num_threads(1)

VOCAB = 64
#: the two frameworks' f32 logits differ by < 1e-4 (test_torch_llama);
#: a greedy step whose top-2 gap is under ten times that may flip
GAP_TOL = 1e-3


@pytest.fixture(scope="module")
def models():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from lzy_tpu.models import llama as ref_llama, unbox

    rcfg = dataclasses.replace(ref_llama.LlamaConfig.tiny(vocab_size=VOCAB),
                               dtype=jnp.float32)
    boxed, _ = ref_llama.init_params(rcfg, jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(np.asarray, unbox(boxed))
    cfg = dataclasses.replace(LlamaConfig.tiny(vocab_size=VOCAB),
                              dtype=torch.float32, param_dtype=torch.float32)
    model = convert.load_reference(init_params(cfg, device="cpu"), params)
    return rcfg, params, model


def _assert_top2_rule(want, got, logits):
    """``want``/``got`` token lists of one row; ``logits[i]`` the
    reference logits the i-th new token was picked from."""
    for i, (a, b) in enumerate(zip(want, got)):
        if a != b:
            top2 = np.sort(logits[i])[-2:]
            gap = float(top2[1] - top2[0])
            assert gap < GAP_TOL, (
                f"divergence at step {i} where the reference's top-2 gap "
                f"is {gap} (>= {GAP_TOL})")
            return i
    assert len(want) == len(got)
    return len(want)


@pytest.mark.parametrize("eos", [None, 7], ids=["no-eos", "eos"])
def test_greedy_generate_matches_reference(models, eos):
    import jax.numpy as jnp

    from lzy_tpu.models.generate import generate as ref_generate
    from lzy_tpu.models.llama import Llama as RefLlama

    rcfg, params, model = models
    rng = np.random.default_rng(11)
    prompt = rng.integers(0, VOCAB, (2, 19)).astype(np.int32)
    n = 24
    want = np.asarray(ref_generate(rcfg, params, jnp.asarray(prompt),
                                   max_new_tokens=n, eos_token=eos,
                                   prefill_chunk=8))
    got = generate(model, torch.from_numpy(prompt), max_new_tokens=n,
                   eos_token=eos, prefill_chunk=8).numpy()
    assert np.array_equal(got[:, :19], prompt)
    full = np.asarray(RefLlama(rcfg).apply({"params": params},
                                           jnp.asarray(want)))
    agreed = 0
    for row in range(2):
        agreed += _assert_top2_rule(want[row, 19:].tolist(),
                                    got[row, 19:].tolist(),
                                    full[row, 18:18 + n])
    assert agreed >= n        # most of the stream is compared


def test_return_logits_are_the_picked_from_logits(models):
    model = models[2]
    prompt = torch.tensor([[3, 1, 4, 1, 5, 9, 2, 6]])
    out, logits = generate(model, prompt, max_new_tokens=6,
                           return_logits=True)
    assert logits.shape == (1, 6, VOCAB)
    assert torch.equal(logits.argmax(-1), out[:, 8:])


SAMPLING = [
    dict(temperature=0.0),
    dict(temperature=0.7, top_k=5),
    dict(temperature=1.0, top_p=0.9),
    dict(temperature=1.3, top_k=12, top_p=0.6),
    dict(temperature=0.9, top_k=0),
]


@pytest.mark.parametrize("kw", SAMPLING, ids=lambda kw: "-".join(
    f"{k}{v}" for k, v in kw.items()))
def test_sample_token_matches_reference_with_shared_noise(kw):
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from lzy_tpu.models.generate import sample_token as ref_sample

    for seed in range(4):
        logits = np.random.default_rng(seed).standard_normal(
            (6, VOCAB)).astype(np.float32) * 3
        key = jax.random.PRNGKey(seed)
        want, _ = ref_sample(jnp.asarray(logits), kw["temperature"], key,
                             top_k=kw.get("top_k"), top_p=kw.get("top_p"))
        # the reference draws categorical(split(key)[1]) = argmax(logits
        # + gumbel(split(key)[1])): hand the port that same noise
        noise = np.asarray(jax.random.gumbel(jax.random.split(key)[1],
                                             logits.shape, jnp.float32))
        got = sample_token(torch.from_numpy(logits), kw["temperature"],
                           top_k=kw.get("top_k"), top_p=kw.get("top_p"),
                           noise=torch.tensor(noise))
        assert got.tolist() == np.asarray(want).tolist()


def test_sampled_generate_is_seed_deterministic(models):
    model = models[2]
    prompt = torch.tensor([[5, 9, 3, 7, 2]])

    def run(seed):
        gen = torch.Generator().manual_seed(seed)
        return generate(model, prompt, max_new_tokens=10, temperature=0.8,
                        top_k=10, generator=gen).tolist()

    assert run(1) == run(1)


def test_prefill_plan_matches_reference():
    pytest.importorskip("jax")
    from lzy_tpu.models.generate import prefill_plan as ref_plan

    for t0 in (1, 5, 8, 9, 63, 64, 65, 130, 250):
        for chunk in (1, 8, 24, 64):
            for max_len in (256, t0 + 3):
                assert prefill_plan(t0, chunk, max_len) == \
                    ref_plan(t0, chunk, max_len)
