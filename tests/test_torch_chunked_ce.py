"""Port chunked cross-entropy (lzy_tpu_torch/ops/chunked_ce.py) and
``models/common.cross_entropy_loss`` held to the JAX reference.

At f32 on the CPU, with the same numpy inputs on both sides: the
chunked CE's value and its gradients with respect to the features and
the head equal the reference's ``chunked_cross_entropy`` (under
``jax.value_and_grad``), with a mask and with a chunk that does not
divide the vocabulary (both fall back to its largest divisor below the
chunk); and it equals the dense ``cross_entropy_loss``.
"""

import os

import numpy as np
import pytest
import torch

from lzy_tpu_torch.models.common import cross_entropy_loss
from lzy_tpu_torch.ops.chunked_ce import _chunk_size, chunked_cross_entropy

torch.set_num_threads(1)

#: f32 on both sides: logsumexp over 96 logits of |x| < 10 and the head
#: products, summed in other orders; values and gradients are O(1)
ATOL = 1e-5
RTOL = 1e-5

B, T, D, V, CHUNK = 2, 24, 32, 96, 40


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


def _inputs(masked):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    head = (0.3 * rng.standard_normal((V, D))).astype(np.float32)
    labels = rng.integers(0, V, (B, T)).astype(np.int32)
    mask = (rng.random((B, T)) < 0.6) if masked else None
    return x, head, labels, mask


@pytest.fixture(scope="module")
def reference():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from lzy_tpu.ops.chunked_ce import chunked_cross_entropy as ref_ce

    out = {}
    for masked in (False, True):
        x, head, labels, mask = _inputs(masked)

        def f(x_, h_, mask=mask, labels=labels):
            return ref_ce(x_, h_, jnp.asarray(labels), chunk=CHUNK,
                          mask=None if mask is None else jnp.asarray(mask))

        val, grads = jax.value_and_grad(f, argnums=(0, 1))(
            jnp.asarray(x), jnp.asarray(head))
        out[masked] = (float(val), np.asarray(grads[0]),
                       np.asarray(grads[1]))
    return out


def _port(masked):
    x, head, labels, mask = _inputs(masked)
    tx = torch.from_numpy(x).requires_grad_()
    th = torch.from_numpy(head).requires_grad_()
    loss = chunked_cross_entropy(
        tx, th, torch.from_numpy(labels), chunk=CHUNK,
        mask=None if mask is None else torch.from_numpy(mask))
    loss.backward()
    return loss.detach(), tx.grad, th.grad


def test_chunk_falls_back_to_a_divisor():
    assert _chunk_size(V, CHUNK) == 32
    assert _chunk_size(V, 4096) == V and _chunk_size(64, 16) == 16


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
def test_chunked_ce_value_and_grads_match_reference(reference, masked):
    loss, dx, dh = _port(masked)
    want_loss, want_dx, want_dh = reference[masked]
    assert abs(float(loss) - want_loss) <= ATOL + RTOL * abs(want_loss)
    np.testing.assert_allclose(dx.numpy(), want_dx, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(dh.numpy(), want_dh, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
def test_chunked_ce_equals_dense_cross_entropy(masked):
    x, head, labels, mask = _inputs(masked)
    tx, th = torch.from_numpy(x), torch.from_numpy(head)
    dense = cross_entropy_loss(tx @ th.t(), torch.from_numpy(labels),
                               None if mask is None
                               else torch.from_numpy(mask))
    loss, _, _ = _port(masked)
    assert abs(float(loss) - float(dense)) <= ATOL


def test_fully_masked_batch_gives_zero_loss():
    x, head, labels, _ = _inputs(False)
    zero = torch.zeros(B, T, dtype=torch.bool)
    loss = chunked_cross_entropy(torch.from_numpy(x), torch.from_numpy(head),
                                 torch.from_numpy(labels), chunk=CHUNK,
                                 mask=zero)
    assert float(loss) == 0.0
    assert float(cross_entropy_loss(torch.zeros(B, T, V),
                                    torch.from_numpy(labels), zero)) == 0.0
