"""``hairci_torch.losses.ranking.s2r2_loss`` (Smooth-AP, taken over chunks
of queries) against the JAX package's ``s2r2_loss`` on the same seeded
embeddings: the loss within 1e-5 absolute, its gradient at rtol 1e-4 / atol
1e-6, at N below one chunk, at N that the chunk does not divide and at N
that it does, with the three-view targets and with given labels."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hairci.losses.ranking import s2r2_loss as jax_s2r2_loss
from hairci_torch.losses import ranking
from hairci_torch.losses.ranking import s2r2_loss

torch.set_num_threads(1)


def _both(e, targets, **kw):
    jt = None if targets is None else jnp.asarray(targets)
    jloss, jgrad = jax.value_and_grad(
        lambda x: jax_s2r2_loss(x, jt, **kw))(jnp.asarray(e))
    x = torch.from_numpy(e).requires_grad_()
    loss = s2r2_loss(x, None if targets is None else torch.from_numpy(
        targets), **kw)
    loss.backward()
    return (loss.detach().numpy(), x.grad.numpy(), np.asarray(jloss),
            np.asarray(jgrad))


@pytest.mark.parametrize("n,labelled", [
    (12, False), (30, True),            # below one chunk
    (96, False), (96, True),            # 64 + 32: the chunk does not divide
    (3 * ranking.CHUNK, False),         # three whole chunks
])
def test_s2r2_matches_jax(n, labelled):
    rng = np.random.default_rng(n + labelled)
    e = rng.normal(size=(n, 24)).astype(np.float32)
    targets = rng.integers(0, 5, n).astype(np.int32) if labelled else None
    loss, grad, jloss, jgrad = _both(e, targets)
    np.testing.assert_allclose(loss, jloss, rtol=0, atol=1e-5)
    np.testing.assert_allclose(grad, jgrad, rtol=1e-4, atol=1e-6)
    assert 0.0 <= float(loss) <= 1.0 and np.abs(grad).max() > 0


def test_s2r2_views_and_temperature():
    # two views of 10 rows, a milder temperature; bf16 input is taken in f32
    rng = np.random.default_rng(3)
    e = rng.normal(size=(20, 8)).astype(np.float32)
    loss, grad, jloss, jgrad = _both(e, None, tau=0.1, k_views=2)
    np.testing.assert_allclose(loss, jloss, rtol=0, atol=1e-5)
    np.testing.assert_allclose(grad, jgrad, rtol=1e-4, atol=1e-6)
    half = s2r2_loss(torch.from_numpy(e).bfloat16(), tau=0.1, k_views=2)
    assert half.dtype == torch.float32
    ref = s2r2_loss(torch.from_numpy(e).bfloat16().float(), tau=0.1,
                    k_views=2)
    assert torch.equal(half, ref)


def test_exact_ties():
    # every row's positives are exact copies of it: ties of the similarities,
    # where the sigmoid is exactly 1/2
    rng = np.random.default_rng(4)
    e = np.tile(rng.normal(size=(6, 16)).astype(np.float32), (3, 1))
    assert float(s2r2_loss(torch.from_numpy(e))) == pytest.approx(
        float(jax_s2r2_loss(jnp.asarray(e))), abs=1e-5)
