"""``hairci_torch.losses.recon`` against ``hairci.losses.recon``: patchify
and unpatchify (bitwise, (p, q, c) order), the masked MSE with and without
``norm_pix`` and without a mask, the masked L1, the standardisation and
UniGrad, values at rtol 1e-6 and their gradients at rtol 1e-5 (entries that
cancel to about 0 within 1e-6 of the largest)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hairci.losses.recon as jax_recon
from hairci_torch.losses import recon

torch.set_num_threads(1)
RTOL = 1e-6


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("shape,p", [((2, 32, 32, 3), 8), ((3, 16, 16, 3), 4),
                                     ((1, 48, 48, 1), 16)])
def test_patchify_roundtrip_bitwise(shape, p):
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    want = jax_recon.patchify(jnp.asarray(x), p)
    got = recon.patchify(_t(x), p)
    assert torch.equal(got, _t(want))
    back = recon.unpatchify(got, p, shape[-1])
    assert torch.equal(back, _t(jax_recon.unpatchify(want, p, shape[-1])))
    assert torch.equal(back, _t(x))


def _inputs(seed=0, B=4, N=16, P=48):
    rng = np.random.default_rng(seed)
    pred = rng.normal(size=(B, N, P)).astype(np.float32)
    target = (rng.normal(size=(B, N, P)) * 2 + 0.5).astype(np.float32)
    mask = (rng.uniform(size=(B, N)) < 0.75).astype(np.float32)
    return pred, target, mask


def _value_and_grad(jfn, tfn, pred, *rest):
    jv, jg = jax.value_and_grad(jfn)(jnp.asarray(pred),
                                     *(jnp.asarray(r) for r in rest))
    tp = _t(pred).requires_grad_(True)
    tv = tfn(tp, *(_t(r) for r in rest))
    tv.backward()
    np.testing.assert_allclose(tv.item(), float(jv), rtol=RTOL)
    # entries that cancel to ~0 are held at 1e-6 of the largest
    jg = np.asarray(jg)
    np.testing.assert_allclose(tp.grad.numpy(), jg, rtol=1e-5,
                               atol=1e-6 * np.abs(jg).max())


@pytest.mark.parametrize("norm_pix", [False, True])
@pytest.mark.parametrize("masked", ["float", "bool", None])
def test_masked_mse_loss(norm_pix, masked):
    pred, target, mask = _inputs(1)
    m = {"float": mask, "bool": mask > 0.5, None: None}[masked]
    _value_and_grad(
        lambda p, t: jax_recon.masked_mse_loss(p, t, m, norm_pix=norm_pix),
        lambda p, t: recon.masked_mse_loss(
            p, t, None if m is None else _t(m), norm_pix=norm_pix),
        pred, target)


@pytest.mark.parametrize("masked", ["bool", None])
def test_masked_l1_loss(masked):
    pred, target, mask = _inputs(2)
    m = None if masked is None else mask > 0.5
    _value_and_grad(
        lambda p, t: jax_recon.masked_l1_loss(p, t, m),
        lambda p, t: recon.masked_l1_loss(p, t,
                                          None if m is None else _t(m)),
        pred, target)


def test_empty_mask_divides_by_one():
    pred, target, _ = _inputs(3)
    zero = np.zeros(pred.shape[:2], np.float32)
    want = jax_recon.masked_mse_loss(jnp.asarray(pred), jnp.asarray(target),
                                     jnp.asarray(zero))
    got = recon.masked_mse_loss(_t(pred), _t(target), _t(zero))
    assert float(want) == got.item() == 0.0


def test_standardize():
    x = np.random.default_rng(4).normal(size=(8, 32)).astype(np.float32) * 3
    np.testing.assert_allclose(
        recon._standardize(_t(x)).numpy(),
        np.asarray(jax_recon._standardize(jnp.asarray(x))), rtol=RTOL,
        atol=1e-6)


@pytest.mark.parametrize("online_ln", [False, True])
def test_unigrad_loss(online_ln):
    rng = np.random.default_rng(5)
    pred = rng.normal(size=(16, 32)).astype(np.float32)
    target = (rng.normal(size=(16, 32)) * 2 + 1).astype(np.float32)
    _value_and_grad(
        lambda p, t: jax_recon.unigrad_loss(p, t, 0.02, online_ln),
        lambda p, t: recon.unigrad_loss(p, t, 0.02, online_ln),
        pred, target)
    # no gradient reaches the target
    tt = _t(target).requires_grad_(True)
    recon.unigrad_loss(_t(pred).requires_grad_(True), tt, 0.02,
                       online_ln).backward()
    assert tt.grad is None
