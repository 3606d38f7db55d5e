"""The port's rotate (hairci_torch/ops/rotate.py) against the JAX package:
the twin bitwise against ``hairci.aug.ops.rotate_shear(order=0)``, with the
blur against the composed ``rotate_shear`` + ``gaussian_blur(k=3)``, both
against ``rotate_shear_pallas`` in interpret mode; the CUDA kernel against
the twin on a card."""

import math
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hairci.aug import ops as jops
from hairci.ops import rotate_pallas as rp
from hairci_torch.ops.rotate import (
    rotate_shear,
    rotate_shear_reference,
    shear_coefficients,
)

torch.set_num_threads(1)
DEG = math.pi / 180.0
# -2 atan(1/8) in f32: -tan(theta/2) is exactly 0.125 in torch and in JAX, so
# with an odd height the shear at d = r - cy = 4 is exactly 0.5: rounding
# half up gives 1 where round-half-even gives 0
HALF_THETA = np.float32(-0.24870999)
THETAS = np.asarray([0.0, 15 * DEG, -15 * DEG, HALF_THETA, 0.2, -0.11],
                    np.float32)


def _inputs(H=33, W=32, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(len(THETAS), H, W, 3)).astype(np.float32)
    sigma = rng.uniform(0.1, 0.5, size=len(THETAS)).astype(np.float32)
    return x, sigma


def _interpret():
    orig = rp.pl.pallas_call
    return mock.patch.object(
        rp.pl, "pallas_call",
        lambda *a, **k: orig(*a, **{**k, "interpret": True}))


def test_half_theta_is_an_exact_half():
    alpha, _ = shear_coefficients(torch.tensor([HALF_THETA]))
    assert float(alpha[0]) == 0.125 and float(alpha[0]) * 4 == 0.5


@pytest.mark.parametrize("H,W", [(33, 32), (32, 32)])
def test_twin_matches_jax_bitwise(H, W):
    x, _ = _inputs(H, W)
    want = jops.rotate_shear(jnp.asarray(x), jnp.asarray(THETAS), order=0,
                             max_degrees=15.0)
    got = rotate_shear_reference(torch.from_numpy(x),
                                 torch.from_numpy(THETAS), max_degrees=15.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_twin_blur_matches_jax_composed():
    x, sigma = _inputs()
    # gaussian_blur(k=3, p=1) draws (apply, sigma) from one key: feed its
    # sigma to the port
    key = jax.random.key(3)
    _, k_sigma = jax.random.split(key)
    sigma = np.array(jax.random.uniform(k_sigma, (len(THETAS),),
                                          minval=0.1, maxval=0.5))
    want = jops.rotate_shear(jnp.asarray(x), jnp.asarray(THETAS), order=0,
                             max_degrees=15.0)
    want = jops.gaussian_blur(key, want, 3, sigma_range=(0.1, 0.5), p=1.0)
    got = rotate_shear(torch.from_numpy(x), torch.from_numpy(THETAS),
                       max_degrees=15.0, blur_sigma=torch.from_numpy(sigma))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2e-6)


def test_twins_match_pallas_interpret():
    x, sigma = _inputs(seed=1)
    with _interpret():
        plain = rp.rotate_shear_pallas(jnp.asarray(x), jnp.asarray(THETAS),
                                       max_degrees=15.0)
        blurred = rp.rotate_shear_pallas(jnp.asarray(x), jnp.asarray(THETAS),
                                         max_degrees=15.0,
                                         blur_sigma=jnp.asarray(sigma))
    xt, tt = torch.from_numpy(x), torch.from_numpy(THETAS)
    np.testing.assert_array_equal(
        rotate_shear(xt, tt, max_degrees=15.0).numpy(), np.asarray(plain))
    np.testing.assert_allclose(
        rotate_shear(xt, tt, max_degrees=15.0,
                     blur_sigma=torch.from_numpy(sigma)).numpy(),
        np.asarray(blurred), rtol=0, atol=2e-6)


def test_fill_and_clamp_beyond_the_bound():
    # |theta| past max_degrees: the shifts are clamped as by the roll ladder
    x, _ = _inputs(seed=2)
    theta = np.full(len(THETAS), 40 * DEG, np.float32)
    want = jops.rotate_shear(jnp.asarray(x), jnp.asarray(theta), order=0,
                             fill=-1.0, max_degrees=15.0)
    got = rotate_shear(torch.from_numpy(x), torch.from_numpy(theta),
                       fill=-1.0, max_degrees=15.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_wrapper_checks_and_cpu_path():
    x = torch.zeros(2, 8, 8, 3)
    before = rotate_shear.launches
    assert rotate_shear(x, torch.zeros(2)).shape == x.shape
    assert rotate_shear.launches == before  # the twin is no launch
    with pytest.raises(ValueError, match="f32"):
        rotate_shear(x.double(), torch.zeros(2))
    with pytest.raises(ValueError, match="theta"):
        rotate_shear(x, torch.zeros(3))
    with pytest.raises(ValueError, match="blur_sigma"):
        rotate_shear(x, torch.zeros(2), blur_sigma=torch.ones(1))
    # the CPU path refuses what the kernel refuses
    with pytest.raises(ValueError, match="contiguous"):
        rotate_shear(x.permute(0, 2, 1, 3), torch.zeros(2))


@pytest.mark.cuda
def test_cuda_kernel_matches_twin():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the GPU)")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for B, H, W, C in ((6, 33, 32, 3), (4, 224, 224, 3), (3, 17, 45, 5)):
        x = torch.randn(B, H, W, C, device="cuda", generator=gen)
        theta = (torch.rand(B, device="cuda", generator=gen) * 30 - 15) * DEG
        theta[0] = 15 * DEG
        theta[1] = float(HALF_THETA)
        sigma = torch.rand(B, device="cuda", generator=gen) * 0.4 + 0.1
        for blur in (None, sigma):
            got = rotate_shear(x, theta, max_degrees=15.0, blur_sigma=blur)
            want = rotate_shear_reference(x, theta, max_degrees=15.0,
                                          blur_sigma=blur)
            torch.cuda.synchronize()
            if blur is None:
                assert torch.equal(got, want)
            else:
                torch.testing.assert_close(got, want, rtol=0, atol=2e-6)
