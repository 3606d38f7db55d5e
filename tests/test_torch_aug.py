"""Each apply half of the port's augmentations (hairci_torch/aug) against
the JAX package on JAX's own draws: the draws are recomputed here with the
same ``jax.random`` calls and injected. Selection logic is held bitwise,
arithmetic at 1e-5."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hairci.aug import ops as jops
from hairci.aug import pipelines as jpipe
from hairci.aug.hair_masking import mask_hair_patches as jax_mask
from hairci_torch.aug import ops
from hairci_torch.aug import pipelines as pipe
from hairci_torch.aug.hair_masking import mask_hair_patches

torch.set_num_threads(1)
B, H, W = 4, 40, 36
TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.array(a))


def _x(seed=0, shape=(B, H, W, 3)):
    return np.random.default_rng(seed).uniform(size=shape).astype(np.float32)


def _flags(key, p, n=B):
    return _t(jax.random.uniform(key, (n, 1, 1, 1)) < p).reshape(n)


def _crop_draws(key, n, h, w, scale=(0.08, 1.0)):
    keys = jax.random.split(key, n)
    boxes = jax.vmap(lambda k: jops._sample_crop_params(
        k, h, w, scale, (3.0 / 4.0, 4.0 / 3.0)))(keys)
    return [_t(b) for b in boxes]


def _cj_draws(key, n, b, c, s, h, p):
    k_apply, k_b, k_c, k_s, k_h, k_perm = jax.random.split(key, 6)

    def u(k, lo, hi):
        return _t(jax.random.uniform(k, (n, 1, 1, 1), minval=lo,
                                     maxval=hi)).reshape(n)
    return {"brightness": u(k_b, max(0, 1 - b), 1 + b),
            "contrast": u(k_c, max(0, 1 - c), 1 + c),
            "saturation": u(k_s, max(0, 1 - s), 1 + s),
            "hue": u(k_h, -h, h),
            "order": _t(jax.random.permutation(k_perm, 4)),
            "apply": _flags(k_apply, p, n)}


def _blur_draws(key, n, sigma_range, p):
    k_apply, k_sigma = jax.random.split(key)
    sigma = _t(jax.random.uniform(k_sigma, (n,), minval=sigma_range[0],
                                  maxval=sigma_range[1]))
    return sigma, _flags(k_apply, p, n)


def view_draws(view, key, n, h, w):
    """JAX's draws of ``ViewConfig.__call__`` as the port's draw dict."""
    ks = jax.random.split(key, 6)
    s = view.cj_strength
    d = {"crop": torch.stack(_crop_draws(ks[0], n, h, w, view.crop_scale)),
         "flip": _flags(ks[1], view.hflip_p, n),
         "gray": _flags(ks[3], view.grayscale_p, n)}
    d.update({f"cj_{k}": v for k, v in _cj_draws(
        ks[2], n, view.cj_bright * s, view.cj_contrast * s, view.cj_sat * s,
        view.cj_hue * s, view.cj_p).items()})
    d["blur_sigma"], d["blur"] = _blur_draws(ks[4], n, view.blur_sigma,
                                             view.blur_p)
    return d


def test_resized_crop():
    key, x = jax.random.key(1), _x(1)
    rrc = jax.jit(jops.random_resized_crop, static_argnames=("size", "scale"))
    want = rrc(key, jnp.asarray(x), 24)
    got = ops.resized_crop(_t(x), *_crop_draws(key, B, H, W), 24)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # upsampling too: a small crop of a big image is magnified
    want = rrc(key, jnp.asarray(x), 64, scale=(0.05, 0.1))
    got = ops.resized_crop(_t(x), *_crop_draws(key, B, H, W, (0.05, 0.1)), 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_crop_draws_are_valid_boxes():
    top, left, h, w = ops.draw_crop_params(torch.Generator().manual_seed(0),
                                           64, H, W)
    assert ((top >= 0) & (left >= 0) & (top + h <= H + 1e-4)
            & (left + w <= W + 1e-4)).all()
    area = h * w / (H * W)
    assert ((area > 0.08 - 1e-4) & (area <= 1 + 1e-4)).all()


@pytest.mark.parametrize("op", ["hflip", "grayscale", "solarize"])
def test_selection_ops_bitwise(op):
    key, x = jax.random.key(2), _x(2)
    if op == "hflip":
        want = jops.random_hflip(key, jnp.asarray(x), p=0.5)
        got = ops.hflip(_t(x), _flags(key, 0.5))
    elif op == "grayscale":
        want = jops.random_grayscale(key, jnp.asarray(x), p=0.5)
        got = ops.grayscale(_t(x), _flags(key, 0.5))
    else:
        want = jops.random_solarize(key, jnp.asarray(x), p=0.5)
        got = ops.where_image(_flags(key, 0.5), ops.solarize(_t(x)), _t(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_center_crop_and_knn_transform_bitwise():
    x = (_x(3, (2, 37, 30, 3)) * 255).astype(np.uint8)
    for size in (24, 33):  # crop, and pad where the image is smaller
        np.testing.assert_array_equal(
            ops.center_crop(_t(x), size).numpy(),
            np.asarray(jops.center_crop(jnp.asarray(x), size)))
    np.testing.assert_allclose(pipe.knn_transform(_t(x), 24).numpy(),
                               np.asarray(jpipe.knn_transform(
                                   jnp.asarray(x), 24)), rtol=0, atol=1e-6)


@pytest.mark.parametrize("seed", [4, 5])
def test_color_jitter(seed):
    key, x = jax.random.key(seed), _x(seed)
    want = jops.color_jitter(key, jnp.asarray(x), 0.8, 0.8, 0.8, 0.2, p=0.8)
    got = ops.color_jitter(_t(x), _cj_draws(key, B, 0.8, 0.8, 0.8, 0.2, 0.8))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_hue_wraps_as_floor_mod():
    x = _x(6)
    for f in (-0.5, -0.3, 0.0, 0.45):
        fac = np.full(B, f, np.float32)
        np.testing.assert_allclose(
            ops.adjust_hue(_t(x), _t(fac)).numpy(),
            np.asarray(jops.adjust_hue(jnp.asarray(x),
                                       jnp.asarray(fac)[:, None, None])),
            **TOL)


@pytest.mark.parametrize("k", [3, 9])
def test_gaussian_blur(k):
    key, x = jax.random.key(7), _x(7)
    want = jops.gaussian_blur(key, jnp.asarray(x), k, (0.1, 2.0), p=0.5)
    got = ops.gaussian_blur(_t(x), k, *_blur_draws(key, B, (0.1, 2.0), 0.5))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_positive_transform():
    key, x = jax.random.key(8), _x(8) * 4 - 2
    want = jax.jit(jpipe.positive_transform)(key, jnp.asarray(x))
    k1, k2 = jax.random.split(key)
    theta = jax.random.uniform(k1, (B,), minval=-15.0, maxval=15.0) \
        * (math.pi / 180.0)
    sigma, _ = _blur_draws(k2, B, (0.1, 0.5), 1.0)
    got = pipe.positive_transform(_t(x), {"theta": _t(theta),
                                          "sigma": sigma})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2e-6)


def test_rotate_bitwise():
    key, x = jax.random.key(10), _x(10)
    theta = jax.random.uniform(key, (B,), minval=-15.0, maxval=15.0) \
        * (math.pi / 180.0)
    want = jops.rotate_shear(jnp.asarray(x), theta, order=0,
                             max_degrees=15.0)
    got = ops.rotate_shear(_t(x), _t(theta), max_degrees=15.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # order=1 is plain torch on every device, as it is plain JAX
    want = jops.rotate_shear(jnp.asarray(x), theta, order=1,
                             max_degrees=15.0)
    got = ops.rotate_shear(_t(x), _t(theta), order=1, max_degrees=15.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
    with pytest.raises(ValueError, match="order must be 0 or 1"):
        ops.rotate_shear(_t(x), _t(theta), order=3)
    # random_rotate is draw_rotation followed by rotate_shear
    gen = torch.Generator().manual_seed(10)
    drawn = ops.draw_rotation(torch.Generator().manual_seed(10), B, 15.0)
    np.testing.assert_array_equal(
        ops.random_rotate(gen, _t(x)).numpy(),
        ops.rotate_shear(_t(x), drawn, max_degrees=15.0).numpy())


def test_hair_masking_bitwise():
    # black background, hair in some patches: as the hair-region crops
    rng = np.random.default_rng(9)
    x = rng.uniform(size=(B, 64, 64, 3)).astype(np.float32)
    x *= (rng.uniform(size=(B, 4, 1, 4, 1, 1)) < 0.6).repeat(16, 2) \
        .repeat(16, 4).reshape(B, 64, 64, 1)
    key = jax.random.key(9)
    want = jax_mask(key, jnp.asarray(x), 16, (0.2, 0.6))
    k_ratio, k_score = jax.random.split(key)
    ratio = _t(jax.random.uniform(k_ratio, (B,), minval=0.2, maxval=0.6))
    scores = _t(jax.random.uniform(k_score, (B, 16)))
    got = mask_hair_patches(_t(x), ratio, scores, 16)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got == 0).sum() > (_t(x) == 0).sum()  # something was masked


def test_simclr_view_pipeline():
    key, x = jax.random.key(10), (_x(10) * 255).astype(np.uint8)
    view = jpipe.ViewConfig(size=24, blur_kernel=5)
    want = view(key, jnp.asarray(x))
    port = pipe.ViewConfig(size=24, blur_kernel=5)
    got = port.apply(_t(x), view_draws(view, key, B, H, W))
    # after normalize (1/std ~ 4.4) the 1e-5 of the ops grows to ~5e-5
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=5e-5)


@pytest.mark.parametrize("shape,degrees,fill", [
    ((3, 17, 23, 3), 15.0, 0.0), ((2, 32, 32, 1), 45.0, 0.5),
    ((2, 9, 12, 4), 30.0, 0.0)])
def test_rotate_linear_matches_jax(shape, degrees, fill):
    """``rotate_shear(order=1)``: floor shifts, one roll-by-one blend a
    pass, the clamped roll and the unclamped fill of JAX's roll ladder. The
    same f32 operations in the same order; XLA may contract the blend into
    a fused multiply-add, so within 1e-6 (a few ulps of values in [0, 1])."""
    key = jax.random.key(shape[1])
    x = _x(shape[1], shape)
    theta = jax.random.uniform(key, (shape[0],), minval=-degrees,
                               maxval=degrees) * (math.pi / 180.0)
    want = jops.rotate_shear(jnp.asarray(x), theta, order=1, fill=fill,
                             max_degrees=degrees)
    got = ops.rotate_shear(_t(x), _t(theta), order=1, fill=fill,
                           max_degrees=degrees)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
    # the interpolation is not the nearest rotation
    near = ops.rotate_shear(_t(x), _t(theta), fill=fill, max_degrees=degrees)
    assert not torch.equal(got, near)


def test_mae_view_pipeline():
    """``mae_transform``: one view, RandomResizedCrop(0.2, 1) + hflip."""
    key, x = jax.random.key(12), (_x(12) * 255).astype(np.uint8)
    jtf = jpipe.mae_transform(24)
    (want,) = jtf(key, jnp.asarray(x))
    (k0,) = jax.random.split(key, 1)
    (view,) = jtf.views
    assert (view.crop_scale, view.cj_p, view.grayscale_p, view.blur_p) == (
        (0.2, 1.0), 0.0, 0.0, 0.0)
    for tf in (pipe.mae_transform(24), pipe.simmim_transform(24)):
        (got,) = tf.apply(_t(x), [view_draws(view, k0, B, H, W)])
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=5e-5)
        draws = tf.draw(torch.Generator().manual_seed(0), B, H, W)
        assert set(draws[0]) == {"crop", "flip"}


def test_draw_halves_are_seeded():
    port = pipe.simclr_transform(24)
    x = torch.from_numpy((_x(11) * 255).astype(np.uint8))
    a = port(torch.Generator().manual_seed(3), x)
    b = port(torch.Generator().manual_seed(3), x)
    c = port(torch.Generator().manual_seed(4), x)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    assert not torch.equal(a[0], c[0])
    assert a[0].shape == (B, 24, 24, 3) and torch.isfinite(a[0]).all()


def test_negative_transform_on_jax_draws():
    """``negative_transform`` (flip with p = 0.5, colour jitter 0.1 / 0.1 /
    0.1 / 0.02 always applied) on JAX's draws; the draw half is seeded."""
    key, x = jax.random.key(12), _x(12)
    want = jax.jit(jpipe.negative_transform)(key, jnp.asarray(x))
    k1, k2 = jax.random.split(key)
    d = {"flip": _flags(k1, 0.5)}
    d.update({f"cj_{k}": v for k, v in _cj_draws(
        k2, B, 0.1, 0.1, 0.1, 0.02, 1.0).items()})
    got = pipe.negative_transform(_t(x), d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert d["flip"].any() and not d["flip"].all()
    a = pipe.draw_negative(torch.Generator().manual_seed(2), B)
    b = pipe.draw_negative(torch.Generator().manual_seed(2), B)
    assert set(a) == set(d) and all(torch.equal(a[k], b[k]) for k in a)
    assert a["cj_apply"].all()
