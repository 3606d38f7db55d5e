"""The port's token masks and the ViT's masked forward against the JAX
package: ``random_token_mask`` and ``random_block_mask`` bitwise from JAX's
own noise (rows with ties included, and block grids the block size does not
divide), ``mask_to_ids_keep`` on all-tie masks, ``resize_pos_embed`` both
ways (shrinking antialiases, as ``jax.image.resize`` does), and the ViT's
``ids_keep`` / ``token_mask`` forward and another resolution at tiny
widths."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hairci.models.masking as jax_masking
import hairci.models.vit as jax_vit
import hairci_torch.models.masking as masking
import hairci_torch.models.vit as port_vit
from hairci_torch.models.convert import vit_state_dict_from_jax

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


def _tied(rng, shape, levels=8):
    """Uniform noise rounded to a few levels: every row is full of ties."""
    return (np.floor(rng.uniform(size=shape) * levels) / levels).astype(
        np.float32)


def _token_mask_case(key, B, N, ratio, noise):
    ids_keep, ids_restore, mask = jax_masking.random_token_mask(
        key, B, N, ratio)
    got = masking.random_token_mask_from_noise(_t(noise), ratio)
    for name, g, w in zip(("ids_keep", "ids_restore", "mask"), got,
                          (ids_keep, ids_restore, mask)):
        assert torch.equal(g, _t(w).to(g.dtype)), name
    return got


@pytest.mark.parametrize("N,ratio,keep", [(196, 0.75, 49), (196, 0.6, 78),
                                          (16, 0.75, 4), (16, 0.6, 6)])
def test_token_mask_bitwise_from_jax_noise(N, ratio, keep):
    B = 16
    for seed in range(3):
        key = jax.random.key(seed)
        noise = np.asarray(jax.random.uniform(key, (B, N)))
        ids_keep, ids_restore, mask = _token_mask_case(key, B, N, ratio,
                                                       noise)
        assert ids_keep.shape == (B, keep)
        assert (mask.sum(1) == N - keep).all()
        # the kept tokens are the unmasked ones, and the restore inverts
        assert not mask.gather(1, ids_keep).any()
        shuffle = torch.argsort(ids_restore, dim=1)
        assert torch.equal(shuffle.gather(1, ids_restore),
                           torch.arange(N).expand(B, N))


def test_token_mask_ties_follow_jax_stable_sort(monkeypatch):
    """Rows with many tied noise values (JAX's 23-bit uniforms tie in about
    one 196-token row in 430): the ties keep their index order in both."""
    rng = np.random.default_rng(0)
    B, N = 8, 196
    noise = _tied(rng, (B, N))
    noise[0] = 0.5                                   # one row all ties
    monkeypatch.setattr(jax.random, "uniform",
                        lambda key, shape, **kw: jnp.asarray(noise))
    ids_keep, _, mask = _token_mask_case(jax.random.key(0), B, N, 0.75,
                                         noise)
    assert torch.equal(ids_keep[0], torch.arange(49))
    assert not mask[0, :49].any() and mask[0, 49:].all()


@pytest.mark.parametrize("grid,block,ratio", [
    (14, 4, 0.4),     # coarse 4: 16 cells cropped to 14 patches a side
    (7, 4, 0.5),      # block shrinks to 3; coarse 3 cropped to 7
    (16, 4, 0.3),     # divides
    (6, 4, 0.6),      # block 3, coarse 2
    (2, 4, 0.5),      # block 1
])
def test_block_mask_bitwise_from_jax_scores(grid, block, ratio):
    B = 6
    bsz, coarse = masking.block_grid(grid, block)
    for seed in range(3):
        key = jax.random.key(seed)
        want = jax_masking.random_block_mask(key, B, grid, ratio, block)
        scores = jax.random.uniform(key, (B, coarse, coarse))
        got = masking.random_block_mask_from_scores(_t(scores), grid, ratio,
                                                    block)
        assert got.dtype == torch.bool and got.shape == (B, grid * grid)
        assert torch.equal(got, _t(want))
    gen = torch.Generator().manual_seed(0)
    assert masking.draw_block_scores(gen, B, grid, block).shape == (
        B, coarse, coarse)


def test_block_mask_masks_every_tie(monkeypatch):
    rng = np.random.default_rng(1)
    B, grid, block = 4, 14, 4
    scores = _tied(rng, (B, 4, 4), levels=3)
    monkeypatch.setattr(jax.random, "uniform",
                        lambda key, shape, **kw: jnp.asarray(scores))
    want = jax_masking.random_block_mask(jax.random.key(0), B, grid, 0.4,
                                         block)
    got = masking.random_block_mask_from_scores(_t(scores), grid, 0.4, block)
    assert torch.equal(got, _t(want))


def test_mask_to_ids_keep_is_stable():
    rng = np.random.default_rng(2)
    B, N = 6, 49
    mask = rng.uniform(size=(B, N)) < 0.5
    mask[0] = False                                  # all ties
    mask[1] = True
    for num_keep in (0, 10, N):
        want = jax_masking.mask_to_ids_keep(jnp.asarray(mask), num_keep)
        got = masking.mask_to_ids_keep(_t(mask), num_keep)
        assert torch.equal(got, _t(want).long())
    assert torch.equal(masking.mask_to_ids_keep(_t(mask), N)[0],
                       torch.arange(N))


def test_draws_are_seeded():
    a = masking.random_token_mask(torch.Generator().manual_seed(3), 2, 16,
                                  0.75)
    b = masking.random_token_mask(torch.Generator().manual_seed(3), 2, 16,
                                  0.75)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    blocks = masking.random_block_mask(torch.Generator().manual_seed(3), 2,
                                       14, 0.4)
    assert blocks.shape == (2, 196)


# ---------------------------------------------------------------------------
# the ViT: position-table resize and the masked forward
# ---------------------------------------------------------------------------

# float32 bilinear taps summed in another order: a few ulps of unit values
RESIZE_ATOL = 2e-6


@pytest.mark.parametrize("new_grid", [6, 16, 14])
def test_resize_pos_embed_matches_jax(new_grid):
    """14 -> 6 (the 96 px local crop at patch 16: shrinking, antialiased),
    14 -> 16 (growing) and 14 -> 14 (identity)."""
    rng = np.random.default_rng(new_grid)
    pe = rng.normal(size=(1, 1 + 14 * 14, 96)).astype(np.float32)
    want = jax_vit.resize_pos_embed(jnp.asarray(pe), new_grid, 14)
    got = port_vit.resize_pos_embed(_t(pe), new_grid, 14)
    assert got.shape == (1, 1 + new_grid ** 2, 96)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=RESIZE_ATOL)
    # without the antialias the shrink is another function
    if new_grid == 6:
        plain = torch.nn.functional.interpolate(
            _t(pe[:, 1:]).reshape(1, 14, 14, 96).permute(0, 3, 1, 2),
            size=(6, 6), mode="bilinear", align_corners=False)
        plain = plain.permute(0, 2, 3, 1).reshape(1, 36, 96).numpy()
        assert np.abs(plain - np.asarray(want)[:, 1:]).max() > 1e-2


TINY = dict(patch_size=8, embed_dim=64, depth=2, num_heads=2, img_size=32)


@pytest.fixture(scope="module")
def tiny_vit():
    jmod = jax_vit.VisionTransformer(**TINY)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 32, 32, 3)).astype(np.float32)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.normal(0, 0.05, a.shape).astype(
            np.float32),
        jmod.init(jax.random.key(0), jnp.asarray(x))["params"])
    port = port_vit.VisionTransformer(**TINY)
    port.load_state_dict(vit_state_dict_from_jax(params, 2), strict=True)
    apply = jax.jit(lambda p, x, ids, tm: jmod.apply(
        {"params": p}, x, ids_keep=ids, token_mask=tm))
    return jmod, params, port, x, apply


def test_vit_ids_keep_and_token_mask_match_jax(tiny_vit):
    jmod, params, port, x, apply = tiny_vit
    key = jax.random.key(5)
    ids_keep, _, maskf = jax_masking.random_token_mask(key, 3, 16, 0.6)
    token_mask = np.asarray(maskf) > 0.5
    for ids, tm in ((ids_keep, None), (None, token_mask),
                    (ids_keep, token_mask)):
        want = (jmod.apply({"params": params}, jnp.asarray(x),
                           ids_keep=ids, token_mask=tm)
                if ids is None or tm is None else
                apply(params, jnp.asarray(x), ids, jnp.asarray(tm)))
        got = port(_t(x), ids_keep=None if ids is None else _t(ids).long(),
                   token_mask=None if tm is None else _t(tm))
        assert got.shape == want.shape
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-5)


def test_vit_resizes_its_table_for_another_resolution(tiny_vit):
    jmod, params, port, _, _ = tiny_vit
    x = np.random.default_rng(1).normal(size=(2, 48, 48, 3)).astype(
        np.float32)
    want = jmod.apply({"params": params}, jnp.asarray(x), pool=True)
    got = port(_t(x), pool=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-5)
