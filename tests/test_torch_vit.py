"""The port's ViT (hairci_torch/models/vit.py) against the JAX reference
(hairci/models/vit.py) on identical params and inputs, on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hairci.models.vit import VisionTransformer as JaxViT
from hairci.models.vit import gelu as jax_gelu
from hairci.models.vit import get_2d_sincos_pos_embed as jax_pos_embed
from hairci.retrieval.torch_import import (
    export_vit,
    load_torch_state_dict as jax_load_torch_state_dict,
    save_torch_state_dict,
)
from hairci_torch.models.convert import vit_state_dict_from_jax
from hairci_torch.models.vit import VisionTransformer, build_vit, gelu
from hairci_torch.models.vit import get_2d_sincos_pos_embed
from hairci_torch.retrieval.encoders import HairEncoder

torch.set_num_threads(1)

# tiny ViT: patch 8, image 32, dim 64, depth 2, 4 heads
TINY = dict(patch_size=8, embed_dim=64, depth=2, num_heads=4, img_size=32)


def _jax_params(global_pool=False, seed=0):
    model = JaxViT(**TINY, global_pool=global_pool)
    params = model.init(jax.random.key(seed), jnp.zeros((1, 32, 32, 3)),
                        train=False)["params"]
    # non-trivial LN affine and biases, so the mapping of every key shows
    rng = np.random.default_rng(seed + 1)
    return jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.05 * rng.standard_normal(p.shape).astype(
            np.float32), params)


def _port(params, dtype, global_pool=False):
    m = VisionTransformer(**TINY, dtype=dtype, global_pool=global_pool)
    m.load_state_dict(vit_state_dict_from_jax(params, TINY["depth"]),
                      strict=True)
    return m.eval()


def _images(n=3, seed=0):
    return np.random.default_rng(seed).normal(size=(n, 32, 32, 3)).astype(
        np.float32)


def test_vit_tokens_match_jax_f32():
    params = _jax_params()
    x = _images()
    ref = np.asarray(JaxViT(**TINY).apply({"params": params}, x, train=False))
    with torch.no_grad():
        out = _port(params, torch.float32)(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape == (3, 17, 64)
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("global_pool", [False, True])
def test_vit_pooled_match_jax_f32(global_pool):
    params = _jax_params(global_pool)
    x = _images()
    ref = np.asarray(JaxViT(**TINY, global_pool=global_pool).apply(
        {"params": params}, x, train=False, pool=True))
    with torch.no_grad():
        out = _port(params, torch.float32, global_pool)(
            torch.from_numpy(x), pool=True).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)


def _l2n(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def test_vit_cls_features_match_jax_bf16():
    # bf16 rounds at different places in the two frameworks: compare the
    # normalised CLS features at bf16-scale tolerance
    params = _jax_params()
    x = _images(4)
    ref = np.asarray(JaxViT(**TINY, dtype=jnp.bfloat16).apply(
        {"params": params}, x, train=False))[:, 0]
    with torch.no_grad():
        out = _port(params, torch.bfloat16)(torch.from_numpy(x))[:, 0]
    assert out.dtype == torch.float32  # LayerNorm is pinned to f32
    a, b = _l2n(out.numpy()), _l2n(ref.astype(np.float32))
    np.testing.assert_allclose(a, b, atol=3e-2)
    assert np.all(np.sum(a * b, axis=1) >= 0.999)


def test_sincos_pos_embed_exact():
    for d, grid in ((64, 4), (768, 14)):
        np.testing.assert_array_equal(get_2d_sincos_pos_embed(d, grid, True),
                                      jax_pos_embed(d, grid, True))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gelu_matches_jax(dtype):
    x = np.random.default_rng(0).normal(size=(4096,)).astype(np.float32) * 4
    ref = np.asarray(jax_gelu(jnp.asarray(x, dtype)).astype(jnp.float32))
    out = gelu(torch.from_numpy(x).to(getattr(torch, dtype))).float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(out, ref, atol=1e-6, rtol=1e-6)
    else:
        # the port rounds the f32 tanh form once; XLA evaluates it step by
        # step in bf16, so the two differ by a few bf16 steps of the
        # intermediates (|x| <= 16 here)
        exact = torch.nn.functional.gelu(
            torch.from_numpy(x).bfloat16().float(), approximate="tanh")
        np.testing.assert_array_equal(out, exact.bfloat16().float().numpy())
        np.testing.assert_allclose(out, ref, rtol=2 ** -7, atol=4e-3)


def test_converter_matches_export_vit():
    params = _jax_params(global_pool=True)
    ours = vit_state_dict_from_jax(params, TINY["depth"])
    ref = export_vit(params, depth=TINY["depth"])
    assert set(ours) == set(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(ours[k].numpy(), v, err_msg=k)
    model = VisionTransformer(**TINY, global_pool=True)
    assert set(model.state_dict()) == set(ours)


def _tiny_hair_encoder(ckpt, device="cpu"):
    enc = HairEncoder.__new__(HairEncoder)
    enc.img_size = 32
    enc.model = VisionTransformer(**TINY, global_pool=True)
    super(HairEncoder, enc).__init__(ckpt, 4, device)
    return enc


def test_export_vit_and_timm_checkpoints_load_alike(tmp_path):
    """A .pth from save_torch_state_dict(export_vit(...)) and a timm-style
    ViT .pth (prefixed, extra head, no mask token) load the same weights."""
    params = _jax_params(global_pool=True)
    exported = tmp_path / "exported.pth"
    save_torch_state_dict(export_vit(params, depth=TINY["depth"]),
                          str(exported))
    sd = jax_load_torch_state_dict(str(exported))
    timm = {f"module.{k}": torch.from_numpy(np.ascontiguousarray(v))
            for k, v in sd.items() if k != "mask_token"}
    timm["module.head.weight"] = torch.zeros(10, 64)
    timm_path = tmp_path / "timm.pth"
    torch.save(timm, timm_path)
    a = _tiny_hair_encoder(str(exported)).model.state_dict()
    b = _tiny_hair_encoder(str(timm_path)).model.state_dict()
    for k in a:
        if k != "mask_token":
            assert torch.equal(a[k], b[k]), k
    assert torch.count_nonzero(b["mask_token"]) == 0
    np.testing.assert_array_equal(a["blocks.1.mlp.fc1.weight"].numpy(),
                                  np.asarray(params["block1"]["mlp"]["fc1"]
                                             ["kernel"]).T)


def test_orbax_checkpoint_raises_clearly(tmp_path):
    with pytest.raises(ValueError, match="export_vit"):
        _tiny_hair_encoder(str(tmp_path))


def test_seeded_init_is_dtype_independent():
    a = build_vit("vit_tiny_patch16", img_size=32,
                  generator=torch.Generator().manual_seed(3))
    b = build_vit("vit_tiny_patch16", img_size=32, dtype=torch.bfloat16,
                  generator=torch.Generator().manual_seed(3))
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        torch.testing.assert_close(va.to(vb.dtype), vb, rtol=0, atol=0,
                                   msg=k)
    assert b.blocks[0].norm1.weight.dtype == torch.float32
    assert b.blocks[0].attn.qkv.weight.dtype == torch.bfloat16


def test_no_silent_cpu_path(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _tiny_hair_encoder(None, device=None)
