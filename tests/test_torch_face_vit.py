"""The port's face ViT (``hairci_torch.models.face_vit``) against the JAX
package's on the CPU, at the JAX tests' shapes (32 px, patch 8, dim 64,
depth 2, 2 heads x 16, mlp 128, 10 classes): both patch modes and both
pools in f32 at 1e-5 and in bf16 at 3e-2 (and no farther from the f32
model than JAX's bf16 model is, within 1.5x); the margin heads and the SFace
loss with its gradient at 1e-5; and the same embeddings from JAX params and
from a reference-layout ``ViT_face`` state dict."""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hairci.models.face_vit import ViTFace as JaxViTFace
from hairci.models.face_vit import margin_logits as jax_margin_logits
from hairci.models.face_vit import sface_loss as jax_sface_loss
from hairci.retrieval.torch_import import convert_vit_face, merge_params
from hairci_torch.models.convert import (
    face_vit_state_dict,
    face_vit_state_dict_from_jax,
)
from hairci_torch.models.face_vit import (
    ViTFace,
    build_vit_face,
    margin_logits,
    sface_loss,
)

torch.set_num_threads(1)

TINY = dict(image_size=32, patch_size=8, dim=64, depth=2, heads=2,
            dim_head=16, mlp_dim=128, num_class=10)
LOSSES = ("Softmax", "CosFace", "ArcFace", "SFace")
# bf16: the port and XLA:CPU round the bf16 stream at other points (a
# fused bias add, the mean pool); each lies 1-2e-2 from the f32 model, so
# two bf16 steps of the embedding's |x| <= 4
BF16_ATOL = 3e-2


def _images(n=3, seed=0):
    return np.random.default_rng(seed).normal(
        size=(n, 32, 32, 3)).astype(np.float32)


def _jax_params(model, x, seed=0):
    """JAX init, every leaf then moved off its init value (biases and
    LayerNorm scales included) by seeded noise."""
    params = model.init(jax.random.key(seed), jnp.asarray(x))["params"]
    rng = np.random.default_rng(seed + 1)
    return jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.1 * rng.standard_normal(p.shape).astype(
            np.float32), params)


def _port(params, dtype=torch.float32, **kw):
    model = ViTFace(**TINY, dtype=dtype, **kw)
    model.load_state_dict(
        face_vit_state_dict_from_jax(params, TINY["depth"]), strict=True)
    return model.eval()


@pytest.mark.parametrize("overlapping", [False, True])
@pytest.mark.parametrize("pool", ["cls", "mean"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embeddings_match_jax(overlapping, pool, dtype):
    kw = dict(overlapping=overlapping, pool=pool, loss_type="CosFace")
    jmodel = JaxViTFace(**TINY, **kw, dtype=getattr(jnp, dtype))
    x = _images()
    params = _jax_params(jmodel, x)
    ref = np.asarray(jmodel.apply({"params": params}, jnp.asarray(x)))
    model = _port(params, getattr(torch, dtype), **kw)
    with torch.no_grad():
        emb = model(torch.from_numpy(x))
    assert emb.dtype == torch.float32 and emb.shape == (3, 64)
    if dtype == "float32":
        np.testing.assert_allclose(emb.numpy(), ref, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_allclose(emb.numpy(), ref, atol=BF16_ATOL, rtol=0)
        f32 = np.asarray(JaxViTFace(**TINY, **kw).apply({"params": params},
                                                        jnp.asarray(x)))
        assert np.abs(emb.numpy() - f32).max() <= 1.5 * np.abs(
            ref - f32).max()


@pytest.mark.parametrize("loss_type", LOSSES)
def test_model_logits_match_jax(loss_type):
    """``forward(img, label)``: the head's logits and the embeddings."""
    jmodel = JaxViTFace(**TINY, loss_type=loss_type)
    x = _images(4, seed=2)
    labels = np.array([1, 3, 3, 9])
    params = _jax_params(jmodel, x, seed=2)
    assert ("loss_bias" in params) == (loss_type == "Softmax")
    ref_logits, ref_emb = jmodel.apply({"params": params}, jnp.asarray(x),
                                       jnp.asarray(labels))
    model = _port(params, loss_type=loss_type)
    with torch.no_grad():
        logits, emb = model(torch.from_numpy(x), torch.from_numpy(labels))
    np.testing.assert_allclose(emb.numpy(), ref_emb, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(logits.numpy(), ref_logits, rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("loss_type", LOSSES)
@pytest.mark.parametrize("with_label", [True, False])
def test_margin_logits_match_jax(loss_type, with_label):
    rng = np.random.default_rng(3)
    w = rng.normal(size=(10, 16)).astype(np.float32)
    emb = rng.normal(size=(6, 16)).astype(np.float32)
    bias = rng.normal(size=(10,)).astype(np.float32)
    # target cosines on both sides of the ArcFace guard's threshold
    # cos(pi - 0.5) = -0.878: near -1 and near +1, each 0.2 off its weight
    # row (at a cosine of exactly +-1, sqrt(1 - cos^2) turns an f32 rounding
    # of cos into 1e-2 of a logit)
    emb[0] = -w[2] + 0.2 * emb[0] / np.linalg.norm(emb[0]) * np.linalg.norm(
        w[2])
    emb[1] = w[4] + 0.2 * emb[1] / np.linalg.norm(emb[1]) * np.linalg.norm(
        w[4])
    label = np.array([2, 4, 0, 9, 5, 5])
    lab = label if with_label else None
    b = bias if loss_type == "Softmax" else None
    ref = jax_margin_logits(
        jnp.asarray(w), jnp.asarray(emb),
        None if lab is None else jnp.asarray(lab), loss_type,
        bias=None if b is None else jnp.asarray(b))
    out = margin_logits(
        torch.from_numpy(w), torch.from_numpy(emb),
        None if lab is None else torch.from_numpy(lab), loss_type,
        bias=None if b is None else torch.from_numpy(b))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_margin_logits_unknown_type_raises():
    w, emb = torch.ones(3, 4), torch.ones(2, 4)
    with pytest.raises(ValueError, match="unknown loss_type"):
        margin_logits(w, emb, torch.tensor([0, 1]), "NoFace")
    with pytest.raises(ValueError, match="unknown loss_type"):
        ViTFace(**{**TINY, "depth": 1}, loss_type="NoFace")


def test_sface_loss_and_gradient_match_jax():
    rng = np.random.default_rng(4)
    cos = rng.uniform(-1, 1, (4, 10)).astype(np.float32)
    cos[0, 0] = 0.93   # a target near the intra gate's centre a = 0.9
    label = np.array([0, 1, 2, 3])
    fn = lambda c: jax_sface_loss(c, jnp.asarray(label))  # noqa: E731
    ref, ref_grad = jax.value_and_grad(fn)(jnp.asarray(cos))
    c = torch.from_numpy(cos).requires_grad_()
    loss = sface_loss(c, torch.from_numpy(label))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(c.grad.numpy(), ref_grad, rtol=1e-5,
                               atol=1e-5)


def _reference_state_dict(depth, seed=5, patch_dim=192):
    """A synthetic state dict in the reference ``ViT_face`` layout (the keys
    ``convert_vit_face`` reads), CosFace head included, for 32-px images
    (16 patches of ``patch_dim`` features: 192 plain, 432 overlapping)."""
    rng = np.random.default_rng(seed)
    r = lambda *s: (0.2 * rng.standard_normal(s)).astype(np.float32)  # noqa
    sd = {"cls_token": r(1, 1, 64), "pos_embedding": r(1, 17, 64),
          "patch_to_embedding.weight": r(64, patch_dim),
          "patch_to_embedding.bias": r(64),
          "mlp_head.0.weight": 1 + r(64), "mlp_head.0.bias": r(64),
          "loss.weight": r(10, 64)}
    for i in range(depth):
        a, f = f"transformer.layers.{i}.0.fn", f"transformer.layers.{i}.1.fn"
        sd.update({f"{a}.norm.weight": 1 + r(64), f"{a}.norm.bias": r(64),
                   f"{a}.fn.to_qkv.weight": r(96, 64),
                   f"{a}.fn.to_out.0.weight": r(64, 32),
                   f"{a}.fn.to_out.0.bias": r(64),
                   f"{f}.norm.weight": 1 + r(64), f"{f}.norm.bias": r(64),
                   f"{f}.fn.net.0.weight": r(128, 64),
                   f"{f}.fn.net.0.bias": r(128),
                   f"{f}.fn.net.3.weight": r(64, 128),
                   f"{f}.fn.net.3.bias": r(64)})
    return sd


def test_reference_state_dict_and_jax_params_give_the_same_model():
    """A reference ``.pth`` layout read by the port and by JAX's
    ``convert_vit_face``, and the JAX params that conversion gives mapped
    with ``face_vit_state_dict_from_jax``: one model, JAX's embeddings."""
    sd = _reference_state_dict(TINY["depth"])
    jmodel = JaxViTFace(**TINY)
    x = _images(4, seed=6)
    init = jmodel.init(jax.random.key(0), jnp.asarray(x))["params"]
    jparams = merge_params(init, convert_vit_face(sd, TINY["depth"])[0])
    ref = np.asarray(jmodel.apply({"params": jparams}, jnp.asarray(x)))

    from_jax = _port(jparams)
    from_ref = ViTFace(**TINY)
    from_ref.load_state_dict(face_vit_state_dict(
        {k: torch.from_numpy(v) for k, v in sd.items()}, from_ref),
        strict=True)
    for a, b in zip(from_jax.state_dict().values(),
                    from_ref.state_dict().values()):
        assert torch.equal(a, b)
    with torch.no_grad():
        emb = from_ref.eval()(torch.from_numpy(x))
    np.testing.assert_allclose(emb.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_reference_state_dict_without_a_head_keeps_the_models():
    sd = {k: torch.from_numpy(v) for k, v in
          _reference_state_dict(1).items() if not k.startswith("loss.")}
    model = ViTFace(**{**TINY, "depth": 1}, loss_type="Softmax")
    out = face_vit_state_dict(sd, model)
    assert torch.equal(out["loss_weight"], model.loss_weight)
    assert torch.equal(out["loss_bias"], model.loss_bias)
    model.load_state_dict(out, strict=True)
    del sd["transformer.layers.0.1.fn.fn.net.3.bias"]
    with pytest.raises(KeyError):
        face_vit_state_dict(sd, model)


def test_build_vit_face_reference_widths():
    """``VIT`` / ``VITs`` at the reference's widths (built here one block
    deep with 10 classes; the defaults are 20 blocks and 93,431 classes):
    196 patches at 112 px in both modes, 1 + 196 position rows, 8 heads x
    64, mlp 2048, an f32 classifier weight; a seeded build gives the same
    weights in f32 and bf16."""
    for name, patch_dim in (("VIT", 192), ("VITs", 432)):
        m = build_vit_face(name, num_class=10, depth=1, dtype=torch.bfloat16,
                           generator=torch.Generator().manual_seed(0))
        assert m.patch_to_embedding.weight.shape == (512, patch_dim)
        assert m.patch_to_embedding.weight.dtype == torch.bfloat16
        assert m.pos_embedding.shape == (1, 197, 512)
        assert m.loss_weight.shape == (10, 512)
        assert m.loss_weight.dtype == torch.float32 and m.loss_bias is None
        assert m.blocks[0].attn.to_qkv.weight.shape == (3 * 8 * 64, 512)
        assert m.blocks[0].ff.fc1.weight.shape == (2048, 512)
        assert m.patchify(torch.zeros(1, 112, 112, 3)).shape == (
            1, 196, patch_dim)
    defaults = {k: p.default for k, p in
                inspect.signature(ViTFace).parameters.items()}
    assert {k: defaults[k] for k in ("image_size", "patch_size", "dim",
                                     "depth", "heads", "dim_head",
                                     "mlp_dim", "num_class")} == {
        "image_size": 112, "patch_size": 8, "dim": 512, "depth": 20,
        "heads": 8, "dim_head": 64, "mlp_dim": 2048, "num_class": 93431}
    assert inspect.signature(build_vit_face).parameters[
        "num_class"].default == 93431
    f32 = ViTFace(**TINY, generator=torch.Generator().manual_seed(0))
    b16 = ViTFace(**TINY, dtype=torch.bfloat16,
                  generator=torch.Generator().manual_seed(0))
    for (name, a), b in zip(f32.state_dict().items(),
                            b16.state_dict().values()):
        assert torch.equal(a.to(b.dtype), b), name
    with pytest.raises(ValueError, match="unknown face model"):
        build_vit_face("VITx")
