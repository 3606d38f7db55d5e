"""The port's reader of torchvision-layout ViT state dicts
(``models.convert.torchvision_vit_state_dict``) against the JAX package's
``convert_torchvision_vit`` on the CPU: a synthetic torchvision ViT (patch
8, width 64, depth 2 at 32 px; both MLP namings, both cls-token names)
gives JAX's tokens at 1e-5; and ``knn_classification --mode simclr --model
vit_b_16`` reads a reference SimCLR ``.pth`` holding one."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hairci.models.vit import VisionTransformer as JaxViT
from hairci.retrieval.torch_import import (
    convert_torchvision_vit,
    merge_params,
    save_torch_state_dict,
)
from hairci_torch.models.convert import (
    torchvision_vit_state_dict,
    vit_state_dict_from_jax,
)
from hairci_torch.models.vit import VisionTransformer

torch.set_num_threads(1)
TINY = dict(patch_size=8, embed_dim=64, depth=2, num_heads=4, img_size=32)


def _torchvision_sd(seed=0, mlp_names=("0", "3"), cls="class_token"):
    """A torchvision ``VisionTransformer`` state dict at TINY's shapes, with
    torchvision's learned position table and classifier head."""
    rng = np.random.default_rng(seed)
    r = lambda *s: (0.1 * rng.standard_normal(s)).astype(np.float32)  # noqa
    sd = {cls: r(1, 1, 64), "encoder.pos_embedding": r(1, 17, 64),
          "conv_proj.weight": r(64, 3, 8, 8), "conv_proj.bias": r(64),
          "encoder.ln.weight": 1 + r(64), "encoder.ln.bias": r(64),
          "heads.head.weight": r(10, 64), "heads.head.bias": r(10)}
    for i in range(2):
        t = f"encoder.layers.encoder_layer_{i}"
        sd.update({
            f"{t}.ln_1.weight": 1 + r(64), f"{t}.ln_1.bias": r(64),
            f"{t}.ln_2.weight": 1 + r(64), f"{t}.ln_2.bias": r(64),
            f"{t}.self_attention.in_proj_weight": r(192, 64),
            f"{t}.self_attention.in_proj_bias": r(192),
            f"{t}.self_attention.out_proj.weight": r(64, 64),
            f"{t}.self_attention.out_proj.bias": r(64),
            f"{t}.mlp.{mlp_names[0]}.weight": r(256, 64),
            f"{t}.mlp.{mlp_names[0]}.bias": r(256),
            f"{t}.mlp.{mlp_names[1]}.weight": r(64, 256),
            f"{t}.mlp.{mlp_names[1]}.bias": r(64)})
    return sd


def _jax_tokens(sd, x, global_pool=False):
    model = JaxViT(**TINY, global_pool=global_pool)
    init = model.init(jax.random.key(0), jnp.asarray(x), train=False)
    params = merge_params(init["params"],
                          convert_torchvision_vit(sd, depth=2)[0])
    return params, np.asarray(model.apply({"params": params}, jnp.asarray(x),
                                          train=False))


@pytest.mark.parametrize("mlp_names,cls", [
    (("0", "3"), "class_token"), (("linear_1", "linear_2"), "cls_token")])
def test_reader_matches_jax(mlp_names, cls):
    sd = _torchvision_sd(mlp_names=mlp_names, cls=cls)
    x = np.random.default_rng(1).normal(size=(3, 32, 32, 3)).astype(
        np.float32)
    params, ref = _jax_tokens(sd, x)
    model = VisionTransformer(**TINY)
    model.load_state_dict(torchvision_vit_state_dict(
        {k: torch.from_numpy(v) for k, v in sd.items()}, model), strict=True)
    with torch.no_grad():
        tokens = model.eval()(torch.from_numpy(x))
    np.testing.assert_allclose(tokens.numpy(), ref, rtol=1e-5, atol=1e-5)
    # the same weights as JAX's converted params carried by the JAX mapping
    for key, value in vit_state_dict_from_jax(params, 2).items():
        assert torch.equal(model.state_dict()[key], value), key


def test_reader_fills_fc_norm_and_refuses_other_layouts():
    sd = {k: torch.from_numpy(v) for k, v in _torchvision_sd().items()}
    model = VisionTransformer(**TINY, global_pool=True)
    out = torchvision_vit_state_dict(sd, model)
    assert torch.equal(out["fc_norm.weight"], torch.ones(64))
    assert torch.equal(out["mask_token"], torch.zeros(1, 1, 64))
    model.load_state_dict(out, strict=True)
    with pytest.raises(KeyError, match="not a torchvision ViT"):
        torchvision_vit_state_dict({"cls_token": sd["class_token"]}, model)


def test_knn_cli_reads_a_reference_simclr_vit_pth(tmp_path, monkeypatch):
    """``--mode simclr --model vit_b_16`` (ViT-B/16 cut to TINY) on a
    reference SimCLR ``.pth``: ``backbone.`` holds the torchvision ViT,
    ``projection_head.layers`` the head. The CLI's features are JAX's
    tokens' cls row of the same images, L2-normalised."""
    import hairci_torch.models.heads as port_heads
    import hairci_torch.models.vit as port_vit
    from hairci_torch.cli import knn_classification as cli
    from hairci_torch.ssl.simclr import SimCLRModule
    from test_torch_knn_cli import IMG_DIR, _manifests

    monkeypatch.setitem(port_vit.VIT_CONFIGS, "vit_base_patch16",
                        (8, 64, 2, 4))
    monkeypatch.setitem(port_heads.SIMCLR_PROJ_DIMS, "vit_b_16", (64, 32))
    sd = {f"backbone.{k}": v for k, v in _torchvision_sd(seed=2).items()}
    head = SimCLRModule("vit_b_16", img_size=32).projection_head
    sd.update({f"projection_head.{k}": v.numpy()
               for k, v in head.state_dict().items()})
    path = str(tmp_path / "simclr_vit.pth")
    save_torch_state_dict(sd, path)
    train_csv, test_csv = _manifests(tmp_path, n_train=6, n_test=3)
    clf = cli.main([
        "--mode", "simclr", "--model", "vit_b_16", "--size", "32",
        "--device", "cpu", "--dtype", "float32", "--batch_size", "4",
        "--num_workers", "1", "--eval_type", "knn", "--checkpoint_path", path,
        "--train_annotation", train_csv, "--test_annotation", test_csv,
        "--img_dir", str(IMG_DIR), "--save_path", str(tmp_path / "knn")])
    feats = clf.extracting_features()[2]
    images = next(iter(clf.test_loader))[0]
    from hairci.aug.pipelines import knn_transform

    x = np.asarray(knn_transform(jnp.asarray(images), 32))
    _, tokens = _jax_tokens({k[len("backbone."):]: v for k, v in sd.items()
                             if k.startswith("backbone.")}, x)
    ref = tokens[:, 0] / np.linalg.norm(tokens[:, 0], axis=1, keepdims=True)
    np.testing.assert_allclose(feats, ref, atol=1e-5)
