"""The port's ResNet and SHAMModule against the JAX package on the same
weights (converted with ``hairci_torch.models.convert``): pooled features and
projections in eval and train BN, f32, plus the new running stats."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hairci.models.resnet import build_resnet as jax_build_resnet
from hairci.ssl.sham import SHAMModule as JaxSHAMModule
from hairci_torch.models.convert import (
    resnet_state_dict_from_jax,
    sham_state_dict_from_jax,
)
from hairci_torch.models.resnet import build_resnet
from hairci_torch.ssl.sham import SHAMModule

torch.set_num_threads(1)
TOL = dict(rtol=1e-4, atol=1e-4)


def random_variables(module, x, rng, **kw):
    """Seeded numpy weights in the shapes of ``module.init`` (eager flax init
    takes ~20 s a ResNet on the CPU; ``eval_shape`` only traces): kernels of
    variance 1/fan_in, and BN scales, biases and running stats away from
    their init, so the zero-init last gammas and the eval-mode stats both
    matter."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.key(0),
                                                jnp.asarray(x), **kw))

    def leaf(path, s):
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "kernel":
            fan_in = int(np.prod(s.shape[:-1]))
            v = rng.normal(0, fan_in ** -0.5, s.shape)
        elif name == "scale":
            v = rng.uniform(0.5, 1.5, s.shape)
        elif name in ("bias", "mean"):
            v = rng.normal(0, 0.1, s.shape)
        elif name == "var":
            v = rng.uniform(0.5, 1.5, s.shape)
        else:
            raise AssertionError(f"unexpected variable {name}")
        return v.astype(np.float32)

    v = jax.tree_util.tree_map_with_path(leaf, shapes)
    return v["params"], v["batch_stats"]


def _nhwc(rng, B, size):
    return rng.normal(size=(B, size, size, 3)).astype(np.float32)


@pytest.mark.parametrize("stem,size", [("imagenet", 48), ("cifar", 16)])
def test_resnet18_matches_jax(stem, size):
    rng = np.random.default_rng(0)
    x = _nhwc(rng, 3, size)
    jmodel = jax_build_resnet("resnet18", stem=stem)
    params, stats = random_variables(jmodel, x, rng, train=False)
    model = build_resnet("resnet18", stem=stem)
    model.load_state_dict(resnet_state_dict_from_jax(params, stats),
                          strict=True)
    model.eval()
    apply = jax.jit(jmodel.apply, static_argnames=("train", "mutable"))
    want = apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                 train=False)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    model.train()
    want, upd = apply({"params": params, "batch_stats": stats},
                      jnp.asarray(x), train=True, mutable=("batch_stats",))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    new = resnet_state_dict_from_jax(params, upd["batch_stats"])
    for k, t in model.state_dict().items():
        if "running" in k:
            np.testing.assert_allclose(t.numpy(), new[k].numpy(), rtol=1e-5,
                                       atol=1e-5, err_msg=k)


def test_sham_module_matches_jax():
    # 16 rows: the head's train-mode BN normalises over the batch alone, and
    # over 4 similar rows it amplifies f32 rounding past 1e-4
    rng = np.random.default_rng(1)
    x = _nhwc(rng, 16, 32)
    jmod = JaxSHAMModule(backbone_name="resnet18", img_size=32)
    params, stats = random_variables(jmod, x, rng, train=True)
    mod = SHAMModule("resnet18")
    mod.load_state_dict(sham_state_dict_from_jax(params, stats), strict=True)
    variables = {"params": params, "batch_stats": stats}
    apply = jax.jit(jmod.apply, static_argnames=("train", "mutable",
                                                 "method"))
    mod.eval()
    with torch.no_grad():
        feats = mod.extract_features(torch.from_numpy(x))
        proj = mod(torch.from_numpy(x))
    np.testing.assert_allclose(
        feats.numpy(), np.asarray(apply(
            variables, jnp.asarray(x), train=False,
            method=JaxSHAMModule.extract_features)), **TOL)
    np.testing.assert_allclose(
        proj.numpy(), np.asarray(apply(variables, jnp.asarray(x),
                                       train=False)), **TOL)
    mod.train()
    want, upd = apply(variables, jnp.asarray(x), train=True,
                      mutable=("batch_stats",))
    with torch.no_grad():
        got = mod(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    new = sham_state_dict_from_jax(params, upd["batch_stats"])
    for k in ("projection_head.layers.1.running_var",
              "projection_head.layers.4.running_mean",
              "backbone.layer4.1.bn2.running_var"):
        np.testing.assert_allclose(mod.state_dict()[k].numpy(),
                                   new[k].numpy(), rtol=1e-5, atol=1e-5)


def test_resnet50_sham_state_dict_loads_strict():
    # the bottleneck key mapping at full width, from shapes alone
    jmod = JaxSHAMModule(backbone_name="resnet50", img_size=32)
    params, stats = random_variables(jmod, np.zeros((2, 32, 32, 3)),
                                     np.random.default_rng(2), train=True)
    sd = sham_state_dict_from_jax(params, stats, model="resnet50")
    mod = SHAMModule("resnet50")
    mod.load_state_dict(sd, strict=True)
    assert mod.backbone.num_features == 2048
    bns = [m for m in mod.modules() if type(m).__name__ == "BatchNorm"]
    assert len(bns) == 55  # 53 in the trunk, 2 in the head
    assert not any("num_batches_tracked" in k for k in mod.state_dict())
