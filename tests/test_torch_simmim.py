"""SimMIM in the port against the JAX package's ``SimMIMRecipe``: the
forward, one ``train_step`` from identical weights, view and mask (the
loss, every gradient, the parameters after AdamW with weight decay, and
Adam's moments), ``extract_features`` (the mean of the normed tokens), the
reference ``.pth`` reader (a torchvision ViT) on a state dict built here,
and both CLIs end to end on the CPU.

ViT-B/16 is cut to patch 8, width 64, depth 2, 2 heads at 32 px (16
tokens, 6 kept at ratio 0.6) in both packages: the step is one XLA compile
on the CPU."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hairci.ssl.simmim as jax_simmim
import hairci_torch.ssl.simmim as port_simmim
from hairci.retrieval import torch_import as ti
from hairci.train.state import TrainState as JaxTrainState
from hairci_torch.models.convert import (
    simmim_state_dict,
    simmim_state_dict_from_jax,
)
from hairci_torch.models.masking import random_token_mask_from_noise
from test_torch_mae import (
    B,
    N,
    S,
    TINY_VIT,
    WD,
    capture_grads,
    check_features,
    check_optimizer,
    check_step,
    close,
    random_params,
    run_clis,
    check_trained_run,
    tiny,
)

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def jax_run():
    with pytest.MonkeyPatch.context() as mp:
        tiny(mp)
        capture_grads(mp)
        rng = np.random.default_rng(1)
        view = rng.normal(size=(B, S, S, 3)).astype(np.float32)
        jrec = jax_simmim.SimMIMRecipe(backbone="vit_base_patch16",
                                       img_size=S, weight_decay=WD,
                                       dtype=jnp.float32)
        jrec.transform = lambda key, images: [jnp.asarray(view)]
        key = jax.random.key(11)
        _, k_mask = jax.random.split(key)
        noise = np.asarray(jax.random.uniform(k_mask, (B, N)))
        _, _, maskf = jax_simmim.random_token_mask(k_mask, B, N, 0.6)
        mask = np.asarray(maskf) > 0.5
        params = random_params(lambda: jrec.module.init(
            jax.random.key(0), jnp.asarray(view), jnp.asarray(mask)), rng)
        state = JaxTrainState(
            step=jnp.zeros((), jnp.int32), params=params, batch_stats={},
            opt_state=jrec.tx.init(params), tx=jrec.tx)
        new, aux = jax.device_get(jax.jit(jrec.train_step)(
            state, {"image": jnp.zeros((B, S, S, 3), jnp.uint8)}, key))
        pred = jrec.module.apply({"params": params}, jnp.asarray(view),
                                 jnp.asarray(mask))
        images = rng.integers(0, 256, (4, S + 8, S + 8, 3), dtype=np.uint8)
        feats = jrec.extract_features(state, jnp.asarray(images))
        return dict(view=view, noise=noise, mask=mask, params=params,
                    new=new, aux=aux, pred=np.asarray(pred), images=images,
                    feats=np.asarray(feats))


def _port_state(run, mp):
    tiny(mp, port_only=True)
    rec = port_simmim.SimMIMRecipe(img_size=S, weight_decay=WD,
                                   dtype=torch.float32)
    state = rec.create_state(0, B, torch.device("cpu"))
    state.online.load_state_dict(simmim_state_dict_from_jax(run["params"]),
                                 strict=True)
    return rec, state


def _mask(run):
    _, _, maskf = random_token_mask_from_noise(_t(run["noise"]), 0.6)
    mask = maskf > 0.5
    assert torch.equal(mask, _t(run["mask"]))
    assert (~mask).sum(1).eq(6).all()            # int(16 * 0.4) kept
    return mask


def test_simmim_forward_and_features_match_jax(jax_run, monkeypatch):
    rec, state = _port_state(jax_run, monkeypatch)
    with torch.no_grad():
        pred = state.online(_t(jax_run["view"]), _mask(jax_run))
    assert pred.dtype == torch.float32 and pred.shape == (B, N, 8 * 8 * 3)
    close("pred", pred, jax_run["pred"], 1e-4, 1e-5)
    feats = rec.extract_features(state, _t(jax_run["images"]))
    close("features", feats, jax_run["feats"], 1e-4, 1e-5)
    assert "pos_embed" not in state.online.state_dict()
    assert "pos_embed" in dict(state.online.named_buffers())


def test_simmim_step_matches_jax(jax_run, monkeypatch):
    rec, state = _port_state(jax_run, monkeypatch)
    metrics = rec.step_on_view(state, _t(jax_run["view"]), _mask(jax_run))
    # every parameter takes a gradient: the mask token replaces 10 tokens
    g, after = check_step(state, metrics, jax_run,
                          simmim_state_dict_from_jax, ())
    assert state.online.mask_token.grad.abs().sum() > 0
    _, state = _port_state(jax_run, monkeypatch)
    check_optimizer(state, g, after, jax_run["new"].opt_state,
                    simmim_state_dict_from_jax)


def reference_simmim_sd(seed=0):
    """A reference SimMIM state dict at the tiny widths: lightly's masked
    torchvision ViT (``backbone.vit.``: ``class_token``, ``conv_proj``,
    ``encoder.pos_embedding``, ``encoder.layers.encoder_layer_{i}``,
    ``encoder.ln``; lightly's own ``backbone.mask_token``) and the linear
    ``decoder``."""
    rng = np.random.default_rng(seed)
    p, d, depth, _ = TINY_VIT

    def r(*shape):
        return torch.from_numpy(rng.normal(0, 0.1, shape).astype(np.float32))

    sd = {"backbone.vit.class_token": r(1, 1, d),
          "backbone.vit.conv_proj.weight": r(d, 3, p, p),
          "backbone.vit.conv_proj.bias": r(d),
          "backbone.vit.encoder.pos_embedding": r(1, N + 1, d),
          "backbone.vit.encoder.ln.weight": r(d),
          "backbone.vit.encoder.ln.bias": r(d),
          "backbone.mask_token": r(1, 1, d),
          "decoder.weight": r(p * p * 3, d), "decoder.bias": r(p * p * 3)}
    for i in range(depth):
        t = f"backbone.vit.encoder.layers.encoder_layer_{i}"
        for n in ("ln_1", "ln_2"):
            sd[f"{t}.{n}.weight"], sd[f"{t}.{n}.bias"] = r(d), r(d)
        sd[f"{t}.self_attention.in_proj_weight"] = r(3 * d, d)
        sd[f"{t}.self_attention.in_proj_bias"] = r(3 * d)
        sd[f"{t}.self_attention.out_proj.weight"] = r(d, d)
        sd[f"{t}.self_attention.out_proj.bias"] = r(d)
        sd[f"{t}.mlp.0.weight"], sd[f"{t}.mlp.0.bias"] = r(4 * d, d), r(4 * d)
        sd[f"{t}.mlp.3.weight"], sd[f"{t}.mlp.3.bias"] = r(d, 4 * d), r(d)
    return sd


def test_reference_reader_matches_convert_simmim(monkeypatch):
    tiny(monkeypatch, port_only=True)
    sd = reference_simmim_sd()
    model = port_simmim.SimMIMModule(img_size=S)
    got = simmim_state_dict(sd, model)
    model.load_state_dict(got, strict=True)
    params, _ = ti.convert_simmim({k: v.numpy() for k, v in sd.items()},
                                  depth=2)
    want = simmim_state_dict_from_jax(params)
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    # the class token and position table have no place, as in JAX
    assert not any("class_token" in k or "pos" in k for k in got)


def test_clis_train_and_evaluate_simmim(tmp_path, monkeypatch):
    tiny(monkeypatch, port_only=True)
    trainer, clf = run_clis("simMIM", tmp_path)
    check_trained_run(trainer)
    check_features(clf, 64)


def test_knn_cli_reads_a_reference_simmim_pth(tmp_path, monkeypatch):
    tiny(monkeypatch)
    sd = reference_simmim_sd(seed=4)
    torch.save({"model_state_dict": sd}, tmp_path / "simmim.pth")
    _, clf = run_clis("simMIM", tmp_path,
                      checkpoint=tmp_path / "simmim.pth")
    got = check_features(clf, 64)
    params, _ = ti.convert_simmim({k: v.numpy() for k, v in sd.items()},
                                  depth=2)
    jrec = jax_simmim.SimMIMRecipe(backbone="vit_base_patch16", img_size=S,
                                   dtype=jnp.float32)
    images = np.concatenate([x for x, _ in clf.train_loader])[:10]
    want = np.array(jrec.extract_features(
        types.SimpleNamespace(params=params), jnp.asarray(images)))
    want /= np.linalg.norm(want, axis=1, keepdims=True)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
