"""MAE in the port against the JAX package's ``MAERecipe``: the forward, one
``train_step`` from identical weights, view and mask (the loss, every
gradient, the parameters after AdamW with weight decay, and Adam's moments),
``extract_features``, the reference ``.pth`` reader on a state dict built
here, and both CLIs end to end on the CPU.

Both packages' ``vit_base_patch16`` is cut to patch 8, width 64, depth 2,
2 heads, and the decoder to width 32, depth 2, 2 heads, at 32 px (16
tokens, 4 kept): the step is one XLA compile on the CPU. The JAX CLI's
``--model vit_b_16`` raises ``KeyError`` (its ``VIT_CONFIGS`` lacks the
name); the port maps it to ``vit_base_patch16`` and is held against the JAX
recipe built with that name."""

import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import hairci.models.vit as jax_vit
import hairci.ssl.mae as jax_mae
import hairci_torch.models.vit as port_vit
import hairci_torch.ssl.mae as port_mae
from hairci.cli import knn_classification as jax_cli
from hairci.retrieval import torch_import as ti
from hairci.train.state import TrainState as JaxTrainState
from hairci_torch.cli import knn_classification, mainpretrain
from hairci_torch.models.convert import (
    mae_state_dict,
    mae_state_dict_from_jax,
    vit_state_dict_from_jax,
)
from hairci_torch.models.masking import random_token_mask_from_noise

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]
IMG_DIR = REPO / "HairPretraining" / "data" / "hair_regions"
B, S = 8, 32
N = (S // 8) ** 2
TINY_VIT = (8, 64, 2, 2)          # patch, width, depth, heads
TINY_DECODER = {"embed_dim": 32, "depth": 2, "num_heads": 2}
# a weight decay large enough that one step's decay (lr * wd = 5e-4 of a
# weight) shows above the tolerance of the parameters without a gradient
WD = 0.5
# the encoder's parameters that take no gradient in either package
NO_GRAD = ("encoder.pos_embed", "encoder.mask_token")


class TinyDecoder(jax_mae.MAEDecoder):
    embed_dim: int = TINY_DECODER["embed_dim"]
    depth: int = TINY_DECODER["depth"]
    num_heads: int = TINY_DECODER["num_heads"]


def _t(a):
    return torch.from_numpy(np.array(a))


def tiny(mp, port_only=False):
    """Both packages' ViT-B/16 (and MAE decoder) cut to tiny widths."""
    mp.setitem(port_vit.VIT_CONFIGS, "vit_base_patch16", TINY_VIT)
    mp.setattr(port_mae, "DECODER", TINY_DECODER)
    if not port_only:
        mp.setitem(jax_vit.VIT_CONFIGS, "vit_base_patch16", TINY_VIT)
        mp.setattr(jax_mae, "MAEDecoder", TinyDecoder)


def random_params(init_fn, rng):
    """Seeded numpy values in the shapes of ``init_fn()``'s params: kernels
    of variance 1/fan_in, LayerNorm parameters away from their init, tokens
    and position tables of unit scale."""
    def leaf(path, s):
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "kernel":
            v = rng.normal(0, np.prod(s.shape[:-1]) ** -0.5, s.shape)
        elif name == "scale":
            v = rng.uniform(0.5, 1.5, s.shape)
        elif name == "bias":
            v = rng.normal(0, 0.1, s.shape)
        elif name in ("cls_token", "mask_token", "pos_embed"):
            v = rng.normal(0, 0.5, s.shape)
        else:
            raise AssertionError(f"unexpected variable {name}")
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(
        leaf, jax.eval_shape(init_fn))["params"]


def capture_grads(mp):
    """JAX's ``apply_gradients`` keeps the raw gradients in ``extra``."""
    orig = JaxTrainState.apply_gradients
    mp.setattr(JaxTrainState, "apply_gradients",
               lambda self, grads, **kw: orig(self, grads, **kw).replace(
                   extra=grads))


def adam_moments(opt_state):
    """(mu, nu) of the optax Adam state inside ``opt_state``."""
    for s in jax.tree_util.tree_leaves(
            opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState)):
        if isinstance(s, optax.ScaleByAdamState):
            return s.mu, s.nu
    raise AssertionError("no Adam state")


def close(name, got, want, rtol, atol):
    np.testing.assert_allclose(
        got.detach().numpy() if isinstance(got, torch.Tensor) else got,
        np.asarray(want), rtol=rtol, atol=atol, err_msg=name)


def check_step(state, metrics, run, to_sd, no_grad):
    """The port's step against JAX's: loss, gradients, the no-gradient
    parameters and the cls token after the port's own AdamW step; then the
    optimizer alone on JAX's gradients: every parameter and Adam's
    moments. ``to_sd`` maps a JAX param tree to the port's names."""
    new, aux = run["new"], run["aux"]
    close("loss", metrics["loss"], aux["loss"], 1e-4, 1e-7)
    g = to_sd(new.extra)
    for name, p in state.online.named_parameters():
        close(f"grad {name}", p.grad, g[name], 1e-4, 1e-6)
    for name in no_grad:
        assert not state.online.get_parameter(name).grad.any(), name
    after, start = to_sd(new.params), to_sd(run["params"])
    # Adam's first step moves a weight by about lr whatever the size of its
    # gradient, so where the true gradient is 0 (the key part of qkv.bias,
    # which softmax ignores) both packages move by +-lr on rounding noise:
    # the other weights are held through the optimizer on JAX's gradients
    for name in no_grad + tuple(n for n in after if n.endswith("cls_token")):
        assert not np.allclose(after[name], start[name], rtol=1e-4), name
        close(name, state.online.get_parameter(name), after[name], 1e-4,
              1e-6)
    assert state.step == 1
    return g, after


def check_optimizer(state, g, after, opt_state, to_sd):
    for name, p in state.online.named_parameters():
        p.grad = g[name].clone()
    state.optimizer.step()
    mu, nu = (to_sd(m) for m in adam_moments(opt_state))
    for name, p in state.online.named_parameters():
        close(f"param {name}", p, after[name], 1e-6, 1e-6)
        st = state.optimizer.state[p]
        close(f"mu {name}", st["exp_avg"], mu[name], 1e-6, 1e-12)
        close(f"nu {name}", st["exp_avg_sq"], nu[name], 1e-6, 1e-12)


@pytest.fixture(scope="module")
def jax_run():
    """JAX's forward, step and features from one seeded state; the view is
    a seeded array handed to both, the mask comes from JAX's key."""
    with pytest.MonkeyPatch.context() as mp:
        tiny(mp)
        capture_grads(mp)
        rng = np.random.default_rng(0)
        view = rng.normal(size=(B, S, S, 3)).astype(np.float32)
        jrec = jax_mae.MAERecipe(backbone="vit_base_patch16", img_size=S,
                                 weight_decay=WD, dtype=jnp.float32)
        assert jrec.num_patches == N
        jrec.transform = lambda key, images: [jnp.asarray(view)]
        key = jax.random.key(7)
        _, k_mask = jax.random.split(key)
        noise = np.asarray(jax.random.uniform(k_mask, (B, N)))
        ids_keep, ids_restore, mask = jrec._mask(k_mask, B)
        params = random_params(lambda: jrec.module.init(
            jax.random.key(0), jnp.asarray(view), ids_keep, ids_restore),
            rng)
        state = JaxTrainState(
            step=jnp.zeros((), jnp.int32), params=params, batch_stats={},
            opt_state=jrec.tx.init(params), tx=jrec.tx)
        new, aux = jax.device_get(jax.jit(jrec.train_step)(
            state, {"image": jnp.zeros((B, S, S, 3), jnp.uint8)}, key))
        pred = jrec.module.apply({"params": params}, jnp.asarray(view),
                                 ids_keep, ids_restore)
        images = rng.integers(0, 256, (4, S + 8, S + 8, 3), dtype=np.uint8)
        feats = jrec.extract_features(state, jnp.asarray(images))
        return dict(view=view, noise=noise, params=params, new=new, aux=aux,
                    pred=np.asarray(pred), images=images,
                    feats=np.asarray(feats),
                    ids=[np.asarray(a) for a in (ids_keep, ids_restore,
                                                 mask)])


def _port_state(run, mp):
    tiny(mp, port_only=True)
    rec = port_mae.MAERecipe(img_size=S, weight_decay=WD,
                             dtype=torch.float32)
    state = rec.create_state(0, B, torch.device("cpu"))
    state.online.load_state_dict(mae_state_dict_from_jax(run["params"]),
                                 strict=True)
    return rec, state


def _mask(run):
    ids = random_token_mask_from_noise(_t(run["noise"]), 0.75)
    for got, want in zip(ids, run["ids"]):
        assert torch.equal(got, _t(want).to(got.dtype))
    return ids


def test_mae_forward_and_features_match_jax(jax_run, monkeypatch):
    rec, state = _port_state(jax_run, monkeypatch)
    ids_keep, ids_restore, _ = _mask(jax_run)
    assert ids_keep.shape == (B, 4)
    with torch.no_grad():
        pred = state.online(_t(jax_run["view"]), ids_keep, ids_restore)
    assert pred.dtype == torch.float32 and pred.shape == (B, N, 8 * 8 * 3)
    close("pred", pred, jax_run["pred"], 1e-4, 1e-5)
    feats = rec.extract_features(state, _t(jax_run["images"]))
    close("features", feats, jax_run["feats"], 1e-4, 1e-5)
    # the decoder's position table is a constant: a buffer, not saved
    assert "decoder.pos_embed" not in state.online.state_dict()
    assert "decoder.pos_embed" in dict(state.online.named_buffers())


def test_mae_step_matches_jax(jax_run, monkeypatch):
    rec, state = _port_state(jax_run, monkeypatch)
    metrics = rec.step_on_view(state, _t(jax_run["view"]), *_mask(jax_run))
    g, after = check_step(state, metrics, jax_run, mae_state_dict_from_jax,
                          NO_GRAD)
    _, state = _port_state(jax_run, monkeypatch)
    check_optimizer(state, g, after, jax_run["new"].opt_state,
                    mae_state_dict_from_jax)


def test_mae_recipe_maps_backbones_to_vit_b16(monkeypatch):
    tiny(monkeypatch, port_only=True)
    for name in ("resnet18", "resnet50", "vit_b_16", "vit_base_patch16"):
        rec = port_mae.MAERecipe(backbone=name, img_size=S)
        assert rec.backbone == "vit_base_patch16" and rec.num_patches == N
    # the JAX CLI's --model vit_b_16 is a KeyError there (reference fault)
    args = jax_cli.build_eval_parser().parse_args(
        ["--mode", "mae", "--model", "vit_b_16"])
    with pytest.raises(KeyError):
        jax_cli.recipe_for_eval(args)


# ---------------------------------------------------------------------------
# the reference checkpoint layout
# ---------------------------------------------------------------------------

def timm_block(sd, t, d, rng):
    """A timm ViT block's tensors under ``t`` (torch layouts)."""
    def put(name, *shape):
        sd[f"{t}.{name}"] = torch.from_numpy(
            rng.normal(0, 0.1, shape).astype(np.float32))
    for n in ("norm1", "norm2"):
        put(f"{n}.weight", d)
        put(f"{n}.bias", d)
    put("attn.qkv.weight", 3 * d, d)
    put("attn.qkv.bias", 3 * d)
    put("attn.proj.weight", d, d)
    put("attn.proj.bias", d)
    put("mlp.fc1.weight", 4 * d, d)
    put("mlp.fc1.bias", 4 * d)
    put("mlp.fc2.weight", d, 4 * d)
    put("mlp.fc2.bias", d)


def reference_mae_sd(seed=0, decoder=True):
    """A reference MAE state dict at the tiny widths: lightly's masked timm
    ViT under ``backbone.`` and MAEDecoderTIMM under ``decoder.``, with the
    tensors the readers drop (lightly's own mask token, the timm head, the
    decoder's fixed position table)."""
    rng = np.random.default_rng(seed)
    p, d, depth, _ = TINY_VIT
    dd = TINY_DECODER["embed_dim"]

    def r(*shape):
        return torch.from_numpy(rng.normal(0, 0.1, shape).astype(np.float32))

    sd = {"backbone.vit.cls_token": r(1, 1, d),
          "backbone.vit.pos_embed": r(1, N + 1, d),
          "backbone.vit.patch_embed.proj.weight": r(d, 3, p, p),
          "backbone.vit.patch_embed.proj.bias": r(d),
          "backbone.vit.norm.weight": r(d), "backbone.vit.norm.bias": r(d),
          "backbone.vit.head.weight": r(10, d),
          "backbone.mask_token": r(1, 1, d)}
    for i in range(depth):
        timm_block(sd, f"backbone.vit.blocks.{i}", d, rng)
    if decoder:
        sd.update({"decoder.decoder_embed.weight": r(dd, d),
                   "decoder.decoder_embed.bias": r(dd),
                   "decoder.mask_token": r(1, 1, dd),
                   "decoder.decoder_pos_embed": r(1, N + 1, dd),
                   "decoder.decoder_norm.weight": r(dd),
                   "decoder.decoder_norm.bias": r(dd),
                   "decoder.decoder_pred.weight": r(p * p * 3, dd),
                   "decoder.decoder_pred.bias": r(p * p * 3)})
        for i in range(TINY_DECODER["depth"]):
            timm_block(sd, f"decoder.decoder_blocks.{i}", dd, rng)
    return sd


@pytest.mark.parametrize("decoder", [True, False])
def test_reference_reader_matches_convert_mae(decoder, monkeypatch):
    """``mae_state_dict`` against ``convert_mae`` mapped by
    ``mae_state_dict_from_jax``: equal tensors; a file without the decoder
    leaves the model's own decoder."""
    tiny(monkeypatch, port_only=True)
    sd = reference_mae_sd(decoder=decoder)
    model = port_mae.MAEModule(img_size=S)
    own = {k: v.clone() for k, v in model.state_dict().items()}
    model.load_state_dict(mae_state_dict(sd, model), strict=True)
    params, _ = ti.convert_mae({k: v.numpy() for k, v in sd.items()},
                               depth=2, decoder_depth=2)
    assert ("decoder" in params) == decoder
    want = (mae_state_dict_from_jax(params) if decoder else
            {f"encoder.{k}": v for k, v in
             vit_state_dict_from_jax(params["encoder"], 2).items()})
    for k, v in model.state_dict().items():
        assert torch.equal(v, want[k] if k in want else own[k]), k
    assert set(want) <= set(model.state_dict())
    assert decoder or not any(k.startswith("decoder.") for k in want)


# ---------------------------------------------------------------------------
# both CLIs on the CPU
# ---------------------------------------------------------------------------

def manifests(root, n_train=10, n_test=6):
    names = sorted(p.name for p in IMG_DIR.glob("*_hair.png"))
    out = []
    for name, rows in (("train.csv", names[:n_train]),
                       ("test.csv", names[2:2 + n_test])):
        (root / name).write_text("id,class\n" + "".join(
            f"{n},{int(n[:6]) % 3}\n" for n in rows))
        out.append(str(root / name))
    return out


def run_clis(mode, tmp_path, checkpoint=None):
    """``mainpretrain --mode MODE`` for 2 epochs (batches of 4, the last
    padded) unless ``checkpoint`` is given, then ``knn_classification
    --mode MODE --eval_type knn`` on the run or the file; both with
    ``--model vit_b_16 --device cpu``. Returns (trainer, classifier)."""
    train_csv, test_csv = manifests(tmp_path)
    common = ["--mode", mode, "--model", "vit_b_16", "--size", str(S),
              "--device", "cpu", "--dtype", "float32", "--batch_size", "4",
              "--num_workers", "1", "--train_annotation", train_csv,
              "--img_dir", str(IMG_DIR)]
    trainer = None
    if checkpoint is None:
        trainer = mainpretrain.main(common + [
            "--epochs", "2", "--save_path", str(tmp_path / "out")])
        checkpoint = trainer.save_path
    clf = knn_classification.main(common + [
        "--eval_type", "knn", "--test_annotation", test_csv,
        "--checkpoint_path", str(checkpoint),
        "--save_path", str(tmp_path / "knn")])
    assert (tmp_path / "knn" / "knn_evaluation_results.txt").is_file()
    return trainer, clf


def check_trained_run(trainer):
    run = Path(trainer.save_path)
    assert trainer.state.step == 6 and len(trainer.train_loader) == 3
    log = (run / "training_log.txt").read_text()
    losses = [float(line.split("Loss = ")[1]) for line in log.splitlines()
              if ": Loss = " in line]
    assert len(losses) == 2 and all(np.isfinite(losses))
    ckpt = torch.load(run / "model_ckpt_latest", weights_only=True)
    assert set(ckpt) == {"online", "optimizer", "step", "epoch"}


def check_features(clf, width):
    tr_f, _, te_f, _ = clf.extracting_features()
    assert tr_f.shape == (10, width) and te_f.shape == (6, width)
    for f in (tr_f, te_f):
        assert np.isfinite(f).all()
        np.testing.assert_allclose(np.linalg.norm(f, axis=1), 1, atol=1e-5)
    return tr_f


def test_clis_train_and_evaluate_mae(tmp_path, monkeypatch):
    tiny(monkeypatch, port_only=True)
    trainer, clf = run_clis("mae", tmp_path)
    check_trained_run(trainer)
    check_features(clf, 64)


def test_knn_cli_reads_a_reference_mae_pth(tmp_path, monkeypatch):
    """A reference MAE ``.pth`` through the eval CLI gives the JAX recipe's
    features of the same images, its weights read by ``convert_mae``."""
    tiny(monkeypatch)
    sd = reference_mae_sd(seed=3)
    torch.save({"model_state_dict": sd}, tmp_path / "mae.pth")
    _, clf = run_clis("mae", tmp_path, checkpoint=tmp_path / "mae.pth")
    got = check_features(clf, 64)
    params, _ = ti.convert_mae({k: v.numpy() for k, v in sd.items()},
                               depth=2, decoder_depth=2)
    jrec = jax_mae.MAERecipe(backbone="vit_base_patch16", img_size=S,
                             dtype=jnp.float32)
    images = np.concatenate([x for x, _ in clf.train_loader])[:10]
    want = np.array(jrec.extract_features(
        types.SimpleNamespace(params=params), jnp.asarray(images)))
    want /= np.linalg.norm(want, axis=1, keepdims=True)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
