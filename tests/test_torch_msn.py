"""MSN in the port against the JAX package's ``MSNRecipe``: one
``train_step`` from identical weights, BN statistics, views and mask (the
loss and every gradient, the prototypes' included, at rtol 1e-4; the BN
running statistics after the anchors' and the focal views' passes at rtol
1e-4; the target branch's EMA, taken BEFORE the step over parameters and BN
statistics, and the parameters after the optimizer on JAX's gradients at
rtol 1e-6), the features of the target branch, the reference ``.pth``
readers of MSN and DINOv2 (all three weight-norm layouts of DINOv2's last
layer) on state dicts built here, against ``convert_msn`` /
``convert_dinov2``, and both CLIs on the CPU.

Both packages' ``vit_base_patch16`` is cut to patch 8, width 64, depth 2,
2 heads at 32-px views and 16-px focal views (two of them); the step is one
XLA compile on the CPU. The JAX recipe raises ``KeyError`` on
``backbone="vit_b_16"``; the port maps it to ``vit_base_patch16``."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hairci.models.vit as jax_vit
import hairci.ssl.msn as jax_msn
import hairci_torch.models.vit as port_vit
from hairci.retrieval import torch_import as ti
from hairci.train.state import TrainState as JaxTrainState
from hairci_torch.aug.pipelines import knn_transform
from hairci_torch.models.convert import (
    dinov2_state_dict,
    dinov2_state_dict_from_jax,
    msn_state_dict,
    msn_state_dict_from_jax,
)
from hairci_torch.models.masking import random_token_mask_from_noise
from hairci_torch.ssl import RECIPES
from hairci_torch.ssl.dinov2 import DINOv2Module
from hairci_torch.ssl.msn import MSNModule, MSNRecipe
from test_torch_convert import _torchvision_sd
from test_torch_distill import random_tree
from test_torch_mae import IMG_DIR, manifests, timm_block

torch.set_num_threads(1)
B, S, FOCAL, N_FOCAL = 4, 32, 16, 2
TINY_VIT = (8, 64, 2, 2)          # patch, width, depth, heads
N = (S // 8) ** 2
WD = 0.5        # one step's decay (lr * wd) shows above the tolerance
CPU = torch.device("cpu")


def _t(a):
    return torch.from_numpy(np.array(a))


def tiny(mp, port_only=False):
    mp.setitem(port_vit.VIT_CONFIGS, "vit_base_patch16", TINY_VIT)
    if not port_only:
        mp.setitem(jax_vit.VIT_CONFIGS, "vit_base_patch16", TINY_VIT)


def close(name, got, want, rtol, atol):
    np.testing.assert_allclose(
        got.detach().numpy() if isinstance(got, torch.Tensor) else got,
        np.asarray(want), rtol=rtol, atol=atol, err_msg=name)


@pytest.fixture(scope="module")
def jax_run():
    """JAX's step and target features from a seeded state whose target
    branch (parameters and BN statistics) is apart from the anchor's."""
    with pytest.MonkeyPatch.context() as mp:
        tiny(mp)
        orig = JaxTrainState.apply_gradients
        # keep the raw gradients (the step leaves neg_indices unused)
        mp.setattr(JaxTrainState, "apply_gradients",
                   lambda self, grads, **kw: orig(self, grads, **kw).replace(
                       neg_indices=grads))
        rng = np.random.default_rng(0)
        views = [rng.normal(size=(B, S, S, 3)).astype(np.float32)
                 for _ in range(2)] + [
            rng.normal(size=(B, FOCAL, FOCAL, 3)).astype(np.float32)
            for _ in range(N_FOCAL)]
        jrec = jax_msn.MSNRecipe(img_size=S, focal_size=FOCAL,
                                 n_focal=N_FOCAL, weight_decay=WD,
                                 dtype=jnp.float32)
        assert jrec.num_patches == N
        jrec.transform = lambda key, images: [jnp.asarray(v) for v in views]
        sample = jnp.zeros((B, S, S, 3), jnp.uint8)
        shapes = jax.eval_shape(lambda: jrec.create_state(
            jax.random.key(0), sample))
        params, stats, ema, ema_stats = (
            random_tree(t, rng) for t in (shapes.params, shapes.batch_stats,
                                          shapes.params, shapes.batch_stats))
        state = JaxTrainState(
            step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
            opt_state=jrec.tx.init(params), tx=jrec.tx, ema_params=ema,
            ema_batch_stats=ema_stats)
        key = jax.random.key(7)
        _, k_mask = jax.random.split(key)
        noise = np.asarray(jax.random.uniform(k_mask, (B, N)))
        ids_keep = np.asarray(jax_msn.random_token_mask(k_mask, B, N, 0.15)[0])
        new, aux = jax.device_get(jax.jit(jrec.train_step)(
            state, {"image": sample}, key))
        images = rng.integers(0, 256, (3, S + 8, S + 8, 3), dtype=np.uint8)
        extract = jax.jit(jrec.extract_features)
        feats = np.asarray(extract(state, images))
        return dict(views=views, noise=noise, ids_keep=ids_keep,
                    params=params, stats=stats, ema=ema, ema_stats=ema_stats,
                    new=new, aux=aux, images=images, feats=feats,
                    extract=extract)


def _port_state(run, mp):
    tiny(mp, port_only=True)
    rec = MSNRecipe(img_size=S, focal_size=FOCAL, n_focal=N_FOCAL,
                    weight_decay=WD, dtype=torch.float32)
    state = rec.create_state(0, B, CPU)
    state.online.load_state_dict(
        msn_state_dict_from_jax(run["params"], run["stats"]), strict=True)
    state.ema.load_state_dict(
        msn_state_dict_from_jax(run["ema"], run["ema_stats"]), strict=True)
    return rec, state


def test_step_matches_jax(jax_run, monkeypatch):
    rec, state = _port_state(jax_run, monkeypatch)
    ids_keep, _, _ = random_token_mask_from_noise(_t(jax_run["noise"]), 0.15)
    assert torch.equal(ids_keep, _t(jax_run["ids_keep"]).to(ids_keep.dtype))
    assert ids_keep.shape == (B, 13)
    new = jax_run["new"]
    metrics = rec.step_on_views(state, [_t(v) for v in jax_run["views"]],
                                ids_keep)
    close("loss", metrics["loss"], jax_run["aux"]["loss"], 1e-4, 1e-7)
    g = msn_state_dict_from_jax(new.neg_indices, new.batch_stats)
    for name, p in state.online.named_parameters():
        close(f"grad {name}", p.grad, g[name], 1e-4, 1e-6)
    assert state.online.prototypes.grad.abs().sum() > 0
    # the BN running statistics: anchors' pass, then the focal views'
    for name, buf in state.online.named_buffers():
        close(f"running {name}", buf, g[name], 1e-4, 1e-6)
    start = msn_state_dict_from_jax(jax_run["params"], jax_run["stats"])
    assert not np.allclose(g["projection_head.layers.1.running_mean"],
                           start["projection_head.layers.1.running_mean"])
    # the target branch moved BEFORE the step, parameters and statistics
    ema = msn_state_dict_from_jax(new.ema_params, new.ema_batch_stats)
    for name, v in state.ema.state_dict().items():
        close(f"ema {name}", v, ema[name], 1e-6, 1e-7)
    assert state.step == 1
    # the optimizer on JAX's gradients
    _, state = _port_state(jax_run, monkeypatch)
    for name, p in state.online.named_parameters():
        p.grad = g[name].clone()
    state.optimizer.step()
    after = msn_state_dict_from_jax(new.params, new.batch_stats)
    for name, p in state.online.named_parameters():
        close(f"param {name}", p, after[name], 1e-6, 1e-6)


def test_features_come_from_the_target_branch(jax_run, monkeypatch):
    rec, state = _port_state(jax_run, monkeypatch)
    images = _t(jax_run["images"])
    feats = rec.extract_features(state, images)
    close("target features", feats, jax_run["feats"], 1e-5, 1e-5)
    # the anchor branch's features of the same view are others
    with torch.no_grad():
        online = state.online.eval().extract_features(
            knn_transform(images, S))
    assert online.shape == feats.shape
    assert not torch.allclose(online, feats, atol=1e-2)


def test_recipe_maps_backbones_to_vit_b16(monkeypatch):
    tiny(monkeypatch, port_only=True)
    for name in ("resnet18", "resnet50", "vit_b_16", "vit_base_patch16"):
        rec = MSNRecipe(backbone=name, img_size=S)
        assert rec.backbone == "vit_base_patch16" and rec.num_patches == N
    # the JAX recipe maps only the ResNet names (a reference fault)
    with pytest.raises(KeyError):
        jax_msn.MSNRecipe(backbone="vit_b_16")
    assert jax_msn.MSNRecipe(backbone="resnet50").num_patches == 196


# ---------------------------------------------------------------------------
# the reference checkpoint layouts
# ---------------------------------------------------------------------------

def reference_msn_sd(seed=0):
    """A reference MSN state dict at the tiny widths: the anchor and the
    target torchvision ViTs, lightly's MSN heads (with
    ``num_batches_tracked``), the prototypes."""
    rng = np.random.default_rng(seed)
    sd = {}
    for bb, head in (("anchor_backbone.vit.", "anchor_projection_head."),
                     ("backbone.vit.", "projection_head.")):
        sd.update({f"{bb}{k}": v for k, v in _torchvision_sd(
            seed=int(rng.integers(1000))).items()})

        def r(*shape, base=0.0):
            return (base + 0.1 * rng.standard_normal(shape)).astype(
                np.float32)
        for lin, (cin, cout, bias) in ((0, (64, 2048, False)),
                                       (3, (2048, 2048, False)),
                                       (6, (2048, 256, True))):
            sd[f"{head}layers.{lin}.weight"] = r(cout, cin)
            if bias:
                sd[f"{head}layers.{lin}.bias"] = r(cout)
        for bn in (1, 4):
            sd.update({f"{head}layers.{bn}.weight": r(2048, base=1.0),
                       f"{head}layers.{bn}.bias": r(2048),
                       f"{head}layers.{bn}.running_mean": r(2048),
                       f"{head}layers.{bn}.running_var": np.abs(
                           r(2048, base=1.0)),
                       f"{head}layers.{bn}.num_batches_tracked":
                           np.array(7)})
    sd["prototypes"] = (0.1 * rng.standard_normal((1024, 256))).astype(
        np.float32)
    return {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}


def test_msn_reader_matches_convert_msn(monkeypatch):
    tiny(monkeypatch, port_only=True)
    sd = reference_msn_sd()
    model = MSNModule(img_size=S)
    anchor, target = msn_state_dict(sd, model)
    params, stats, ema, ema_stats = ti.convert_msn(
        {k: v.numpy() for k, v in sd.items()}, depth=2)
    for got, want in ((anchor, msn_state_dict_from_jax(params, stats)),
                      (target, msn_state_dict_from_jax(ema, ema_stats))):
        model.load_state_dict(got, strict=True)
        assert set(got) == set(want)
        for k, v in want.items():
            assert torch.equal(got[k].reshape(v.shape), v), k
    assert not torch.equal(anchor["backbone.cls_token"],
                           target["backbone.cls_token"])
    del sd["anchor_projection_head.layers.4.running_var"]
    with pytest.raises(KeyError):
        msn_state_dict(sd, model)


def reference_dinov2_sd(layout, seed=0):
    """A reference DINOv2 state dict at the tiny widths: student and
    teacher timm ViTs with LayerScale (and timm's head), lightly's DINO
    heads with ``last_layer`` weight-normalised in ``layout``."""
    rng = np.random.default_rng(seed)
    p, d, depth, _ = TINY_VIT

    def r(*shape, scale=0.1):
        return torch.from_numpy((scale * rng.standard_normal(shape)).astype(
            np.float32))

    sd = {}
    for who in ("student", "teacher"):
        bb, head = f"{who}_backbone.vit.", f"{who}_head.dino_head."
        sd.update({f"{bb}cls_token": r(1, 1, d), f"{bb}pos_embed": r(
            1, N + 1, d), f"{bb}patch_embed.proj.weight": r(d, 3, p, p),
            f"{bb}patch_embed.proj.bias": r(d), f"{bb}norm.weight": r(d),
            f"{bb}norm.bias": r(d), f"{bb}head.weight": r(10, d)})
        for i in range(depth):
            timm_block(sd, f"{bb}blocks.{i}", d, rng)
            for ls in ("ls1", "ls2"):
                sd[f"{bb}blocks.{i}.{ls}.gamma"] = r(d)
        for i, (cin, cout) in ((0, (d, 2048)), (2, (2048, 2048)),
                               (4, (2048, 256))):
            sd[f"{head}layers.{i}.weight"] = r(cout, cin)
            sd[f"{head}layers.{i}.bias"] = r(cout)
        v = r(64, 256)
        if layout == "weight_v":
            sd[f"{head}last_layer.weight_v"] = v
            sd[f"{head}last_layer.weight_g"] = r(64, 1)
        elif layout == "parametrizations":
            sd[f"{head}last_layer.parametrizations.weight.original1"] = v
            sd[f"{head}last_layer.parametrizations.weight.original0"] = r(
                64, 1)
        else:
            sd[f"{head}last_layer.weight"] = v
    return sd


@pytest.mark.parametrize("layout", ["weight_v", "parametrizations",
                                    "weight"])
def test_dinov2_reader_matches_convert_dinov2(layout, monkeypatch):
    monkeypatch.setitem(port_vit.VIT_CONFIGS, "vit_small_patch16", TINY_VIT)
    sd = reference_dinov2_sd(layout)
    model = DINOv2Module(img_size=S, head_out=64)
    student, teacher = dinov2_state_dict(sd, model)
    params, ema = ti.convert_dinov2({k: v.numpy() for k, v in sd.items()},
                                    depth=2)
    for got, want in ((student, dinov2_state_dict_from_jax(params)),
                      (teacher, dinov2_state_dict_from_jax(ema))):
        model.load_state_dict(got, strict=True)
        assert set(got) == set(want)
        for k, v in want.items():
            assert torch.equal(got[k].reshape(v.shape), v), k
    assert torch.equal(student["dino_head.prototypes"],
                       sd[next(k for k in sd if k.startswith(
                           "student_head.dino_head.last_layer")
                           and "original0" not in k and "weight_g" not in k)])
    del sd["teacher_backbone.vit.blocks.1.ls2.gamma"]
    with pytest.raises(KeyError):
        dinov2_state_dict(sd, model)


# ---------------------------------------------------------------------------
# both CLIs on the CPU
# ---------------------------------------------------------------------------

def _argv(mode, train_csv):
    return ["--mode", mode, "--model", "vit_b_16", "--size", str(S),
            "--device", "cpu", "--dtype", "float32", "--batch_size", "4",
            "--num_workers", "1", "--train_annotation", train_csv,
            "--img_dir", str(IMG_DIR)]


def _evaluate(argv, test_csv, checkpoint, out):
    from hairci_torch.cli import knn_classification

    clf = knn_classification.main(argv + [
        "--eval_type", "knn", "--test_annotation", test_csv,
        "--checkpoint_path", str(checkpoint), "--save_path", str(out)])
    assert (out / "knn_evaluation_results.txt").is_file()
    tr_f, _, te_f, _ = clf.extracting_features()
    assert tr_f.shape == (10, TINY_VIT[1]) and te_f.shape == (6, TINY_VIT[1])
    assert np.isfinite(tr_f).all()
    np.testing.assert_allclose(np.linalg.norm(te_f, axis=1), 1, atol=1e-5)
    return clf, tr_f


def test_clis_train_and_evaluate_msn(tmp_path, monkeypatch):
    """``mainpretrain --mode MSN`` for 2 epochs (batches of 4, the last
    padded), then ``knn_classification --mode MSN`` on the run: the
    features are the restored target branch's."""
    from hairci_torch.cli import mainpretrain

    tiny(monkeypatch, port_only=True)
    monkeypatch.setitem(RECIPES, "MSN", functools.partial(
        MSNRecipe, focal_size=FOCAL, n_focal=N_FOCAL))
    train_csv, test_csv = manifests(tmp_path)
    argv = _argv("MSN", train_csv)
    trainer = mainpretrain.main(argv + ["--epochs", "2", "--save_path",
                                        str(tmp_path / "out")])
    assert trainer.state.step == 6 and trainer.recipe.backbone == \
        "vit_base_patch16"
    ckpt = torch.load(f"{trainer.save_path}/model_ckpt_latest",
                      weights_only=True)
    assert set(ckpt) == {"online", "ema", "optimizer", "step", "epoch"}
    clf, tr_f = _evaluate(argv, test_csv, trainer.save_path,
                          tmp_path / "knn")
    images = np.concatenate([x for x, _ in clf.train_loader])[:10]
    want = trainer.recipe.extract_features(trainer.state, _t(images))
    np.testing.assert_allclose(
        tr_f, (want / want.norm(dim=1, keepdim=True)).numpy(), atol=1e-5)


def test_knn_cli_reads_reference_pths(jax_run, tmp_path, monkeypatch):
    """A reference MSN ``.pth`` gives the JAX recipe's target features of
    the same images (weights read by ``convert_msn``; the JAX features by
    the fixture's jitted ``extract_features``); a reference DINOv2 ``.pth``
    gives its student's."""
    tiny(monkeypatch)
    monkeypatch.setitem(port_vit.VIT_CONFIGS, "vit_small_patch16", TINY_VIT)
    monkeypatch.setitem(RECIPES, "dinov2", functools.partial(
        RECIPES["dinov2"], head_out=64))
    train_csv, test_csv = manifests(tmp_path)
    sd = reference_msn_sd(seed=3)
    torch.save({"model_state_dict": sd}, tmp_path / "msn.pth")
    clf, got = _evaluate(_argv("MSN", train_csv), test_csv,
                         tmp_path / "msn.pth", tmp_path / "knn_msn")
    params, stats, ema, ema_stats = ti.convert_msn(
        {k: v.numpy() for k, v in sd.items()}, depth=2)
    images = np.concatenate([x for x, _ in clf.train_loader])[:10]
    state = JaxTrainState(step=0, params=params, batch_stats=stats,
                          opt_state=None, tx=None, ema_params=ema,
                          ema_batch_stats=ema_stats)
    want = np.asarray(jax_run["extract"](state, jnp.asarray(images)))
    np.testing.assert_allclose(
        got, want / np.linalg.norm(want, axis=1, keepdims=True), atol=1e-5)

    sd = reference_dinov2_sd("weight_v", seed=4)
    torch.save({"state_dict": sd}, tmp_path / "dinov2.pth")
    _, got = _evaluate(_argv("dinov2", train_csv), test_csv,
                       tmp_path / "dinov2.pth", tmp_path / "knn_dino")
    model = DINOv2Module(img_size=S, head_out=64)
    model.load_state_dict(dinov2_state_dict(sd, model)[0])
    with torch.no_grad():
        want = model.eval().extract_features(knn_transform(_t(images), S))
    np.testing.assert_allclose(
        got, (want / want.norm(dim=1, keepdim=True)).numpy(), atol=1e-5)
