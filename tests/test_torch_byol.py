"""BYOL in the port (``hairci_torch/ssl/byol.py``) against the JAX package's
``BYOLRecipe``: one f32 step from identical weights, BN statistics, EMA and
views -- the loss, every gradient, the BN running statistics over the 2B
rows of the one online forward, the momentum branch's EMA taken BEFORE the
step over parameters and BN statistics, the weights after Adam(W) -- and
the online features; the per-epoch cosine momentum and the engine's branch
that passes it; the mode through ``mainpretrain`` on the CPU, and its
absence from the evaluation CLI (as in JAX).

Both packages' ResNet-18 is cut to one block per stage at 32 px and 8
images, with the full 4096-wide heads; the step is one XLA compile on the
CPU. Gradients and weights are compared at rtol 1e-4 with an atol of 1e-4
of the tensor's largest entry.

At full size the step is discontinuous at rounding level: in
``chip_smoke.py`` phase 10 (ResNet-50 at 224, B=8, f32) the card's
gradient of ``prediction_head.layers.0.weight`` stands 0.0129 of the
model's largest gradient entry off the CPU's, the losses 6e-7 apart. One
ReLU input of the prediction head, 1.15e-6 from 0 on the CPU, takes the
other sign on the card (the two devices' f32 forwards agree to 4.8e-6 of
the largest BN output there), so that element's gradient passes on one
device and not on the other. Weights moved by 1e-7 of themselves move the
CPU gradient by 1e-6 of that entry (too little to cross the ReLU), by 1e-5
by 0.0129 (it crosses): the step's own sensitivity, not a fault of the
port (NVIDIA H100 80GB HBM3, 700 W, and its host's CPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hairci.models.resnet as jax_resnet
import hairci.ssl.byol as jax_byol
import hairci_torch.models.resnet as port_resnet
from hairci.train.state import TrainState as JaxTrainState
from hairci_torch.models.convert import byol_state_dict_from_jax
from hairci_torch.ssl import RECIPES, build_recipe
from hairci_torch.ssl.byol import BYOLModule, BYOLRecipe
from test_torch_distill import random_tree
from test_torch_mae import IMG_DIR, manifests
from test_torch_supcon import _close

torch.set_num_threads(1)
B, S = 8, 32
WD = 0.5          # one step's decay (lr * wd) shows above the tolerance
MOMENTUM = 0.9    # the EMA's move shows above the tolerance
CPU = torch.device("cpu")


def _t(a):
    return torch.from_numpy(np.array(a))


def _cut(mp, port_only=False):
    mp.setitem(port_resnet._STAGES, "resnet18",
               ([1, 1, 1, 1], port_resnet.BasicBlock))
    if not port_only:
        mp.setitem(jax_resnet._STAGES, "resnet18",
                   ([1, 1, 1, 1], jax_resnet.BasicBlock))


@pytest.fixture(scope="module")
def jax_run():
    """JAX's step and features from a seeded state whose momentum branch
    (parameters and BN statistics) is apart from the online one."""
    with pytest.MonkeyPatch.context() as mp:
        _cut(mp)
        orig = JaxTrainState.apply_gradients
        # keep the raw gradients (the step leaves neg_indices unused)
        mp.setattr(JaxTrainState, "apply_gradients",
                   lambda self, grads, **kw: orig(self, grads, **kw).replace(
                       neg_indices=grads))
        rng = np.random.default_rng(0)
        views = [rng.normal(size=(B, S, S, 3)).astype(np.float32)
                 for _ in range(2)]
        jrec = jax_byol.BYOLRecipe(backbone="resnet18", img_size=S,
                                   weight_decay=WD, dtype=jnp.float32)
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
        new, aux = jax.device_get(jax.jit(jrec.train_step)(
            state, {"image": sample}, jax.random.key(7), MOMENTUM))
        images = rng.integers(0, 256, (3, S + 8, S + 8, 3), dtype=np.uint8)
        feats = np.asarray(jax.jit(jrec.extract_features)(state, images))
    return dict(views=views, start=(params, stats), ema=(ema, ema_stats),
                new=new, aux=aux, images=images, feats=feats)


def _port_state(run, mp):
    _cut(mp, port_only=True)
    rec = BYOLRecipe(backbone="resnet18", img_size=S, weight_decay=WD,
                     dtype=torch.float32)
    state = rec.create_state(0, B, CPU)
    state.online.load_state_dict(
        byol_state_dict_from_jax(*run["start"], "resnet18"), strict=True)
    state.ema.load_state_dict(
        byol_state_dict_from_jax(*run["ema"], "resnet18"), strict=True)
    return rec, state


def test_step_matches_jax(jax_run, monkeypatch):
    rec, state = _port_state(jax_run, monkeypatch)
    new = jax_run["new"]
    metrics = rec.step_on_views(state, *(_t(v) for v in jax_run["views"]),
                                momentum=MOMENTUM)
    _close("loss", metrics["loss"], jax_run["aux"]["loss"], 1e-4, 1e-7)
    assert state.step == 1

    g = byol_state_dict_from_jax(new.neg_indices, jax_run["start"][1],
                                 "resnet18")
    for name, p in state.online.named_parameters():
        _close(f"grad {name}", p.grad, g[name], 1e-4)
    # the BN statistics of the one forward over both views: the trunk's
    # and both heads' (layers.1), each over 2B rows
    after = byol_state_dict_from_jax(new.params, new.batch_stats, "resnet18")
    for name, t in state.online.named_buffers():
        _close(f"running {name}", t, after[name], 1e-4)
    start = byol_state_dict_from_jax(*jax_run["start"], "resnet18")
    for head in ("projection_head", "prediction_head"):
        key = f"{head}.layers.1.running_mean"
        assert not torch.allclose(state.online.get_buffer(key), start[key])
    # the momentum branch moved BEFORE the step, parameters and statistics
    ema = byol_state_dict_from_jax(new.ema_params, new.ema_batch_stats,
                                   "resnet18")
    for name, v in state.ema.state_dict().items():
        _close(f"ema {name}", v, ema[name], 1e-6, 1e-7)
    # after the port's own Adam step: every weight whose gradient stands
    # clear of rounding (Adam's first step moves a weight by about lr
    # whatever the size of its gradient)
    for name, p in state.online.named_parameters():
        gn = g[name].numpy()
        clear = np.abs(gn) > max(1e-3 * np.abs(gn).max(), 1e-6)
        _close(name, p.detach()[clear], after[name][clear], 1e-4)

    # the optimizer on JAX's gradients: every weight
    _, state = _port_state(jax_run, monkeypatch)
    for name, p in state.online.named_parameters():
        p.grad = g[name].clone()
    state.optimizer.step()
    for name, p in state.online.named_parameters():
        _close(f"param {name}", p, after[name], 1e-6, 1e-6)


def test_features_are_the_online_backbones(jax_run, monkeypatch):
    rec, state = _port_state(jax_run, monkeypatch)
    feats = rec.extract_features(state, _t(jax_run["images"]))
    assert feats.shape == (3, 512) and state.online.training
    np.testing.assert_allclose(feats.numpy(), jax_run["feats"], atol=1e-5)


def test_momentum_for_epoch_matches_jax():
    """The cosine 0.996 -> 1 over the run's epochs, as the JAX recipe's."""
    for epochs in (1, 2, 7, 100):
        port = BYOLRecipe(epochs=epochs)
        ref = jax_byol.BYOLRecipe(epochs=epochs)
        got = [port.momentum_for_epoch(e) for e in range(epochs + 1)]
        assert got == [ref.momentum_for_epoch(e) for e in range(epochs + 1)]
        assert got[epochs - 1] == 1.0
        if epochs > 1:
            assert got[0] == 0.996


def test_recipe_builds_the_reference_transform_and_heads():
    """No transform given: both views without blur (the reference's), the
    second solarized with p = 0.2; the heads 2048 -> 4096 -> 256 and
    256 -> 4096 -> 256 in lightly's key layout."""
    rec = BYOLRecipe()
    jrec = jax_byol.BYOLRecipe()
    for ours, theirs in zip(rec.transform.views, jrec.transform.views):
        assert ours.blur_p == theirs.blur_p == 0.0
        assert (ours.solarize_p, ours.crop_scale, ours.cj_bright,
                ours.cj_sat) == (theirs.solarize_p, theirs.crop_scale,
                                 theirs.cj_bright, theirs.cj_sat)
    assert [v.solarize_p for v in rec.transform.views] == [0.0, 0.2]
    with torch.device("meta"):
        module = BYOLModule("resnet50")
    shapes = {k: tuple(v.shape) for k, v in module.state_dict().items()
              if "_head" in k}
    assert shapes == {
        "projection_head.layers.0.weight": (4096, 2048),
        "projection_head.layers.1.weight": (4096,),
        "projection_head.layers.1.bias": (4096,),
        "projection_head.layers.1.running_mean": (4096,),
        "projection_head.layers.1.running_var": (4096,),
        "projection_head.layers.3.weight": (256, 4096),
        "projection_head.layers.3.bias": (256,),
        "prediction_head.layers.0.weight": (4096, 256),
        "prediction_head.layers.1.weight": (4096,),
        "prediction_head.layers.1.bias": (4096,),
        "prediction_head.layers.1.running_mean": (4096,),
        "prediction_head.layers.1.running_var": (4096,),
        "prediction_head.layers.3.weight": (256, 4096),
        "prediction_head.layers.3.bias": (256,)}


def test_only_byol_and_densecl_take_the_epoch_momentum():
    """The engine's branch is keyed on ``momentum_for_epoch``: no recipe
    ported before these two may take it (MSN has ``ema_momentum``); of
    those ported after them, SiameseIM does, as in JAX, and SHAM v1 (a
    fixed ``ema_momentum``) does not."""
    build_recipe("BYOL", dtype=torch.float32)       # registers them all
    takers = sorted(n for n, cls in RECIPES.items()
                    if hasattr(cls, "momentum_for_epoch"))
    assert takers == ["BYOL", "DenseCL", "siameseim"]


def test_cli_trains_byol_with_the_epoch_momentum(tmp_path, monkeypatch):
    """``mainpretrain --mode BYOL`` trains ResNet-50 whatever ``--model``
    says (cut here to one block per stage), 2 epochs of 3 batches of 4 (the
    last padded): the engine hands each step its epoch's momentum, the log
    has JAX's ``Loss =`` line, the checkpoint holds both branches. The
    evaluation CLI has no BYOL mode, as in JAX."""
    from hairci.cli.knn_classification import EVAL_MODES as JAX_EVAL_MODES
    from hairci_torch.cli import knn_classification, mainpretrain

    monkeypatch.setitem(port_resnet._STAGES, "resnet50",
                        ([1, 1, 1, 1], port_resnet.BottleneckBlock))
    seen = []
    step = BYOLRecipe.train_step

    def spy(self, state, images, gen, momentum=0.996):
        seen.append(momentum)
        assert images.shape[0] == 4      # the last batch padded
        return step(self, state, images, gen, momentum=momentum)

    monkeypatch.setattr(BYOLRecipe, "train_step", spy)
    train_csv, test_csv = manifests(tmp_path)
    trainer = mainpretrain.main([
        "--mode", "BYOL", "--model", "resnet18", "--size", str(S),
        "--device", "cpu", "--dtype", "float32", "--batch_size", "4",
        "--num_workers", "1", "--epochs", "2", "--train_annotation",
        train_csv, "--img_dir", str(IMG_DIR),
        "--save_path", str(tmp_path / "out")])
    rec = trainer.recipe
    assert rec.backbone == "resnet50" and rec.epochs == 2
    assert trainer.state.online.backbone.num_features == 2048
    assert seen == [0.996] * 3 + [1.0] * 3 and trainer.state.step == 6
    log = (tmp_path / "out").glob("*/training_log.txt")
    lines = [line for line in next(log).read_text().splitlines()
             if line.startswith("Epoch ")]
    assert [line.split(":")[0] for line in lines] == ["Epoch 0", "Epoch 1"]
    assert all(np.isfinite(float(line.split("Loss = ")[1]))
               for line in lines)
    ckpt = torch.load(f"{trainer.save_path}/model_ckpt_latest",
                      weights_only=True)
    assert set(ckpt) == {"online", "ema", "optimizer", "step", "epoch"}

    assert "BYOL" not in JAX_EVAL_MODES
    assert "BYOL" not in knn_classification.EVAL_MODES
    with pytest.raises(SystemExit):
        knn_classification.build_eval_parser().parse_args(
            ["--mode", "BYOL"])
