"""DINOv2 in the port against the JAX package's ``DINOv2Recipe``: the
forward (student tokens under the block mask, the DINO head on cls and
patch tokens, the features), the iBOT gather indices bitwise against
``lax.top_k`` (ties included), the chunked iBOT loss against the unchunked
one, one ``train_step`` from identical weights, views and mask (the loss
terms, every gradient and both centres at rtol 1e-4; the parameters and the
teacher's EMA after the optimizer on JAX's gradients at rtol 1e-6), a
checkpoint round trip with the centres, and both CLIs on the CPU with a
resumed run equal to an uninterrupted one.

Both packages' ``vit_small_patch16`` is cut to patch 8, width 64, depth 2,
2 heads at 32-px global and 16-px local views, with 64 prototypes; the step
is one XLA compile on the CPU, run twice: at the recipe's LayerScale init
(gamma 1e-5, teacher = student) with ``koleo_weight=0`` (KoLeo's nearest
neighbour is rounding noise there), and at a non-degenerate state (random
gammas, a teacher apart from the student) with KoLeo at 0.1."""

import functools
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hairci.models.vit as jax_vit
import hairci.ssl.dinov2 as jax_dinov2
import hairci_torch.models.vit as port_vit
from hairci.aug.pipelines import knn_transform as jax_knn_transform
from hairci.models.masking import random_block_mask as jax_block_mask
from hairci.train.state import TrainState as JaxTrainState
from hairci_torch.losses.distill import ibot_patch_loss
from hairci_torch.models.convert import dinov2_state_dict_from_jax
from hairci_torch.models.masking import (
    block_grid,
    random_block_mask_from_scores,
)
from hairci_torch.ssl import RECIPES
from hairci_torch.ssl.dinov2 import DINOv2Module, DINOv2Recipe, ibot_indices
from hairci_torch.train import checkpoint as ckpt_lib
from hairci_torch.train.state import ema_update
from test_torch_distill import random_tree
from test_torch_mae import IMG_DIR, manifests

torch.set_num_threads(1)
B, S, LOCAL, N_LOCAL, HEAD = 4, 32, 16, 2, 64
TINY_VIT = (8, 64, 2, 2)          # patch, width, depth, heads
GRID = S // 8
WD = 0.5        # one step's decay (lr * wd) shows above the tolerance
CPU = torch.device("cpu")


def _t(a):
    return torch.from_numpy(np.array(a))


def tiny(mp, port_only=False):
    mp.setitem(port_vit.VIT_CONFIGS, "vit_small_patch16", TINY_VIT)
    if not port_only:
        mp.setitem(jax_vit.VIT_CONFIGS, "vit_small_patch16", TINY_VIT)


def port_recipe(**kw):
    return DINOv2Recipe(img_size=S, local_size=LOCAL, n_local=N_LOCAL,
                        head_out=HEAD, weight_decay=WD, dtype=torch.float32,
                        **kw)


def close(name, got, want, rtol, atol):
    np.testing.assert_allclose(
        got.detach().numpy() if isinstance(got, torch.Tensor) else got,
        np.asarray(want), rtol=rtol, atol=atol, err_msg=name)


# (gamma of the student, teacher apart, koleo_weight, temp, momentum)
CASES = {"init": (1e-5, False, 0.0, 0.04, 0.992),
         "trained": (None, True, 0.1, 0.055, 0.995)}


@pytest.fixture(scope="module")
def jax_run():
    """JAX's step from two states (one compile), the forward pieces and the
    features. Views are seeded arrays handed to both packages; the block
    mask comes from JAX's key."""
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
            rng.normal(size=(B, LOCAL, LOCAL, 3)).astype(np.float32)
            for _ in range(N_LOCAL)]
        jrec = jax_dinov2.DINOv2Recipe(
            img_size=S, local_size=LOCAL, n_local=N_LOCAL, head_out=HEAD,
            weight_decay=WD, dtype=jnp.float32, remat=False)
        assert (jrec.grid, jrec.n_masked) == (GRID, 4)
        jrec.transform = lambda key, images: [jnp.asarray(v) for v in views]
        sample = jnp.zeros((B, S, S, 3), jnp.uint8)
        shapes = jax.eval_shape(lambda: jrec.create_state(
            jax.random.key(0), sample))
        key = jax.random.key(7)
        _, k_mask = jax.random.split(key)
        _, coarse = block_grid(GRID, 4)
        scores = np.asarray(jax.random.uniform(k_mask, (2 * B, coarse,
                                                        coarse)))
        mask = np.asarray(jax_block_mask(k_mask, 2 * B, GRID, 0.3))

        def step(state, temp, mom, koleo):
            jrec.koleo_weight = koleo     # traced: one compile for both
            return jrec.train_step(state, {"image": sample}, key,
                                   teacher_temp=temp, momentum=mom)

        step = jax.jit(step)
        runs = {}
        for case, (gamma, apart, koleo, temp, mom) in CASES.items():
            params = random_tree(shapes.params, rng, gamma)
            ema = random_tree(shapes.params, rng) if apart else params
            extra = {k: rng.normal(0, 0.3, v.shape).astype(np.float32)
                     for k, v in shapes.extra.items()}
            state = JaxTrainState(
                step=jnp.zeros((), jnp.int32), params=params, batch_stats={},
                opt_state=jrec.tx.init(params), tx=jrec.tx, ema_params=ema,
                ema_batch_stats={}, extra=extra)
            new, aux = jax.device_get(step(state, temp, mom, koleo))
            runs[case] = dict(params=params, ema=ema, extra=extra, new=new,
                              aux=aux, koleo=koleo, temp=temp, mom=mom)
        jrec.koleo_weight = 0.1

        params = runs["trained"]["params"]
        images = rng.integers(0, 256, (3, S + 8, S + 8, 3), dtype=np.uint8)
        m = jrec.module

        @jax.jit
        def forward(p, glob, mask, local, images):
            tokens = m.apply({"params": p}, glob, token_mask=mask,
                             method=m.forward_tokens)
            return (tokens, m.apply({"params": p}, tokens[:, 0],
                                    method=m.cls_logits),
                    m.apply({"params": p}, tokens[:, 1:],
                            method=m.patch_logits),
                    m.apply({"params": p}, local, method=m.forward_tokens),
                    m.apply({"params": p}, jax_knn_transform(images, S),
                            train=False, method=m.extract_features))

        glob = np.concatenate(views[:2])
        fwd = [np.asarray(a) for a in forward(params, glob, mask, views[2],
                                              images)]
        return dict(views=views, scores=scores, mask=mask, runs=runs,
                    fwd=fwd, images=images)


def _port_state(run, mp, **recipe_kw):
    tiny(mp, port_only=True)
    rec = port_recipe(**recipe_kw)
    state = rec.create_state(0, B, CPU)
    state.online.load_state_dict(dinov2_state_dict_from_jax(run["params"]),
                                 strict=True)
    state.ema.load_state_dict(dinov2_state_dict_from_jax(run["ema"]),
                              strict=True)
    state.extra = {k: _t(v) for k, v in run["extra"].items()}
    return rec, state


def _mask(jax_run):
    mask = random_block_mask_from_scores(_t(jax_run["scores"]), GRID, 0.3)
    assert torch.equal(mask, _t(jax_run["mask"]))
    return mask


def test_forward_and_features_match_jax(jax_run, monkeypatch):
    rec, state = _port_state(jax_run["runs"]["trained"], monkeypatch)
    m = state.online.eval()
    tokens, cls, patch, local, feats = jax_run["fwd"]
    glob = _t(np.concatenate(jax_run["views"][:2]))
    with torch.no_grad():
        got = m.forward_tokens(glob, token_mask=_mask(jax_run))
        close("masked tokens", got, tokens, 1e-5, 1e-5)
        close("cls logits", m.cls_logits(got[:, 0]), cls, 1e-5, 1e-5)
        close("patch logits", m.patch_logits(got[:, 1:]), patch, 1e-5, 1e-5)
        close("local tokens", m.forward_tokens(_t(jax_run["views"][2])),
              local, 1e-5, 1e-5)
    close("features", rec.extract_features(state, _t(jax_run["images"])),
          feats, 1e-5, 1e-5)
    assert not any(k.startswith("ibot_head") for k in m.state_dict())


def _tied_masks(rng, rows, grid, ratio):
    """Block masks from scores with many ties: rows mask more blocks than
    the static bound, and some fewer tokens than it at a cropped edge."""
    _, coarse = block_grid(grid, 4)
    scores = np.floor(rng.uniform(size=(rows, coarse, coarse)) * 3) / 3
    return random_block_mask_from_scores(_t(scores.astype(np.float32)),
                                         grid, ratio)


@pytest.mark.parametrize("grid", [4, 7, 14])
def test_ibot_indices_bitwise_against_lax_top_k(grid):
    rng = np.random.default_rng(grid)
    rec = DINOv2Recipe(img_size=16 * grid)
    n = rec.n_masked
    masks = [_tied_masks(rng, 16, grid, 0.3),
             torch.from_numpy(rng.uniform(size=(16, grid * grid)) < 0.5),
             torch.zeros(2, grid * grid, dtype=torch.bool)]
    for mask in masks:
        values, idx = ibot_indices(mask, n)
        want_v, want_i = jax.lax.top_k(jnp.asarray(mask.numpy(), jnp.int32),
                                       n)
        assert torch.equal(idx, _t(want_i).to(idx.dtype))
        assert torch.equal(values, _t(want_v))
    counts = masks[0].sum(1)
    assert (counts > n).any() or grid == 14


def test_chunked_ibot_loss_matches_unchunked(monkeypatch):
    """20 rows (a chunk of 16 and one of 4), zero weights in some slots:
    the loss, the centre and the gradients of the student tokens and head
    at rtol 1e-5."""
    tiny(monkeypatch, port_only=True)
    rec = port_recipe()
    torch.manual_seed(0)
    online = DINOv2Module(img_size=S, head_out=HEAD)
    teacher = DINOv2Module(img_size=S, head_out=HEAD)
    g = torch.Generator().manual_seed(1)
    R, M, D = 20, 4, TINY_VIT[1]
    t_m = torch.randn(R, M, D, generator=g)
    s_m = torch.randn(R, M, D, generator=g, requires_grad=True)
    w = (torch.rand(R, M, generator=g) < 0.7).float()
    center = torch.randn(1, HEAD, generator=g) * 0.3
    loss, new_center = rec._ibot_loss_chunked(online, teacher, t_m, s_m, w,
                                              center, 0.05)
    loss.backward()
    grads = [s_m.grad.clone()] + [p.grad.clone()
                                  for p in online.dino_head.parameters()]
    s_m.grad = None
    online.zero_grad()
    with torch.no_grad():
        t_out = teacher.patch_logits(t_m)
    want, want_center = ibot_patch_loss(t_out, online.patch_logits(s_m),
                                        w > 0, center, 0.05)
    want.backward()
    close("loss", loss, want.detach(), 1e-5, 1e-7)
    close("centre", new_center, want_center, 1e-5, 1e-7)
    for got, ref in zip(grads, [s_m.grad] + [
            p.grad for p in online.dino_head.parameters()]):
        close("grad", got, ref, 1e-5, 1e-8)


@pytest.mark.parametrize("case", list(CASES))
def test_step_matches_jax(jax_run, monkeypatch, case):
    run = jax_run["runs"][case]
    new, aux = run["new"], run["aux"]
    rec, state = _port_state(run, monkeypatch, koleo_weight=run["koleo"])
    views = [_t(v) for v in jax_run["views"]]
    metrics = rec.step_on_views(state, views, _mask(jax_run), run["temp"],
                                run["mom"])
    for k in ("loss", "dino_loss", "ibot_loss", "koleo_loss"):
        close(k, metrics[k], aux[k], 1e-4, 1e-7)
    assert (float(metrics["koleo_loss"]) == 0.0) == (run["koleo"] == 0.0)
    g = dinov2_state_dict_from_jax(new.neg_indices)
    for name, p in state.online.named_parameters():
        close(f"grad {name}", p.grad, g[name], 1e-4, 1e-6)
    assert not state.online.backbone.pos_embed.grad.any()
    for k in ("dino_center", "ibot_center"):
        close(k, state.extra[k], new.extra[k], 1e-4, 1e-6)
    assert state.step == 1
    # the optimizer on JAX's gradients, then the teacher's EMA after it
    _, state = _port_state(run, monkeypatch)
    for name, p in state.online.named_parameters():
        p.grad = g[name].clone()
    state.optimizer.step()
    ema_update(state.ema, state.online, run["mom"])
    after = dinov2_state_dict_from_jax(new.params)
    ema = dinov2_state_dict_from_jax(new.ema_params)
    for name, p in state.online.named_parameters():
        close(f"param {name}", p, after[name], 1e-6, 1e-6)
        close(f"ema {name}", state.ema.get_parameter(name), ema[name], 1e-6,
              1e-6)


def test_checkpoint_round_trip_keeps_the_centres(tmp_path, monkeypatch):
    tiny(monkeypatch, port_only=True)
    rec = port_recipe()
    state = rec.create_state(0, B, CPU)
    images = torch.randint(0, 256, (B, S + 8, S + 8, 3), dtype=torch.uint8)
    rec.train_step(state, images, torch.Generator().manual_seed(0))
    assert state.extra["dino_center"].abs().sum() > 0
    path = ckpt_lib.save_checkpoint(str(tmp_path), "model_ckpt_latest",
                                    state, 0)
    ckpt = torch.load(path, weights_only=True)
    assert list(ckpt) == ["online", "ema", "optimizer", "extra", "step",
                          "epoch"]
    fresh = rec.create_state(1, B, CPU)
    assert ckpt_lib.restore_checkpoint(path, fresh) == 0
    for k in ("dino_center", "ibot_center"):
        assert fresh.extra[k].shape == (1, HEAD)
        assert torch.equal(fresh.extra[k], state.extra[k])
    for a, b in zip(fresh.ema.state_dict().values(),
                    state.ema.state_dict().values()):
        assert torch.equal(a, b)
    assert fresh.step == 1


# ---------------------------------------------------------------------------
# both CLIs on the CPU
# ---------------------------------------------------------------------------

def _cli_argv(tmp_path, train_csv):
    return ["--mode", "dinov2", "--model", "resnet18", "--size", str(S),
            "--device", "cpu", "--dtype", "float32", "--batch_size", "4",
            "--num_workers", "1", "--train_annotation", train_csv,
            "--img_dir", str(IMG_DIR)]


def test_clis_train_resume_and_evaluate_dinov2(tmp_path, monkeypatch):
    """``mainpretrain --mode dinov2`` (the recipe at the tiny widths) for 3
    epochs of 3 steps, its checkpoint after epoch 1 kept aside; a run
    resumed from that checkpoint ends with the same centres, teacher and
    weights. Then ``knn_classification --mode dinov2`` on the run."""
    from hairci_torch.cli import knn_classification, mainpretrain
    from hairci_torch.train import engine

    tiny(monkeypatch, port_only=True)
    monkeypatch.setitem(RECIPES, "dinov2", functools.partial(
        DINOv2Recipe, local_size=LOCAL, n_local=N_LOCAL, head_out=HEAD))
    train_csv, test_csv = manifests(tmp_path)
    argv = _cli_argv(tmp_path, train_csv)
    aside = tmp_path / "aside"
    aside.mkdir()
    save = ckpt_lib.save_checkpoint

    def keep_epoch_1(save_path, name, state, epoch):
        path = save(save_path, name, state, epoch)
        if epoch == 1:
            save(str(aside), name, state, epoch)
        return path

    monkeypatch.setattr(engine.ckpt_lib, "save_checkpoint", keep_epoch_1)
    straight = mainpretrain.main(argv + [
        "--epochs", "3", "--save_path", str(tmp_path / "a")])
    assert straight.recipe.epochs == 3 and \
        straight.recipe.steps_per_epoch == 3
    resumed = mainpretrain.main(argv + [
        "--epochs", "3", "--save_path", str(tmp_path / "b"),
        "--continue_training", "--checkpoint_folder", str(aside)])
    assert resumed.start_epoch == 2 and resumed.state.step == 9
    assert straight.state.step == 9 and straight.recipe.backbone == \
        "vit_small_patch16"
    for k in ("dino_center", "ibot_center"):
        assert torch.equal(resumed.state.extra[k], straight.state.extra[k])
    for a, b in zip(list(resumed.state.online.parameters())
                    + list(resumed.state.ema.parameters()),
                    list(straight.state.online.parameters())
                    + list(straight.state.ema.parameters())):
        assert torch.equal(a, b)
    run = Path(straight.save_path)
    metrics = [json.loads(line) for line in
               (run / "metrics.jsonl").read_text().splitlines()]
    assert [m["epoch"] for m in metrics] == [0, 1, 2]
    for m in metrics:
        assert {"loss", "dino_loss", "ibot_loss", "koleo_loss"} <= set(m)
        assert np.isfinite(m["loss"])
    assert (run / "training_log.txt").read_text().count(": Loss = ") == 3
    ckpt = torch.load(run / "model_ckpt_latest", weights_only=True)
    assert set(ckpt) == {"online", "ema", "optimizer", "extra", "step",
                         "epoch"}
    clf = knn_classification.main(argv + [
        "--eval_type", "knn", "--test_annotation", test_csv,
        "--checkpoint_path", str(run), "--save_path", str(tmp_path / "knn")])
    assert (tmp_path / "knn" / "knn_evaluation_results.txt").is_file()
    tr_f, _, te_f, _ = clf.extracting_features()
    assert tr_f.shape == (10, TINY_VIT[1]) and te_f.shape == (6, TINY_VIT[1])
    assert np.isfinite(tr_f).all()
    np.testing.assert_allclose(np.linalg.norm(te_f, axis=1), 1, atol=1e-5)


@pytest.mark.parametrize("mode", ["dinov2", "MSN"])
def test_config_and_recipe_dispatch_match_jax(mode):
    """``--config configs/pretrain_dinov2.yaml`` (and ``--mode MSN``) parse
    as the JAX CLI parses them, and both CLIs' dispatch builds the recipe
    with the same backbone, optimizer settings and schedules: no backbone
    is passed, the run's length goes to the recipe."""
    from hairci.cli.mainpretrain import build_recipe_from_args as jax_build
    from hairci.utils.config import parse_pretrain_args as jax_parse
    from hairci_torch.cli.mainpretrain import build_recipe_from_args
    from hairci_torch.utils.config import parse_pretrain_args

    repo = Path(__file__).resolve().parents[1]
    argv = (["--config", str(repo / "configs" / "pretrain_dinov2.yaml")]
            if mode == "dinov2" else
            ["--mode", "MSN", "--model", "vit_b_16", "--epochs", "30"])
    ours, ref = parse_pretrain_args(argv), jax_parse(argv)
    assert ours.mode == ref.mode == mode
    assert {k: v for k, v in vars(ours).items() if k != "device"} == \
        {k: v for k, v in vars(ref).items() if k != "device"}
    port, jrec = build_recipe_from_args(ours, 7), jax_build(ref, 7)
    if mode == "dinov2":
        assert (ours.batch_size, ours.weight_decay, ours.epochs) == (
            128, 0.04, 100)
        assert port.backbone == jrec.module.backbone_name == \
            "vit_small_patch16"
        assert (port.epochs, port.steps_per_epoch) == (jrec.epochs,
                                                       jrec.steps_per_epoch)
        for gstep in (0, 1, 99, 350, 699):
            assert port.teacher_temp(gstep) == jrec.teacher_temp(gstep)
            assert port.momentum(gstep) == jrec.momentum(gstep)
    else:
        assert port.backbone == jrec.module.backbone_name == \
            "vit_base_patch16"
        assert (port.n_focal, port.mask_ratio, port.ema_momentum) == (
            jrec.n_focal, jrec.mask_ratio, jrec.ema_momentum)
    assert (port.learning_rate, port.weight_decay, port.dtype) == (
        ours.lr, ours.weight_decay, torch.bfloat16)
