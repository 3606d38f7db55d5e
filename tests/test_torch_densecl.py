"""DenseCL in the port (``hairci_torch/ssl/densecl.py``) against the JAX
package's ``DenseCLRecipe``: two f32 steps from identical weights, BN
statistics, EMA, banks and views (one jitted JAX step run twice) -- the
loss and its global and local terms, every gradient, the BN running
statistics, the EMA taken BEFORE the step, the weights after Adam, both
banks and pointers (the second step meets the non-zero banks of the first
and wraps the ring) -- and the online features; a checkpoint that resumes
the banks where they stopped; the reference ``.pth`` reader against
``convert_densecl``; both CLIs on the CPU.

Both packages' ResNet-18 is cut to one block per stage at 64 px, so the
grid is 2 x 2, with 4 images and banks of 6 rows; the full 2048-wide heads
to 512. Gradients and weights are compared at rtol 1e-4 with an atol of
1e-4 of the tensor's largest entry."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hairci.models.resnet as jax_resnet
import hairci.ssl.densecl as jax_densecl
import hairci_torch.models.resnet as port_resnet
from hairci.retrieval import torch_import as ti
from hairci.train.state import TrainState as JaxTrainState
from hairci_torch.models.convert import (
    _SEQUENTIAL_RESNET,
    densecl_state_dict,
    densecl_state_dict_from_jax,
)
from hairci_torch.ssl.densecl import DenseCLModule, DenseCLRecipe
from hairci_torch.train import checkpoint as ckpt_lib
from test_torch_distill import random_tree
from test_torch_mae import IMG_DIR, manifests
from test_torch_supcon import _close

torch.set_num_threads(1)
B, S, M = 4, 64, 6
MOMENTA = (0.9, 0.95)      # the two steps' EMA momentum
CPU = torch.device("cpu")
EXTRA = ("bank_g", "ptr_g", "bank_l", "ptr_l")


def _t(a):
    return torch.from_numpy(np.array(a))


def _cut(mp, port_only=False):
    mp.setitem(port_resnet._STAGES, "resnet18",
               ([1, 1, 1, 1], port_resnet.BasicBlock))
    if not port_only:
        mp.setitem(jax_resnet._STAGES, "resnet18",
                   ([1, 1, 1, 1], jax_resnet.BasicBlock))


def _sd(params, stats):
    return densecl_state_dict_from_jax(params, stats, "resnet18")


@pytest.fixture(scope="module")
def jax_run():
    """Two JAX steps from a seeded state (momentum branch apart from the
    online one, zero banks), through one jitted step: the views come in
    through the batch, the gradients out through ``neg_indices``."""
    with pytest.MonkeyPatch.context() as mp:
        _cut(mp)
        orig = JaxTrainState.apply_gradients
        mp.setattr(JaxTrainState, "apply_gradients",
                   lambda self, grads, **kw: orig(self, grads, **kw).replace(
                       neg_indices=grads))
        rng = np.random.default_rng(0)
        views = [rng.normal(size=(2, B, S, S, 3)).astype(np.float32)
                 for _ in range(2)]
        jrec = jax_densecl.DenseCLRecipe(backbone="resnet18", img_size=S,
                                         bank_size=M, dtype=jnp.float32)
        jrec.transform = lambda key, images: (images[0], images[1])
        sample = jnp.zeros((2, B, S, S, 3), jnp.float32)
        shapes = jax.eval_shape(lambda: jrec.create_state(
            jax.random.key(0), sample))
        params, stats, ema, ema_stats = (
            random_tree(t, rng) for t in (shapes.params, shapes.batch_stats,
                                          shapes.params, shapes.batch_stats))
        extra = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                       shapes.extra)
        state = JaxTrainState(
            step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
            opt_state=jrec.tx.init(params), tx=jrec.tx, ema_params=ema,
            ema_batch_stats=ema_stats, extra=extra,
            neg_indices=jax.tree_util.tree_map(np.zeros_like, params))
        step = jax.jit(jrec.train_step)
        states, auxs = [state], []
        for v, m in zip(views, MOMENTA):
            new, aux = step(states[-1], {"image": jnp.asarray(v)},
                            jax.random.key(7), m)
            states.append(new)
            auxs.append(aux)
        states, auxs = jax.device_get((states, auxs))
        images = rng.integers(0, 256, (3, S + 8, S + 8, 3), dtype=np.uint8)
        feats = np.asarray(jax.jit(jrec.extract_features)(state, images))
    return dict(views=views, states=states, auxs=auxs, images=images,
                feats=feats)


def _port_state(js, mp):
    """The port's state at JAX's state ``js``: both branches, the banks and
    pointers, and Adam's moments and count."""
    _cut(mp, port_only=True)
    rec = DenseCLRecipe(backbone="resnet18", img_size=S, bank_size=M,
                        dtype=torch.float32)
    state = rec.create_state(0, B, CPU)
    state.online.load_state_dict(_sd(js.params, js.batch_stats), strict=True)
    state.ema.load_state_dict(_sd(js.ema_params, js.ema_batch_stats),
                              strict=True)
    state.extra = {k: _t(js.extra[k]).to(state.extra[k].dtype)
                   for k in EXTRA}
    (adam,) = [s for s in jax.tree_util.tree_leaves(
        js.opt_state, is_leaf=lambda s: hasattr(s, "mu")) if hasattr(s, "mu")]
    count = int(adam.count)
    if count:
        mu, nu = _sd(adam.mu, js.batch_stats), _sd(adam.nu, js.batch_stats)
        for name, p in state.online.named_parameters():
            state.optimizer.state[p] = {
                "step": torch.tensor(float(count)),
                "exp_avg": mu[name].clone(), "exp_avg_sq": nu[name].clone()}
    state.step = count
    return rec, state


@pytest.mark.parametrize("i", [0, 1])
def test_step_matches_jax(jax_run, i, monkeypatch):
    """Step ``i + 1`` from JAX's state before it; the second meets the banks
    the first filled (rows 0-3 of 6) and wraps them (rows 4, 5, 0, 1)."""
    before, after = jax_run["states"][i], jax_run["states"][i + 1]
    aux = jax_run["auxs"][i]
    rec, state = _port_state(before, monkeypatch)
    assert bool(state.extra["bank_g"].any()) == (i == 1)
    view = jax_run["views"][i]
    metrics = rec.step_on_views(state, _t(view[0]), _t(view[1]),
                                momentum=MOMENTA[i])
    for k in ("loss", "global_loss", "local_loss"):
        _close(k, metrics[k], aux[k], 1e-4, 1e-7)
    assert state.step == i + 1

    g = _sd(after.neg_indices, before.batch_stats)
    for name, p in state.online.named_parameters():
        _close(f"grad {name}", p.grad, g[name], 1e-4)
    new = _sd(after.params, after.batch_stats)
    for name, t in state.online.named_buffers():
        _close(f"running {name}", t, new[name], 1e-4)
    ema = _sd(after.ema_params, after.ema_batch_stats)
    for name, v in state.ema.state_dict().items():
        _close(f"ema {name}", v, ema[name], 1e-6, 1e-7)
    for k in ("bank_g", "bank_l"):
        _close(k, state.extra[k], after.extra[k], 1e-4)
    assert [int(state.extra[k]) for k in ("ptr_g", "ptr_l")] == \
        [int(after.extra["ptr_g"]), int(after.extra["ptr_l"])] == \
        [(B * (i + 1)) % M] * 2
    assert state.extra["ptr_g"].dtype == torch.long
    for name, p in state.online.named_parameters():
        gn = g[name].numpy()
        clear = np.abs(gn) > max(1e-3 * np.abs(gn).max(), 1e-6)
        _close(name, p.detach()[clear], new[name][clear], 1e-4)

    # the optimizer on JAX's gradients: every weight
    _, state = _port_state(before, monkeypatch)
    for name, p in state.online.named_parameters():
        p.grad = g[name].clone()
    state.optimizer.step()
    for name, p in state.online.named_parameters():
        _close(f"param {name}", p, new[name], 1e-6, 1e-6)


def test_features_are_the_unrounded_pooled_trunk(jax_run, monkeypatch):
    rec, state = _port_state(jax_run["states"][0], monkeypatch)
    feats = rec.extract_features(state, _t(jax_run["images"]))
    assert feats.shape == (3, 512) and state.online.training
    np.testing.assert_allclose(feats.numpy(), jax_run["feats"], atol=1e-5)


def test_checkpoint_resumes_the_ring(jax_run, tmp_path, monkeypatch):
    """A checkpoint after the first step holds both banks and their integer
    pointers; restored into a fresh state on the online module's device, the
    next step writes the same rows and gives the same loss as the state
    that was saved."""
    rec, state = _port_state(jax_run["states"][1], monkeypatch)
    path = ckpt_lib.save_checkpoint(str(tmp_path), "model_ckpt_latest",
                                    state, epoch=0)
    ckpt = torch.load(path, weights_only=True)
    assert set(ckpt) == {"online", "ema", "optimizer", "extra", "step",
                         "epoch"}
    assert set(ckpt["extra"]) == set(EXTRA)
    resumed = rec.create_state(1, B, CPU)
    assert not resumed.extra["bank_g"].any()
    assert ckpt_lib.restore_checkpoint(path, resumed) == 0
    for k in EXTRA:
        assert torch.equal(resumed.extra[k], state.extra[k]), k
        assert resumed.extra[k].dtype == state.extra[k].dtype
    assert int(resumed.extra["ptr_l"]) == B
    view = jax_run["views"][1]
    outs = [rec.step_on_views(s, _t(view[0]), _t(view[1]), 0.95)
            for s in (state, resumed)]
    assert torch.equal(outs[0]["loss"], outs[1]["loss"])
    for k in EXTRA:
        assert torch.equal(resumed.extra[k], state.extra[k]), k
    assert int(resumed.extra["ptr_g"]) == (2 * B) % M


def test_momentum_for_epoch_matches_jax():
    for epochs in (1, 3, 100):
        port = DenseCLRecipe(epochs=epochs)
        ref = jax_densecl.DenseCLRecipe(epochs=epochs)
        assert [port.momentum_for_epoch(e) for e in range(epochs)] == \
            [ref.momentum_for_epoch(e) for e in range(epochs)]


# ---------------------------------------------------------------------------
# the reference checkpoint layout
# ---------------------------------------------------------------------------

def reference_densecl_sd(module: DenseCLModule, seed=0):
    """A reference DenseCL state dict in ``module``'s shapes: each trunk as
    ``nn.Sequential(*resnet.children())[:-2]`` (with
    ``num_batches_tracked``), lightly's heads; the momentum copies apart."""
    rng = np.random.default_rng(seed)
    seq = {name: index for index, name in _SEQUENTIAL_RESNET.items()}
    sd = {}
    for suffix in ("", "_momentum"):
        for key, v in module.state_dict().items():
            top, _, rest = key.partition(".")
            if top == "backbone":
                child, _, tail = rest.partition(".")
                name = f"backbone{suffix}.{seq[child]}.{tail}"
                if tail.endswith("running_var"):
                    sd[name.replace("running_var", "num_batches_tracked")
                       ] = torch.tensor(3)
            else:
                name = f"{top}{suffix}.{rest}"
            a = rng.normal(0, 0.05, tuple(v.shape)).astype(np.float32)
            sd[name] = torch.from_numpy(np.abs(a) + 0.5 if "var" in name
                                        else a)
    return sd


def test_reader_matches_convert_densecl():
    """ResNet-50 at full width: the online and the momentum branch, tensor
    by tensor as ``convert_densecl`` reads them (through
    ``densecl_state_dict_from_jax``), with no JAX forward."""
    with torch.device("meta"):
        shapes = DenseCLModule("resnet50")
    sd = reference_densecl_sd(shapes)
    online, momentum = densecl_state_dict(sd, shapes)
    params, stats, ema, ema_stats = ti.convert_densecl(
        {k: v.numpy() for k, v in sd.items()})
    for got, want in ((online, densecl_state_dict_from_jax(params, stats)),
                      (momentum, densecl_state_dict_from_jax(ema,
                                                             ema_stats))):
        assert set(got) == set(want) == set(shapes.state_dict())
        for k, v in want.items():
            assert torch.equal(got[k], v), k
    assert not torch.equal(online["backbone.conv1.weight"],
                           momentum["backbone.conv1.weight"])
    assert online["projection_head_local.layers.2.weight"].shape == (512,
                                                                      2048)
    del sd["projection_head_local_momentum.layers.2.bias"]
    with pytest.raises(KeyError):
        densecl_state_dict(sd, shapes)


# ---------------------------------------------------------------------------
# both CLIs on the CPU
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """``mainpretrain --mode DenseCL`` for 2 epochs (batches of 4, the last
    padded): ResNet-50 whatever ``--model`` says, cut to one block per
    stage here."""
    from hairci_torch.cli import mainpretrain

    root = tmp_path_factory.mktemp("densecl")
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(port_resnet._STAGES, "resnet50",
                   ([1, 1, 1, 1], port_resnet.BottleneckBlock))
        train_csv, test_csv = manifests(root)
        common = ["--mode", "DenseCL", "--size", str(S), "--device", "cpu",
                  "--dtype", "float32", "--batch_size", "4",
                  "--num_workers", "1", "--train_annotation", train_csv,
                  "--img_dir", str(IMG_DIR)]
        trainer = mainpretrain.main(common + [
            "--model", "resnet18", "--epochs", "2",
            "--save_path", str(root / "out")])
    return dict(root=root, trainer=trainer, test_csv=test_csv,
                argv=common + ["--model", "resnet50"])


def test_cli_trains_densecl(trained):
    import json
    from pathlib import Path

    trainer = trained["trainer"]
    assert trainer.recipe.backbone == "resnet50" and trainer.recipe.epochs \
        == 2 and trainer.state.step == 6
    run = Path(trainer.save_path)
    metrics = [json.loads(s) for s in
               (run / "metrics.jsonl").read_text().splitlines()]
    assert [m["epoch"] for m in metrics] == [0, 1]
    for m in metrics:
        assert {"loss", "global_loss", "local_loss"} <= set(m)
        np.testing.assert_allclose(
            m["loss"], 0.5 * (m["global_loss"] + m["local_loss"]),
            rtol=1e-5)
    log = (run / "training_log.txt").read_text()
    assert log.count("\nEpoch 0: Loss = ") == 1 and "Epoch 1: Loss = " in log
    ckpt = torch.load(run / "model_ckpt_latest", weights_only=True)
    assert set(ckpt) == {"online", "ema", "optimizer", "extra", "step",
                         "epoch"}
    assert ckpt["extra"]["bank_g"].shape == (4096, 512)
    assert int(ckpt["extra"]["ptr_g"]) == int(ckpt["extra"]["ptr_l"]) == 24
    assert ckpt["extra"]["bank_l"][:24].abs().sum(1).min() > 0
    assert not ckpt["extra"]["bank_l"][24:].any()


@pytest.mark.parametrize("eval_type,name", [
    ("knn", "knn_evaluation_results.txt"),
    ("linear_prob", "linear_probe_results.txt"),
    ("visualization", "umap_test.npz"),
    ("inter_intra_distance", "variance_analysis_both.txt")])
def test_knn_cli_evaluates_the_trainer_checkpoint(trained, eval_type, name,
                                                  monkeypatch):
    """Each ``--eval_type`` on the run: the online trunk's unrounded pooled
    features of the restored checkpoint."""
    from hairci_torch.cli import knn_classification

    monkeypatch.setitem(port_resnet._STAGES, "resnet50",
                        ([1, 1, 1, 1], port_resnet.BottleneckBlock))
    out = trained["root"] / eval_type
    clf = knn_classification.main(trained["argv"] + [
        "--eval_type", eval_type, "--test_annotation", trained["test_csv"],
        "--checkpoint_path", trained["trainer"].save_path,
        "--save_path", str(out)])
    assert (out / name).is_file()
    tr_f, _, te_f, _ = clf.extracting_features()
    assert tr_f.shape == (10, 2048) and te_f.shape == (6, 2048)
    trainer = trained["trainer"]
    images = np.concatenate([x for x, _ in clf.test_loader])
    want = trainer.recipe.extract_features(trainer.state, _t(images))
    np.testing.assert_allclose(
        te_f, (want / want.norm(dim=1, keepdim=True)).numpy(), atol=1e-5)


def test_knn_cli_reads_a_reference_pth(trained, monkeypatch):
    """The trained weights written in the reference layout: the CLI reads
    them back (online branch) to the same features; with ``--model
    resnet18`` it exits naming ``--model resnet50``."""
    from hairci_torch.cli import knn_classification

    monkeypatch.setitem(port_resnet._STAGES, "resnet50",
                        ([1, 1, 1, 1], port_resnet.BottleneckBlock))
    trainer, root = trained["trainer"], trained["root"]
    seq = {name: index for index, name in _SEQUENTIAL_RESNET.items()}
    sd = {}
    for suffix, module in (("", trainer.state.online),
                           ("_momentum", trainer.state.ema)):
        for key, v in module.state_dict().items():
            top, _, rest = key.partition(".")
            if top == "backbone":
                child, _, tail = rest.partition(".")
                sd[f"backbone{suffix}.{seq[child]}.{tail}"] = v
            else:
                sd[f"{top}{suffix}.{rest}"] = v
    torch.save({"state_dict": sd}, root / "densecl.pth")
    argv = trained["argv"] + [
        "--eval_type", "knn", "--test_annotation", trained["test_csv"],
        "--checkpoint_path", str(root / "densecl.pth")]
    clf = knn_classification.main(argv + ["--save_path", str(root / "pth")])
    te_f = clf.extracting_features()[2]
    images = np.concatenate([x for x, _ in clf.test_loader])
    want = trainer.recipe.extract_features(trainer.state, _t(images))
    np.testing.assert_allclose(
        te_f, (want / want.norm(dim=1, keepdim=True)).numpy(), atol=1e-5)
    argv[argv.index("resnet50")] = "resnet18"
    with pytest.raises(SystemExit, match="--model resnet50"):
        knn_classification.main(argv + ["--save_path", str(root / "r18")])
