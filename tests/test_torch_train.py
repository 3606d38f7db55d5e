"""The port's training path around the step, against the JAX package: the
losses, the negative samplers, the staging rules, the config parser,
``python -m hairci_torch.cli.mainpretrain`` for SHAM with its log format and
resume, SimCLR and SupCon through the same CLI with a padded last batch and
the ``Loss =`` log line, and checkpoints without an EMA teacher and written
before there were such checkpoints."""

import json
import re
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hairci.losses.contrastive as jcontrastive
from hairci.losses.contrastive import margin_violation_stats as j_viol
from hairci.losses.contrastive import nt_xent_loss as j_ntx
from hairci.losses.contrastive import triplet_margin_loss as j_trip
from hairci.data.loader import DataLoader as JaxDataLoader
from hairci.data.manifest import load_manifest as jax_load_manifest
from hairci.ssl.sham import SHAMRecipe as JaxSHAMRecipe
from hairci.ssl.sham import derangement as j_derangement
from hairci.ssl.sham import kth_neighbor_indices as j_kth
from hairci.train.engine import Trainer as JaxTrainer
from hairci.utils.config import parse_pretrain_args as jax_parse
from hairci_torch.cli import mainpretrain
from hairci_torch.losses import contrastive
from hairci_torch.losses.contrastive import (
    margin_violation_stats,
    nt_xent_loss,
    triplet_margin_loss,
)
from hairci_torch.ssl.sham import (
    SHAMRecipe,
    derangement,
    kth_neighbor_indices,
)
from hairci_torch.train import checkpoint as ckpt_lib
from hairci_torch.utils.config import parse_pretrain_args

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# losses and negative samplers
# ---------------------------------------------------------------------------

def test_losses_match_jax():
    rng = np.random.default_rng(0)
    a, p, n = (rng.normal(size=(6, 16)).astype(np.float32) for _ in range(3))
    tol = dict(rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        nt_xent_loss(_t(p), _t(a), 0.5).numpy(), np.asarray(j_ntx(p, a, 0.5)),
        **tol)
    np.testing.assert_allclose(
        triplet_margin_loss(_t(a), _t(p), _t(n), 0.7).numpy(),
        np.asarray(j_trip(a, p, n, 0.7)), **tol)
    ours = margin_violation_stats(_t(a), _t(p), _t(n), 0.5)
    ref = j_viol(a, p, n, 0.5)
    for o, r in zip(ours[:2], ref[:2]):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), **tol)
    assert int(ours[2]) == int(ref[2])
    # the SHAM MSE term on normalised embeddings
    mse = torch.mean(torch.square(_t(p) - _t(a)))
    np.testing.assert_allclose(mse.numpy(),
                               np.asarray(jnp.mean(jnp.square(p - a))), **tol)


LOOSE_LOSSES = {
    "nt_xent_1anchor_2positive": ((0, 1, 2), {"temperature": 0.3}),
    "positive_consistency_loss_margin": ((0, 1), {"margin": 0.9}),
    "bidirectional_margin_loss": ((0, 1, 2), {"margin_pos": 0.9,
                                              "margin_neg": 1.1}),
    "mse_alignment_loss": ((0, 1), {}),
}


@pytest.mark.parametrize("name", sorted(LOOSE_LOSSES))
def test_loose_losses_and_gradients_match_jax(name):
    """The losses no recipe calls, value and gradients at rtol 1e-5 (the
    margins put about half the hinges above 0)."""
    from test_torch_distill import check_grads

    argnums, kw = LOOSE_LOSSES[name]
    rng = np.random.default_rng(9)
    arrays = [rng.normal(size=(6, 16)).astype(np.float32)
              for _ in range(len(argnums))]
    check_grads(lambda *a: getattr(jcontrastive, name)(*a, **kw),
                lambda *a: getattr(contrastive, name)(*a, **kw), arrays,
                argnums=argnums)


def test_negative_samplers_match_jax():
    key = jax.random.key(3)
    perm = jax.random.permutation(key, 7)
    assert torch.equal(derangement(_t(perm)),
                       _t(j_derangement(key, 7)).long())
    # duplicated rows tie: the stable sort keeps the lower index first
    rng = np.random.default_rng(1)
    f = rng.normal(size=(5, 8)).astype(np.float32)
    f = np.concatenate([f, f[:3]])
    for k in range(1, 9):
        assert torch.equal(kth_neighbor_indices(_t(f), k),
                           _t(j_kth(jnp.asarray(f), jnp.asarray(k))).long())


def test_staging_rules_match_jax():
    for abl in ("None", "randomly"):
        ours = SHAMRecipe(warm_up_epochs=3, ablation=abl)
        ref = JaxSHAMRecipe(warm_up_epochs=3, ablation=abl)
        assert [ours.stage_for_epoch(e) for e in range(6)] == \
            [ref.stage_for_epoch(e) for e in range(6)]
    for v in (0.0, 3.0, 7.5, 31.0, 64.0):
        assert SHAMRecipe.adapt_k(v, 64) == JaxSHAMRecipe.adapt_k(v, 64)


# ---------------------------------------------------------------------------
# config and CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("argv", [
    [],
    ["--mode", "SHAM", "--model", "resnet50", "--epochs=7", "--k", "3"],
    ["--config", str(REPO / "configs" / "pretrain_sham.yaml")],
    ["--config", str(REPO / "configs" / "pretrain_sham.yaml"),
     "--batch_size", "64", "--ablation", "No masked positive"],
])
def test_config_parser_matches_jax(argv):
    ours, ref = vars(parse_pretrain_args(argv)), vars(jax_parse(argv))
    assert ours.pop("device") == "cuda" and ref.pop("device") == "tpu"
    assert ours == ref


def _manifest(tmp_path, n=8):
    img_dir = REPO / "HairPretraining" / "data" / "hair_regions"
    rows = [f"{i:06d}_hair.png,{i % 3}" for i in range(n)]
    csv = tmp_path / "train.csv"
    csv.write_text("id,class\n" + "\n".join(rows) + "\n")
    return csv, img_dir


def test_cli_trains_logs_and_resumes(tmp_path):
    csv, img_dir = _manifest(tmp_path)
    argv = ["--mode", "SHAM", "--model", "resnet18", "--size", "32",
            "--device", "cpu", "--dtype", "float32", "--batch_size", "4",
            "--epochs", "3", "--warm_up_epochs", "2", "--k", "3",
            "--num_workers", "1", "--train_annotation", str(csv),
            "--img_dir", str(img_dir), "--save_path", str(tmp_path / "out")]
    subprocess.run([sys.executable, "-m", "hairci_torch.cli.mainpretrain",
                    *argv], cwd=REPO, check=True, timeout=300,
                   env={"PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "1",
                        "HOME": str(tmp_path)})
    run = tmp_path / "out" / "SHAM_resnet18_ep3_bs4_lr0.001_temp0.5_warm2_ema0.99_k3"
    lines = (run / "metrics.jsonl").read_text().splitlines()
    metrics = [json.loads(s) for s in lines]
    assert [m["epoch"] for m in metrics] == [0, 1, 2]
    assert all(np.isfinite(m["loss"]) for m in metrics)
    assert (run / "model_ckpt_latest").is_file()

    # the log line is the JAX engine's, byte for byte
    log = (run / "training_log.txt").read_text()
    fake = types.SimpleNamespace(args=types.SimpleNamespace(mode="SHAM"),
                                 metrics_file=str(tmp_path / "j.jsonl"),
                                 log_file=str(tmp_path / "j.txt"))
    total_k = [3, SHAMRecipe.adapt_k(metrics[0]["margin_violations"], 4)]
    for m, k in zip(metrics, total_k + total_k[-1:]):
        JaxTrainer._log_epoch(fake, m["epoch"], m, k)
    assert log == (tmp_path / "j.txt").read_text()
    assert re.search(r"Margin violations: [\d.]+, Total k: \d+\n$", log)

    # resume from model_ckpt_latest: the next epoch is 3
    ckpt = torch.load(run / "model_ckpt_latest", weights_only=True)
    assert ckpt["epoch"] == 2 and ckpt["step"] == 6
    # (a new --epochs names a new run dir; the checkpoint folder is given)
    trainer = mainpretrain.main(argv + ["--continue_training",
                                        "--checkpoint_folder", str(run),
                                        "--epochs", "4"])
    assert trainer.start_epoch == 3 and trainer.state.step == 8
    resumed = [json.loads(s) for s in Path(
        trainer.save_path, "metrics.jsonl").read_text().splitlines()]
    assert [m["epoch"] for m in resumed] == [3]


def test_cli_refuses_what_is_not_ported(tmp_path):
    csv, img_dir = _manifest(tmp_path)
    base = ["--device", "cpu", "--train_annotation", str(csv), "--img_dir",
            str(img_dir), "--save_path", str(tmp_path)]
    # every mode of the JAX CLI is ported (SiameseIM last:
    # tests/test_torch_siameseim.py); SHAM v1 is no mode of either CLI
    # (the registry and the Trainer reach it: tests/test_torch_sham_v1.py)
    from hairci.utils.config import PRETRAIN_MODES as JAX_MODES

    assert sorted(mainpretrain.PORTED_MODES) == sorted(JAX_MODES)
    with pytest.raises(SystemExit):
        mainpretrain.main(base + ["--mode", "SHAM_v1"])
    args = parse_pretrain_args(base + ["--mode", "siameseim"])
    args.mode = "SHAM_v1"
    with pytest.raises(SystemExit, match="not yet ported.*siameseim"):
        mainpretrain.build_recipe_from_args(args, num_batches=1)


def test_cli_trains_vit_sham_with_s2r2(tmp_path, monkeypatch):
    """``--model vit_b_16 --S2R2`` through the CLI, with ViT-B/16 cut to
    patch 8, width 64, depth 2 at 32 px: the recipe carries the Smooth-AP
    weight and block remat, and the run trains through all three stages."""
    import hairci_torch.models.vit as port_vit
    import hairci_torch.ssl.sham as port_sham

    monkeypatch.setitem(port_vit.VIT_CONFIGS, "vit_base_patch16",
                        (8, 64, 2, 2))
    monkeypatch.setitem(port_sham._PROJ_DIMS, "vit_b_16", (64, 64, 32))
    csv, img_dir = _manifest(tmp_path)
    argv = ["--mode", "SHAM", "--model", "vit_b_16", "--S2R2", "--size",
            "32", "--device", "cpu", "--dtype", "float32", "--batch_size",
            "4", "--epochs", "3", "--warm_up_epochs", "2", "--k", "3",
            "--num_workers", "1", "--train_annotation", str(csv),
            "--img_dir", str(img_dir), "--save_path", str(tmp_path / "out")]
    args = parse_pretrain_args(argv)
    recipe = mainpretrain.build_recipe_from_args(args, num_batches=2)
    assert recipe.s2r2_weight == 1.0 and recipe.remat is True
    trainer = mainpretrain.main(argv)
    backbone = trainer.state.online.backbone
    assert backbone.remat is True and backbone.blocks[0].mlp.fc1.weight.dtype \
        == torch.float32
    metrics = [json.loads(s) for s in Path(
        trainer.save_path, "metrics.jsonl").read_text().splitlines()]
    assert [m["epoch"] for m in metrics] == [0, 1, 2]
    for m in metrics:
        assert np.isfinite(m["loss"])
        # the Smooth-AP term (in [0, 1]) is in the total
        rest = m["contrastive_loss"] + 0.5 * m["triplet_loss"] \
            + 0.2 * m["mse_loss"]
        assert 0 < m["loss"] - rest <= 1 + 1e-5
    assert trainer.state.step == 6


# ---------------------------------------------------------------------------
# SimCLR and SupCon through the CLI; checkpoints
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["simclr", "simclr_supcon"])
def test_cli_trains_baseline_with_padded_last_batch(tmp_path, mode):
    """10 images at batches of 4: every epoch ends in a batch padded with
    its last row, as the JAX loader pads it; the log has the JAX engine's
    ``Loss =`` line; the checkpoint has no EMA and no negative cache, and
    resumes."""
    csv, img_dir = _manifest(tmp_path, n=10)
    argv = ["--mode", mode, "--model", "resnet18", "--size", "32",
            "--device", "cpu", "--dtype", "float32", "--batch_size", "4",
            "--epochs", "2", "--num_workers", "1", "--train_annotation",
            str(csv), "--img_dir", str(img_dir), "--save_path",
            str(tmp_path / "out")]
    trainer = mainpretrain.main(argv)
    loader = trainer.train_loader
    assert len(loader) == 3 and loader.pad_last and not loader.drop_last
    ref = JaxDataLoader(jax_load_manifest(str(csv), str(img_dir)), 4,
                        size=loader.size, mode="raw_resize", shuffle=True,
                        drop_last=False, pad_last=True, seed=42,
                        num_workers=1)
    for epoch in (0, 1):
        loader.set_epoch(epoch)
        ref.set_epoch(epoch)
        ours, want = list(loader), list(ref)
        assert len(ours) == len(want) == 3
        for (x, y), (rx, ry) in zip(ours, want):
            np.testing.assert_array_equal(x, rx)
            np.testing.assert_array_equal(y, ry)
        x, y = ours[-1]
        assert x.shape[0] == 4 and (x[2] == x[3]).all() and y[2] == y[3]
    assert trainer.state.step == 6

    run = Path(trainer.save_path)
    metrics = [json.loads(s) for s in (run / "metrics.jsonl").read_text()
               .splitlines()]
    assert [m["epoch"] for m in metrics] == [0, 1]
    assert all(np.isfinite(m["loss"]) for m in metrics)
    fake = types.SimpleNamespace(args=types.SimpleNamespace(mode=mode),
                                 metrics_file=str(tmp_path / "j.jsonl"),
                                 log_file=str(tmp_path / "j.txt"))
    for m in metrics:
        JaxTrainer._log_epoch(fake, m["epoch"], m, 7)
    log = (run / "training_log.txt").read_text()
    assert log == (tmp_path / "j.txt").read_text()
    assert re.fullmatch(r"(\nEpoch \d: Loss = \d+\.\d{6}\n){2}", log)

    ckpt = torch.load(run / "model_ckpt_latest", weights_only=True)
    assert set(ckpt) == {"online", "optimizer", "step", "epoch"}
    assert ckpt["step"] == 6 and ckpt["epoch"] == 1
    resumed = mainpretrain.main(argv + ["--continue_training", "--epochs",
                                        "3", "--checkpoint_folder",
                                        str(run)])
    assert resumed.start_epoch == 2 and resumed.state.step == 9
    assert resumed.state.ema is None


def test_simclr_checkpoint_round_trip(tmp_path):
    """A SimCLR state saves without an EMA and restores exactly: the online
    weights, the BN stats, the Adam moments and the step."""
    from hairci_torch.ssl import build_recipe

    rec = build_recipe("simclr", backbone="resnet18", img_size=32)
    state = rec.create_state(0, 4, torch.device("cpu"))
    images = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (4, 36, 36, 3), np.uint8))
    rec.train_step(state, images, torch.Generator().manual_seed(1))
    path = ckpt_lib.save_checkpoint(str(tmp_path), "model_ckpt_latest",
                                    state, 4)
    fresh = rec.create_state(1, 4, torch.device("cpu"))
    assert ckpt_lib.restore_checkpoint(path, fresh) == 4
    assert fresh.step == 1 and fresh.ema is None
    for (name, t), u in zip(state.online.state_dict().items(),
                            fresh.online.state_dict().values()):
        assert torch.equal(t, u), name
    a, b = state.optimizer.state_dict(), fresh.optimizer.state_dict()
    for i, st in a["state"].items():
        for k in st:
            assert torch.equal(st[k], b["state"][i][k])


def test_sham_checkpoint_of_the_old_layout_restores(tmp_path):
    """A SHAM checkpoint as the Trainer wrote it before ``TrainState``'s
    EMA and negative cache became optional (the keys and their order built
    here by hand) restores into today's state; today's SHAM checkpoint has
    the same keys in the same order."""
    rec = SHAMRecipe(backbone="resnet18", img_size=32, num_batches=2)
    old = rec.create_state(0, 4, torch.device("cpu"))
    with torch.no_grad():
        for p in old.ema.parameters():
            p.add_(1.0)
    old.neg_indices.copy_(torch.arange(8).reshape(2, 4).flip(1))
    old.step = 5
    path = tmp_path / "model_ckpt_latest"
    torch.save({"online": old.online.state_dict(),
                "ema": old.ema.state_dict(),
                "optimizer": old.optimizer.state_dict(),
                "neg_indices": old.neg_indices,
                "step": old.step,
                "epoch": 7}, path)
    new = rec.create_state(1, 4, torch.device("cpu"))
    assert ckpt_lib.restore_checkpoint(str(path), new) == 7
    assert new.step == 5 and torch.equal(new.neg_indices, old.neg_indices)
    for a, b in ((old.online, new.online), (old.ema, new.ema)):
        for (name, t), u in zip(a.state_dict().items(),
                                b.state_dict().values()):
            assert torch.equal(t, u), name
    written = ckpt_lib.save_checkpoint(str(tmp_path), "again", new, 7)
    assert list(torch.load(written, weights_only=True)) == \
        list(torch.load(path, weights_only=True))
