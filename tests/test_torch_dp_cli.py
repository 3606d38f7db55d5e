"""``mainpretrain --num_processes 2`` for the recipes whose steps became the
global batch's after SHAM's and SimCLR's ResNet steps: ``--mode dinov2``,
``--mode siameseim``, ``--mode simclr --S2R2`` and ``--mode BYOL``, each
one step of the
global batch of 16 on ``tests/test_torch_dp.py``'s 16-image manifest, run
with two gloo processes and with one: the loss at rtol 3e-4 and the
update's norm at rtol 2e-3, as ``tests/test_multiprocess.py`` holds them.
Then DINOv2's checkpoint, written by the two ranks, resumed in one process
for a second step against a one-process resume of the one-process
checkpoint (its centres too, rtol 1e-4 / atol 1e-6).

The ViTs are cut to patch 16, width 64, depth 2, 2 heads at 32 px; DINOv2
takes two 16-px local views, 64 prototypes and ``koleo_weight`` 0
(KoLeo's nearest neighbour at DINOv2's init is rounding noise: the cls
rows nearly tie, so the two runs' KoLeo terms part by far more than the
tolerance); SiameseIM a 64-wide decoder of 1 + 2 blocks. BYOL trains
ResNet-18 (its CLI mode builds ResNet-50 whatever ``--model`` says) with
the full 4096-wide heads at 32 px, the momentum branch and the heads' BNs
over the global batch. One spawn of two gloo processes runs the four
two-process runs; the one-process runs are computed in this process
meanwhile.
"""

import functools
import os

import numpy as np
import pytest
import torch

from hairci_torch.cli import mainpretrain
from test_torch_dp import (  # noqa: F401 (dataset is a fixture)
    B,
    CLI_FLAGS,
    W,
    _cli_run,
    _free_port,
    _run_out,
    _update_norm,
    dataset,
)

torch.set_num_threads(1)
CLI_MODES = {"dinov2": ["--mode", "dinov2"],
             "siameseim": ["--mode", "siameseim"],
             "S2R2": ["--S2R2"],
             "BYOL": ["--mode", "BYOL"]}
TINY_VIT = (16, 64, 2, 2)         # patch, width, depth, heads


def _cut_vit_recipes(setitem):
    """DINOv2's ViT-S/16 and SiameseIM's ViT-B/16 cut for the CPU, with
    small heads, and BYOL on ResNet-18 (``setitem``: a monkeypatch's, or a
    plain one in a spawned rank)."""
    from hairci_torch.models import vit
    from hairci_torch.ssl import RECIPES
    from hairci_torch.ssl.byol import BYOLRecipe
    from hairci_torch.ssl.dinov2 import DINOv2Recipe
    from hairci_torch.ssl.siameseim import SiameseIMRecipe

    for name in ("vit_small_patch16", "vit_base_patch16"):
        setitem(vit.VIT_CONFIGS, name, TINY_VIT)
    setitem(RECIPES, "dinov2", functools.partial(
        DINOv2Recipe, local_size=16, n_local=2, head_out=64,
        koleo_weight=0.0))
    setitem(RECIPES, "siameseim", functools.partial(
        SiameseIMRecipe, decoder_dim=64, decoder_num_heads=4,
        projector_depth=1, predictor_depth=2))
    setitem(RECIPES, "BYOL", functools.partial(BYOLRecipe,
                                               backbone="resnet18"))


def _worker(rank, ports, out_dir, flags):
    torch.set_num_threads(1)
    _cut_vit_recipes(lambda d, k, v: d.__setitem__(k, v))
    for (mode, extra), port in zip(CLI_MODES.items(), ports):
        mainpretrain.main(flags + extra + [
            "--save_path", os.path.join(out_dir, f"two_{mode}"),
            "--num_processes", str(W), "--process_index", str(rank),
            "--coordinator", f"localhost:{port}"])


@pytest.fixture(scope="module")
def runs(dataset, tmp_path_factory):
    out = tmp_path_factory.mktemp("dpcli")
    flags = CLI_FLAGS + dataset
    one_step = flags + ["--epochs", "1"]
    ctx = torch.multiprocessing.start_processes(
        _worker, args=([_free_port() for _ in CLI_MODES], str(out),
                       one_step), nprocs=W, join=False, start_method="spawn")
    starts = {}
    dino = flags + CLI_MODES["dinov2"] + ["--epochs", "2",
                                          "--continue_training"]
    try:
        with pytest.MonkeyPatch.context() as mp:
            _cut_vit_recipes(mp.setitem)
            for mode, extra in CLI_MODES.items():
                _cli_run(one_step + extra, str(out / f"one_{mode}"))
                rec = mainpretrain.build_recipe_from_args(
                    mainpretrain.parse_pretrain_args(flags + extra), 1)
                starts[mode] = rec.create_state(5, B, torch.device(
                    "cpu")).online.state_dict()
            _cli_run(dino, str(out / "one_from_one_dinov2"),
                     "--checkpoint_folder",
                     _run_out(str(out / "one_dinov2"))["run"])
            while not ctx.join():
                pass
            # DINOv2's centres and teacher, written by two ranks, resumed
            # alone
            _cli_run(dino, str(out / "one_from_two_dinov2"),
                     "--checkpoint_folder",
                     _run_out(str(out / "two_dinov2"))["run"])
    finally:
        while not ctx.join():
            pass
    names = [f"{n}_{mode}" for mode in CLI_MODES for n in ("one", "two")]
    cli = {name: _run_out(str(out / name)) for name in names + [
        "one_from_one_dinov2", "one_from_two_dinov2"]}
    for name in cli:
        cli[name]["extra"] = torch.load(
            os.path.join(cli[name]["run"], "model_ckpt_latest"),
            weights_only=True).get("extra")
    return {"cli": cli, "starts": starts}


@pytest.mark.parametrize("mode", list(CLI_MODES))
def test_cli_two_processes_match_one_for_the_vit_recipes(runs, mode):
    """One step of the global batch on two processes, as one process takes
    it; rank 0 alone wrote the run's log."""
    one, two = runs["cli"][f"one_{mode}"], runs["cli"][f"two_{mode}"]
    start = runs["starts"][mode]
    np.testing.assert_allclose(two["loss"], one["loss"], rtol=3e-4, atol=1e-5)
    np.testing.assert_allclose(_update_norm(two["online"], start),
                               _update_norm(one["online"], start), rtol=2e-3)
    assert _update_norm(two["online"], start) > 0
    with open(os.path.join(two["run"], "metrics.jsonl")) as f:
        assert len(f.read().splitlines()) == 1


def test_cli_dinov2_centres_restore_across_world_sizes(runs):
    """The checkpoint two ranks wrote holds the one-process run's centres
    (global teacher-logit means), and resumed in one process its second
    step matches a one-process resume of the one-process checkpoint."""
    one, two = runs["cli"]["one_dinov2"], runs["cli"]["two_dinov2"]
    for key in ("dino_center", "ibot_center"):
        np.testing.assert_allclose(two["extra"][key].numpy(),
                                   one["extra"][key].numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=key)
    got = runs["cli"]["one_from_two_dinov2"]
    want = runs["cli"]["one_from_one_dinov2"]
    assert got["epoch"] == want["epoch"] == 1
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=3e-4,
                               atol=1e-5)
    for key in ("dino_center", "ibot_center"):
        np.testing.assert_allclose(got["extra"][key].numpy(),
                                   want["extra"][key].numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=key)
