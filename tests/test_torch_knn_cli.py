"""The port's kNN evaluation slice as a whole, through
``hairci_torch.cli.knn_classification.main`` on the CPU, against the JAX
package: a ResNet-18 SHAM model at 40 px on committed images, the same
weights in both (one reference-layout ``.pth``), the same features,
predictions and result file; the parser's Namespace; checkpoints of the
port's Trainer, ResNet and ViT; and what is not ported yet."""

import types
from pathlib import Path

import numpy as np
import pytest
import torch

from hairci.cli import knn_classification as jax_cli
from hairci.data.loader import DataLoader as JaxDataLoader
from hairci.data.manifest import load_manifest as jax_load_manifest
from hairci.eval.classifier import Classifier as JaxClassifier
from hairci.retrieval import torch_import as ti
from hairci_torch.cli import knn_classification as cli
from hairci_torch.cli import mainpretrain
from hairci_torch.eval.knn import DEFAULT_KS, knn_predict_multi
from hairci_torch.ops.conv3x3 import conv3x3
from test_torch_resnet import random_variables

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]
IMG_DIR = REPO / "HairPretraining" / "data" / "hair_regions"
SIZE, BATCH = 40, 4


def _manifests(root, n_train=10, n_test=6):
    names = sorted(p.name for p in IMG_DIR.glob("*_hair.png"))
    out = []
    for name, rows in (("train.csv", names[:n_train]),
                       ("test.csv", names[2:2 + n_test])):
        (root / name).write_text("id,class\n" + "".join(
            f"{n},{int(n[:6]) % 3}\n" for n in rows))
        out.append(str(root / name))
    return out


def _argv(root, train_csv, test_csv, *extra):
    return ["--mode", "SHAM", "--model", "resnet18", "--size", str(SIZE),
            "--batch_size", str(BATCH), "--dtype", "float32", "--eval_type",
            "knn", "--num_workers", "1", "--train_annotation", train_csv,
            "--test_annotation", test_csv, "--img_dir", str(IMG_DIR),
            *extra]


@pytest.fixture(scope="module")
def slice_(tmp_path_factory):
    root = tmp_path_factory.mktemp("knncli")
    train_csv, test_csv = _manifests(root)
    argv = _argv(root, train_csv, test_csv, "--checkpoint_path",
                 str(root / "sham.pth"))

    # JAX: seeded weights -> the reference's .pth layout -> back through the
    # converter the JAX CLI uses for such a file
    jargs = jax_cli.build_eval_parser().parse_args(
        argv + ["--save_path", str(root / "jax")])
    jrec = jax_cli.recipe_for_eval(jargs)
    rng = np.random.default_rng(0)
    sample = rng.normal(size=(2, SIZE, SIZE, 3)).astype(np.float32)
    params, stats = random_variables(jrec.module, sample, rng, train=True)
    ti.save_torch_state_dict(ti.export_sham2(params, stats, "resnet18"),
                             str(root / "sham.pth"))
    jparams, jstats = ti.convert_sham2(
        ti.load_torch_state_dict(str(root / "sham.pth")), "resnet18")
    jstate = types.SimpleNamespace(params=jparams, batch_stats=jstats)
    loaders = [JaxDataLoader(jax_load_manifest(csv, str(IMG_DIR)), BATCH,
                             size=SIZE, mode="center_crop", shuffle=False,
                             num_workers=1)
               for csv in (train_csv, test_csv)]
    jclf = JaxClassifier(lambda im: jrec.extract_features(jstate, im),
                         *loaders, str(root / "jax"), batch_size=BATCH)
    jacc = jclf.knn_eval()

    before = conv3x3.launches
    clf = cli.main(argv + ["--device", "cpu", "--save_path",
                           str(root / "port")])
    assert conv3x3.launches == before       # the twins ran, no kernel
    return dict(root=root, argv=argv, jclf=jclf, jacc=jacc, clf=clf)


def test_features_match_jax(slice_):
    ours, ref = (c.extracting_features() for c in (slice_["clf"],
                                                   slice_["jclf"]))
    for a, b in zip(ours, ref):
        assert a.shape == b.shape
    np.testing.assert_allclose(ours[0], ref[0], atol=1e-4)
    np.testing.assert_allclose(ours[2], ref[2], atol=1e-4)
    np.testing.assert_array_equal(ours[1], ref[1])
    np.testing.assert_array_equal(ours[3], ref[3])
    assert ours[0].shape == (10, 512) and ours[2].shape == (6, 512)
    np.testing.assert_allclose(np.linalg.norm(ours[0], axis=1), 1, atol=1e-5)
    # the images differ: so do their features
    assert np.abs(ours[0][0] - ours[0][1]).max() > 1e-3


def test_predictions_and_result_file_match_jax(slice_):
    from hairci.eval.knn import knn_predict_multi as jax_multi

    tr_f, tr_l, te_f, te_l = slice_["clf"].extracting_features()
    jtr_f, jtr_l, jte_f, _ = slice_["jclf"].extracting_features()
    ours = knn_predict_multi(tr_f, tr_l, te_f, DEFAULT_KS, 3, device="cpu")
    ref = jax_multi(jtr_f, jtr_l, jte_f, DEFAULT_KS, 3)
    for k in DEFAULT_KS:
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=f"k={k}")
    name = "knn_evaluation_results.txt"
    text = (slice_["root"] / "port" / name).read_text()
    assert text == (slice_["root"] / "jax" / name).read_text()
    assert all(f"Results for k={k}\n" in text for k in DEFAULT_KS)
    # a test image is in the train set, so k=5 is no coin toss
    assert f"Accuracy: {slice_['jacc'][5]:.4f}" in text


@pytest.mark.parametrize("argv", [
    [],
    ["--mode", "SHAM", "--model", "resnet50", "--eval_type", "knn",
     "--batch_size=48", "--dtype", "float32", "--checkpoint_path", "x.pth"],
])
def test_parser_matches_jax(argv):
    ours = vars(cli.build_eval_parser().parse_args(argv))
    ref = vars(jax_cli.build_eval_parser().parse_args(argv))
    assert ours.pop("device") == "cuda" and ref.pop("device") == "tpu"
    assert ours == ref
    assert cli.EVAL_MODES == jax_cli.EVAL_MODES


def test_yaml_config_yields_to_explicit_flags(slice_, tmp_path):
    cfg = tmp_path / "eval.yaml"
    cfg.write_text("batch_size: 2\nsize: 48\nseed: 7\n")
    parser = cli.build_eval_parser()
    argv = ["--config", str(cfg), "--size", str(SIZE)]
    args = cli.merge_config_with_args(parser.parse_args(argv), parser, argv)
    assert (args.batch_size, args.size, args.seed) == (2, SIZE, 7)


def test_round_trip_from_a_trainer_checkpoint(slice_, tmp_path):
    train_csv, test_csv = _manifests(tmp_path, n_train=8, n_test=3)
    trainer = mainpretrain.main([
        "--mode", "SHAM", "--model", "resnet18", "--size", "32", "--device",
        "cpu", "--dtype", "float32", "--batch_size", "4", "--epochs", "1",
        "--warm_up_epochs", "2", "--k", "3", "--num_workers", "1",
        "--train_annotation", train_csv, "--img_dir", str(IMG_DIR),
        "--save_path", str(tmp_path / "out")])
    run = Path(trainer.save_path)
    assert (run / "model_ckpt_latest").is_file()
    base = ["--mode", "SHAM", "--model", "resnet18", "--size", "32",
            "--batch_size", "4", "--dtype", "float32", "--eval_type", "knn",
            "--device", "cpu", "--num_workers", "1", "--train_annotation",
            train_csv, "--test_annotation", test_csv, "--img_dir",
            str(IMG_DIR)]
    feats = {}
    # the run directory resolves to its newest checkpoint; so does the file
    for name, path in (("dir", run), ("file", run / "model_ckpt_latest")):
        clf = cli.main(base + ["--checkpoint_path", str(path), "--save_path",
                               str(tmp_path / name)])
        feats[name] = clf.extracting_features()[0]
        assert (tmp_path / name / "knn_evaluation_results.txt").is_file()
    np.testing.assert_array_equal(feats["dir"], feats["file"])
    # the online model of the checkpoint, not the seeded init: the loader
    # of the training run resized, the eval loader crops, so compare through
    # the recipe on the eval loader's own first batch
    eval_images = next(iter(clf.train_loader))[0]
    direct = trainer.recipe.extract_features(
        trainer.state, torch.from_numpy(eval_images))
    direct = direct / direct.norm(dim=1, keepdim=True)
    np.testing.assert_allclose(feats["file"][:4], direct.numpy(), atol=1e-6)
    assert feats["file"].shape == (8, 512)
    random_init = cli.main(base + ["--save_path", str(tmp_path / "rand")])
    assert np.abs(random_init.extracting_features()[0][:4]
                  - feats["file"][:4]).max() > 1e-3


def test_cli_refuses_what_is_not_ported(slice_, tmp_path):
    base = slice_["argv"] + ["--device", "cpu", "--save_path",
                                         str(tmp_path)]

    def swap(flag, value):
        out = list(base)
        out[out.index(flag) + 1] = value
        return out

    for argv in (swap("--mode", "simclr"), swap("--eval_type", "linear_prob"),
                 swap("--eval_type", "visualization")):
        with pytest.raises(SystemExit, match="not yet ported"):
            cli.main(argv)
    # a reference .pth of SHAM on a ViT: no converter in either package
    with pytest.raises(SystemExit, match="ResNet backbones only"):
        cli.main(swap("--model", "vit_b_16"))
    no_type = list(base)
    del no_type[no_type.index("--eval_type"):no_type.index("--eval_type") + 2]
    with pytest.raises(SystemExit, match="--eval_type is required"):
        cli.main(no_type)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(swap("--device", "cuda"))


def test_vit_trainer_checkpoint_evaluates(tmp_path, monkeypatch):
    """``--model vit_b_16`` on a checkpoint of the port's own ViT SHAM run
    (ViT-B/16 cut to patch 8, width 64, depth 2 at 32 px): the backbone's
    pooled cls token, unit-norm, and every test image finds itself."""
    import hairci_torch.models.vit as port_vit
    import hairci_torch.ssl.sham as port_sham

    monkeypatch.setitem(port_vit.VIT_CONFIGS, "vit_base_patch16",
                        (8, 64, 2, 2))
    monkeypatch.setitem(port_sham._PROJ_DIMS, "vit_b_16", (64, 64, 32))
    train_csv, test_csv = _manifests(tmp_path, n_train=8, n_test=3)
    common = ["--mode", "SHAM", "--model", "vit_b_16", "--size", "32",
              "--device", "cpu", "--dtype", "float32", "--batch_size", "4",
              "--num_workers", "1", "--train_annotation", train_csv,
              "--img_dir", str(IMG_DIR)]
    trainer = mainpretrain.main(common + [
        "--S2R2", "--epochs", "1", "--save_path", str(tmp_path / "out")])
    clf = cli.main(common + [
        "--eval_type", "knn", "--checkpoint_path", trainer.save_path,
        "--test_annotation", test_csv, "--save_path", str(tmp_path / "knn")])
    tr_f, tr_l, te_f, te_l = clf.extracting_features()
    assert tr_f.shape == (8, 64) and te_f.shape == (3, 64)
    np.testing.assert_allclose(np.linalg.norm(tr_f, axis=1), 1, atol=1e-5)
    text = (tmp_path / "knn" / "knn_evaluation_results.txt").read_text()
    assert all(f"Results for k={k}\n" in text for k in DEFAULT_KS)
    # the test images are train images 2-4: each is its own neighbour
    np.testing.assert_array_equal(
        knn_predict_multi(tr_f, tr_l, te_f, [1], 3, device="cpu")[1], te_l)
    eval_images = next(iter(clf.test_loader))[0]
    direct = trainer.recipe.extract_features(
        trainer.state, torch.from_numpy(eval_images))
    direct = direct / direct.norm(dim=1, keepdim=True)
    np.testing.assert_allclose(te_f, direct.numpy(), atol=1e-6)
