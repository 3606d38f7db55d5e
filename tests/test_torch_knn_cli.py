"""The port's evaluation slice as a whole, through
``hairci_torch.cli.knn_classification.main`` on the CPU, against the JAX
package: a ResNet-18 SHAM model at 40 px on committed images, the same
weights in both (one reference-layout ``.pth``), the same features,
predictions and result files for all four ``--eval_type``s; reference
SimCLR and SupCon ``.pth`` files; the parser's Namespace; checkpoints of the
port's Trainer (SHAM on a ResNet and a ViT, SimCLR); and what is not ported
yet."""

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

    # siaMIM is ported; this ResNet SHAM file is no SiameseIM .pth
    with pytest.raises(SystemExit, match="not a reference siaMIM .pth"):
        cli.main(swap("--mode", "siaMIM"))
    # DenseCL is ported, but a reference DenseCL .pth holds ResNet-50 trunks
    # only (convert_densecl's): with --model resnet18 the CLI names the flag
    with pytest.raises(SystemExit, match="--model resnet50"):
        cli.main(swap("--mode", "DenseCL"))
    # a reference .pth of SHAM on a ViT: no converter in either package
    with pytest.raises(SystemExit, match="ResNet backbones only"):
        cli.main(swap("--model", "vit_b_16"))
    # a reference SimCLR .pth on vit_b_16 must hold a torchvision ViT (read
    # in tests/test_torch_convert.py); this ResNet file is refused, named
    vit_simclr = swap("--model", "vit_b_16")
    vit_simclr[vit_simclr.index("--mode") + 1] = "simclr"
    with pytest.raises(SystemExit, match="torchvision ViT"):
        cli.main(vit_simclr)
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


def _coords_up_to_sign(ours, ref):
    for j in range(ref.shape[1]):
        sign = np.sign(np.dot(ours[:, j], ref[:, j]))
        np.testing.assert_allclose(sign * ours[:, j], ref[:, j],
                                   atol=1e-4 * np.abs(ref).max())


def test_cli_eval_types_match_jax(slice_, tmp_path):
    """``--eval_type linear_prob | visualization | inter_intra_distance`` on
    the slice's SHAM ``.pth``, against the JAX ``Classifier``'s methods on
    JAX's features: the probe's file byte for byte, the 2-D projection of
    the test split up to sign, the variance of both splits at rtol 1e-5."""
    jclf, root = slice_["jclf"], slice_["root"]
    base = slice_["argv"] + ["--device", "cpu"]

    def run(eval_type):
        argv = list(base)
        argv[argv.index("--eval_type") + 1] = eval_type
        return cli.main(argv + ["--save_path", str(tmp_path / eval_type)])

    run("linear_prob")
    jclf.linear_probe_eval()
    name = "linear_probe_results.txt"
    assert (tmp_path / "linear_prob" / name).read_bytes() == \
        (root / "jax" / name).read_bytes()

    run("visualization")
    ours = np.load(tmp_path / "visualization" / "umap_test.npz")
    ref = np.load(jclf.save_umap(split="test").replace(".png", ".npz"))
    np.testing.assert_array_equal(ours["labels"], ref["labels"])
    assert ours["coords"].shape == (6, 2)
    _coords_up_to_sign(ours["coords"], ref["coords"])

    clf = run("inter_intra_distance")
    want = jclf.compute_intra_inter_variance(split="both")
    got = clf.compute_intra_inter_variance(split="both")
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5)
    text = (tmp_path / "inter_intra_distance"
            / "variance_analysis_both.txt").read_text()
    assert text.startswith("Embedding Geometry Analysis\n")


@pytest.mark.parametrize("mode", ["simclr", "simclr_supcon"])
def test_baseline_pth_matches_jax(mode, tmp_path):
    """A reference SimCLR ``.pth`` (the SHAM layout: ``backbone.{0,1,4-7}``
    + ``projection_head.layers``) and a reference ``SupConResNet`` ``.pth``
    (``encoder.`` with ``shortcut``, ``head.0``/``head.2``), written from
    seeded JAX weights: the JAX package reads them with ``convert_simclr``
    / ``convert_supcon``, the port through ``--checkpoint_path``; the same
    features and the same kNN file."""
    train_csv, test_csv = _manifests(tmp_path)
    path = str(tmp_path / f"{mode}.pth")
    argv = _argv(tmp_path, train_csv, test_csv, "--checkpoint_path", path)
    argv[argv.index("--mode") + 1] = mode
    jargs = jax_cli.build_eval_parser().parse_args(
        argv + ["--save_path", str(tmp_path / "jax")])
    jrec = jax_cli.recipe_for_eval(jargs)
    rng = np.random.default_rng(1)
    sample = rng.normal(size=(2, SIZE, SIZE, 3)).astype(np.float32)
    params, stats = random_variables(jrec.module, sample, rng, train=True)
    if mode == "simclr":
        sd = ti.export_sham2(
            {"backbone": params["backbone"], "projection_head":
             params["head"]},
            {"backbone": stats["backbone"], "projection_head":
             stats["head"]}, "resnet18")
        jparams, jstats = ti.convert_simclr(sd, "resnet18")
    else:
        sd = {f"encoder.{k.replace('.downsample.', '.shortcut.')}": v
              for k, v in ti.export_resnet(params["encoder"],
                                           stats["encoder"]).items()}
        for i in (1, 2):
            sd[f"head.{2 * i - 2}.weight"] = np.asarray(
                params[f"head_fc{i}"]["kernel"]).T
            sd[f"head.{2 * i - 2}.bias"] = np.asarray(
                params[f"head_fc{i}"]["bias"])
        jparams, jstats = ti.convert_supcon(sd, "resnet18")
    ti.save_torch_state_dict(sd, path)
    jstate = types.SimpleNamespace(params=jparams, batch_stats=jstats)
    loaders = [JaxDataLoader(jax_load_manifest(csv, str(IMG_DIR)), BATCH,
                             size=SIZE, mode="center_crop", shuffle=False,
                             num_workers=1)
               for csv in (train_csv, test_csv)]
    jclf = JaxClassifier(lambda im: jrec.extract_features(jstate, im),
                         *loaders, str(tmp_path / "jax"), batch_size=BATCH)
    jclf.knn_eval()

    clf = cli.main(argv + ["--device", "cpu", "--save_path",
                           str(tmp_path / "port")])
    assert clf.extracting_features()[0].shape == (10, 512)
    for a, b in zip(clf.extracting_features(), jclf.extracting_features()):
        np.testing.assert_allclose(a, b, atol=1e-4)
    name = "knn_evaluation_results.txt"
    assert (tmp_path / "port" / name).read_text() == \
        (tmp_path / "jax" / name).read_text()


def test_simclr_trainer_checkpoint_takes_every_eval_type(tmp_path):
    """A checkpoint of the port's SimCLR run (one epoch, its last batch
    padded) through all four ``--eval_type``s: each writes its file from
    the checkpoint's online backbone, unit-norm features."""
    train_csv, test_csv = _manifests(tmp_path, n_train=10, n_test=3)
    common = ["--mode", "simclr", "--model", "resnet18", "--size", "32",
              "--device", "cpu", "--dtype", "float32", "--batch_size", "4",
              "--num_workers", "1", "--train_annotation", train_csv,
              "--img_dir", str(IMG_DIR)]
    trainer = mainpretrain.main(common + [
        "--epochs", "1", "--save_path", str(tmp_path / "out")])
    assert trainer.state.step == 3
    files = {"knn": "knn_evaluation_results.txt",
             "linear_prob": "linear_probe_results.txt",
             "visualization": "umap_test.npz",
             "inter_intra_distance": "variance_analysis_both.txt"}
    for eval_type, name in files.items():
        clf = cli.main(common + [
            "--eval_type", eval_type, "--checkpoint_path",
            trainer.save_path, "--test_annotation", test_csv,
            "--save_path", str(tmp_path / eval_type)])
        assert (tmp_path / eval_type / name).is_file(), eval_type
    tr_f, _, te_f, _ = clf.extracting_features()
    assert tr_f.shape == (10, 512) and te_f.shape == (3, 512)
    np.testing.assert_allclose(np.linalg.norm(tr_f, axis=1), 1, atol=1e-5)
    eval_images = next(iter(clf.test_loader))[0]
    direct = trainer.recipe.extract_features(
        trainer.state, torch.from_numpy(eval_images))
    direct = direct / direct.norm(dim=1, keepdim=True)
    np.testing.assert_allclose(te_f, direct.numpy(), atol=1e-6)
    text = (tmp_path / "inter_intra_distance"
            / "variance_analysis_both.txt").read_text()
    assert "variance_ratio" in text
