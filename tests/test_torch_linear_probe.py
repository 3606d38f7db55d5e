"""The rest of the port's evaluation (``hairci_torch/eval``) against the JAX
package on seeded numpy features: the L-BFGS linear probe, the
intra/inter-class variance, the PCA fallback of the 2-D projection, and the
three ``Classifier`` methods that write them."""

import numpy as np
import pytest
import torch

from hairci.eval import classifier as jax_classifier
from hairci.eval import linear_probe as jax_lp
from hairci.eval import umap_export as jax_umap
from hairci.eval import variance as jax_variance
from hairci_torch.eval import linear_probe, umap_export, variance
from hairci_torch.eval.classifier import Classifier

torch.set_num_threads(1)


def _blobs(rng, n_per=40, d=16, c=4, spread=0.3, scale=3.0):
    """``tests/test_eval_engine.py``'s blobs: class centres of N(0, scale²)
    from a fixed seed, rows at ``spread`` around them."""
    centers = np.random.default_rng(123).normal(size=(c, d)) * scale
    X = np.concatenate([centers[i] + spread * rng.normal(size=(n_per, d))
                        for i in range(c)]).astype(np.float32)
    return X, np.repeat(np.arange(c), n_per)


def _objective(W, b, X, y):
    """mean CE + ||W||² / (2N) in f64."""
    logits = X.astype(np.float64) @ W + b
    logits -= logits.max(axis=1, keepdims=True)
    logp = logits - np.log(np.exp(logits).sum(axis=1, keepdims=True))
    return -logp[np.arange(len(y)), y].mean() + 0.5 / len(y) * np.sum(
        np.asarray(W, np.float64) ** 2)


def test_probe_predictions_equal_jax_on_blobs():
    rng = np.random.default_rng(0)
    Xtr, ytr = _blobs(rng)
    Xte, yte = _blobs(rng, n_per=10)
    ours = linear_probe.linear_probe_fit_predict(Xtr, ytr, Xte,
                                                 device="cpu")
    ref = jax_lp.linear_probe_fit_predict(Xtr, ytr, Xte, backend="jax")
    np.testing.assert_array_equal(ours, np.asarray(ref))
    assert np.mean(ours == yte) >= 0.95


def test_probe_lands_on_jax_optimum_on_overlapping_classes():
    """Classes that overlap (spread 1.5 around centres of unit scale): the
    two fits agree on >= 99 % of the test rows, and on the objective at
    rtol 1e-4."""
    rng = np.random.default_rng(1)
    Xtr, ytr = _blobs(rng, n_per=100, d=16, c=5, spread=1.5, scale=1.0)
    Xte, yte = _blobs(rng, n_per=100, d=16, c=5, spread=1.5, scale=1.0)
    W, b, info = linear_probe.fit_lbfgs(torch.from_numpy(Xtr),
                                        torch.from_numpy(ytr), 5)
    (jW, jb), _ = jax_lp._fit_lbfgs(Xtr, ytr, 5, 500)
    jW, jb = np.asarray(jW), np.asarray(jb)
    ours = np.argmax(Xte @ W.numpy() + b.numpy(), axis=1)
    ref = np.argmax(Xte @ jW + jb, axis=1)
    assert np.mean(ours == ref) >= 0.99
    assert 0.5 < np.mean(ref == yte) < 0.95          # the classes overlap
    obj, jobj = _objective(W.numpy(), b.numpy(), Xtr, ytr), \
        _objective(jW, jb, Xtr, ytr)
    np.testing.assert_allclose(obj, jobj, rtol=1e-4)
    np.testing.assert_allclose(info["objective"], obj, rtol=1e-5)
    assert 0 < info["iterations"] <= 500
    assert info["evaluations"] >= info["iterations"]
    # and through the entry point
    np.testing.assert_array_equal(linear_probe.linear_probe_fit_predict(
        Xtr, ytr, Xte, device="cpu"), ours)


def test_probe_eval_and_sklearn_backend():
    rng = np.random.default_rng(2)
    Xtr, ytr = _blobs(rng, n_per=20, d=8)
    Xte, yte = _blobs(rng, n_per=5, d=8)
    ours = linear_probe.linear_probe_eval(Xtr, ytr, Xte, yte, device="cpu")
    ref = jax_lp.linear_probe_eval(Xtr, ytr, Xte, yte)
    assert ours["accuracy"] == ref["accuracy"]
    np.testing.assert_array_equal(ours["confusion_matrix"],
                                  ref["confusion_matrix"])
    np.testing.assert_array_equal(
        linear_probe.linear_probe_fit_predict(Xtr, ytr, Xte,
                                              backend="sklearn"),
        jax_lp.linear_probe_fit_predict(Xtr, ytr, Xte, backend="sklearn"))
    with pytest.raises(ValueError, match="unknown backend"):
        linear_probe.linear_probe_fit_predict(Xtr, ytr, Xte, backend="jax",
                                              device="cpu")


def test_variance_matches_jax():
    rng = np.random.default_rng(3)
    for spread in (0.1, 3.0):
        X, y = _blobs(rng, spread=spread)
        ours = variance.compute_intra_inter_variance(X, y)
        ref = jax_variance.compute_intra_inter_variance(X, y)
        assert list(ours) == list(ref)
        for k in ref:
            np.testing.assert_allclose(ours[k], ref[k], rtol=1e-5)
        assert variance.format_variance_report(ours) == \
            jax_variance.format_variance_report(ref)
    # the hand-computed 1-D case
    r = variance.compute_intra_inter_variance(
        np.array([[0.0], [2.0], [10.0], [12.0]]), np.array([0, 0, 1, 1]))
    assert r["intra_class_variance"] == pytest.approx(1.0)
    assert r["inter_class_variance"] == pytest.approx(25.0)
    assert r["variance_ratio"] == pytest.approx(25.0 / (1.0 + 1e-8))


def _equal_up_to_sign(ours, ref, atol):
    assert ours.shape == ref.shape
    for j in range(ref.shape[1]):
        sign = np.sign(np.dot(ours[:, j], ref[:, j]))
        np.testing.assert_allclose(sign * ours[:, j], ref[:, j], atol=atol)


def test_pca_2d_matches_jax_up_to_sign():
    X, _ = _blobs(np.random.default_rng(4))
    ours = umap_export.pca_2d(X, device="cpu")
    ref = np.asarray(jax_umap.pca_2d(X))
    _equal_up_to_sign(ours, ref, 1e-4 * np.abs(ref).max())
    assert ours[:, 0].var() >= ours[:, 1].var()
    # no umap here: the projection is the PCA
    np.testing.assert_array_equal(umap_export.project_2d(X, device="cpu"),
                                  ours)


def test_classifier_files_match_jax(tmp_path):
    """``linear_probe_eval``, ``save_umap`` and
    ``compute_intra_inter_variance`` of both ``Classifier``s on the same
    features (labels with gaps): the probe's file byte for byte, the
    variance reports' numbers at rtol 1e-5, the 2-D coordinates up to
    sign."""
    rng = np.random.default_rng(9)
    centres = rng.normal(size=(9, 12)).astype(np.float32)

    def split(sizes):
        out = []
        for n in sizes:
            y = rng.choice([0, 2, 3, 8], size=n).astype(np.int32)
            x = centres[y] + 0.8 * rng.normal(size=(n, 12)).astype(np.float32)
            out.append((x.astype(np.float32), y))
        return out

    train, test = split((16, 16, 16, 5)), split((16, 7))
    ref = jax_classifier.Classifier(lambda x: x, train, test,
                                    str(tmp_path / "jax"), batch_size=16)
    ours = Classifier(lambda x: x, train, test, str(tmp_path / "port"),
                      batch_size=16, device="cpu")

    acc, ref_acc = ours.linear_probe_eval(), ref.linear_probe_eval()
    assert acc == ref_acc and 0.5 < acc <= 1.0
    name = "linear_probe_results.txt"
    text = (tmp_path / "port" / name).read_bytes()
    assert text == (tmp_path / "jax" / name).read_bytes()
    assert text.startswith(b"Linear Probe Evaluation Results\n")

    for split_name in ("test", "both", "train"):
        got = ours.compute_intra_inter_variance(split_name)
        want = ref.compute_intra_inter_variance(split_name)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5)
        fname = f"variance_analysis_{split_name}.txt"
        lines = (tmp_path / "port" / fname).read_text().splitlines()
        ref_lines = (tmp_path / "jax" / fname).read_text().splitlines()
        assert [s.split(":")[0] for s in lines] == \
            [s.split(":")[0] for s in ref_lines]
        for a, b in zip(lines[2:], ref_lines[2:]):
            np.testing.assert_allclose(float(a.split(": ")[1]),
                                       float(b.split(": ")[1]), rtol=1e-5)

    for split_name in ("test", "both"):
        out, ref_out = ours.save_umap(split_name), ref.save_umap(split_name)
        assert out.endswith(f"umap_{split_name}.png")
        got = np.load(out.replace(".png", ".npz"))
        want = np.load(ref_out.replace(".png", ".npz"))
        np.testing.assert_array_equal(got["labels"], want["labels"])
        _equal_up_to_sign(got["coords"], want["coords"],
                          1e-4 * np.abs(want["coords"]).max())
