"""The port's kNN evaluation (``hairci_torch/eval``) against the JAX package
on seeded numpy features: predictions equal at every k (duplicated rows,
vote ties, k > N, chunked queries), feature extraction with a padded last
batch, the ``Classifier``'s result files (the kNN and linear-probe files
byte for byte, the variance and the 2-D projection by value), the numpy report
against sklearn, and ``resize`` / ``test_transform`` against JAX."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn import metrics as skm

from hairci.aug import ops as jax_ops
from hairci.aug import pipelines as jax_pipelines
from hairci.eval import classifier as jax_classifier
from hairci.eval import features as jax_features
from hairci.eval import knn as jax_knn
from hairci_torch.aug import ops, pipelines
from hairci_torch.eval import knn, report
from hairci_torch.eval.classifier import Classifier
from hairci_torch.eval.features import extract_features

torch.set_num_threads(1)


def _data(seed, n_train=300, n_test=80, d=32, c=7):
    rng = np.random.default_rng(seed)
    train = rng.normal(size=(n_train, d)).astype(np.float32)
    test = rng.normal(size=(n_test, d)).astype(np.float32)
    train /= np.linalg.norm(train, axis=1, keepdims=True)
    test /= np.linalg.norm(test, axis=1, keepdims=True)
    return (train, rng.integers(0, c, n_train), test,
            rng.integers(0, c, n_test))


def _with_ties(seed=1):
    """Exactly duplicated gallery rows under other labels (similarity ties),
    queries that equal them, and few classes (vote ties)."""
    train, ytr, test, yte = _data(seed, n_train=120, n_test=64, c=4)
    train[10] = train[50] = train[90]
    ytr[10], ytr[50], ytr[90] = 3, 0, 2
    train[7] = train[3]
    ytr[7], ytr[3] = 0, 1
    test[0], test[1] = train[90], train[3]
    return train, ytr, test, yte


@pytest.mark.parametrize("k", [1, 2, 5, 20, 120])
@pytest.mark.parametrize("method", ["sort", "topk"])
def test_ordered_neighbours_match_lax_top_k(k, method):
    train, _, test, _ = _with_ties()
    sims = test @ train.T
    _, ref = jax.lax.top_k(jnp.asarray(sims), k)
    ours = knn.ordered_neighbours(torch.from_numpy(sims), k, method)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    if k >= 2:      # duplicated rows 10, 50, 90 and 3, 7: the lower index
        assert ours[0, :2].tolist() == [10, 50] and \
            ours[1, :2].tolist() == [3, 7]


@pytest.mark.parametrize("k", [1, 2, 5, 20, 642])
def test_knn_predict_matches_jax(k):
    train, ytr, test, _ = _with_ties()
    ref = jax_knn.knn_predict(train, ytr, test, k, num_classes=4)
    ours = knn.knn_predict_multi(train, ytr, test, (k,), num_classes=4,
                                 device="cpu")[k]
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(
        knn.knn_predict(train, ytr, test, k, num_classes=4, device="cpu"),
        ref)
    assert ours.dtype == ref.dtype == np.int32
    if k == 1:      # the lower index of the duplicated rows wins
        assert ours[0] == 3 and ours[1] == 1
    if k == 2:      # 1:1 votes go to the lower class
        assert ours[0] == 0 and ours[1] == 0


@pytest.mark.parametrize("chunk", [4096, 8])
def test_knn_predict_multi_matches_jax(chunk):
    train, ytr, test, _ = _with_ties(2)
    ks = (1, 5, 20, 27, 642, 5)     # 642 clips to 120; a repeated k
    ref = jax_knn.knn_predict_multi(train, ytr, test, ks, num_classes=4)
    ours = knn.knn_predict_multi(train, ytr, test, ks, num_classes=4,
                                 chunk=chunk, device="cpu")
    assert set(ours) == set(ref) == set(ks)
    for k in ks:
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=f"k={k}")
        np.testing.assert_array_equal(
            ours[k], knn.knn_predict(train, ytr, test, k, 4, device="cpu"))


def test_unnormalized_features_and_inferred_classes():
    train, ytr, test, _ = _data(3, n_train=60, n_test=20)
    train, test = 3.0 * train, 0.5 * test
    ref = jax_knn.knn_predict_multi(train, ytr, test, (3, 9),
                                    normalized=False)
    ours = knn.knn_predict_multi(train, ytr, test, (3, 9), normalized=False,
                                 device="cpu")
    for k in (3, 9):
        np.testing.assert_array_equal(ours[k], ref[k])


def test_topk_ordering_repairs_ties_at_the_boundary():
    rng = np.random.default_rng(4)
    # scores on a coarse grid: every row has many equal values, and the
    # k-th value is shared with columns that top-k may have left out
    sims = torch.from_numpy(rng.integers(0, 6, (40, 97)).astype(np.float32))
    for k in (1, 7, 50, 97):
        want = torch.sort(sims, dim=1, descending=True,
                          stable=True).indices[:, :k]
        assert torch.equal(knn.ordered_neighbours(sims, k, "sort"), want)
        assert torch.equal(knn.ordered_neighbours(sims, k, "topk"), want)
    with pytest.raises(ValueError, match="unknown method"):
        knn.ordered_neighbours(sims, 3, "heap")


def test_similarities_ignore_the_global_matmul_precision():
    before = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("medium")
        with knn.full_f32_matmul():
            assert torch.get_float32_matmul_precision() == "highest"
        assert torch.get_float32_matmul_precision() == "medium"
    finally:
        torch.set_float32_matmul_precision(before)


def test_knn_eval_and_report_match_jax():
    train, ytr, test, yte = _data(5, n_train=100, n_test=30)
    ref = jax_knn.knn_eval(train, ytr, test, yte, ks=(5, 10, 642))
    ours = knn.knn_eval(train, ytr, test, yte, ks=(5, 10, 642), device="cpu")
    assert set(ours) == set(ref)
    for k in ref:
        assert ours[k]["accuracy"] == ref[k]["accuracy"]
        np.testing.assert_array_equal(ours[k]["confusion_matrix"],
                                      ref[k]["confusion_matrix"])
        np.testing.assert_array_equal(ours[k]["predictions"],
                                      ref[k]["predictions"])
    assert knn.format_knn_report(ours) == jax_knn.format_knn_report(ref)
    assert knn.DEFAULT_KS == jax_knn.DEFAULT_KS


# ---------------------------------------------------------------------------
# feature extraction and the Classifier's file
# ---------------------------------------------------------------------------

def _batches(seed, sizes, d=12, c=5):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(n, d)).astype(np.float32),
             rng.integers(0, c, n).astype(np.int32)) for n in sizes]


def test_extract_features_pads_the_last_batch_like_jax():
    rng = np.random.default_rng(6)
    proj = rng.normal(size=(12, 9)).astype(np.float32)
    batches = _batches(7, (8, 8, 3))
    seen = []

    def embed(x):
        seen.append(x.clone())
        return torch.tanh(x @ torch.from_numpy(proj))

    ref_f, ref_l = jax_features.extract_features(
        lambda x: jnp.tanh(x @ proj), iter(batches), 8)
    f, l = extract_features(embed, iter(batches), 8, device="cpu")
    assert [tuple(x.shape) for x in seen] == [(8, 12)] * 3
    # the padding repeats the batch's last row
    assert torch.equal(seen[2][3:], seen[2][2:3].expand(5, 12))
    assert f.shape == ref_f.shape == (19, 9) and f.dtype == np.float32
    np.testing.assert_allclose(f, ref_f, atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(f, axis=1), 1, atol=1e-6)
    np.testing.assert_array_equal(l, ref_l)
    raw, _ = extract_features(embed, iter(batches), 8, normalize=False,
                              device="cpu")
    ref_raw, _ = jax_features.extract_features(
        lambda x: jnp.tanh(x @ proj), iter(batches), 8, normalize=False)
    np.testing.assert_allclose(raw, ref_raw, atol=1e-6)


def test_extract_features_runs_without_grad():
    w = torch.ones(12, 4, requires_grad=True)
    modes = []

    def embed(x):
        modes.append(torch.is_grad_enabled())
        return x @ w

    extract_features(embed, iter(_batches(8, (4,))), 4, device="cpu")
    assert modes == [False]


def test_classifier_file_matches_jax_byte_for_byte(tmp_path):
    # features with class structure, so the report is not all zeros, and
    # labels with gaps (num_classes comes from the maximum; the confusion
    # matrix covers only labels that occur)
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
    proj = rng.normal(size=(12, 10)).astype(np.float32)
    ref = jax_classifier.Classifier(lambda x: x @ proj, train, test,
                                    str(tmp_path / "jax"), batch_size=16)
    ours = Classifier(lambda x: x @ torch.from_numpy(proj), train, test,
                      str(tmp_path / "port"), batch_size=16, device="cpu")
    ref_acc, acc = ref.knn_eval(), ours.knn_eval()
    assert acc == ref_acc and list(acc) == list(knn.DEFAULT_KS)
    assert 0.3 < acc[5] < 1.0
    name = "knn_evaluation_results.txt"
    text = (tmp_path / "port" / name).read_bytes()
    assert text == (tmp_path / "jax" / name).read_bytes()
    assert text.count(b"Results for k=") == 7
    for a, b in zip(ours.extracting_features(), ref.extracting_features()):
        np.testing.assert_allclose(a, b, atol=1e-6)
    assert ours.extracting_features() is ours.extracting_features()
    # the other three evaluations on the same cached features
    assert ours.linear_probe_eval() == ref.linear_probe_eval()
    name = "linear_probe_results.txt"
    assert (tmp_path / "port" / name).read_bytes() == \
        (tmp_path / "jax" / name).read_bytes()
    got, want = (c.compute_intra_inter_variance() for c in (ours, ref))
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5)
    assert (tmp_path / "port" / "variance_analysis_test.txt").is_file()
    coords = [np.load(c.save_umap().replace(".png", ".npz"))["coords"]
              for c in (ours, ref)]
    for j in range(2):      # each principal axis up to its sign
        sign = np.sign(np.dot(coords[0][:, j], coords[1][:, j]))
        np.testing.assert_allclose(sign * coords[0][:, j], coords[1][:, j],
                                   atol=1e-4 * np.abs(coords[1]).max())


@pytest.mark.parametrize("case", ["random", "one_class_predicted",
                                  "labels_only_predicted", "single_label",
                                  "binary", "many_classes", "int32"])
def test_report_matches_sklearn(case):
    rng = np.random.default_rng(10)
    y_true, y_pred = {
        "random": (rng.integers(0, 5, 50), rng.integers(0, 5, 50)),
        "one_class_predicted": (rng.integers(0, 3, 40), np.zeros(40, int)),
        "labels_only_predicted": (np.array([0, 1, 2, 2, 100]),
                                  np.array([3, 3, 3, 2, 7])),
        "single_label": (np.ones(5, int), np.ones(5, int)),
        "binary": (np.array([0, 1, 0, 1, 1]), np.array([1, 1, 0, 0, 1])),
        "many_classes": (rng.integers(0, 61, 1000),
                         rng.integers(0, 61, 1000)),
        "int32": (rng.integers(0, 7, 90).astype(np.int32),
                  rng.integers(0, 7, 90).astype(np.int32)),
    }[case]
    acc, text, cm = report.report(y_true, y_pred)
    assert acc == skm.accuracy_score(y_true, y_pred)
    assert text == skm.classification_report(y_true, y_pred, zero_division=0)
    if case != "single_label":      # sklearn warns about the shape there
        ref = skm.confusion_matrix(y_true, y_pred)
        np.testing.assert_array_equal(cm, ref)
        assert cm.dtype == ref.dtype
        assert np.array2string(cm) == np.array2string(ref)


# ---------------------------------------------------------------------------
# resize and the test transform
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,size", [((2, 40, 56, 3), (24, 24)),
                                        ((1, 17, 9, 3), (32, 20)),
                                        ((2, 16, 16, 3), (16, 16))])
def test_resize_matches_jax(shape, size):
    x = np.random.default_rng(11).uniform(size=shape).astype(np.float32)
    ref = np.asarray(jax_ops.resize(jnp.asarray(x), size))
    got = ops.resize(torch.from_numpy(x), size)
    assert got.shape == ref.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)
    with pytest.raises(NotImplementedError):
        ops.resize(torch.from_numpy(x), size, method="bicubic")


def test_test_transform_matches_jax():
    x = np.random.default_rng(12).integers(0, 256, (3, 50, 38, 3),
                                           dtype=np.uint8)
    ref = np.asarray(jax_pipelines.test_transform(jnp.asarray(x), 32))
    got = pipelines.test_transform(torch.from_numpy(x), 32)
    assert got.shape == (3, 32, 32, 3)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)
    ref = np.asarray(jax_pipelines.knn_transform(jnp.asarray(x), 32))
    np.testing.assert_allclose(
        pipelines.knn_transform(torch.from_numpy(x), 32).numpy(), ref,
        atol=1e-6)
