"""The port's hard-negative mining (``hairci_torch/train/mining.py``) and
metric logging (``hairci_torch/utils/metrics.py``) against the JAX package
on the CPU: ``estimate_k_by_pca`` gives the same (K, m*); ``_lloyd`` from
JAX's k-means++ indices the same centroids (rtol 1e-5) and, on separated
clusters, the same assignments; ``_mine`` from JAX's offsets the same ids,
bitwise (ties included); the port's own k-means++ recovers planted
clusters and its mining never returns the anchor, as
``tests/test_mining_utils.py`` asks of JAX; ``SmoothedValue``,
``MetricLogger`` and the label-smoothing cross-entropy against JAX's (rtol
1e-6), and the (count, total) sum over two gloo processes."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hairci.train.mining as jmining
import hairci.utils.metrics as jmetrics
from hairci_torch.train import mining
from hairci_torch.utils import metrics

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


def _clusters(rng, k=4, n_per=50, d=8, spread=0.2):
    centers = rng.normal(size=(k, d)) * 5
    X = np.concatenate([centers[i] + spread * rng.normal(size=(n_per, d))
                        for i in range(k)]).astype(np.float32)
    return X, centers


@pytest.mark.parametrize("case", ["three_directions", "clusters", "flat"])
def test_estimate_k_by_pca_equals_jax(case):
    rng = np.random.default_rng(0)
    if case == "three_directions":
        basis = rng.normal(size=(3, 16))
        X = rng.normal(size=(200, 3)) @ basis + 0.01 * rng.normal(
            size=(200, 16))
    elif case == "clusters":
        X, _ = _clusters(rng, k=6, d=24)
    else:
        X = rng.normal(size=(40, 64))
    X = X.astype(np.float32)
    for kw in ({}, {"explained_var_threshold": 0.5, "scale_factor": 3.0},
               {"max_k": 7}):
        got = mining.estimate_k_by_pca(_t(X), **kw)
        assert got == jmining.estimate_k_by_pca(jnp.asarray(X), **kw)


@pytest.mark.parametrize("spread", [0.2, 2.0])
def test_lloyd_from_jax_indices_equals_jax(spread):
    """From JAX's k-means++ indices: the centroids at rtol 1e-5; on
    separated clusters (spread 0.2) the assignments equal, on overlapping
    ones (2.0) at least 99 % of them (a point between two centroids may
    fall either way by rounding)."""
    rng = np.random.default_rng(1)
    X, _ = _clusters(rng, k=5, n_per=40, d=8, spread=spread)
    idx = jmining._kmeanspp_init(jnp.asarray(X), jax.random.key(3), 5)
    jc, ja = jmining._lloyd(jnp.asarray(X), idx, 5, 10)
    c, a = mining._lloyd(_t(X), _t(idx).long(), 5, 10)
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=1e-5,
                               atol=1e-5)
    if spread == 0.2:
        np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
    else:
        assert np.mean(a.numpy() == np.asarray(ja)) >= 0.99
    # two centroids seeded on one point: the tie goes to the lower, so the
    # second's cluster is empty and it keeps its centroid
    dup = _t(np.array([0, 0, 50, 100, 150]))
    c1, a1 = mining._lloyd(_t(X), dup, 5, 1)
    assert not (a1 == 1).any() and torch.equal(c1[1], _t(X)[0])
    c2, a2 = mining._lloyd(_t(X), dup, 5, 3)
    jc2, ja2 = jmining._lloyd(jnp.asarray(X), jnp.asarray(dup.numpy()), 5, 3)
    np.testing.assert_allclose(c2.numpy(), np.asarray(jc2), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("topk", [1, 3, 5])
def test_mine_from_jax_offsets_bitwise(topk):
    """The same key's offsets: the same hard-negative ids, with duplicated
    anchors (ties to the lower index) and self-collisions."""
    rng = np.random.default_rng(2)
    X, _ = _clusters(rng, k=4, n_per=12, d=6)
    X = np.concatenate([X, X[:6]])            # exact ties
    cents = X[[0, 12, 24, 36]] + 0.1
    key = jax.random.key(11)
    want = jmining._mine(jnp.asarray(X), jnp.asarray(cents), key, topk)
    offs = _t(jax.random.randint(key, (X.shape[0],), 0, topk)).long()
    got = mining._mine(_t(X), _t(cents), offs, topk)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not (got == torch.arange(X.shape[0])).any()


def test_mine_keeps_jaxs_self_negative_when_the_anchor_is_first():
    """The reference's rule: a self pick falls back to the first candidate
    of the second-nearest centroid, which can be the anchor itself (an
    anchor nearer to that centroid than any other sample). Anchor 0 at 0.5
    between centroids at 0.6 and 0.3: with offset 0 both packages return 0
    for it."""
    X = np.array([[0.5], [5.0], [6.0], [7.0], [8.0], [9.0]], np.float32)
    cents = np.array([[0.6], [0.3], [7.0]], np.float32)
    key = next(jax.random.key(i) for i in range(100) if int(
        jax.random.randint(jax.random.key(i), (6,), 0, 5)[0]) == 0)
    want = jmining._mine(jnp.asarray(X), jnp.asarray(cents), key, 5)
    offs = _t(jax.random.randint(key, (6,), 0, 5)).long()
    got = mining._mine(_t(X), _t(cents), offs)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got[0]) == 0


def test_kmeans_recovers_planted_clusters_and_mines_across_them():
    rng = np.random.default_rng(4)
    X, centers = _clusters(rng)
    cents, assign = mining.run_kmeans(_t(X), k=4, niter=20)
    for i in range(4):
        assert np.bincount(assign[i * 50:(i + 1) * 50].numpy()).max() >= 45
    d = np.linalg.norm(cents.numpy()[:, None] - centers[None], axis=2)
    assert d.min(axis=0).max() < 1.0
    again = mining.run_kmeans(_t(X), k=4, niter=20)
    assert torch.equal(again[0], cents) and torch.equal(again[1], assign)
    hard = mining.mine_hard_negatives(_t(X), cents, seed=0)
    assert hard.shape == (200,) and hard.dtype == torch.int64
    assert not (hard == torch.arange(200)).any()
    cluster = np.repeat(np.arange(4), 50)
    assert np.mean(cluster[hard.numpy()] != cluster) > 0.9
    # numpy input goes to the device asked for
    k, _ = mining.estimate_k_by_pca(X, device="cpu")
    assert 5 <= k <= 199


def test_kmeanspp_draws_are_seeded_and_distinct():
    X = _t(np.random.default_rng(5).normal(size=(30, 4)).astype(np.float32))
    d = mining.draw_kmeanspp(torch.Generator().manual_seed(1), 30, 6)
    idx = mining._kmeanspp_init(X, d, 6)
    assert idx.shape == (6,) and len(set(idx.tolist())) == 6
    d2 = mining.draw_kmeanspp(torch.Generator().manual_seed(1), 30, 6)
    assert torch.equal(mining._kmeanspp_init(X, d2, 6), idx)


def test_smoothed_value_and_logger_equal_jax():
    ours, ref = metrics.SmoothedValue(window_size=3), jmetrics.SmoothedValue(3)
    for x, n in [(1.0, 1), (2.5, 3), (3.0, 1), (-4.0, 2)]:
        ours.update(x, n)
        ref.update(x, n)
        for attr in ("median", "avg", "global_avg", "max", "value", "count",
                     "total"):
            assert getattr(ours, attr) == pytest.approx(getattr(ref, attr),
                                                        rel=1e-6)
        assert str(ours) == str(ref)
    ours.synchronize_between_processes()      # no process group: unchanged
    assert (ours.count, ours.total) == (ref.count, ref.total)
    log, jlog = metrics.MetricLogger(), jmetrics.MetricLogger()
    for kw in ({"loss": 1.0, "acc": 0.5}, {"loss": torch.tensor(3.0),
                                           "acc": 0.75}):
        log.update(**kw)
        jlog.update(**{k: float(v) for k, v in kw.items()})
    assert str(log) == str(jlog) and log.loss.global_avg == 2.0
    with pytest.raises(AttributeError):
        log.missing
    seen = list(log.log_every(range(3), 2, header="h"))
    assert seen == [0, 1, 2]


@pytest.mark.parametrize("smoothing", [0.0, 0.1, 0.3])
def test_label_smoothing_cross_entropy_equals_jax(smoothing):
    rng = np.random.default_rng(6)
    logits = (rng.normal(size=(7, 5)) * 3).astype(np.float32)
    labels = rng.integers(0, 5, 7)
    got = metrics.label_smoothing_cross_entropy(_t(logits), _t(labels),
                                                smoothing)
    want = jmetrics.label_smoothing_cross_entropy(
        jnp.asarray(logits), jnp.asarray(labels), smoothing)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def _sync_worker(rank, init_file, out_dir):
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=2)
    v = metrics.SmoothedValue()
    for x in range(rank + 2):                 # 2 and 3 values
        v.update(float(x) + 0.5 * rank, n=rank + 1)
    v.synchronize_between_processes()
    with open(os.path.join(out_dir, f"{rank}.txt"), "w") as f:
        f.write(f"{v.count} {v.total!r}")
    dist.destroy_process_group()


def test_synchronize_sums_over_two_gloo_processes(tmp_path):
    torch.multiprocessing.spawn(
        _sync_worker, args=(str(tmp_path / "init"), str(tmp_path)), nprocs=2)
    # rank 0: 0 + 1 (n=1); rank 1: (0.5 + 1.5 + 2.5) * 2 (n=2 each)
    for rank in (0, 1):
        count, total = (tmp_path / f"{rank}.txt").read_text().split()
        assert int(count) == 2 + 6 and float(total) == 1.0 + 9.0
