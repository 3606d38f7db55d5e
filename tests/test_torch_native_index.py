"""The port's host flat index (``hairci_torch.native.NativeFlatIndex``, its own
copy of ``hairci/native/flatindex.cpp``, built with g++ into
``native/_build/``) against the JAX package's: the same scores and indices
for both metrics, the same file bytes, files interchanged both ways, and the
port's ``GalleryIndex`` ranking on unit rows."""

import numpy as np
import pytest

import hairci.native as jax_native
from hairci_torch.native import METRIC_IP, METRIC_L2, NativeFlatIndex
from hairci_torch.native import flatindex
from hairci_torch.retrieval.index import GalleryIndex


def _data(n=300, d=24, q=9, seed=0):
    rng = np.random.default_rng(seed)
    emb = rng.normal(size=(n, d)).astype(np.float32)
    return emb, rng.normal(size=(q, d)).astype(np.float32)


def test_library_builds_into_the_git_ignored_build_dir():
    path = flatindex.library_path()
    assert path.parent.name == "_build" and path.parent.parent == \
        flatindex.SRC.parent
    assert path.name.startswith("libflatindex-") and path.suffix == ".so"
    NativeFlatIndex(4)
    assert path.exists()


@pytest.mark.parametrize("metric", [METRIC_IP, METRIC_L2])
@pytest.mark.parametrize("k", [1, 7, 400])
def test_search_matches_jax(metric, k):
    emb, q = _data()
    ours, ref = NativeFlatIndex(24, metric), jax_native.NativeFlatIndex(
        24, metric)
    ours.add(emb[:200])
    ours.add(emb[200:])
    ref.add(emb)
    assert len(ours) == len(ref) == 300
    s, i = ours.search(q, k)
    rs, ri = ref.search(q, k)
    assert s.shape == (9, min(k, 300)) and i.dtype == np.int64
    np.testing.assert_array_equal(i, ri)
    np.testing.assert_array_equal(s, rs)
    # exact order against numpy: descending score, ties to the lower row
    score = q @ emb.T if metric == METRIC_IP else -(
        (q[:, None, :] - emb[None]) ** 2).sum(-1)
    want = np.argsort(-score, axis=1, kind="stable")[:, :min(k, 300)]
    np.testing.assert_array_equal(i, want)


def test_files_interchange_both_ways(tmp_path):
    emb, q = _data(seed=1)
    ours, ref = NativeFlatIndex(24, METRIC_L2), jax_native.NativeFlatIndex(
        24, METRIC_L2)
    ours.add(emb)
    ref.add(emb)
    ours.save(str(tmp_path / "port.hciflat"))
    ref.save(str(tmp_path / "jax.hciflat"))
    assert (tmp_path / "port.hciflat").read_bytes() == \
        (tmp_path / "jax.hciflat").read_bytes()
    from_jax = NativeFlatIndex.load(str(tmp_path / "jax.hciflat"))
    from_port = jax_native.NativeFlatIndex.load(str(tmp_path / "port.hciflat"))
    assert (from_jax.dim, from_jax.metric, len(from_jax)) == (24, METRIC_L2,
                                                              300)
    assert (from_port.dim, from_port.metric) == (24, METRIC_L2)
    for a, b in ((from_jax.search(q, 5), ref.search(q, 5)),
                 (from_port.search(q, 5), ours.search(q, 5))):
        np.testing.assert_array_equal(a[1], b[1])
        np.testing.assert_array_equal(a[0], b[0])
    with pytest.raises(IOError, match="failed to load"):
        NativeFlatIndex.load(str(tmp_path / "missing.hciflat"))


def test_matches_gallery_index_and_threads():
    """Unit rows: the host index ranks as the port's GalleryIndex does;
    one thread and eight give the same answer; a duplicate row ties to the
    lower index."""
    emb, q = _data(n=120, d=16, q=40, seed=2)
    emb[77] = emb[12]
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    q[0] = emb[12]
    gs, gi = GalleryIndex(emb, [str(i) for i in range(120)], normalized=True,
                          device="cpu").search(q, k=7, normalized=True)
    idx = NativeFlatIndex(16, METRIC_IP)
    idx.add(emb)
    s1, i1 = idx.search(q, 7, num_threads=1)
    s8, i8 = idx.search(q, 7, num_threads=8)
    np.testing.assert_array_equal(i1, gi)
    np.testing.assert_allclose(s1, gs, atol=1e-5)
    np.testing.assert_array_equal(i1, i8)
    np.testing.assert_array_equal(s1, s8)
    assert list(i1[0, :2]) == [12, 77]
    s, i = idx.search(q[3], 2)     # one query as a vector
    np.testing.assert_array_equal(i, i1[3:4, :2])


def test_wrong_widths_raise():
    idx = NativeFlatIndex(8)
    with pytest.raises(ValueError, match=r"\(n, 8\)"):
        idx.add(np.zeros((3, 7), np.float32))
    idx.add(np.ones((3, 8), np.float32))
    with pytest.raises(ValueError, match=r"\(Q, 8\)"):
        idx.search(np.zeros((2, 9), np.float32), 2)
