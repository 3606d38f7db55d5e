"""The port's row-sharded gallery search (``hairci_torch/retrieval/
sharded.py``) on two gloo ranks against the JAX package's
``sharded_gallery_search`` and ``ShardedGalleryIndex`` on its 8-device CPU
mesh, and against ``GalleryIndex``, on the same arrays: the counterparts of
``tests/test_sharded_retrieval.py``'s three tests (a single-device match,
ties between duplicates across shards, the facade with padding), plus a
gallery whose padded rows outrank every real row (held against JAX on two
of its devices: the mesh's size sets the padding), and the search over the
``data`` axis of a (1, 2) mesh.

Indices must be equal wherever the scores part by more than 1e-5 from
their neighbours in the full f64 ranking (two routes may order scores
within rounding of each other differently); scores within 1e-5. One spawn
of two ranks computes every case.
"""

import os
import socket

import numpy as np
import pytest
import torch

from hairci_torch.ops.topk import topk_gallery_search
from hairci_torch.parallel import batch_sharding, collectives, create_mesh
from hairci_torch.retrieval import ShardedGalleryIndex, sharded_gallery_search
from hairci_torch.retrieval.index import GalleryIndex

torch.set_num_threads(1)
W = 2


def _unit(a):
    return (a / np.linalg.norm(a, axis=1, keepdims=True)).astype(np.float32)


def _data(n=512, d=32, q=7, seed=0):
    rng = np.random.default_rng(seed)
    return (_unit(rng.normal(size=(n, d))), _unit(rng.normal(size=(q, d))))


def _duplicates():
    base = np.random.default_rng(1).normal(size=(8, 16))
    g = _unit(np.concatenate([base] * 8))   # 8 copies, over both shards
    return g, g[:4].copy()


def _behind():
    """Every real score negative: the zero padding rows outrank them."""
    g, q = _data(n=101, d=16, q=3, seed=2)
    g = _unit(-np.abs(g))
    return g, _unit(np.abs(q))


# case -> (gallery, queries, k, through the facade)
CASES = {
    "single_device": (*_data(), 10, False),
    "ties": (*_duplicates(), 3, False),
    "facade_padding": (*_data(n=101, seed=3), 5, True),
    "padding_outranks": (*_behind(), 5, True),
}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _port_search(mesh, case):
    g, q, k, facade = CASES[case]
    if facade:
        idx = ShardedGalleryIndex(mesh, g, [str(i) for i in range(len(g))],
                                  normalized=True, device="cpu")
        return idx.search(q, k=k, normalized=True)
    shard = batch_sharding(mesh, 2).local(torch.from_numpy(g))
    s, i = sharded_gallery_search(mesh, torch.from_numpy(q), shard, k=k)
    return s.numpy(), i.numpy()


def _worker(rank, port, out_dir):
    torch.set_num_threads(1)
    collectives.init_distributed(f"localhost:{port}", W, rank)
    mesh = create_mesh()
    out = {case: _port_search(mesh, case) for case in CASES}
    out["model_axis"] = _port_search(create_mesh(n_model=2), "single_device")
    out["calls"] = dict(collectives.calls)
    torch.save(out, os.path.join(out_dir, f"{rank}.pt"))
    collectives.shutdown()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("sharded")
    torch.multiprocessing.spawn(_worker, args=(_free_port(), str(out)),
                                nprocs=W)
    return [torch.load(str(out / f"{r}.pt"), weights_only=False)
            for r in range(W)]


@pytest.fixture(scope="module")
def jax_results():
    """JAX's sharded search and facade on its 8-device mesh (on two of the
    devices for the gallery whose padding outranks it)."""
    import jax.numpy as jnp

    from hairci.parallel import create_mesh as jax_mesh
    from hairci.retrieval.sharded import (
        ShardedGalleryIndex as JaxShardedGalleryIndex,
        sharded_gallery_search as jax_search,
    )

    out = {}
    for case, (g, q, k, facade) in CASES.items():
        # how many zero rows pad the gallery, and so how many can outrank
        # the real rows, depends on the mesh: the same two ranks there
        mesh = jax_mesh(n_data=W if case == "padding_outranks" else None)
        if facade:
            idx = JaxShardedGalleryIndex(
                mesh, g, [str(i) for i in range(len(g))], normalized=True)
            out[case] = idx.search(q, k=k, normalized=True)
        else:
            s, i = jax_search(mesh, jnp.asarray(q), jnp.asarray(g), k=k)
            out[case] = (np.asarray(s), np.asarray(i))
    return out


def _near_tie_equal(got, want, g, q):
    """Scores within 1e-5; indices equal at every rank whose f64 score
    parts by more than 1e-5 from both neighbours in the full ranking."""
    (s_got, i_got), (s_want, i_want) = got, want
    assert s_got.shape == s_want.shape
    np.testing.assert_allclose(s_got, s_want, rtol=0, atol=1e-5)
    full = np.sort(q.astype(np.float64) @ g.astype(np.float64).T, axis=1)
    full = np.concatenate([full, np.zeros((len(q), 1))], 1)[:, ::-1]
    k = s_want.shape[1]
    for row in range(len(q)):
        for j in range(k):
            above = j == 0 or full[row, j - 1] - full[row, j] > 1e-5
            below = full[row, j] - full[row, j + 1] > 1e-5
            if above and below and np.isfinite(s_want[row, j]):
                assert i_got[row, j] == i_want[row, j], (row, j)


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_search_matches_jax(ranks, jax_results, case):
    g, q, _, _ = CASES[case]
    for out in ranks:
        _near_tie_equal(out[case], jax_results[case], g, q)
    for a, b in zip(ranks[0][case], ranks[1][case]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case", ["single_device", "facade_padding",
                                  "model_axis"])
def test_sharded_search_matches_gallery_index(ranks, case):
    g, q, k, _ = CASES["single_device" if case == "model_axis" else case]
    ref = GalleryIndex(g, [str(i) for i in range(len(g))], normalized=True,
                       device="cpu").search(q, k=k, normalized=True)
    for out in ranks:
        _near_tie_equal(out[case], ref, g, q)


def test_sharded_tie_breaking(ranks):
    """The lowest global index wins a tie between duplicates held by both
    ranks, exactly."""
    for out in ranks:
        i = out["ties"][1]
        np.testing.assert_array_equal(i[:, 0], np.arange(4))
        np.testing.assert_array_equal(i[:, 1], np.arange(4) + 8)
        np.testing.assert_array_equal(i[:, 2], np.arange(4) + 16)


def test_padded_hits_rank_last(ranks, jax_results):
    """101 rows pad to 102 on two ranks: the padded hit is ranked last with
    score -inf and index 0, as in JAX on two devices."""
    s, i = ranks[0]["padding_outranks"]
    js, ji = jax_results["padding_outranks"]
    assert (i < 101).all()
    assert np.isneginf(s[:, -1]).all() and (i[:, -1] == 0).all()
    np.testing.assert_array_equal(np.isneginf(s), np.isneginf(js))
    assert ranks[0]["calls"]["all_gather"] > 0
    # the kernel's launch counter never moves on the CPU
    assert topk_gallery_search.launches == 0
