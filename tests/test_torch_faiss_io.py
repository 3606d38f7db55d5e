"""The port's FAISS flat-index files (``hairci_torch.retrieval.faiss_io``)
against the JAX package's on the CPU: the bytes written are equal, each
package reads the other's files, the reader refuses what the JAX reader
refuses, and ``--faiss_index`` through both retrieval CLIs (tiny ViT
encoders carrying the same ``.pth``) prints the same top-k."""

import pickle
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import hairci.retrieval.encoders as jax_encoders
import hairci.retrieval.faiss_io as jax_io
from hairci.cli import retrieval as jax_cli
from hairci.models.vit import VisionTransformer as JaxViT
from hairci.retrieval.index import GalleryIndex as JaxGalleryIndex
from hairci.retrieval.torch_import import export_vit, save_torch_state_dict
from hairci_torch.cli import retrieval as cli
from hairci_torch.models.vit import VisionTransformer
from hairci_torch.retrieval import encoders
from hairci_torch.retrieval import faiss_io as io
from hairci_torch.retrieval.index import GalleryIndex

torch.set_num_threads(1)
TINY = dict(patch_size=8, embed_dim=64, depth=2, num_heads=4, img_size=32)
METRICS = [io.METRIC_L2, io.METRIC_INNER_PRODUCT]


def _unit(n, d, seed):
    v = np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


@pytest.mark.parametrize("metric", METRICS)
def test_writer_bytes_equal_jax(tmp_path, metric):
    vecs = np.random.default_rng(0).normal(size=(17, 5)).astype(np.float32)
    io.write_flat_index(vecs, str(tmp_path / "p.index"), metric)
    jax_io.write_flat_index(vecs, str(tmp_path / "j.index"), metric)
    data = (tmp_path / "p.index").read_bytes()
    assert data == (tmp_path / "j.index").read_bytes()
    # the golden layout: fourcc, d, ntotal, two 1 << 20, trained, metric,
    # the float count, the floats
    assert data[:4] == (b"IxF2" if metric == io.METRIC_L2 else b"IxFI")
    assert data[4:45] == struct.pack("<iqqq?iQ", 5, 17, 1 << 20, 1 << 20,
                                     True, metric, 17 * 5)
    assert data[45:] == vecs.astype("<f4").tobytes()
    got, got_metric = io.read_flat_index(str(tmp_path / "j.index"))
    np.testing.assert_array_equal(got, vecs)
    assert got_metric == metric


@pytest.mark.parametrize("storage", [torch.float32, torch.bfloat16])
def test_gallery_artifacts_equal_jax_and_load_both_ways(tmp_path, storage):
    """``save_faiss_flat`` of a port and a JAX index over the same rows: the
    same index and pickle bytes; each package loads the other's pair (paths
    found by the ``index_*`` -> ``paths_*`` naming) and ranks alike."""
    # 64 wide: bf16 storage keeps each row's norm within the importer's
    # 1e-3 (at 16 wide its rounding alone moves a norm by 1.3e-3)
    feats = _unit(40, 64, 1)
    paths = [f"img_{i:03d}_hair.png" for i in range(40)]
    port_idx = GalleryIndex(feats, paths, normalized=True, device="cpu",
                            storage_dtype=storage)
    jax_idx = JaxGalleryIndex(feats, paths, normalized=True,
                              storage_dtype=jnp.bfloat16
                              if storage == torch.bfloat16 else jnp.float32)
    for pkg, idx, mod in (("p", port_idx, io), ("j", jax_idx, jax_io)):
        (tmp_path / pkg).mkdir()
        mod.save_faiss_flat(idx, str(tmp_path / pkg / "index_hair_region.index"),
                            str(tmp_path / pkg / "paths_hair_region.pkl"))
    for name in ("index_hair_region.index", "paths_hair_region.pkl"):
        assert (tmp_path / "p" / name).read_bytes() == \
            (tmp_path / "j" / name).read_bytes()
    from_jax = io.load_faiss_flat(str(tmp_path / "j" /
                                      "index_hair_region.index"), device="cpu")
    from_port = jax_io.load_faiss_flat(str(tmp_path / "p" /
                                           "index_hair_region.index"))
    assert from_jax.paths == from_port.paths == paths
    q = feats[[3, 17, 29]] + 0.05 * _unit(3, 64, 2)
    s, i = from_jax.search(q, k=5)
    ref_s, ref_i = from_port.search(q, k=5)
    np.testing.assert_array_equal(i, ref_i)
    np.testing.assert_allclose(s, ref_s, atol=1e-5)
    assert list(i[:, 0]) == [3, 17, 29]


def test_reader_refuses_what_jax_refuses(tmp_path):
    bad = tmp_path / "bad.index"
    bad.write_bytes(b"IwXX" + b"\0" * 40)
    for mod in (io, jax_io):
        with pytest.raises(ValueError, match="not a FAISS flat index"):
            mod.read_flat_index(str(bad))
    trunc = tmp_path / "trunc.index"
    io.write_flat_index(np.ones((4, 4), np.float32), str(trunc))
    trunc.write_bytes(trunc.read_bytes()[:-8])
    with pytest.raises(ValueError, match="payload mismatch"):
        io.read_flat_index(str(trunc))
    raw = str(tmp_path / "raw.index")
    io.write_flat_index(3 * _unit(6, 4, 3), raw, io.METRIC_INNER_PRODUCT)
    with pytest.raises(ValueError, match="not L2-normalized"):
        io.load_faiss_flat(raw, device="cpu")
    ip, pp = str(tmp_path / "y.index"), str(tmp_path / "y.pkl")
    io.write_flat_index(np.ones((4, 4), np.float32) / 2.0, ip)
    with open(pp, "wb") as f:
        pickle.dump(["only", "two"], f)
    with pytest.raises(ValueError, match="2 paths for 4 vectors"):
        io.load_faiss_flat(ip, pp, device="cpu")


def test_reader_accepts_a_byte_count_and_names_rows_without_a_pickle(
        tmp_path):
    vecs = _unit(3, 4, 4)
    path = tmp_path / "my_index_region.index"
    path.write_bytes(b"IxF2" + struct.pack("<iqqq?iQ", 4, 3, 1 << 20, 1 << 20,
                                           True, 1, 3 * 4 * 4)
                     + vecs.tobytes())
    # only a leading "index_" maps to "paths_": this pickle is not found
    with open(tmp_path / "my_paths_region.pkl", "wb") as f:
        pickle.dump(["a", "b", "c"], f)
    idx = io.load_faiss_flat(str(path), device="cpu")
    ref = jax_io.load_faiss_flat(str(path))
    assert idx.paths == ref.paths == ["0", "1", "2"]
    np.testing.assert_allclose(idx.embeddings.numpy(), vecs, atol=1e-6)


def _tiny_hair_models(monkeypatch):
    """Both packages' hair encoders build a tiny f32 ViT at 32 px."""
    monkeypatch.setattr(
        encoders, "build_vit",
        lambda name, img_size, global_pool, dtype, generator:
        VisionTransformer(**TINY, global_pool=global_pool,
                          generator=generator))
    monkeypatch.setattr(encoders.HairEncoder, "img_size", 32)
    monkeypatch.setattr(
        jax_encoders, "build_vit",
        lambda name, img_size, global_pool, dtype: JaxViT(
            **TINY, global_pool=global_pool))
    monkeypatch.setattr(jax_encoders.HairEncoder, "img_size", 32)
    monkeypatch.setattr(
        jax_encoders.HairEncoder, "_init_params",
        lambda self: self.model.init(jax.random.key(0),
                                     jnp.zeros((1, 32, 32, 3)),
                                     train=False)["params"])


def _printed(out):
    lines = out.strip().splitlines()
    return lines[0], [(line.split()[1], float(line.split()[3].rstrip(")")))
                      for line in lines[1:]]


def test_faiss_index_through_both_clis(tmp_path, monkeypatch, capsys):
    """A reference-style artifact pair of 10 images' features: both CLIs
    import it with ``--faiss_index --retrieve_only`` and print the same
    top-k; extraction flags are refused in both."""
    _tiny_hair_models(monkeypatch)
    data = tmp_path / "images"
    data.mkdir()
    rng = np.random.default_rng(5)
    for i in range(10):
        Image.fromarray(rng.integers(0, 256, (36, 44, 3), dtype=np.uint8)
                        ).save(data / f"{i:03d}_hair.png")
    params = jax_encoders.HairEncoder(None).params
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.05 * rng.standard_normal(p.shape).astype(
            np.float32), params)
    ckpt = str(tmp_path / "tiny.pth")
    save_torch_state_dict(export_vit(params, depth=TINY["depth"]), ckpt)
    enc = encoders.HairEncoder(ckpt, device="cpu")
    gallery = enc.extract_dataset_features(str(data), str(tmp_path / "emb"))
    artifact = str(tmp_path / "index_hair_region.index")
    io.save_faiss_flat(gallery, artifact,
                       str(tmp_path / "paths_hair_region.pkl"))

    query = str(data / "006_hair.png")
    argv = ["--data_path", str(data), "--ckpt_path", ckpt, "--faiss_index",
            artifact, "--retrieve_only", "--query_image", query,
            "--top_k", "4", "--embed_save_dir", str(tmp_path / "none")]
    jax_cli.run("hair", argv)
    ref = _printed(capsys.readouterr().out)
    cli.run("hair", argv + ["--device", "cpu"])
    ours = _printed(capsys.readouterr().out)
    assert ours[0] == ref[0] == f"Query: {query}"
    assert [p for p, _ in ours[1]] == [p for p, _ in ref[1]]
    assert ours[1][0][0] == query
    np.testing.assert_allclose([s for _, s in ours[1]],
                               [s for _, s in ref[1]], atol=1e-4)
    assert not (tmp_path / "none").exists()
    for flag in ("--force_extract", "--extract_only"):
        for run in (cli.run, jax_cli.run):
            with pytest.raises(SystemExit, match="cannot be combined"):
                run("hair", argv + [flag, "--device", "cpu"]
                    if run is cli.run else argv + [flag])
