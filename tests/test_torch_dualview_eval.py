"""DualViewHair's evaluation in the port against the JAX package on the
CPU: ``recall_map_at_k``, ``save_top100_results`` and ``load_benchmark``
equal to JAX's (an empty ground truth, the alternative key names, the
Visualizer JSON byte for byte); ``evaluate`` over a tiny index with a fixed
embedder (the same dict, the same file); ``train.main`` into
``quantitative_eval.main --model dualview`` end to end on the port's own
checkpoint (ResNet-50 cut to one block a stage, 32 px); ``--model vit``
through a cut ``HairEncoder``; and ``qualitative_test`` writing its grids."""

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

import hairci.eval.retrieval_metrics as jrm
import hairci.experiments.dualview.quantitative_eval as jqe
import hairci_torch.models.resnet as port_resnet
from hairci.retrieval.index import GalleryIndex as JaxGalleryIndex
from hairci_torch.eval import retrieval_metrics as rm
from hairci_torch.experiments.dualview import models, qualitative_test
from hairci_torch.experiments.dualview import quantitative_eval as qe
from hairci_torch.experiments.dualview import train as dvtrain
from hairci_torch.retrieval.index import GalleryIndex

torch.set_num_threads(1)

RETRIEVED = [["a_hair.png", "b_hair.png", "c_hair.png", "d_hair.png"],
             ["c_hair.png", "x_hair.png", "b_hair.png"],
             ["q_hair.png"],
             ["b_hair.png", "a_hair.png"]]
TRUTH = [["b_hair.png", "d_hair.png"], ["b_hair.png"], [], ["z_hair.png"]]


@pytest.mark.parametrize("ks", [(1, 2, 3), (10, 20, 50), (2,)])
def test_recall_and_map_equal_jax(ks):
    got = rm.recall_map_at_k(RETRIEVED, TRUTH, ks)
    assert got == jrm.recall_map_at_k(RETRIEVED, TRUTH, ks)
    assert got["total_queries"] == 4
    empty = rm.recall_map_at_k([], [], ks)
    assert empty == jrm.recall_map_at_k([], [], ks)


def test_top100_json_and_benchmark_equal_jax(tmp_path):
    long = [[f"/db/{i}_{j}_hair.png" for j in range(130)] for i in range(2)]
    ours = rm.save_top100_results(["/q/0_hair.png", "1_hair.png"], long,
                                  str(tmp_path / "ours" / "top.json"))
    ref = jrm.save_top100_results(["/q/0_hair.png", "1_hair.png"], long,
                                  str(tmp_path / "ref" / "top.json"))
    assert open(ours, "rb").read() == open(ref, "rb").read()
    data = json.load(open(ours))
    assert data[0]["query"] == "0_hair.png" and len(data[0]["top100"]) == 100
    bench = [{"query_image": "a.jpg", "ground_truth": ["b.jpg"]},
             {"query_id": "c.jpg", "ground_truths": ["d.jpg", "e.jpg"]},
             {"query": "f.jpg"}]
    path = tmp_path / "bench.json"
    path.write_text(json.dumps(bench))
    assert rm.load_benchmark(str(path)) == jrm.load_benchmark(str(path))
    assert rm.load_benchmark(str(path))[2] == {"query_image": "f.jpg",
                                               "ground_truth": []}


def test_evaluate_equals_jax(tmp_path):
    """A 12-image database, a fixed embedder (a seeded vector per file), 5
    queries of which one is missing: the same metrics and the same bytes
    of the top-100 file as JAX's ``evaluate``."""
    rng = np.random.default_rng(0)
    names = [f"{i:03d}_hair.png" for i in range(12)]
    for n in names:
        (tmp_path / n).write_bytes(b"")
    vecs = {str(tmp_path / n): rng.normal(size=16).astype(np.float32)
            for n in names}
    paths = sorted(vecs)
    emb = np.stack([vecs[p] for p in paths])
    bench = [{"query_image": f"{i:03d}.jpg",
              "ground_truth": [f"{(i + d) % 12:03d}.jpg" for d in (0, 3)]}
             for i in (0, 2, 5, 7)]
    bench.append({"query_image": "999.jpg", "ground_truth": ["000.jpg"]})
    got = qe.evaluate(GalleryIndex(emb, paths, device="cpu"), vecs.get, bench,
                      str(tmp_path), ks=(1, 5, 10),
                      out_json=str(tmp_path / "ours.json"))
    want = jqe.evaluate(JaxGalleryIndex(emb, paths), vecs.get, bench,
                        str(tmp_path), ks=(1, 5, 10),
                        out_json=str(tmp_path / "ref.json"))
    assert got == want and got["total_queries"] == 4
    assert got["Recall"][1] == 1.0          # each query is in the database
    assert (tmp_path / "ours.json").read_bytes() == \
        (tmp_path / "ref.json").read_bytes()


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    """6 (full, hair) pairs of 48 px: distinct colours."""
    root = tmp_path_factory.mktemp("dv_pairs")
    rng = np.random.default_rng(1)
    for i in range(6):
        full = (rng.uniform(40, 200, (1, 1, 3))
                + rng.uniform(-30, 30, (48, 48, 3))).astype(np.uint8)
        hair = full.copy()
        hair[:, :16] = 0
        Image.fromarray(full).save(root / f"{i:03d}.jpg")
        Image.fromarray(hair).save(root / f"{i:03d}_hair.png")
    bench = [{"query_image": f"{i:03d}.jpg", "ground_truth": [f"{i:03d}.jpg"]}
             for i in range(3)]
    (root / "bench.json").write_text(json.dumps(bench))
    return root


def test_train_then_quantitative_eval_end_to_end(pairs, tmp_path, monkeypatch):
    """``train.main`` for 2 epochs of the queue loss on the CPU writes the
    port's checkpoint (the state only: no queue in it, as in JAX);
    ``quantitative_eval.main --model dualview`` reads it for both towers,
    writes the Visualizer file and returns Recall@K / mAP@K."""
    monkeypatch.setitem(port_resnet._STAGES, "resnet50",
                        ([1, 1, 1, 1], port_resnet.BottleneckBlock))
    out = dvtrain.main(["--data_root", str(pairs), "--epochs", "2",
                        "--batch_size", "4", "--size", "32", "--loss",
                        "queue", "--device", "cpu",
                        "--save_path", str(tmp_path / "ckpt")])
    assert len(out["history"]) == 2 and all(np.isfinite(out["history"]))
    assert out["state"].step == 2       # 6 pairs, one full batch an epoch
    ckpt = str(tmp_path / "ckpt" / "dualview_latest")
    saved = torch.load(ckpt, weights_only=True)
    assert set(saved) == {"online", "ema", "optimizer", "step", "epoch"}
    results = {}
    for tower in ("student", "teacher"):
        out_json = str(tmp_path / f"{tower}.json")
        results[tower] = qe.main([
            "--db_path", str(pairs), "--benchmark", str(pairs / "bench.json"),
            "--ckpt_path", ckpt, "--model", "dualview", "--size", "32",
            "--tower", tower, "--device", "cpu", "--out", out_json])
        data = json.load(open(out_json))
        assert [r["query"] for r in data] == [f"{i:03d}_hair.png"
                                             for i in range(3)]
        assert all(len(r["top100"]) == 6 for r in data)
        assert results[tower]["total_queries"] == 3
        # the query's own crop is in the database: rank 1
        assert results[tower]["Recall"][10] == 1.0
    # the embedder restores the saved student: a query's embedding is its
    # database row
    build, embed = qe._dualview_embedder(ckpt, "resnet", 32, device="cpu")
    index = build(str(pairs))
    assert len(index) == 6 and index.dim == 256
    q = embed(str(pairs / "000_hair.png"))
    np.testing.assert_allclose(q / np.linalg.norm(q),
                               index.embeddings[0].numpy(), atol=1e-6)
    fresh = models.DualViewHairModel().create_state(0, "cpu").online
    assert not torch.equal(fresh.emb_fc.weight, out["state"].online.emb_fc
                           .weight)


def test_quantitative_and_qualitative_with_the_hair_encoder(pairs, tmp_path,
                                                           monkeypatch):
    """``--model vit``: the ``HairEncoder`` (ViT cut to depth 2 at width 64)
    embeds the database into ``--embed_dir`` and evaluates;
    ``qualitative_test.main`` reuses those embeddings and writes one grid
    per query (matplotlib imported inside ``render_grids``)."""
    import hairci_torch.models.vit as port_vit

    monkeypatch.setitem(port_vit.VIT_CONFIGS, "vit_base_patch16",
                        (16, 64, 2, 2))
    embed_dir = str(tmp_path / "emb")
    res = qe.main(["--db_path", str(pairs), "--benchmark",
                   str(pairs / "bench.json"), "--embed_dir", embed_dir,
                   "--model", "vit", "--device", "cpu",
                   "--out", str(tmp_path / "vit.json")])
    assert res["total_queries"] == 3
    assert os.path.exists(os.path.join(embed_dir, "embeddings.npy"))
    qualitative_test.main(["--db_path", str(pairs), "--embed_dir", embed_dir,
                           "--out_dir", str(tmp_path / "grids"),
                           "--num_queries", "2", "--top_k", "3",
                           "--device", "cpu"])
    pngs = sorted(os.listdir(tmp_path / "grids"))
    assert pngs == ["qualitative_0.png", "qualitative_1.png"]
    assert Image.open(tmp_path / "grids" / pngs[0]).size[0] > 100
