"""The port's face-retrieval slice against the JAX package on the CPU: a tiny
``ViT_face`` (32 px, dim 64, depth 2) swapped into both packages'
``FaceEncoder``, the same reference-layout ``.pth`` loaded by each; the same
features (1e-5), index files and top-k; ``run("face")`` through both CLIs;
and the port's HTTP API with ``--encoder face``, all on ``--device cpu``."""

import base64
import json
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import hairci.retrieval.encoders as jax_encoders
from hairci.cli import retrieval as jax_cli
from hairci.models.face_vit import ViTFace as JaxViTFace
from hairci.retrieval.torch_import import save_torch_state_dict
from hairci_torch.cli import retrieval as cli
from hairci_torch.models.face_vit import ViTFace
from hairci_torch.retrieval import encoders
from hairci_torch.serve import api
from test_torch_face_vit import TINY, _reference_state_dict

torch.set_num_threads(1)
N_IMAGES = 12


def _patch_dim(name):
    return 432 if name == "VITs" else 192


def _tiny_models(monkeypatch):
    """Both packages' face encoders build the tiny model at 32 px, in f32
    (the encoders' bf16 is held against JAX's in test_torch_face_vit.py)."""
    monkeypatch.setattr(
        encoders, "build_vit_face",
        lambda name, dtype, generator: ViTFace(
            **TINY, overlapping=name == "VITs", generator=generator))
    monkeypatch.setattr(encoders.FaceEncoder, "img_size", 32)
    monkeypatch.setattr(
        jax_encoders, "build_vit_face",
        lambda name, dtype: JaxViTFace(**TINY, overlapping=name == "VITs"))
    monkeypatch.setattr(jax_encoders.FaceEncoder, "img_size", 32)
    monkeypatch.setattr(
        jax_encoders.FaceEncoder, "_init_params",
        lambda self: self.model.init(jax.random.key(0),
                                     jnp.zeros((1, 32, 32, 3)))["params"])


@pytest.fixture(scope="module")
def slice_(tmp_path_factory):
    root = tmp_path_factory.mktemp("torchface")
    data = root / "images"
    data.mkdir()
    rng = np.random.default_rng(0)
    for i in range(N_IMAGES):
        a = rng.integers(0, 256, (40 + 3 * i, 36, 3), dtype=np.uint8)
        Image.fromarray(a).save(data / f"{i:03d}.png")
    ckpt = {}
    for name in ("VIT", "VITs"):
        ckpt[name] = str(root / f"{name}.pth")
        save_torch_state_dict(_reference_state_dict(
            TINY["depth"], seed=7, patch_dim=_patch_dim(name)), ckpt[name])
    with pytest.MonkeyPatch.context() as mp:
        _tiny_models(mp)
        jax_enc = jax_encoders.FaceEncoder(ckpt["VIT"], batch_size=5)
        port_enc = encoders.FaceEncoder(ckpt["VIT"], device="cpu",
                                        batch_size=5, dtype=torch.float32)
    jax_enc.img_size = port_enc.img_size = 32
    jax_index = jax_enc.extract_dataset_features(str(data), str(root / "jax"))
    port_index = port_enc.extract_dataset_features(str(data),
                                                   str(root / "port"))
    return dict(root=root, data=data, ckpt=ckpt, jax_enc=jax_enc,
                port_enc=port_enc, jax_index=jax_index, port_index=port_index)


def test_features_and_index_files_match_jax(slice_):
    root = slice_["root"]
    port = np.load(root / "port" / "embeddings.npy")
    assert port.shape == (N_IMAGES, 64)
    np.testing.assert_allclose(port, np.load(root / "jax" / "embeddings.npy"),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(port, axis=1), 1, atol=1e-6)
    assert ((root / "port" / "image_paths.txt").read_bytes()
            == (root / "jax" / "image_paths.txt").read_bytes())
    assert slice_["port_enc"].feature_dim == slice_["jax_enc"].feature_dim \
        == 64


def test_single_image_retrieval_matches_jax(slice_):
    for i in (0, 5, 11):
        path = slice_["port_index"].paths[i]
        ref = slice_["jax_enc"].encode_single_image(path)
        feat = slice_["port_enc"].encode_single_image(path)
        np.testing.assert_allclose(feat, ref, atol=1e-5)
        paths, scores = slice_["port_enc"].retrieve_similar_images(
            feat, slice_["port_index"], top_k=5)
        ref_paths, ref_scores = slice_["jax_enc"].retrieve_similar_images(
            ref, slice_["jax_index"], top_k=5)
        assert paths == ref_paths and paths[0] == path
        np.testing.assert_allclose(scores, ref_scores, atol=1e-5)


def _printed(out):
    """(query line, [(path, score)]) of the CLI's top-k print."""
    lines = out.strip().splitlines()
    rows = []
    for line in lines[1:]:
        _, path, _, score = line.split()
        rows.append((path, float(score.rstrip(")"))))
    return lines[0], rows


@pytest.mark.parametrize("model_name", ["VIT", "VITs"])
def test_run_face_matches_the_jax_cli(slice_, model_name, monkeypatch,
                                      tmp_path, capsys):
    _tiny_models(monkeypatch)
    argv = ["--data_path", str(slice_["data"]), "--model_name", model_name,
            "--ckpt_path", slice_["ckpt"][model_name], "--top_k", "4",
            "--batch_size", "5",
            "--query_image", str(slice_["data"] / "004.png")]
    jax_cli.run("face", argv + ["--embed_save_dir", str(tmp_path / "j")])
    ref = _printed(capsys.readouterr().out)
    cli.run("face", argv + ["--embed_save_dir", str(tmp_path / "p"),
                            "--device", "cpu"])
    ours = _printed(capsys.readouterr().out)
    assert ours[0] == ref[0] == f"Query: {slice_['data'] / '004.png'}"
    assert [p for p, _ in ours[1]] == [p for p, _ in ref[1]]
    assert ours[1][0][0] == str(slice_["data"] / "004.png")
    np.testing.assert_allclose([s for _, s in ours[1]],
                               [s for _, s in ref[1]], atol=1e-4)


def test_face_entry_points_need_a_card_unless_asked(slice_, monkeypatch,
                                                    tmp_path):
    _tiny_models(monkeypatch)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.run("face", ["--data_path", str(slice_["data"]),
                         "--embed_save_dir", str(tmp_path / "e")])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        api.main(["--encoder", "face", "--index_dir", str(tmp_path / "i")])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        encoders.FaceEncoder()


def _req(srv, path, payload=None):
    url = f"http://127.0.0.1:{srv.server_address[1]}{path}"
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read())


def test_api_serves_the_face_encoder(slice_, monkeypatch, tmp_path):
    """``--encoder face`` wired by the API's own parser: the face encoder on
    the CPU behind ``serve``; /health, /embed and /search answer with the
    JAX encoder's neighbours."""
    _tiny_models(monkeypatch)
    args = api.build_parser().parse_args(
        ["--encoder", "face", "--index_dir", str(tmp_path / "idx"),
         "--checkpoint_path", slice_["ckpt"]["VIT"], "--device", "cpu"])
    enc = api.build_encoder(args)
    assert isinstance(enc, encoders.FaceEncoder) and not enc.model.overlapping
    srv = api.serve(enc, args.index_dir, port=0,
                    dataset_path=str(slice_["data"]))
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        paths = slice_["port_index"].paths
        assert _req(srv, "/health") == {
            "status": "ok", "gallery_size": N_IMAGES, "dim": 64,
            "model": "FaceEncoder"}
        emb = np.asarray(_req(srv, "/embed",
                              {"image_path": paths[3]})["embedding"])
        assert emb.shape == (1, 64)
        np.testing.assert_allclose(
            emb[0], slice_["jax_enc"].encode_single_image(paths[3]),
            atol=1e-4)
        raw = base64.b64encode(open(paths[7], "rb").read()).decode()
        res = _req(srv, "/search", {"image_b64": raw, "k": 5})
        ref_paths, _ = slice_["jax_enc"].retrieve_similar_images(
            slice_["jax_enc"].encode_single_image(paths[7]),
            slice_["jax_index"], top_k=5)
        assert res["paths"][0] == ref_paths and ref_paths[0] == paths[7]
    finally:
        srv.shutdown()
        srv.server_close()
        t.join(timeout=30)
    assert not t.is_alive()
    vits = api.build_encoder(api.build_parser().parse_args(
        ["--encoder", "face", "--model_name", "VITs", "--index_dir", "x",
         "--device", "cpu"]))
    assert vits.model.overlapping and vits.feature_dim == 64
