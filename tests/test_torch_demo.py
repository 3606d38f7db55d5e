"""The port's demo pipeline (``hairci_torch.serve.demo``) against the JAX
package's on the CPU, with tiny ViT hair encoders carrying the same ``.pth``
in both: the Otsu segmentation (facer is absent here) and the hole-filled
display byte for byte, and ``DemoPipeline``'s paths, scores and display
images on a gallery it builds and on a reference FAISS artifact it imports,
with the dimension check. A stand-in for facer checks the mask's
segmentation path: the hair class where a face is found, the Otsu mask (as
in the JAX package) where none is, and the models loaded once."""

import sys
import types

import jax
import torch
import numpy as np
import pytest
from PIL import Image

import hairci.retrieval.encoders as jax_encoders
import hairci.serve.demo as jax_demo
from hairci.retrieval.torch_import import export_vit, save_torch_state_dict
from hairci_torch.preprocess import face_toolkit
from hairci_torch.retrieval import encoders
from hairci_torch.retrieval.faiss_io import save_faiss_flat, write_flat_index
from hairci_torch.serve import demo
from test_torch_faiss_io import TINY, _tiny_hair_models


def _query(seed=0):
    rng = np.random.default_rng(seed)
    img = np.full((64, 56, 3), 15, np.uint8)
    img[10:50, 8:48] = rng.integers(120, 255, (40, 40, 3))
    img[25:30, 20:30] = 10       # a hole inside the bright region
    return img


def test_parsing_and_display_match_jax():
    img = _query()
    hair, display = demo.parsing_image(img, device="cpu")
    ref_hair, ref_display = jax_demo.parsing_image(img)
    np.testing.assert_array_equal(hair, ref_hair)
    np.testing.assert_array_equal(display, ref_display)
    assert (hair[0, 0] == 0).all() and (display[0, 0] == 255).all()
    filled = demo.fill_holes_display(hair)
    np.testing.assert_array_equal(filled, jax_demo.fill_holes_display(hair))
    assert (filled[27, 25] == 0).all()     # the hole is kept, not whitened


def _fake_facer(n_faces, hair_rows, built):
    """A facer stand-in: ``n_faces`` detections, and a LaPa parse whose hair
    class wins on ``hair_rows``; ``built`` counts the models made."""
    def face_detector(name, device):
        built.append(name)
        return lambda t: {"rects": torch.zeros(n_faces, 4)}

    def face_parser(name, device):
        built.append(name)

        def parse(t, faces):
            n = len(faces["rects"])
            logits = torch.zeros(n, 11, t.shape[2], t.shape[3])
            logits[:, 0] = 1.0
            logits[:, face_toolkit.HAIR_CLASS, hair_rows] = 2.0
            return {"seg": {"logits": logits}}
        return parse
    return types.SimpleNamespace(face_detector=face_detector,
                                 face_parser=face_parser)


@pytest.mark.parametrize("n_faces", [1, 0])
def test_parsing_uses_the_face_parse_or_otsu_without_a_face(monkeypatch,
                                                            n_faces):
    img = _query()
    otsu_hair, otsu_display = jax_demo.parsing_image(img)   # facer absent
    built = []
    monkeypatch.setitem(sys.modules, "facer",
                        _fake_facer(n_faces, slice(10, 30), built))
    monkeypatch.setattr(face_toolkit, "_WORKER_MODELS", None)
    for _ in range(2):
        hair, display = demo.parsing_image(img, device="cpu")
    assert built == ["retinaface/mobilenet", "farl/lapa/448"]
    if n_faces:
        mask = np.zeros(img.shape[:2], bool)
        mask[10:30] = True
        np.testing.assert_array_equal(hair, img * mask[..., None])
        np.testing.assert_array_equal(
            display, np.where(mask[..., None], img, 255))
    else:
        np.testing.assert_array_equal(hair, otsu_hair)
        np.testing.assert_array_equal(display, otsu_display)


@pytest.fixture
def pipelines(tmp_path, monkeypatch):
    """Both packages' DemoPipeline over tiny encoders with one checkpoint,
    and a gallery folder of 6 hair crops."""
    _tiny_hair_models(monkeypatch)
    rng = np.random.default_rng(3)
    gallery = tmp_path / "gallery"
    gallery.mkdir()
    for i in range(6):
        arr = np.zeros((48, 48, 3), dtype=np.uint8)
        arr[8:40, 10:38] = rng.integers(60, 255, (32, 28, 3))
        Image.fromarray(arr).save(gallery / f"g{i}_hair.png")
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.05 * rng.standard_normal(p.shape).astype(
            np.float32), jax_encoders.HairEncoder(None).params)
    ckpt = str(tmp_path / "tiny.pth")
    save_torch_state_dict(export_vit(params, depth=TINY["depth"]), ckpt)
    port_enc = encoders.HairEncoder(ckpt, device="cpu")
    jax_enc = jax_encoders.HairEncoder(ckpt)
    return tmp_path, gallery, port_enc, jax_enc


def _same_retrieval(ours, ref):
    assert ours[2] == ref[2] and len(ours[2]) == 3
    np.testing.assert_allclose(ours[1], ref[1], atol=1e-5)
    for a, b in zip(ours[0], ref[0]):
        np.testing.assert_array_equal(a, b)


def test_pipeline_on_a_built_gallery_matches_jax(pipelines):
    root, gallery, port_enc, jax_enc = pipelines
    ours = demo.DemoPipeline(port_enc, str(root / "p"))
    with pytest.raises(RuntimeError, match="build_index"):
        ours.retrieve(_query())
    ref = jax_demo.DemoPipeline(jax_enc, str(root / "j"))
    assert len(ours.build_index(str(gallery))) == \
        len(ref.build_index(str(gallery))) == 6
    query = np.asarray(Image.open(gallery / "g4_hair.png"))
    got = ours.retrieve(query, k=3)
    _same_retrieval(got, ref.retrieve(query, k=3))
    assert got[2][0] == str(gallery / "g4_hair.png")
    # a second pipeline loads the saved gallery instead of embedding again
    again = demo.DemoPipeline(port_enc, str(root / "p"))
    assert again.build_index("/nonexistent").paths == ours.index.paths


def test_pipeline_imports_a_faiss_artifact_like_jax(pipelines):
    root, gallery, port_enc, jax_enc = pipelines
    built = port_enc.extract_dataset_features(str(gallery), str(root / "e"))
    for pkg in ("p", "j"):
        (root / pkg).mkdir()
        save_faiss_flat(built, str(root / pkg / demo.FAISS_ARTIFACT),
                        str(root / pkg / "paths_hair_region.pkl"))
    ours = demo.DemoPipeline(port_enc, str(root / "p"))
    ref = jax_demo.DemoPipeline(jax_enc, str(root / "j"))
    assert ours.build_index("/nonexistent").paths == \
        ref.build_index("/nonexistent").paths == built.paths
    query = _query(seed=5)
    _same_retrieval(ours.retrieve(query, k=3), ref.retrieve(query, k=3))

    wrong = np.random.default_rng(0).normal(size=(6, 32)).astype(np.float32)
    wrong /= np.linalg.norm(wrong, axis=1, keepdims=True)
    for pkg, pipe in (("pw", demo.DemoPipeline(port_enc, str(root / "pw"))),
                      ("jw", jax_demo.DemoPipeline(jax_enc,
                                                   str(root / "jw")))):
        (root / pkg).mkdir()
        write_flat_index(wrong, str(root / pkg / demo.FAISS_ARTIFACT))
        with pytest.raises(ValueError, match="gallery dim 32 != encoder "
                                             "output dim 64"):
            pipe.build_index("/nonexistent")


def test_launch_gradio_needs_gradio():
    """gradio is imported in ``launch_gradio`` only (the UI itself is not
    driven here: launching it serves until stopped)."""
    try:
        import gradio  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError):
            demo.launch_gradio(demo.DemoPipeline(encoder=None))
    else:
        assert callable(demo.launch_gradio)
