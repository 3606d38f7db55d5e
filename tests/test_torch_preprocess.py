"""The port's preprocessing (``hairci_torch.preprocess``) against the JAX
package's on the CPU, without facer (absent here, as on most machines):
``split_folder``, the Otsu threshold, ``hair_mask``, ``process_face_image``
and ``process_folder_multiprocess`` give byte-equal outputs, and both CLIs
run."""

import filecmp
import logging
import os

import numpy as np
import pytest
from PIL import Image

import hairci.preprocess.data_split as jax_split
import hairci.preprocess.face_toolkit as jax_toolkit
from hairci_torch.preprocess import data_split, face_toolkit


def _make_images(d, n=5, seed=0):
    rng = np.random.default_rng(seed)
    for i in range(n):
        arr = np.zeros((40, 48, 3), dtype=np.uint8)
        arr[5:35, 5:40] = rng.integers(50, 255, (30, 35, 3))
        Image.fromarray(arr).save(d / f"img{i}.jpg")
    (d / "notes.txt").write_text("not an image")


def _same_tree(a, b):
    assert sorted(os.listdir(a)) == sorted(os.listdir(b))
    for name in os.listdir(a):
        pa, pb = os.path.join(a, name), os.path.join(b, name)
        if os.path.isdir(pa):
            _same_tree(pa, pb)
        else:
            assert filecmp.cmp(pa, pb, shallow=False), name


def test_split_folder_matches_jax(tmp_path):
    src = tmp_path / "all"
    src.mkdir()
    _make_images(src, 5)
    ours = data_split.split_folder(str(src), str(tmp_path / "p"),
                                   chunk_size=2)
    ref = jax_split.split_folder(str(src), str(tmp_path / "j"), chunk_size=2)
    assert [os.path.basename(d) for d in ours] == \
        [os.path.basename(d) for d in ref] == ["hair_0", "hair_1", "hair_2"]
    _same_tree(tmp_path / "p", tmp_path / "j")
    data_split.main(["--input_dir", str(src), "--output_dir",
                     str(tmp_path / "cli"), "--chunk_size", "4"])
    assert sorted(os.listdir(tmp_path / "cli")) == ["hair_0", "hair_1"]


@pytest.mark.parametrize("seed", range(4))
def test_otsu_threshold_and_mask_match_jax(seed):
    rng = np.random.default_rng(seed)
    image = rng.integers(0, 256, (37, 29, 3), dtype=np.uint8)
    image[10:30, 5:20] //= 4       # a dark block: a bimodal histogram
    gray = image.astype(np.float32).mean(axis=-1)
    assert face_toolkit._otsu_threshold(gray) == \
        jax_toolkit._otsu_threshold(gray)
    np.testing.assert_array_equal(face_toolkit.hair_mask(image),
                                  jax_toolkit.hair_mask(image))


def test_process_face_image_is_byte_equal(tmp_path, caplog):
    src, p, j = tmp_path / "raw", tmp_path / "p", tmp_path / "j"
    for d in (src, p, j):
        d.mkdir()
    _make_images(src, 2)
    saved = face_toolkit._WORKER_MODELS
    face_toolkit._WORKER_MODELS = None
    try:
        with caplog.at_level(logging.WARNING):
            out = face_toolkit.process_face_image(str(src / "img1.jpg"),
                                                  str(p))
    finally:
        face_toolkit._WORKER_MODELS = saved
    assert "facer unavailable" in caplog.text
    ref = jax_toolkit.process_face_image(str(src / "img1.jpg"), str(j))
    assert os.path.basename(out) == os.path.basename(ref) == "img1_hair.png"
    assert open(out, "rb").read() == open(ref, "rb").read()
    arr = np.asarray(Image.open(out))
    assert (arr[0, 0] == 0).all() and arr[10:30, 10:30].sum() > 0
    assert face_toolkit.process_face_image(str(src / "none.jpg"), str(p)) \
        is None


@pytest.mark.parametrize("workers", [1, 2])
def test_process_folder_is_byte_equal(tmp_path, workers):
    src = tmp_path / "raw"
    src.mkdir()
    _make_images(src, 4, seed=workers)
    done = face_toolkit.process_folder_multiprocess(
        str(src), str(tmp_path / "p"), num_workers=workers, device="cpu")
    ref = jax_toolkit.process_folder_multiprocess(str(src), str(tmp_path / "j"),
                                                  num_workers=1)
    assert [os.path.basename(d) for d in done] == \
        [os.path.basename(d) for d in ref] == \
        [f"img{i}_hair.png" for i in range(4)]
    _same_tree(tmp_path / "p", tmp_path / "j")


def test_face_toolkit_cli(tmp_path):
    src = tmp_path / "raw"
    src.mkdir()
    _make_images(src, 2)
    face_toolkit.main(["--input_dir", str(src), "--output_dir",
                       str(tmp_path / "out"), "--num_workers", "1"])
    assert sorted(os.listdir(tmp_path / "out")) == ["img0_hair.png",
                                                    "img1_hair.png"]
