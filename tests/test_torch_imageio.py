"""The port's copy of the C++ batch decoder (``hairci_torch/native``) against
the JAX package's (``hairci/native/imageio``) and against PIL, on the
fixtures of test_native_imageio.py: bitwise against the JAX package's build
(the same source and flags on the same machine); against PIL bitwise in
``center_crop`` and within 2 LSB in ``raw_resize``; the ok-mask of a corrupt
and a missing file; the loader's ``"auto"`` / ``"native"`` / ``"pil"``
routes against the JAX package's; the decode counter; the build."""

import csv

import numpy as np
import pytest
from PIL import Image

from hairci.data.loader import DataLoader as JaxDataLoader
from hairci.data.manifest import load_manifest as jax_load_manifest
from hairci.native import imageio as jax_imageio
from hairci_torch.data import DataLoader, decode_image, load_manifest
from hairci_torch.native import imageio

MODES = {"raw_resize": imageio.MODE_RAW_RESIZE,
         "center_crop": imageio.MODE_CENTER_CROP}


@pytest.fixture(scope="module")
def image_dir(tmp_path_factory):
    """test_native_imageio.py's images: jpeg and png of four shapes, a
    grayscale png, a corrupt jpeg and a missing file."""
    d = tmp_path_factory.mktemp("imgs")
    rng = np.random.default_rng(0)
    paths = []
    for i, (w, h) in enumerate([(320, 240), (96, 400), (224, 224),
                                (64, 48)]):
        a = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        p = d / (f"{i}.jpg" if i % 2 == 0 else f"{i}.png")
        Image.fromarray(a).save(p)
        paths.append(str(p))
    Image.fromarray(rng.integers(0, 256, (80, 80), dtype=np.uint8),
                    mode="L").save(d / "gray.png")
    paths.append(str(d / "gray.png"))
    (d / "corrupt.jpg").write_bytes(b"\xff\xd8not a real jpeg")
    paths.append(str(d / "corrupt.jpg"))
    paths.append(str(d / "missing.jpg"))
    return paths


@pytest.mark.parametrize("mode,size", [("center_crop", 128),
                                       ("center_crop", 300),
                                       ("raw_resize", 224),
                                       ("raw_resize", 57)])
def test_decoder_bitwise_equal_to_jax_package(image_dir, mode, size):
    out, ok = imageio.decode_batch(image_dir, size, MODES[mode], n_threads=3)
    ref, ref_ok = jax_imageio.decode_batch(image_dir, size, MODES[mode],
                                           n_threads=3)
    assert out.shape == (7, size, size, 3) and out.dtype == np.uint8
    # the corrupt and the missing file fail, and only they
    assert ok.tolist() == ref_ok.tolist() == [True] * 5 + [False, False]
    np.testing.assert_array_equal(out[ok], ref[ref_ok])


def test_center_crop_bitwise_pil(image_dir):
    out, ok = imageio.decode_batch(image_dir, 128, imageio.MODE_CENTER_CROP)
    assert ok.tolist() == [True] * 5 + [False, False]
    for i in range(5):
        np.testing.assert_array_equal(
            out[i], decode_image(image_dir[i], "center_crop", 128))


def test_raw_resize_within_2_lsb_of_pil(image_dir):
    out, ok = imageio.decode_batch(image_dir[:5], 224,
                                   imageio.MODE_RAW_RESIZE)
    assert ok.all()
    for i in range(5):
        d = np.abs(out[i].astype(int)
                   - decode_image(image_dir[i], "raw_resize", 224).astype(int))
        # float resampling against Pillow's 8-bit fixed-point coefficients
        assert d.max() <= 2 and d.mean() < 0.5, (i, d.max(), d.mean())


def _manifests(image_dir, tmp_path):
    rows = [(p.rsplit("/", 1)[1], i % 2) for i, p in enumerate(image_dir)]
    path = tmp_path / "m.csv"
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["id", "class"])
        w.writerows(rows)
    img_dir = image_dir[0].rsplit("/", 1)[0]
    return (load_manifest(str(path), img_dir),
            jax_load_manifest(str(path), img_dir))


@pytest.mark.parametrize("mode,decoder", [
    ("center_crop", "auto"), ("raw_resize", "auto"),
    ("center_crop", "native"), ("raw_resize", "native"),
    ("raw_resize", "pil"), ("resize_center_crop", "auto")])
def test_loader_routes_match_jax_package(image_dir, tmp_path, mode, decoder):
    ours, ref = _manifests(image_dir, tmp_path)
    common = dict(batch_size=4, size=96, mode=mode, shuffle=False,
                  num_workers=2, decoder=decoder)
    before = imageio.decode_batch.decodes
    a = list(DataLoader(ours, **common))
    native = decoder != "pil" and mode != "resize_center_crop"
    assert imageio.decode_batch.decodes - before == (7 if native else 0)
    b = list(JaxDataLoader(ref, **common))
    # the two failed rows are skipped and the second batch padded back
    assert len(a) == len(b) == 2
    for (im, lb), (rim, rlb) in zip(a, b):
        assert im.shape == rim.shape == (4 if len(lb) == 4 else 3, 96, 96, 3)
        np.testing.assert_array_equal(im, rim)
        np.testing.assert_array_equal(lb, rlb)


def test_native_refuses_what_it_cannot_do(image_dir, tmp_path, monkeypatch):
    ours, _ = _manifests(image_dir, tmp_path)
    with pytest.raises(ValueError, match="does not implement"):
        DataLoader(ours, 4, mode="resize_center_crop", decoder="native")
    with pytest.raises(ValueError, match="unknown native decode mode"):
        imageio.decode_batch(image_dir[:1], 32, 2)
    # a library that cannot be built: "native" raises, "auto" takes PIL
    monkeypatch.setattr(imageio, "_load",
                        lambda: (None, "g++ failed: no jpeglib.h"))
    with pytest.raises(RuntimeError, match="no jpeglib.h"):
        DataLoader(ours, 4, mode="center_crop", decoder="native")
    before = imageio.decode_batch.decodes
    auto = list(DataLoader(ours, 4, size=96, mode="center_crop",
                           shuffle=False, num_workers=1))
    pil = list(DataLoader(ours, 4, size=96, mode="center_crop",
                          shuffle=False, num_workers=1, decoder="pil"))
    assert imageio.decode_batch.decodes == before
    for (im, _), (rim, _) in zip(auto, pil):
        np.testing.assert_array_equal(im, rim)


def test_library_name_follows_the_source(tmp_path, monkeypatch):
    built = imageio.library_path()
    assert imageio.available() and built.is_file()
    assert built.parent == imageio.BUILD_DIR
    src = tmp_path / "imageio.cpp"
    src.write_bytes(imageio.SRC.read_bytes() + b"\n// edited\n")
    monkeypatch.setattr(imageio, "SRC", src)
    assert imageio.library_path() != built
