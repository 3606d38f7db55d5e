"""The port's own copy of the manifest reader and the host-side loader
(``hairci_torch/data``) against the originals in ``hairci/data`` on the
committed images: the same manifest, the same uint8 batches bit for bit
under the default decoder of both (the C++ decoder in ``raw_resize`` and
``center_crop``) and under PIL, the same epoch order."""

from pathlib import Path

import numpy as np
import pytest

from hairci.data.loader import DataLoader as JaxDataLoader
from hairci.data.loader import decode_image as jax_decode_image
from hairci.data.manifest import load_manifest as jax_load_manifest
from hairci_torch.data import DataLoader, decode_image, load_manifest
from hairci_torch.native import imageio

REPO = Path(__file__).resolve().parents[1]
IMG_DIR = REPO / "HairPretraining" / "data" / "hair_regions"


@pytest.fixture(scope="module")
def manifests(tmp_path_factory):
    names = sorted(p.name for p in IMG_DIR.glob("*.png"))[:11]
    labels = [7, 3, 3, 12, 7, 0, 5, 5, 12, 3, 9]
    csv = tmp_path_factory.mktemp("data") / "m.csv"
    csv.write_text("id,class\n" + "".join(
        f"{n},{c}\n" for n, c in zip(names, labels)))
    return (load_manifest(str(csv), str(IMG_DIR)),
            jax_load_manifest(str(csv), str(IMG_DIR)))


def test_manifest_matches_original(manifests):
    ours, ref = manifests
    assert ours.paths == ref.paths and len(ours) == len(ref) == 11
    np.testing.assert_array_equal(ours.labels, ref.labels)
    assert ours.labels.dtype == ref.labels.dtype
    np.testing.assert_array_equal(ours.label_indices, ref.label_indices)
    assert ours.label_indices.dtype == ref.label_indices.dtype == np.int32
    assert ours.class_names == ref.class_names
    assert ours.num_classes == ref.num_classes == 6


def _batches(loader):
    return [(im.copy(), lb.copy()) for im, lb in loader]


@pytest.mark.parametrize("mode,size,kw", [
    ("center_crop", 224, {}),
    ("center_crop", 300, {}),            # larger than the images: zero pad
    ("raw_resize", 64, {}),
    ("center_crop", 48, {"pad_last": True}),
    ("raw_resize", 40, {"drop_last": True}),
    ("raw_resize", 64, {"decoder": "pil"}),
])
def test_batches_bitwise_equal(manifests, mode, size, kw):
    ours, ref = manifests
    common = dict(batch_size=4, size=size, mode=mode, shuffle=False,
                  num_workers=2, **kw)
    a = _batches(DataLoader(ours, **common))
    b = _batches(JaxDataLoader(ref, **common))
    assert len(a) == len(b) == (2 if kw.get("drop_last") else 3)
    for (im, lb), (rim, rlb) in zip(a, b):
        assert im.dtype == np.uint8 and im.shape == rim.shape
        assert im.shape[1:] == (size, size, 3)
        np.testing.assert_array_equal(im, rim)
        np.testing.assert_array_equal(lb, rlb)
        assert lb.dtype == rlb.dtype
    if kw.get("pad_last"):
        assert a[-1][0].shape[0] == 4
        np.testing.assert_array_equal(a[-1][0][-1], a[-1][0][2])


@pytest.mark.parametrize("epoch", [0, 3])
def test_shuffled_epoch_order_matches(manifests, epoch):
    ours, ref = manifests
    common = dict(batch_size=4, size=32, mode="raw_resize", shuffle=True,
                  seed=123, num_workers=1)
    a, b = DataLoader(ours, **common), JaxDataLoader(ref, **common)
    a.set_epoch(epoch)
    b.set_epoch(epoch)
    np.testing.assert_array_equal(a._order(), b._order())
    assert not np.array_equal(a._order(), np.arange(11))
    for (im, lb), (rim, rlb) in zip(_batches(a), _batches(b)):
        np.testing.assert_array_equal(lb, rlb)
        np.testing.assert_array_equal(im, rim)
    # iterating advanced the epoch in both: the next order is another one
    np.testing.assert_array_equal(a._order(), b._order())
    assert a._epoch == b._epoch == epoch + 1
    assert len(a) == len(b) == 3


@pytest.mark.parametrize("mode", ["raw_resize", "resize_center_crop",
                                  "center_crop"])
def test_decode_image_matches(manifests, mode):
    path = manifests[0].paths[4]
    np.testing.assert_array_equal(decode_image(path, mode, 56),
                                  jax_decode_image(path, mode, 56))
    assert decode_image(str(IMG_DIR / "missing.png"), mode, 56) is None


@pytest.mark.parametrize("mode", ["raw_resize", "center_crop"])
def test_native_decoder_takes_the_batches(manifests, mode):
    ours = manifests[0]
    common = dict(size=40, mode=mode, shuffle=False, num_workers=2)
    before = imageio.decode_batch.decodes
    native = _batches(DataLoader(ours, 4, decoder="native", **common))
    assert imageio.decode_batch.decodes - before == 11
    auto = _batches(DataLoader(ours, 4, **common))
    assert imageio.decode_batch.decodes - before == 22
    pil = _batches(DataLoader(ours, 4, decoder="pil", **common))
    assert imageio.decode_batch.decodes - before == 22
    for (im, lb), (aim, alb), (pim, plb) in zip(native, auto, pil):
        np.testing.assert_array_equal(im, aim)
        np.testing.assert_array_equal(lb, plb)
        d = np.abs(im.astype(int) - pim.astype(int))
        assert d.max() <= (2 if mode == "raw_resize" else 0), d.max()
    with pytest.raises(ValueError, match="unknown decoder"):
        DataLoader(ours, 4, decoder="turbo")


def test_failed_decodes_are_skipped(manifests, tmp_path):
    csv = tmp_path / "bad.csv"
    good = Path(manifests[0].paths[0]).name
    csv.write_text(f"id,class\n{good},1\nmissing.png,2\n{good},3\n")
    m = load_manifest(str(csv), str(IMG_DIR))
    (images, labels), = _batches(DataLoader(m, 4, size=32, shuffle=False,
                                            num_workers=0))
    # the failed row is dropped and the batch padded back to its 3 rows
    assert images.shape == (3, 32, 32, 3)
    np.testing.assert_array_equal(labels, [0, 2, 2])
