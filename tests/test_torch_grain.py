"""The port's ``GrainLoader`` (``hairci_torch/data/grain_loader.py``) against
the JAX package's on the committed images: the same batches, bit for bit and
in the same order, over two epochs, with grain's in-process reader
(``worker_count=0``); and the port imports grain only when a loader is
made."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from hairci.data.grain_loader import GrainLoader as JaxGrainLoader
from hairci.data.manifest import load_manifest as jax_load_manifest
from hairci_torch.data import GrainLoader, load_manifest

REPO = Path(__file__).resolve().parents[1]
IMG_DIR = REPO / "HairPretraining" / "data" / "hair_regions"


@pytest.fixture(scope="module")
def manifests(tmp_path_factory):
    names = sorted(p.name for p in IMG_DIR.glob("*_hair.png"))[:10]
    csv = tmp_path_factory.mktemp("grain") / "m.csv"
    csv.write_text("id,class\n" + "missing.png,4\n" + "".join(
        f"{n},{i % 3}\n" for i, n in enumerate(names)))
    return (load_manifest(str(csv), str(IMG_DIR)),
            jax_load_manifest(str(csv), str(IMG_DIR)))


@pytest.mark.parametrize("mode,size,shuffle,drop_last", [
    ("raw_resize", 40, True, True),
    ("center_crop", 48, False, False),
])
def test_batches_match_jax_package(manifests, mode, size, shuffle,
                                   drop_last):
    ours, ref = manifests
    kw = dict(batch_size=4, size=size, mode=mode, shuffle=shuffle,
              drop_last=drop_last, seed=5, num_workers=0)
    a, b = GrainLoader(ours, **kw), JaxGrainLoader(ref, **kw)
    assert len(a) == len(b) == (2 if drop_last else 3)
    epochs = []
    for _ in range(2):
        got, want = list(a), list(b)
        assert len(got) == len(want) == len(a)
        for (im, lb), (rim, rlb) in zip(got, want):
            assert im.dtype == np.uint8 and im.shape[1:] == (size, size, 3)
            np.testing.assert_array_equal(im, rim)
            np.testing.assert_array_equal(lb, rlb)
            assert lb.dtype == rlb.dtype == np.int32
        epochs.append(np.concatenate([lb for _, lb in got]))
    # the missing file decodes to zeros, as in the JAX package
    assert any((im.reshape(len(im), -1).max(1) == 0).any() for im, _ in got)
    if shuffle:
        assert not np.array_equal(epochs[0], epochs[1])


def test_grain_is_imported_lazily():
    code = ("import sys\nimport hairci_torch.data\n"
            "assert 'grain' not in sys.modules, 'grain imported'\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)
