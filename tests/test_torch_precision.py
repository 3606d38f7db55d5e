"""Full f32 where the port promises it, whatever the caller's global
settings: ``GalleryIndex.search``'s chunked product, and the two CLIs'
``--dtype float32`` runs (cuDNN allows TF32 by default)."""

from pathlib import Path

import numpy as np
import pytest
import torch

from hairci_torch.cli import knn_classification, mainpretrain
from hairci_torch.retrieval.index import GalleryIndex

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]
IMG_DIR = REPO / "HairPretraining" / "data" / "hair_regions"


@pytest.fixture
def restore_flags():
    before = (torch.backends.cudnn.allow_tf32,
              torch.get_float32_matmul_precision())
    yield
    torch.backends.cudnn.allow_tf32 = before[0]
    torch.set_float32_matmul_precision(before[1])


def test_index_chunked_product_runs_in_full_f32(monkeypatch, restore_flags):
    rng = np.random.default_rng(0)
    g = rng.normal(size=(300, 48)).astype(np.float32)
    q = rng.normal(size=(5, 48)).astype(np.float32)
    index = GalleryIndex(g, [str(i) for i in range(300)], chunk=64,
                         device="cpu")
    seen = []
    matmul = torch.matmul

    def recording(*args, **kw):
        seen.append(torch.get_float32_matmul_precision())
        return matmul(*args, **kw)

    monkeypatch.setattr(torch, "matmul", recording)
    out = {}
    for precision in ("highest", "high"):
        torch.set_float32_matmul_precision(precision)
        out[precision] = index.search(q, k=16)
        assert torch.get_float32_matmul_precision() == precision
    assert seen and set(seen) == {"highest"}
    assert len(seen) == 2 * -(-300 // 64)       # one product per chunk
    np.testing.assert_array_equal(out["highest"][0], out["high"][0])
    np.testing.assert_array_equal(out["highest"][1], out["high"][1])


def _manifest(tmp_path, n=4):
    csv = tmp_path / "m.csv"
    csv.write_text("id,class\n" + "".join(
        f"{i:06d}_hair.png,{i % 2}\n" for i in range(n)))
    return str(csv)


def _record_flags(seen):
    def record(*args, **kw):
        seen.append((torch.backends.cudnn.allow_tf32,
                     torch.get_float32_matmul_precision()))
    return record


@pytest.mark.parametrize("dtype,want", [
    ("float32", (False, "highest")),
    ("bfloat16", (True, "high")),      # bf16 runs keep the caller's flags
])
def test_pretrain_cli_float32_runs_without_tf32(tmp_path, monkeypatch,
                                                restore_flags, dtype, want):
    seen = []
    monkeypatch.setattr(mainpretrain.Trainer, "train", _record_flags(seen))
    torch.backends.cudnn.allow_tf32 = True
    torch.set_float32_matmul_precision("high")
    mainpretrain.main([
        "--mode", "SHAM", "--model", "resnet18", "--size", "32", "--device",
        "cpu", "--dtype", dtype, "--batch_size", "2", "--epochs", "1",
        "--num_workers", "1", "--train_annotation", _manifest(tmp_path),
        "--img_dir", str(IMG_DIR), "--save_path", str(tmp_path / "out")])
    assert seen == [want]
    # the caller's flags are back once the run is over
    assert torch.backends.cudnn.allow_tf32
    assert torch.get_float32_matmul_precision() == "high"


@pytest.mark.parametrize("dtype,want", [
    ("float32", (False, "highest")),
    ("bfloat16", (True, "high")),
])
def test_knn_cli_float32_runs_without_tf32(tmp_path, monkeypatch,
                                           restore_flags, dtype, want):
    seen = []
    monkeypatch.setattr(knn_classification.Classifier, "knn_eval",
                        _record_flags(seen))
    torch.backends.cudnn.allow_tf32 = True
    torch.set_float32_matmul_precision("high")
    csv = _manifest(tmp_path)
    knn_classification.main([
        "--mode", "SHAM", "--model", "resnet18", "--size", "32", "--device",
        "cpu", "--dtype", dtype, "--batch_size", "2", "--eval_type", "knn",
        "--num_workers", "1", "--train_annotation", csv,
        "--test_annotation", csv, "--img_dir", str(IMG_DIR),
        "--save_path", str(tmp_path / "out")])
    assert seen == [want]
    assert torch.backends.cudnn.allow_tf32
    assert torch.get_float32_matmul_precision() == "high"
