"""The port's serving slice (hairci_torch) against the JAX package on the CPU:
tiny ViT encoders carrying the same weights in both, the same image folder,
the same index files, the same search results, and the port's HTTP API."""

import ast
import base64
import json
import pathlib
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from hairci.models.vit import VisionTransformer as JaxViT
from hairci.retrieval.encoders import HairEncoder as JaxHairEncoder
from hairci.retrieval.encoders import _EncoderBase as JaxEncoderBase
from hairci.retrieval.index import GalleryIndex as JaxGalleryIndex
from hairci.retrieval.torch_import import export_vit, save_torch_state_dict
from hairci_torch.cli import retrieval as cli
from hairci_torch.models.vit import VisionTransformer
from hairci_torch.ops.topk import topk_gallery_search
from hairci_torch.retrieval import encoders
from hairci_torch.retrieval.index import GalleryIndex
from hairci_torch.serve.api import serve

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
TINY = dict(patch_size=8, embed_dim=64, depth=2, num_heads=4, img_size=32)
N_IMAGES = 12


class _JaxTinyHair(JaxHairEncoder):
    """The JAX HairEncoder with a tiny f32 ViT at 32 px."""

    img_size = 32

    def __init__(self):
        self.model = JaxViT(**TINY, global_pool=True)
        JaxEncoderBase.__init__(self, None, batch_size=5)

    def _init_params(self):
        return self.model.init(jax.random.key(0), jnp.zeros((1, 32, 32, 3)),
                               train=False)["params"]


def _port_tiny_hair(ckpt):
    """The port's HairEncoder with the same tiny f32 ViT, loaded from a
    .pth written by export_vit (its torch-checkpoint path)."""
    enc = encoders.HairEncoder.__new__(encoders.HairEncoder)
    enc.img_size = 32
    enc.model = VisionTransformer(**TINY, global_pool=True)
    encoders._EncoderBase.__init__(enc, ckpt, 5, "cpu")
    return enc


@pytest.fixture(scope="module")
def slice_(tmp_path_factory):
    root = tmp_path_factory.mktemp("torchserve")
    data = root / "images"
    data.mkdir()
    rng = np.random.default_rng(0)
    for i in range(N_IMAGES):
        a = rng.integers(0, 256, (48, 40 + 4 * i, 3), dtype=np.uint8)
        Image.fromarray(a).save(data / f"{i:03d}.png")
    jax_enc = _JaxTinyHair()
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.05 * rng.standard_normal(p.shape).astype(
            np.float32), jax_enc.params)
    jax_enc.params = params
    ckpt = root / "tiny.pth"
    save_torch_state_dict(export_vit(params, depth=TINY["depth"]), str(ckpt))
    port_enc = _port_tiny_hair(str(ckpt))
    jax_index = jax_enc.extract_dataset_features(str(data), str(root / "jax"))
    port_index = port_enc.extract_dataset_features(str(data),
                                                   str(root / "port"))
    return dict(root=root, data=data, jax_enc=jax_enc, port_enc=port_enc,
                jax_index=jax_index, port_index=port_index)


def test_index_files_match_jax(slice_):
    root = slice_["root"]
    np.testing.assert_allclose(np.load(root / "port" / "embeddings.npy"),
                               np.load(root / "jax" / "embeddings.npy"),
                               atol=1e-5, rtol=0)
    assert ((root / "port" / "image_paths.txt").read_bytes()
            == (root / "jax" / "image_paths.txt").read_bytes())


@pytest.mark.parametrize("use_kernel,chunk", [(False, 65536), (False, 4),
                                              (True, 65536)])
def test_search_matches_jax(slice_, use_kernel, chunk):
    root = slice_["root"]
    emb = np.load(root / "jax" / "embeddings.npy")
    queries = emb[:6] + 0.1 * np.random.default_rng(1).normal(
        size=(6, emb.shape[1])).astype(np.float32)
    ref_s, ref_i = slice_["jax_index"].search(queries, k=5)
    index = GalleryIndex.load(str(root / "port"), device="cpu", chunk=chunk,
                              use_kernel=use_kernel)
    s, i = index.search(queries, k=5)
    np.testing.assert_array_equal(i, ref_i)
    np.testing.assert_allclose(s, ref_s, atol=1e-5)
    # bf16 storage ranks like the JAX bf16 index
    ref16 = JaxGalleryIndex(emb, slice_["jax_index"].paths, normalized=True,
                            storage_dtype=jnp.bfloat16).search(queries, k=5)
    ours16 = GalleryIndex(emb, index.paths, normalized=True, device="cpu",
                          storage_dtype=torch.bfloat16, chunk=chunk,
                          use_kernel=use_kernel).search(queries, k=5)
    np.testing.assert_array_equal(ours16[1], ref16[1])
    np.testing.assert_allclose(ours16[0], ref16[0], atol=1e-5)


def test_each_package_loads_the_others_index(slice_):
    root = slice_["root"]
    from_port = JaxGalleryIndex.load(str(root / "port"))
    from_jax = GalleryIndex.load(str(root / "jax"), device="cpu")
    assert from_port.paths == from_jax.paths == slice_["port_index"].paths
    np.testing.assert_array_equal(
        np.asarray(from_port.embeddings)[:len(from_port), :from_port.dim],
        np.load(root / "port" / "embeddings.npy"))
    np.testing.assert_array_equal(from_jax.embeddings.numpy(),
                                  np.load(root / "jax" / "embeddings.npy"))


def test_single_image_retrieval_matches_jax(slice_):
    path = str(slice_["data"] / "007.png")
    ref = slice_["jax_enc"].encode_single_image(path)
    feat = slice_["port_enc"].encode_single_image(path)
    np.testing.assert_allclose(feat, ref, atol=1e-5)
    paths, scores = slice_["port_enc"].retrieve_similar_images(
        feat, slice_["port_index"], top_k=5)
    ref_paths, _ = slice_["jax_enc"].retrieve_similar_images(
        ref, slice_["jax_index"], top_k=5)
    assert paths == ref_paths and paths[0] == path
    assert scores[0] == pytest.approx(1.0, abs=1e-5)


@pytest.fixture(scope="module")
def server(slice_):
    srv = serve(slice_["port_enc"], str(slice_["root"] / "srvidx"), port=0,
                dataset_path=str(slice_["data"]))
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield srv
    srv.shutdown()
    srv.server_close()
    t.join(timeout=30)
    assert not t.is_alive()


def _req(srv, path, payload=None):
    url = f"http://127.0.0.1:{srv.server_address[1]}{path}"
    if payload is None:
        r = urllib.request.urlopen(url, timeout=30)
    else:
        req = urllib.request.Request(
            url, data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"})
        try:
            r = urllib.request.urlopen(req, timeout=30)
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())
    return r.status, json.loads(r.read())


def test_api_routes(slice_, server):
    paths = slice_["port_index"].paths
    code, h = _req(server, "/health")
    assert code == 200 and h == {"status": "ok", "gallery_size": N_IMAGES,
                                 "dim": 64, "model": "HairEncoder"}
    code, s = _req(server, "/stats")
    assert code == 200 and "search_requests" in s
    raw = [base64.b64encode(open(p, "rb").read()).decode()
           for p in paths[3:5]]
    code, res = _req(server, "/search", {"image_b64": raw[0], "k": 3})
    assert code == 200 and set(res) == {"paths", "scores"}
    assert res["paths"][0][0] == paths[3]
    assert res["scores"][0][0] == pytest.approx(1.0, abs=1e-4)
    code, res = _req(server, "/search", {"images_b64": raw, "k": 5})
    assert code == 200 and [p[0] for p in res["paths"]] == paths[3:5]
    code, e = _req(server, "/embed", {"image_path": paths[5]})
    assert code == 200 and np.asarray(e["embedding"]).shape == (1, 64)
    code, res = _req(server, "/search", {"embedding": e["embedding"][0],
                                         "k": 2})
    assert code == 200 and res["paths"][0][0] == paths[5]
    code, r = _req(server, "/reload", {})
    assert code == 200 and r["gallery_size"] == N_IMAGES
    code, err = _req(server, "/search", {"image_b64": "!!!notbase64"})
    assert code == 400 and "error" in err
    code, _ = _req(server, "/nope", {})
    assert code == 404


def test_cli_runs_the_slice(slice_, monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(encoders, "build_vit",
                        lambda name, img_size, **kw: VisionTransformer(
                            **TINY, **kw))
    monkeypatch.setattr(encoders.HairEncoder, "img_size", 32)
    argv = ["--data_path", str(slice_["data"]), "--device", "cpu",
            "--embed_save_dir", str(tmp_path / "emb"), "--top_k", "3"]
    cli.run("hair", argv)
    out = capsys.readouterr().out.splitlines()
    assert out[0] == f"Query: {slice_['port_index'].paths[0]}"
    assert len(out) == 4 and out[1].startswith("  1. ")
    assert GalleryIndex.exists(str(tmp_path / "emb"))
    # --faiss_index imports a prebuilt gallery (tests/test_torch_faiss_io.py)
    # and refuses the extraction flags, as the JAX CLI does
    with pytest.raises(SystemExit, match="cannot be combined"):
        cli.run("hair", argv + ["--faiss_index", "x.index",
                                "--force_extract"])


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def _module_level_imports(path):
    """Imports outside every function (the ones an import runs)."""
    def walk(nodes):
        for node in nodes:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
                continue
            if isinstance(node, ast.Import):
                yield from (a.name for a in node.names)
            elif isinstance(node, ast.ImportFrom) and node.module:
                yield node.module
            yield from walk(ast.iter_child_nodes(node))
    yield from walk(ast.parse(path.read_text()).body)


def test_port_imports_no_jax():
    files = sorted((REPO / "hairci_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py"]
    assert len(files) > 10
    names = {str(f.relative_to(REPO)) for f in files}
    assert {"hairci_torch/eval/retrieval_metrics.py",
            "hairci_torch/train/mining.py", "hairci_torch/utils/metrics.py"
            } | {f"hairci_torch/experiments/dualview/{m}.py" for m in (
                "__init__", "data", "enhanced", "losses", "models",
                "qualitative_test", "quantitative_eval", "train")} <= names
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "optax", "orbax",
                               "hairci"), f"{f}: imports {mod}"
        # matplotlib only inside the functions that draw (render_grids)
        assert not any(m.split(".")[0] == "matplotlib"
                       for m in _module_level_imports(f)), f
    render = [node for node in ast.walk(ast.parse((
        REPO / "hairci_torch/experiments/dualview/qualitative_test.py"
    ).read_text())) if isinstance(node, ast.FunctionDef)
        and "matplotlib" in {a.name for n in ast.walk(node)
                             if isinstance(n, ast.Import) for a in n.names}]
    assert [f.name for f in render] == ["render_grids"]


def test_port_pulls_in_no_jax_at_runtime():
    # every module of the port, and chip_smoke.py; nor yaml, which the CLIs
    # import only for --config, nor matplotlib, which only the functions
    # that draw import
    code = ("import importlib, pathlib, sys\n"
            "mods = sorted('.'.join(p.with_suffix('').parts) for p in "
            "pathlib.Path('hairci_torch').rglob('*.py'))\n"
            "mods = [m[:-len('.__init__')] if m.endswith('.__init__') else m "
            "for m in mods]\n"
            "assert len(mods) > 60, mods\n"
            "assert {'hairci_torch.models.face_vit', "
            "'hairci_torch.retrieval.faiss_io', "
            "'hairci_torch.native.flatindex', "
            "'hairci_torch.preprocess.face_toolkit', "
            "'hairci_torch.serve.demo', "
            "'hairci_torch.serve.visualizer.server', "
            "'hairci_torch.cli.face_retrieval', "
            "'hairci_torch.ssl.dinov2', 'hairci_torch.ssl.msn', "
            "'hairci_torch.losses.distill', "
            "'hairci_torch.ssl.byol', 'hairci_torch.ssl.densecl', "
            "'hairci_torch.losses.dense', "
            "'hairci_torch.ssl.siameseim', 'hairci_torch.ssl.sham_v1', "
            "'hairci_torch.train.schedules', "
            "'hairci_torch.experiments.dualview', "
            "'hairci_torch.experiments.dualview.data', "
            "'hairci_torch.experiments.dualview.enhanced', "
            "'hairci_torch.experiments.dualview.losses', "
            "'hairci_torch.experiments.dualview.models', "
            "'hairci_torch.experiments.dualview.qualitative_test', "
            "'hairci_torch.experiments.dualview.quantitative_eval', "
            "'hairci_torch.experiments.dualview.train', "
            "'hairci_torch.eval.retrieval_metrics', "
            "'hairci_torch.train.mining', "
            "'hairci_torch.utils.metrics'} <= set(mods), mods\n"
            "for m in mods + ['chip_smoke']:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'yaml', 'hairci', "
            "'matplotlib'))\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)


def test_serving_api_imports_neither_pydantic_nor_the_visualizer():
    """``hairci_torch.serve`` imports nothing itself: the API and the demo
    run where pydantic (the visualizer's schemas) is not installed."""
    code = ("import sys\n"
            "import hairci_torch.serve.api, hairci_torch.serve.demo\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] == "
            "'pydantic' or 'visualizer' in m)\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)


def test_kernel_counter_untouched_on_cpu(slice_):
    before = topk_gallery_search.launches
    GalleryIndex.load(str(slice_["root"] / "port"), device="cpu",
                      use_kernel=True).search(np.ones((2, 64)), k=5)
    assert topk_gallery_search.launches == before
