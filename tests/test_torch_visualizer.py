"""The port's copy of the result visualizer
(``hairci_torch.serve.visualizer``) against the JAX package's: the cases of
``tests/test_serve.py`` on both copies, which must give the same JSON,
HTML and image bytes on every route of the stdlib server."""

import json
import threading
import urllib.request

import numpy as np
import pytest
from PIL import Image

import hairci.serve.visualizer.server as jax_server
from hairci.serve.visualizer import DataManager as JaxDataManager
from hairci.serve.visualizer import RetrievalAPI as JaxRetrievalAPI
from hairci.serve.visualizer.image_utils import \
    ResultProcessor as JaxResultProcessor
from hairci_torch.serve.visualizer import DataManager, RetrievalAPI, server
from hairci_torch.serve.visualizer.image_utils import (
    ResultProcessor,
    to_gt_name,
)


@pytest.fixture(scope="module")
def viz_data(tmp_path_factory):
    """Dataset tree with a benchmark, two models' result files and images
    (``tests/test_serve.py``'s)."""
    root = tmp_path_factory.mktemp("vizdata")
    ds = root / "hairstyle"
    (ds / "results").mkdir(parents=True)
    (ds / "hair").mkdir()
    (ds / "face").mkdir()
    rng = np.random.default_rng(0)
    for i in range(4):
        arr = rng.integers(0, 255, (32, 32, 3), dtype=np.uint8)
        Image.fromarray(arr).save(ds / "hair" / f"q{i}_hair.png")
    bench = [{"query_image": f"q{i}.jpg", "ground_truth": [f"q{i}.jpg"]}
             for i in range(4)]
    (ds / "benchmark.json").write_text(json.dumps(bench))
    for model, hits in (("modelA", True), ("modelB", False)):
        results = []
        for i in range(4):
            top = ([f"q{i}_hair.png"] if hits else []) + \
                [f"q{(i+j) % 4}_hair.png" for j in range(1, 4)]
            results.append({"query": f"q{i}.jpg", "top100": top})
        (ds / "results" / f"{model}_top100_results.json").write_text(
            json.dumps(results))
    return {"hairstyle": {
        "name": "test",
        "benchmark": str(ds / "benchmark.json"),
        "results_dir": str(ds / "results"),
        "mounts": {"hair": str(ds / "hair"), "face": str(ds / "face")},
    }}


def test_hits_and_misses_match_jax():
    args = (["a_hair.png", "b_hair.png", "c.jpg"], ["a.jpg", "c.jpg"], 2)
    assert ResultProcessor.compute_hits_and_misses(*args) == \
        JaxResultProcessor.compute_hits_and_misses(*args)
    rows, hits, misses = ResultProcessor.compute_hits_and_misses(
        ["a_hair.png", "b_hair.png"], ["a.jpg"])
    assert hits == 1 and misses == 1 and rows[0]["hit"]
    assert to_gt_name("x_hair.png") == "x.jpg"


def test_data_manager_and_api_match_jax(viz_data):
    api = RetrievalAPI(DataManager(viz_data))
    ref = JaxRetrievalAPI(JaxDataManager(viz_data))
    assert api.benchmarks() == ref.benchmarks() == ["hairstyle"]
    assert api.models("hairstyle") == ref.models("hairstyle") == \
        ["modelA", "modelB"]
    assert api.queries("hairstyle") == ref.queries("hairstyle")
    assert api.health().model_dump() == ref.health().model_dump() == \
        {"status": "ok", "benchmarks": 1, "models": 2}
    for q in api.queries("hairstyle") + ["absent.jpg"]:
        for models in (None, ["modelB"]):
            assert api.get_query_result("hairstyle", q, models).model_dump() \
                == ref.get_query_result("hairstyle", q, models).model_dump()
    result = api.get_query_result("hairstyle", "q0.jpg")
    a, b = result.models
    assert (a.model, a.hits, a.results[0].hit) == ("modelA", 1, True)
    assert (b.model, b.hits) == ("modelB", 0)


@pytest.mark.parametrize("dataset,query", [
    (None, None), ("hairstyle", None), ("hairstyle", "q2.jpg")])
def test_rendered_page_matches_jax(viz_data, dataset, query):
    page = server.render_index(RetrievalAPI(DataManager(viz_data)), dataset,
                               query, None)
    ref = jax_server.render_index(JaxRetrievalAPI(JaxDataManager(viz_data)),
                                  dataset, query, None)
    assert page == ref and "hits" in page


ROUTES = ["/health", "/api/benchmarks", "/api/models?dataset=hairstyle",
          "/api/queries?dataset=hairstyle",
          "/api/result?dataset=hairstyle&query=q0.jpg",
          "/api/result?dataset=hairstyle&query=q3.jpg&model=modelB",
          "/?dataset=hairstyle&query=q1.jpg", "/",
          "/images/hairstyle/q0_hair.png", "/reload"]


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=30) as r:
            return r.status, r.headers["Content-Type"], r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read()


def test_stdlib_servers_answer_alike(viz_data):
    servers = [server.serve_stdlib(datasets=viz_data, port=0),
               jax_server.serve_stdlib(datasets=viz_data, port=0)]
    threads = [threading.Thread(target=s.serve_forever, daemon=True)
               for s in servers]
    for t in threads:
        t.start()
    try:
        ports = [s.server_address[1] for s in servers]
        for path in ROUTES + ["/images/nowhere/x.png",
                              "/images/hairstyle/missing.png", "/nope"]:
            ours, ref = (_get(p, path) for p in ports)
            assert ours == ref, path
        assert _get(ports[0], "/health")[0] == 200
        assert json.loads(_get(ports[0], "/reload")[2]) == {
            "status": "reloaded"}
    finally:
        for s in servers:
            s.shutdown()
            s.server_close()
        for t in threads:
            t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)


def test_fastapi_app_needs_fastapi(viz_data):
    try:
        import fastapi  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError):
            server.create_fastapi_app(datasets=viz_data)
    else:
        app = server.create_fastapi_app(datasets=viz_data)
        assert {"/", "/health", "/api/result"} <= {r.path for r in app.routes}
