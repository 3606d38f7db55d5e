"""HTTP servers for the Visualizer.

  - `serve_stdlib` — dependency-free http.server implementation with the
    reference's routes (`/`, `/api/result`, `/api/benchmarks`,
    `/api/models`, `/api/queries`, `/health`, `/reload`) + static image
    mounts, so the app runs without fastapi;
  - `create_fastapi_app` — same routes on FastAPI + Jinja2 when installed
    (parity with the reference's `Visualizer/app/main.py:44-174`).

CLI: python -m hairci_torch.serve.visualizer.server --data_root data --port 8000
"""

from __future__ import annotations

import argparse
import html
import json
import logging
import mimetypes
import os
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from hairci_torch.serve.visualizer.data_manager import DataManager
from hairci_torch.serve.visualizer.image_utils import ImagePathResolver
from hairci_torch.serve.visualizer.retrieval_api import RetrievalAPI

log = logging.getLogger(__name__)


def render_index(api: RetrievalAPI, dataset: Optional[str],
                 query: Optional[str], models) -> str:
    """Render via the Jinja2 templates (parity with the reference's
    `templates/index.html`+`base.html`); inline-HTML fallback when jinja2
    is absent."""
    datasets = api.benchmarks()
    dataset = dataset or (datasets[0] if datasets else None)
    try:
        import jinja2

        env = jinja2.Environment(
            loader=jinja2.PackageLoader("hairci_torch.serve.visualizer",
                                        "templates"),
            autoescape=True)
        env.filters["urlencode"] = urllib.parse.quote
        queries = api.queries(dataset) if dataset else []
        query = query or (queries[0] if queries else None)
        result = (api.get_query_result(dataset, query, models)
                  if dataset and query else None)
        return env.get_template("index.html").render(
            datasets=datasets, dataset=dataset, queries=queries[:500],
            query=query, result=result)
    except ImportError:
        pass
    parts = ["<html><head><title>Hair Retrieval Visualizer</title>",
             "<style>.hit{border:3px solid #2a2}.miss{border:3px solid #c33}"
             "img{width:96px;height:96px;object-fit:cover;margin:2px}"
             ".model{display:inline-block;vertical-align:top;width:49%}"
             "</style></head><body>"]
    parts.append("<h1>Hair Retrieval Visualizer</h1>")
    parts.append("<form method='get'>")
    parts.append("<select name='dataset'>" + "".join(
        f"<option {'selected' if d == dataset else ''}>{html.escape(d)}</option>"
        for d in datasets) + "</select>")
    if dataset:
        queries = api.queries(dataset)
        query = query or (queries[0] if queries else None)
        parts.append("<select name='query'>" + "".join(
            f"<option {'selected' if q == query else ''}>{html.escape(q)}</option>"
            for q in queries[:500]) + "</select>")
    parts.append("<button type='submit'>Show</button></form>")
    if dataset and query:
        result = api.get_query_result(dataset, query, models)
        parts.append(f"<h2>Query: {html.escape(result.query)} "
                     f"({len(result.ground_truth)} ground-truth)</h2>")
        for mr in result.models:
            parts.append(f"<div class='model'><h3>{html.escape(mr.model)} — "
                         f"{mr.hits} hits / {mr.misses} misses</h3>")
            for pair in mr.results:
                cls = "hit" if pair.hit else "miss"
                src = f"/images/{dataset}/{urllib.parse.quote(pair.image)}"
                parts.append(
                    f"<img class='{cls}' src='{src}' title='#{pair.rank}'>")
            parts.append("</div>")
    parts.append("</body></html>")
    return "".join(parts)


def make_handler(api: RetrievalAPI, resolvers):
    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, body: bytes, ctype: str) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Access-Control-Allow-Origin", "*")  # CORS
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _json(self, obj, code: int = 200) -> None:
            self._send(code, json.dumps(obj).encode(), "application/json")

        def log_message(self, fmt, *args):  # quiet
            log.debug(fmt, *args)

        def do_GET(self):  # noqa: N802
            parsed = urllib.parse.urlparse(self.path)
            qs = urllib.parse.parse_qs(parsed.query)
            path = parsed.path

            if path == "/health":
                return self._json(api.health().model_dump())
            if path == "/reload":
                api.manager.reload_data()
                return self._json({"status": "reloaded"})
            if path == "/api/benchmarks":
                return self._json(api.benchmarks())
            if path == "/api/models":
                return self._json(api.models(qs.get("dataset", [""])[0]))
            if path == "/api/queries":
                return self._json(api.queries(qs.get("dataset", [""])[0]))
            if path == "/api/result":
                dataset = qs.get("dataset", [""])[0]
                query = qs.get("query", [""])[0]
                models = qs.get("model") or None
                result = api.get_query_result(dataset, query, models)
                return self._json(result.model_dump())
            if path.startswith("/images/"):
                _, _, dataset, name = path.split("/", 3)
                resolver = resolvers.get(dataset)
                if resolver is None:
                    return self._json({"error": "unknown dataset"}, 404)
                fpath = resolver.resolve(urllib.parse.unquote(name))
                if not os.path.exists(fpath):
                    return self._json({"error": "not found"}, 404)
                ctype = mimetypes.guess_type(fpath)[0] or "image/png"
                with open(fpath, "rb") as f:
                    return self._send(200, f.read(), ctype)
            if path == "/":
                dataset = qs.get("dataset", [None])[0]
                query = qs.get("query", [None])[0]
                models = qs.get("model") or None
                page = render_index(api, dataset, query, models)
                return self._send(200, page.encode(), "text/html")
            return self._json({"error": "not found"}, 404)

        do_POST = do_GET  # reference index accepts POST too

    return Handler


def serve_stdlib(data_root: str = "data", port: int = 8000,
                 datasets=None) -> ThreadingHTTPServer:
    manager = DataManager(datasets, data_root)
    api = RetrievalAPI(manager)
    resolvers = {name: ImagePathResolver(cfg["mounts"])
                 for name, cfg in manager.datasets.items()}
    server = ThreadingHTTPServer(("0.0.0.0", port),
                                 make_handler(api, resolvers))
    return server


def create_fastapi_app(data_root: str = "data", datasets=None):
    """FastAPI variant (when fastapi is installed)."""
    from fastapi import FastAPI
    from fastapi.middleware.cors import CORSMiddleware
    from fastapi.responses import HTMLResponse

    manager = DataManager(datasets, data_root)
    api = RetrievalAPI(manager)
    app = FastAPI(title="Hair Retrieval Visualizer")
    app.add_middleware(CORSMiddleware, allow_origins=["*"],
                       allow_methods=["*"], allow_headers=["*"])

    @app.get("/", response_class=HTMLResponse)
    def index(dataset: str = None, query: str = None):
        return render_index(api, dataset, query, None)

    @app.get("/health")
    def health():
        return api.health()

    @app.get("/reload")
    def reload_():
        manager.reload_data()
        return {"status": "reloaded"}

    @app.get("/api/benchmarks")
    def benchmarks():
        return api.benchmarks()

    @app.get("/api/models")
    def models(dataset: str):
        return api.models(dataset)

    @app.get("/api/queries")
    def queries(dataset: str):
        return api.queries(dataset)

    @app.get("/api/result")
    def result(dataset: str, query: str):
        return api.get_query_result(dataset, query)

    return app


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser()
    p.add_argument("--data_root", default="data")
    p.add_argument("--port", type=int, default=8000)
    args = p.parse_args(argv)
    server = serve_stdlib(args.data_root, args.port)
    log.info("visualizer serving on :%d", args.port)
    server.serve_forever()


if __name__ == "__main__":
    main()
