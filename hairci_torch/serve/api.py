"""Retrieval serving API (port of ``hairci/serve/api.py``): the same routes
and JSON over the port's encoder and gallery index.

  GET  /health            -> {status, gallery_size, dim, model}
  GET  /stats             -> request counters + latency EWMAs (ms)
  POST /embed             {image_b64 | image_path} -> {embedding}
  POST /search            {image_b64 | images_b64 | image_path | embedding, k}
                          -> {paths, scores}
  POST /reload            re-load the gallery index from disk

The encoder is the hair encoder (ViT-B/16 at 224) or, with ``--encoder
face``, the face encoder (``--model_name VIT``, the default, or ``VITs``; at
112). Searches run through GalleryIndex (the CUDA top-k kernel for k <= 8 on
a card, chunked matmul otherwise).

    python -m hairci_torch.serve.api --index_dir DIR [--dataset_path DIR] \
        [--encoder hair|face] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import base64
import io
import json
import logging
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from hairci_torch.retrieval.index import GalleryIndex

log = logging.getLogger(__name__)


class RetrievalService:
    """Encoder + gallery index + counters; thread-safe. The index lives on
    the encoder's device."""

    def __init__(self, encoder, index_dir: str):
        self.encoder = encoder
        self.index_dir = index_dir
        self.device = encoder.device
        self._lock = threading.Lock()
        self.stats = {"embed_requests": 0, "search_requests": 0,
                      "errors": 0, "embed_ms_ewma": 0.0,
                      "search_ms_ewma": 0.0}
        self.index = None
        self.reload()

    def reload(self) -> int:
        with self._lock:
            if GalleryIndex.exists(self.index_dir):
                self.index = GalleryIndex.load(self.index_dir,
                                               device=self.device)
            else:
                self.index = None
        return len(self.index) if self.index is not None else 0

    def build(self, dataset_path: str) -> int:
        index = self.encoder.extract_dataset_features(dataset_path,
                                                      self.index_dir)
        with self._lock:
            self.index = index
        return len(index)

    # ------------------------------------------------------------------
    def _decode(self, payload: dict) -> np.ndarray:
        """payload -> (1, S, S, 3) uint8 via the encoder's preprocessing."""
        from PIL import Image

        if "image_path" in payload:
            return self.encoder._preprocess([payload["image_path"]])
        raw = base64.b64decode(payload["image_b64"])
        # encoder host transform (resize shorter side + center crop),
        # replicated here so /embed needs no temp file round-trip
        from hairci_torch.data.loader import _center_crop_uint8

        s = self.encoder.img_size
        with Image.open(io.BytesIO(raw)) as im:
            im = im.convert("RGB")
            w, h = im.size
            if w <= h:
                nw, nh = s, max(int(round(h * s / w)), s)
            else:
                nh, nw = s, max(int(round(w * s / h)), s)
            im = im.resize((nw, nh), Image.BICUBIC)
            arr = _center_crop_uint8(np.asarray(im, np.uint8), s)
        return arr[None]

    def _ewma(self, key: str, ms: float) -> None:
        old = self.stats[key]
        self.stats[key] = ms if old == 0 else 0.9 * old + 0.1 * ms

    def embed(self, payload: dict) -> np.ndarray:
        t0 = time.perf_counter()
        if "images_b64" in payload:
            batches = [self._decode({"image_b64": b})
                       for b in payload["images_b64"]]
            images = np.concatenate(batches)
        else:
            images = self._decode(payload)
        feats = self.encoder.extract_features(images)
        self.stats["embed_requests"] += 1
        self._ewma("embed_ms_ewma", (time.perf_counter() - t0) * 1e3)
        return feats

    def search(self, payload: dict):
        if self.index is None:
            raise RuntimeError("no gallery index loaded; POST /reload after "
                               "building, or start with --dataset_path")
        t0 = time.perf_counter()
        k = int(payload.get("k", 5))
        if "embedding" in payload:
            q = np.asarray(payload["embedding"], np.float32)
            if q.ndim == 1:
                q = q[None]
        else:
            q = self.embed(payload)
        scores, paths = self.index.search_paths(q, k)
        self.stats["search_requests"] += 1
        self._ewma("search_ms_ewma", (time.perf_counter() - t0) * 1e3)
        return scores, paths

    def health(self) -> dict:
        return {
            "status": "ok",
            "gallery_size": len(self.index) if self.index is not None else 0,
            "dim": self.index.dim if self.index is not None else None,
            "model": type(self.encoder).__name__,
        }


def make_handler(svc: RetrievalService):
    class Handler(BaseHTTPRequestHandler):
        def _json(self, obj, code: int = 200) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, fmt, *args):  # quiet
            log.debug(fmt, *args)

        def do_GET(self):  # noqa: N802
            if self.path == "/health":
                self._json(svc.health())
            elif self.path == "/stats":
                self._json(svc.stats)
            else:
                self._json({"error": "not found"}, 404)

        def do_POST(self):  # noqa: N802
            try:
                n = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(n) or b"{}")
                if self.path == "/embed":
                    feats = svc.embed(payload)
                    self._json({"embedding": feats.tolist()})
                elif self.path == "/search":
                    scores, paths = svc.search(payload)
                    self._json({"paths": [list(p) for p in paths],
                                "scores": scores.tolist()})
                elif self.path == "/reload":
                    self._json({"gallery_size": svc.reload()})
                else:
                    self._json({"error": "not found"}, 404)
            except Exception as e:  # noqa: BLE001 — report, keep serving
                log.exception("request to %s failed", self.path)
                svc.stats["errors"] += 1
                self._json({"error": str(e)}, 400)

    return Handler


def serve(encoder, index_dir: str, port: int = 8100,
          dataset_path: Optional[str] = None) -> ThreadingHTTPServer:
    svc = RetrievalService(encoder, index_dir)
    if svc.index is None and dataset_path:
        log.info("building index from %s", dataset_path)
        svc.build(dataset_path)
    server = ThreadingHTTPServer(("0.0.0.0", port), make_handler(svc))
    server.service = svc  # test hook
    return server


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="hairci retrieval serving API")
    p.add_argument("--encoder", default="hair", choices=["hair", "face"])
    p.add_argument("--checkpoint_path", default=None)
    p.add_argument("--model_name", default=None,
                   help="hair: vit_base_patch16 (default); face: VIT "
                        "(default) or VITs")
    p.add_argument("--index_dir", required=True)
    p.add_argument("--dataset_path", default=None,
                   help="build the index from this folder when missing")
    p.add_argument("--port", type=int, default=8100)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; no silent CPU path)")
    return p


def build_encoder(args: argparse.Namespace):
    """The encoder ``main`` serves, from its parsed flags."""
    from hairci_torch.retrieval.encoders import FaceEncoder, HairEncoder

    if args.encoder == "hair":
        return HairEncoder(args.checkpoint_path,
                           model_name=args.model_name or "vit_base_patch16",
                           device=args.device, batch_size=args.batch_size)
    return FaceEncoder(args.checkpoint_path,
                       model_name=args.model_name or "VIT",
                       device=args.device, batch_size=args.batch_size)


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO)
    args = build_parser().parse_args(argv)
    server = serve(build_encoder(args), args.index_dir, args.port,
                   args.dataset_path)
    log.info("retrieval API on :%d", args.port)
    server.serve_forever()


if __name__ == "__main__":
    main()
