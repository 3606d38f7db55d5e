#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``hairci_torch``) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:
  1. device  -- the card's name and power limit; TF32 off for matmul and conv.
  2. build   -- nvcc builds every kernel of the serving path from csrc/.
  3. kernels -- each kernel against its plain PyTorch twin on the card, at the
                serving path's shapes, with median times of both.
  4. serve   -- a full-width ViT-B/16 HairEncoder (bf16, seeded random
                weights) behind ``hairci_torch.serve.api.serve``: index the
                repo's images, answer /health, /search, /embed, /reload, then
                search a 103,945-row gallery; the kernels' launch counters
                must show that /search went through them.
  5. parity  -- the same weights in f32 on the CPU against bf16 on the card.
The last two lines are the kernels' JSON record and
``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

from __future__ import annotations

import base64
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

REPO = os.path.dirname(os.path.abspath(__file__))
DATASET = os.path.join(REPO, "HairPretraining", "data", "hair_regions")
GALLERY_ROWS = 103_945   # the kNN gallery size of the README's benchmark
WIDTH = 768              # ViT-B/16 embedding width
SEED = 0


def _median_ms(fn, runs: int = 30, warmup: int = 5) -> float:
    """Median device time of ``fn`` over ``runs`` calls, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


# ---------------------------------------------------------------------------
# phase 1: device
# ---------------------------------------------------------------------------

def phase_device() -> dict:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}


# ---------------------------------------------------------------------------
# phase 2: build
# ---------------------------------------------------------------------------

def phase_build() -> None:
    from hairci_torch.ops import _build

    path, seconds, log = _build.build("topk")
    print(f"build topk: {seconds:.2f} s -> "
          f"{os.path.relpath(path, REPO)}")
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())


# ---------------------------------------------------------------------------
# phase 3: kernel against its twin
# ---------------------------------------------------------------------------

def _check_topk(q, g, k, atol, n_valid=None, exact=False) -> float:
    """Kernel against the twin on one input; returns the max score error."""
    import torch

    from hairci_torch.ops.topk import (
        topk_gallery_search,
        topk_gallery_search_reference,
    )

    n = g.shape[0] if n_valid is None else n_valid
    s, i = topk_gallery_search(q, g, k, n_valid=n_valid)
    torch.cuda.synchronize()
    kk = min(k, n)
    rs, ri = topk_gallery_search_reference(q, g[:n], min(kk + 1, n))
    if s.shape != (q.shape[0], kk) or i.dtype != torch.int64:
        raise AssertionError(f"topk shape {tuple(s.shape)} {i.dtype}")
    err = (s - rs[:, :kk]).abs().max().item()
    if not err <= atol:
        raise AssertionError(f"topk scores differ by {err} > {atol} "
                             f"(N={n} k={k} {g.dtype})")
    if exact:
        same = torch.equal(i, ri[:, :kk])
    else:
        # an index may differ only where the twin's neighbouring scores are
        # within 1e-5: the two sum in other orders
        inf = torch.full_like(rs[:, :1], float("inf"))
        prev = torch.cat([inf, rs[:, :-1] - rs[:, 1:]], 1)[:, :kk]
        nxt = torch.cat([rs[:, :-1] - rs[:, 1:], inf], 1)[:, :kk]
        clear = torch.minimum(prev, nxt) > 1e-5
        same = bool(((i == ri[:, :kk]) | ~clear).all())
    if not same:
        raise AssertionError(f"topk indices differ (N={n} k={k} {g.dtype})")
    return err


def phase_kernels() -> dict:
    import torch

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def unit(n, d=WIDTH):
        x = torch.randn(n, d, device=dev, generator=gen)
        return x / x.norm(dim=1, keepdim=True)

    g32 = unit(GALLERY_ROWS)
    galleries = {"f32": (g32, 1e-5), "bf16": (g32.bfloat16(), 1e-4)}
    max_err = {"f32": 0.0, "bf16": 0.0}
    for Q in (1, 256):
        # queries near gallery rows, so each has a clear nearest neighbour
        rows = torch.randint(0, GALLERY_ROWS, (Q,), device=dev, generator=gen)
        q = g32[rows] + 0.3 * unit(Q) / WIDTH ** 0.5
        q = (q / q.norm(dim=1, keepdim=True)).contiguous()
        for name, (g, atol) in galleries.items():
            for k in (1, 5, 8, 16):
                err = _check_topk(q, g, k, atol)
                max_err[name] = max(max_err[name], err)
            err = _check_topk(q, g, 5, atol, n_valid=GALLERY_ROWS - 1000)
            max_err[name] = max(max_err[name], err)
    # exact ties: rows i and i + half are equal, the lower index must win
    half = unit(2048)
    dup = torch.cat([half, half]).contiguous()
    from hairci_torch.ops.topk import topk_gallery_search

    _check_topk(half[:64].contiguous(), dup, 4, 1e-5, exact=True)
    _, i = topk_gallery_search(half[:64].contiguous(), dup, 2)
    want = torch.arange(64, device=dev)
    if not (torch.equal(i[:, 0], want) and torch.equal(i[:, 1], want + 2048)):
        raise AssertionError("topk tie order: the lower index must win")
    # fewer rows than k
    _check_topk(unit(4), unit(3), 8, 1e-5, exact=True)
    print(f"topk vs twin: ok; max |score err| f32 {max_err['f32']:.3g} "
          f"bf16 {max_err['bf16']:.3g}")

    from hairci_torch.ops.topk import topk_gallery_search_reference

    times = {}
    for Q in (1, 256):
        q = unit(Q)
        for name, (g, _) in galleries.items():
            kern = _median_ms(lambda: topk_gallery_search(q, g, 5))
            twin = _median_ms(lambda: topk_gallery_search_reference(q, g, 5))
            times[(Q, name)] = (kern, twin)
            print(f"topk Q={Q} N={GALLERY_ROWS} D={WIDTH} k=5 {name}: "
                  f"kernel {kern:.4f} ms, twin {twin:.4f} ms")
    del g32, galleries
    torch.cuda.empty_cache()
    return {"max_abs_err": max_err["f32"], "times": times}


# ---------------------------------------------------------------------------
# phase 4: the serving slice through its entry point
# ---------------------------------------------------------------------------

def _request(server, path, payload=None):
    url = f"http://127.0.0.1:{server.server_address[1]}{path}"
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        if r.status != 200:
            raise AssertionError(f"{path}: HTTP {r.status}")
        return json.loads(r.read())


def _write_big_gallery(index_dir: str, rows: int) -> list:
    """The real embeddings followed by seeded unit-norm rows, as an index
    directory; returns the real rows' paths."""
    import numpy as np

    real = np.load(os.path.join(index_dir, "embeddings.npy"))
    with open(os.path.join(index_dir, "image_paths.txt")) as f:
        paths = f.read().splitlines()
    extra = np.random.default_rng(SEED).standard_normal(
        (rows - len(real), real.shape[1]), dtype=np.float32)
    extra /= np.linalg.norm(extra, axis=1, keepdims=True)
    np.save(os.path.join(index_dir, "embeddings.npy"),
            np.concatenate([real, extra]))
    with open(os.path.join(index_dir, "image_paths.txt"), "w") as f:
        f.write("\n".join(paths + [f"synthetic/{i:06d}"
                                   for i in range(len(real), rows)]) + "\n")
    return paths


def phase_serve(workdir: str):
    import numpy as np
    import torch

    from hairci_torch.ops.topk import topk_gallery_search
    from hairci_torch.retrieval.encoders import HairEncoder
    from hairci_torch.serve.api import serve

    t0 = time.perf_counter()
    encoder = HairEncoder(None, "vit_base_patch16", device="cuda")
    print(f"HairEncoder vit_base_patch16 bf16 on cuda: "
          f"{time.perf_counter() - t0:.2f} s to build")
    index_dir = os.path.join(workdir, "index")

    topk_gallery_search.launches = 0
    searches = 0
    t0 = time.perf_counter()
    server = serve(encoder, index_dir, port=0, dataset_path=DATASET)
    print(f"serve(): indexed the dataset in {time.perf_counter() - t0:.2f} s")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        health = _request(server, "/health")
        n_images = len(server.service.index)
        if health != {"status": "ok", "gallery_size": n_images, "dim": WIDTH,
                      "model": "HairEncoder"} or n_images != 128:
            raise AssertionError(f"/health: {health}")
        paths = list(server.service.index.paths)
        target = paths[2]
        res = _request(server, "/search", {"image_path": target, "k": 5})
        searches += 1
        print(f"/search image_path {os.path.basename(target)}: "
              f"{[os.path.basename(p) for p in res['paths'][0]]} "
              f"{res['scores'][0]}")
        if res["paths"][0][0] != target or res["scores"][0][0] < 0.99:
            raise AssertionError("/search by image_path: rank 1 is not the "
                                 "image itself at score >= 0.99")
        four = paths[10:14]
        b64 = [base64.b64encode(open(p, "rb").read()).decode() for p in four]
        res = _request(server, "/search", {"images_b64": b64, "k": 5})
        searches += 1
        top1 = [row[0] for row in res["paths"]]
        print(f"/search images_b64 x4: rank-1 scores "
              f"{[row[0] for row in res['scores']]}")
        if top1 != four or np.asarray(res["scores"]).shape != (4, 5):
            raise AssertionError(f"/search images_b64: rank 1 {top1}")
        emb = np.asarray(_request(server, "/embed",
                                  {"image_path": paths[5]})["embedding"])
        if emb.shape != (1, WIDTH) or abs(np.linalg.norm(emb) - 1) > 1e-4:
            raise AssertionError(f"/embed: shape {emb.shape}")

        real = _write_big_gallery(index_dir, GALLERY_ROWS)
        t0 = time.perf_counter()
        reloaded = _request(server, "/reload", {})["gallery_size"]
        print(f"/reload: {reloaded} rows in "
              f"{time.perf_counter() - t0:.2f} s")
        if reloaded != GALLERY_ROWS:
            raise AssertionError(f"/reload: {reloaded} rows")
        stored = server.service.index.embeddings
        latencies = []
        for i in range(20):
            q = stored[i].float().cpu().numpy().tolist()
            t0 = time.perf_counter()
            res = _request(server, "/search", {"embedding": q, "k": 5})
            latencies.append((time.perf_counter() - t0) * 1e3)
            searches += 1
            if res["paths"][0][0] != real[i]:
                raise AssertionError(f"self-retrieval failed for row {i}")
        latencies.sort()
        print(f"/search by embedding, {GALLERY_ROWS} rows, k=5: p50 "
              f"{latencies[10]:.3f} ms over 20 requests (HTTP round trip)")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    launches = topk_gallery_search.launches
    print(f"topk kernel launches during the serve run: {launches} for "
          f"{searches} searches")
    if launches < searches:
        raise AssertionError("/search did not go through the top-k kernel")

    batch = encoder._preprocess(
        [paths[i % len(paths)] for i in range(64)])
    x = torch.from_numpy(batch).cuda()
    with torch.no_grad():
        fwd_ms = _median_ms(lambda: encoder._embed_fn(x), runs=20, warmup=3)
    host = []
    for _ in range(10):
        t0 = time.perf_counter()
        encoder.extract_features(batch)
        host.append(time.perf_counter() - t0)
    host.sort()
    print(f"embed batch 64 at 224: forward {fwd_ms:.3f} ms "
          f"({64e3 / fwd_ms:.1f} img/s device), extract_features "
          f"{host[5] * 1e3:.3f} ms ({64 / host[5]:.1f} img/s with copies)")
    return encoder, paths, launches


# ---------------------------------------------------------------------------
# phase 5: the card against the CPU
# ---------------------------------------------------------------------------

def phase_parity(encoder, paths) -> None:
    import numpy as np
    import torch

    from hairci_torch.retrieval.encoders import HairEncoder

    cpu = HairEncoder(None, "vit_base_patch16", device="cpu",
                      dtype=torch.float32)
    images = encoder._preprocess(paths[:4])
    cos = np.sum(cpu.extract_features(images)
                 * encoder.extract_features(images), axis=1)
    print(f"bf16 cuda vs f32 cpu cosine: {cos.tolist()}")
    if not np.all(cos >= 0.99):
        raise AssertionError("card and CPU embeddings disagree")


def main() -> int:
    if not os.path.isdir(os.path.join(REPO, "hairci_torch")):
        raise SystemExit("chip_smoke: hairci_torch/ not found beside "
                         "chip_smoke.py; run it from a checkout of the repo")
    sys.path.insert(0, REPO)
    device = phase_device()
    phase_build()
    kern = phase_kernels()
    # the index is written inside the checkout and removed afterwards
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_",
                                     dir=REPO) as workdir:
        encoder, paths, launches = phase_serve(workdir)
    phase_parity(encoder, paths)
    print(json.dumps({"kernels": [{
        "name": "topk_gallery_search", "route": "cuda",
        "source": "hairci_torch/ops/csrc/topk.cu",
        "replaces": "hairci/ops/topk_pallas.py:43",
        "launches": launches,
        "max_abs_err": kern["max_abs_err"],
        "ms": kern["times"][(1, "f32")][0],
        "plain_ms": kern["times"][(1, "f32")][1]}]}))
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
