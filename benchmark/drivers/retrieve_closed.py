"""Retrieval traffic: closed-loop clients sending batches of query crops
through the port's serving path, ``HairEncoder.extract_features`` and then
``GalleryIndex.search``, the path of ``serve/api.py`` and
``cli/retrieval.py`` after decode.

A traffic file for this driver gives ``clients`` (threads of this
process; each sends its next request when its reply is back), ``sizes``
(the batch sizes each client cycles through, always in that order, client
c starting ``c / clients`` of a cycle later), ``k``, ``query_pool`` (the
distinct crops requests are cut from), ``warmup_rounds``,
``sample_requests`` (how many finished requests the reference checks) and
``trace_seconds``. The seed sets the pixels, the weights and the gallery,
never the sizes or their order.

Each request is timed from its send to its scores and indices back on the
host. The window is closed when the clients have stopped sending at
``--seconds`` and the last reply is back.
"""

from __future__ import annotations

import gc
import threading
import time
from typing import Dict, List

import torch

from harness import data
from harness.profiling import profiler, read_trace
from reference import retrieve as ret_ref


def schedule(traffic, client: int, r: int):
    """(size, first crop of the pool) of client ``client``'s ``r``-th
    request: the same for every seed."""
    sizes = traffic["sizes"]
    shift = (client * len(sizes)) // traffic["clients"]
    size = sizes[(r + shift) % len(sizes)]
    start = (client * 7919 + r * 131) % (traffic["query_pool"] - size + 1)
    return size, start


def serve_setup(cfg, tr, seed: int, device):
    """The program's encoder and index, and the pool of query crops, made
    from the seed as a run sets them up."""
    from hairci_torch.retrieval.encoders import HairEncoder
    from hairci_torch.retrieval.index import GalleryIndex

    model, serve = cfg["model"], cfg["serve"]
    encoder = HairEncoder(model_name=model["serve_name"], device=device,
                          dtype=getattr(torch, cfg["dtype"]))
    encoder.model.load_state_dict(
        data.make_params(ret_ref.leaves(cfg), seed, device), strict=True)
    gallery = data.make_gallery(serve["gallery_rows"],
                                model["arch"]["width"], seed, device)
    index = GalleryIndex(gallery.cpu().numpy(),
                         [str(i) for i in range(serve["gallery_rows"])],
                         normalized=True,
                         storage_dtype=getattr(torch, serve["gallery_dtype"]),
                         device=device)
    del gallery
    pool = data.make_images(tr["query_pool"], cfg["img_size"], seed,
                            data.QUERIES, device).cpu().numpy()
    return encoder, index, pool


def answer(embed, search, pool, size: int, start: int, k: int):
    """One request: its crops embedded, then searched; the host clock at
    its send, between the two calls and at its answer, and the answer."""
    t0 = time.perf_counter()
    emb = embed(pool[start:start + size])
    t1 = time.perf_counter()
    scores, idx = search(emb, k)
    t2 = time.perf_counter()
    return t0, t1, t2, emb, scores, idx


def run(cell, seed: int, seconds: float, trace: bool, device,
        t_start: float, program=None) -> Dict[str, object]:
    """One run of the cell; ``program`` (encoder, index) -> (embed, search)
    replaces the two calls (the benchmark's own tests plant faults
    through it)."""
    cfg, tr = cell.config, cell.traffic
    device = torch.device(device)
    encoder, index, pool = serve_setup(cfg, tr, seed, device)
    embed, search = (program(encoder, index) if program else
                     (encoder.extract_features, index.search))
    k = tr["k"]

    def request(size: int, start: int):
        return answer(embed, search, pool, size, start, k)

    for _ in range(tr["warmup_rounds"]):
        for size in tr["sizes"]:
            request(size, 0)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_start

    done: List[List[dict]] = [[] for _ in range(tr["clients"])]
    errors: List[BaseException] = []
    t_end = [0.0]

    def client(c: int):
        r = 0
        try:
            while time.perf_counter() < t_end[0]:
                size, start = schedule(tr, c, r)
                t0, t1, t2, emb, scores, idx = request(size, start)
                done[c].append({"c": c, "r": r, "size": size, "start": start,
                                "t0": t0, "t1": t1, "t2": t2, "emb": emb,
                                "scores": scores, "idx": idx})
                r += 1
        except BaseException as e:   # recorded, counted as failed
            errors.append(e)

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(tr["clients"])]
    prof, traced = None, None
    if trace:
        prof = profiler(device)
        prof.start()
    t0 = time.perf_counter()
    t_end[0] = t0 + seconds
    for t in threads:
        t.start()
    if prof is not None:
        time.sleep(max(0.0, t0 + tr["trace_seconds"] - time.perf_counter()))
        traced = (t0, time.perf_counter())
        prof.stop()
    for t in threads:
        t.join()
    reqs = [q for per in done for q in per]
    window_s = max([q["t2"] for q in reqs], default=t0) - t0
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    rec = {"kind": "retrieve", "setup_s": setup_s, "window_s": window_s,
           "latency_ms": [(q["t2"] - q["t0"]) * 1e3 for q in reqs],
           "images": sum(q["size"] for q in reqs), "peak_bytes": peak,
           "requests": [{k: q[k] for k in ("c", "r", "size", "start")}
                        for q in reqs],
           "attempted": len(reqs) + len(errors), "failed": len(errors),
           "config": cfg, "traffic": tr}
    if prof is not None:
        lo, hi = traced
        inside = [q for q in reqs if lo <= q["t0"] and q["t2"] <= hi]
        rec["trace"] = read_trace(prof)
        rec["trace_window_s"] = hi - lo
        rec["traced"] = [{"size": q["size"], "embed_ms": (q["t1"] - q["t0"])
                          * 1e3, "search_ms": (q["t2"] - q["t1"]) * 1e3}
                         for q in inside]
        rec["traced_images"] = sum(q["size"] for q in inside)

    # the reference, on a sample of the finished requests, once the
    # program's state is freed
    encoder = index = embed = search = None
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    order = sorted(reqs, key=lambda q: (q["t0"], q["r"]))
    largest = max(range(len(order)), key=lambda i: order[i]["size"],
                  default=None)
    picked = data.sample(seed, len(order), tr["sample_requests"],
                         must=() if largest is None else (largest,))
    sample = [order[i] for i in picked]
    rec["checks"] = ret_ref.check(cfg, seed, device, pool, sample)
    return rec
