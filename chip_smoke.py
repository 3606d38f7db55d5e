#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``hairci_torch``) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:
  1. device  -- the card's name and power limit; TF32 off for matmul and conv.
  2. build   -- nvcc builds every kernel from csrc/, one process per source,
                all started together; ptxas' registers and spills, and the
                occupancy that follows for the conv3x3 tensor-core kernel
                and the bn_stats kernel.
  3. kernels -- each kernel against its plain PyTorch twin on the card, at the
                shapes of the serving, training and evaluation paths (the
                top-k on both its routes, each where plan() sends it and
                at its edges, timed at Q = 1, 16, 64, 256 on the route
                plan() takes). Two
                times per kernel and shape: the card's (50 calls back to back
                inside one pair of CUDA events while the host is ahead) and
                the host's (perf_counter round one call, no synchronise);
                the twin's median time, the least time the card could take
                for the same bytes and operations, and, where one PyTorch
                call computes the same function, that call's time. bn_stats
                and conv3x3 are also run twice for equal bits; conv3x3
                reports which of its two kernels each shape took, and a
                Conv2d whose weight was updated in place must read the new
                weights. Rotate is held bitwise without the blur and within
                2e-6 with it at the step's batch, at seven odd shapes
                (contiguous and in NCHW order) and on the step's own
                strided SimCLR view, and timed on both routes.
  4. serve   -- a full-width ViT-B/16 HairEncoder (bf16, seeded random
                weights) behind ``hairci_torch.serve.api.serve``: index the
                repo's images, answer /health, /search, /embed, /reload, then
                search a 103,945-row gallery, one query at a time and 256 in
                one request; the kernels' launch counters must show that
                /search went through both routes of the top-k.
  5. parity  -- the same weights in f32 on the CPU against bf16 on the card.
  6. train   -- ResNet-50 SHAM at 224, bf16, B=64, seeded random weights,
                through ``hairci_torch.cli.mainpretrain.main`` for 3 epochs
                of 2 steps (warmup, mine, mined) on the repo's 64 hair crops
                listed twice (the strides of the view the step hands to
                positive_transform are printed); the launch counters must
                show every step went
                through the rotate kernel and every train-mode BN through the
                stats kernel, and every forward without gradient (the EMA
                teacher's) through the conv3x3 kernel. Then 10 timed warmup
                and mined steps each.
  7. knn     -- ``hairci_torch.cli.knn_classification.main`` on the
                checkpoint phase 6 wrote: ResNet-50 at 224, bf16, batches of
                48 (the last of each loader padded), the 128-row manifest as
                train and the 64 images as test, all seven ks; every eval
                forward must launch the conv3x3 kernel 3 times and the stats
                kernel never; unit-norm features; self-retrieval at k=1.
  8. knn at full size -- ``knn_predict_multi`` on seeded clustered features,
                103,945 x 2048 gallery, 61 classes, 4096 queries, the seven
                ks; 512 queries against the port on the CPU; exact ties by
                index; top-k + tie repair against a stable sort of the scores.
  9. embed   -- ResNet-50 eval forward at 224, bf16, batch 64: with the
                conv3x3 kernel and with those three convs sent to F.conv2d;
                bf16 on the card against f32 on the CPU.
 10. train parity -- one warmup step of ResNet-50 at 224, B=8, f32, on the
                card and on the CPU from identical weights, views and draws.
The last two lines are the kernels' JSON record and
``{"ok": true, "device": {...}}``. Imports nothing of JAX.

With ``--kernel-times [DIR]`` it only times the bn_stats, Conv2d, top-k and
rotate wrappers of the ``hairci_torch`` package under DIR (see
``kernel_times``).
"""

from __future__ import annotations

import base64
import json
import math
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
TRAIN_BATCH = 64         # the SHAM step's batch on one card (config: 256)
SIZE = 224
KERNELS = ("topk", "rotate", "bn_stats", "conv3x3")
KNN_BATCH = 64           # the embed batch of the full-width kNN phases
CLI_BATCH = 48           # the batch the kNN CLI is driven at (pads a last one)
HBM_BYTES_PER_S = 3.35e12   # H100 SXM: HBM3
# dense tensor-core bf16 and TF32; f32 FMAs outside the tensor cores
PEAK_FLOPS = {"bf16": 989e12, "tf32": 495e12, "f32": 67e12}


def _bound(nbytes: float, flops: float, kind: str) -> tuple:
    """(least ms the card could take, what bounds it): the larger of the
    bytes over the memory rate and the operations over the peak rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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


BACK_TO_BACK = 50   # calls inside one event pair for a kernel's card time


def _host_ms(fn, n: int = BACK_TO_BACK, warmup: int = 5) -> float:
    """Median host time of one call of ``fn``: ``time.perf_counter`` round
    each of ``n`` calls, no synchronise inside. What the wrapper and the
    launch cost the thread that drives the card."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    times.sort()
    return times[len(times) // 2]


def _card_ms(fn, host_ms: float, n: int = BACK_TO_BACK) -> float:
    """The card's time for one call of ``fn``: ``n`` calls back to back
    inside one pair of CUDA events, divided by ``n``. The card first spins
    in a sleep kernel for longer than the host needs to enqueue all ``n``
    (``host_ms`` each), so it never waits for the host between two calls;
    that the host stayed ahead is checked (the start event has not been
    reached when the last call is enqueued; else the round is made again
    with a longer sleep). Two rounds, the lower one."""
    import torch

    best, rounds, spin = float("inf"), 0, 2.0 * n * host_ms + 2.0
    for attempt in range(6):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        # at most 2e6 cycles a ms at the card's clock
        torch.cuda._sleep(int(2e6 * spin))
        start.record()
        for _ in range(n):
            fn()
        ahead = not start.query()
        end.record()
        end.synchronize()
        if not ahead:       # the host was held up: spin longer, try again
            spin *= 2.0
            continue
        best = min(best, start.elapsed_time(end) / n)
        rounds += 1
        if rounds == 2:
            return best
    raise AssertionError("the card caught up with the host inside a "
                         "back-to-back timing, six times")


def _kernel_times(fn) -> tuple:
    """(the card's ms, the host's ms) of one call of a kernel's wrapper."""
    host = _host_ms(fn)
    return _card_ms(fn, host), host


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
    from concurrent.futures import ThreadPoolExecutor

    from hairci_torch.ops import _build

    with ThreadPoolExecutor(len(KERNELS)) as pool:
        built = list(pool.map(_build.build, KERNELS))
    for name, (path, seconds, log) in zip(KERNELS, built):
        print(f"build {name}: {seconds:.2f} s -> "
              f"{os.path.relpath(path, REPO)}")
        entry = ""
        for line in log.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1]
            if "registers" in line or "spill" in line:
                print("  ptxas:", line.strip())
            if "registers" in line:
                _print_occupancy(entry, line)


# threads per block and dynamic shared memory of the kernels this script
# reports the occupancy of (csrc/conv3x3.cu, csrc/bn_stats.cu, and
# csrc/topk.cu's batched route for an f32 and a bf16 gallery)
OCCUPANCY_OF = {"conv3x3_mma_kernel": (256, 155648),
                "bn_stats_kernel": (256, 0),
                "topk_tc_kernelIf": (256, 206848),
                "topk_tc_kernelIt": (256, 178176)}


def _print_occupancy(entry: str, ptxas_line: str) -> None:
    """Blocks and warps an SM holds of a kernel, from ptxas' registers and
    static shared memory: 65,536 registers (a warp's are allotted in units of
    256), 233,472 bytes of shared memory less 1,024 a block, 2,048 threads."""
    import re

    found = [k for k in OCCUPANCY_OF if k in entry]
    regs = re.search(r"Used (\d+) registers", ptxas_line)
    if not found or not regs:
        return
    threads, dynamic = OCCUPANCY_OF[found[0]]
    smem = re.search(r"(\d+) bytes smem", ptxas_line)
    shared = dynamic + (int(smem.group(1)) if smem else 0)
    warps = threads // 32
    per_warp = -(-int(regs.group(1)) * 32 // 256) * 256
    blocks = min(65536 // (per_warp * warps), 233472 // (shared + 1024),
                 2048 // threads, 32)
    print(f"  occupancy: {blocks} blocks = {blocks * warps} warps an SM "
          f"({threads} threads, {regs.group(1)} registers, {shared} bytes of "
          f"shared memory a block)")


# ---------------------------------------------------------------------------
# phase 3: kernel against its twin
# ---------------------------------------------------------------------------

def _check_topk(q, g, k, atol, n_valid=None, exact=False,
                route=None) -> tuple:
    """Kernel against the twin on one input; returns the max score error and
    the route the search took. ``route``: the route ``plan`` must have
    chosen."""
    import torch

    from hairci_torch.ops.topk import (
        topk_gallery_search,
        topk_gallery_search_reference,
    )

    n = g.shape[0] if n_valid is None else n_valid
    before = dict(topk_gallery_search.routes)
    s, i = topk_gallery_search(q, g, k, n_valid=n_valid)
    torch.cuda.synchronize()
    took = [r for r, c in topk_gallery_search.routes.items()
            if c != before[r]]
    if route is not None and took != [route]:
        raise AssertionError(f"topk took {took}, not the {route} route "
                             f"(Q={q.shape[0]} D={q.shape[1]})")
    kk = min(k, n)
    rs, ri = topk_gallery_search_reference(q, g[:n], min(kk + 1, n))
    if s.shape != (q.shape[0], kk) or i.dtype != torch.int64:
        raise AssertionError(f"topk shape {tuple(s.shape)} {i.dtype}")
    err = (s - rs[:, :kk]).abs().max().item()
    if not err <= atol:
        raise AssertionError(f"topk scores differ by {err} > {atol} "
                             f"(Q={q.shape[0]} N={n} k={k} {g.dtype})")
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
        raise AssertionError(f"topk indices differ (Q={q.shape[0]} N={n} "
                             f"k={k} {g.dtype})")
    return err, took[0]


# queries timed, each on the route plan() takes: the serving path's single
# query, the batched route's threshold, and the TPU kernel's design point
TOPK_TIMED_Q = (1, 16, 64, 256)
# --kernel-times: the sweep the threshold was set from
TOPK_SWEEP_Q = (1, 4, 8, 16, 32, 64, 256)


def _topk_bound(Q: int, kind: str, route: str) -> tuple:
    """The least time of a route's work at Q x 103,945 x 768: gallery and
    queries read once, k = 5 scores and indices written; one f32 FMA per
    product (fma), or three tensor-core products (mma: TF32 for an f32
    gallery, bf16 for a bf16 one)."""
    nbytes = ((4 if kind == "f32" else 2) * GALLERY_ROWS * WIDTH
              + 4 * Q * WIDTH + Q * 5 * 12)
    flops = 2.0 * Q * GALLERY_ROWS * WIDTH
    if route == "fma":
        return _bound(nbytes, flops, "f32")
    return _bound(nbytes, 3 * flops, "tf32" if kind == "f32" else "bf16")


def phase_topk() -> dict:
    import torch

    from hairci_torch.ops.topk import (
        BATCHED_MIN_Q,
        topk_gallery_search,
        topk_gallery_search_reference,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def unit(n, d=WIDTH):
        x = torch.randn(n, d, device=dev, generator=gen)
        return x / x.norm(dim=1, keepdim=True)

    def near(g, Q):
        # queries near gallery rows, so each has a clear nearest neighbour
        rows = torch.randint(0, g.shape[0], (Q,), device=dev, generator=gen)
        q = g[rows] + 0.3 * unit(Q, g.shape[1]) / g.shape[1] ** 0.5
        return (q / q.norm(dim=1, keepdim=True)).contiguous()

    g32 = unit(GALLERY_ROWS)
    galleries = {"f32": (g32, 1e-5), "bf16": (g32.bfloat16(), 1e-4)}
    max_err = {(r, name): 0.0 for r in ("fma", "mma") for name in galleries}

    def check(name, *args, **kw):
        err, took = _check_topk(*args, **kw)
        max_err[(took, name)] = max(max_err[(took, name)], err)

    for Q in (1, 256):
        q = near(g32, Q)
        for name, (g, atol) in galleries.items():
            for k in (1, 5, 8, 16):
                check(name, q, g, k, atol)
            check(name, q, g, 5, atol, n_valid=GALLERY_ROWS - 1000)
    # exact ties: rows i and i + half are equal, the lower index must win
    half = unit(2048)
    dup = torch.cat([half, half]).contiguous()
    _check_topk(half[:64].contiguous(), dup, 4, 1e-5, exact=True)
    _, i = topk_gallery_search(half[:64].contiguous(), dup, 2)
    want = torch.arange(64, device=dev)
    if not (torch.equal(i[:, 0], want) and torch.equal(i[:, 1], want + 2048)):
        raise AssertionError("topk tie order: the lower index must win")
    # fewer rows than k
    _check_topk(unit(4), unit(3), 8, 1e-5, exact=True)

    # the batched route's edges: Q at the threshold and just below it, a
    # ragged n_valid, fewer rows than k, D = 96 (a K slice and a zero-filled
    # half) and D = 45 (not a 16-byte multiple: the fma route), ties in a
    # bf16 gallery
    for name, (g, atol) in galleries.items():
        for Q, route in ((BATCHED_MIN_Q, "mma"), (BATCHED_MIN_Q - 1, "fma"),
                         (300, "mma")):
            check(name, near(g32, Q), g, 8, atol, route=route)
        check(name, near(g32, 256), g, 16, atol,
              n_valid=GALLERY_ROWS // 2 + 1, route="mma")
        dtype = g.dtype
        _check_topk(unit(BATCHED_MIN_Q), unit(5).to(dtype), 8, atol,
                    exact=True, route="mma")
        _check_topk(unit(130), unit(200).to(dtype), 16, atol, route="mma")
        for D, route in ((96, "mma"), (45, "fma")):
            small = unit(20_000, D).to(dtype)
            check(name, near(small.float(), 256), small, 5, atol, route=route)
        dup16 = dup.to(dtype)
        _check_topk(half[:256].contiguous(), dup16, 4, atol, exact=True,
                    route="mma")
        _, i = topk_gallery_search(half[:256].contiguous(), dup16, 2)
        want = torch.arange(256, device=dev)
        if not (torch.equal(i[:, 0], want)
                and torch.equal(i[:, 1], want + 2048)):
            raise AssertionError(f"topk tie order at Q=256 {name}: the lower "
                                 "index must win")
    print(f"topk vs twin: ok (both routes, threshold Q={BATCHED_MIN_Q}); max "
          "|score err| " + ", ".join(f"{r} {name} {e:.3g}"
                                     for (r, name), e in max_err.items()))

    times = {}
    for Q in TOPK_TIMED_Q:
        q = unit(Q)
        for name, (g, _) in galleries.items():
            twin = _median_ms(lambda: topk_gallery_search_reference(q, g, 5),
                              runs=15)
            before = dict(topk_gallery_search.routes)
            kern, host = _kernel_times(lambda: topk_gallery_search(q, g, 5))
            route, = [r for r, c in topk_gallery_search.routes.items()
                      if c != before[r]]
            bound = _topk_bound(Q, name, route)
            times[(Q, name)] = (kern, twin, host, bound, route)
            print(f"topk Q={Q} N={GALLERY_ROWS} D={WIDTH} k=5 {name}, "
                  f"{route} route: {kern:.4f} ms on the card "
                  f"({BACK_TO_BACK} calls back to back, "
                  f"{100 * bound[0] / kern:.1f} % of its bound "
                  f"{bound[0]:.4f} ms by {bound[1]}), {host:.4f} ms on "
                  f"the host; twin {twin:.4f} ms")
    del g32, galleries
    torch.cuda.empty_cache()
    return {"max_abs_err": max_err, "times": times}


def resnet50_bn_shapes(rows: int, size: int) -> list:
    """(M, C, count) of every train-mode BN of a ResNet-50 forward over
    ``rows`` images of ``size`` px, in the order of the trunk."""
    out, hw = [], size // 2
    out.append((rows * hw * hw, 64, 1))                  # stem
    hw //= 2                                             # max pool
    for i, blocks in enumerate((3, 4, 6, 3)):
        f = 64 * 2 ** i
        for j in range(blocks):
            out.append((rows * hw * hw, f, 1))           # bn1, before stride
            if i > 0 and j == 0:
                hw //= 2
            out.append((rows * hw * hw, f, 1))           # bn2
            out.append((rows * hw * hw, 4 * f, 1))       # bn3
            if j == 0:
                out.append((rows * hw * hw, 4 * f, 1))   # downsample
    shapes = {}
    for m, c, n in out:
        shapes[(m, c)] = shapes.get((m, c), 0) + n
    return [(m, c, n) for (m, c), n in shapes.items()]


# the shapes the rotate kernel's band tiling cares about, both routes, as in
# tests/test_torch_rotate.py: (B, H, W, C, max_degrees, fill)
ROTATE_ODD = ((5, 33, 31, 3, 15.0, 0.0), (7, 32, 32, 1, 15.0, 0.0),
              (7, 17, 15, 4, 15.0, -1.0), (7, 5, 12, 3, 15.0, 0.0),
              (7, 40, 6, 3, 45.0, 0.5), (7, 9, 7, 5, 15.0, 0.0),
              (7, 3, 2, 1, 45.0, -1.0))


def _step_view(gen, B: int):
    """The positive view the SHAM step hands to ``positive_transform``: the
    port's SimCLR view of a uint8 batch on the card, in the strides its last
    op left."""
    import torch

    from hairci_torch.aug.pipelines import simclr_transform

    view = simclr_transform(SIZE).views[0]
    images = torch.randint(0, 256, (B, SIZE + 32, SIZE + 32, 3),
                           dtype=torch.uint8, device="cuda", generator=gen)
    cpu_gen = torch.Generator().manual_seed(SEED)
    return view.apply(images, view.draw(cpu_gen, B, SIZE + 32, SIZE + 32))


def _check_rotate(x, theta, sigma, max_degrees, fill=0.0) -> dict:
    """The kernel against the twin on both routes: bitwise without the blur,
    within 2e-6 with it. Returns each route's max |error|."""
    import torch

    from hairci_torch.ops.rotate import rotate_shear, rotate_shear_reference

    err = {}
    for key, blur in (("plain", None), ("blur", sigma)):
        got = rotate_shear(x, theta, fill, max_degrees, blur)
        want = rotate_shear_reference(x, theta, fill, max_degrees, blur)
        torch.cuda.synchronize()
        err[key] = (got - want).abs().max().item()
        shape = tuple(x.shape)
        if blur is None and not torch.equal(got, want):
            raise AssertionError(f"rotate differs from its twin at {shape}, "
                                 f"strides {x.stride()}: {err[key]}")
        if not err[key] <= 2e-6:
            raise AssertionError(f"rotate+blur differs by {err[key]} > 2e-6 "
                                 f"at {shape}, strides {x.stride()}")
    return err


def phase_rotate() -> dict:
    import torch

    from hairci_torch.aug.pipelines import positive_transform
    from hairci_torch.ops.rotate import rotate_shear, rotate_shear_reference

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    B = TRAIN_BATCH
    x = torch.randn(B, SIZE, SIZE, 3, device=dev, generator=gen)
    # the +-15 degree grid, extremes included, and -2 atan(1/8): an exact
    # half shift at odd heights
    theta = torch.linspace(-15, 15, B, device=dev) * (math.pi / 180)
    theta[B // 2] = -0.24870999
    sigma = torch.rand(B, device=dev, generator=gen) * 0.4 + 0.1
    err = _check_rotate(x, theta, sigma, 15.0)
    for b, h, w, c, max_deg, fill in ROTATE_ODD:
        xo = torch.randn(b, h, w, c, device=dev, generator=gen)
        m = max_deg * math.pi / 180
        to = (torch.rand(b, device=dev, generator=gen) * 2 - 1) * m
        to[:4] = torch.tensor([m, -0.24870999, -1.5 * m, 2.0 * m])
        so = torch.rand(b, device=dev, generator=gen) * 0.4 + 0.1
        for xin in (xo, xo.permute(0, 3, 1, 2).contiguous().permute(
                0, 2, 3, 1)):
            for key, e in _check_rotate(xin, to, so, max_deg, fill).items():
                err[key] = max(err[key], e)
    print(f"rotate vs twin at {len(ROTATE_ODD)} odd shapes, contiguous and "
          f"in NCHW order: ok")
    # the step's own input: the SimCLR view, strided as the step sees it
    xv = _step_view(gen, B)
    print(f"rotate input of the step (SimCLR view at {SIZE}): shape "
          f"{tuple(xv.shape)} strides {xv.stride()} contiguous "
          f"{xv.is_contiguous()}")
    for key, e in _check_rotate(xv, theta, sigma, 15.0).items():
        err[key] = max(err[key], e)
    times = {}
    for key, blur in (("plain", None), ("blur", sigma)):
        kern, host = _kernel_times(lambda: rotate_shear(
            x, theta, max_degrees=15.0, blur_sigma=blur))
        twin = _median_ms(lambda: rotate_shear_reference(
            x, theta, max_degrees=15.0, blur_sigma=blur))
        times[key] = (kern, twin, host)
    # with the blur: the batch read and written once, angles and sigmas read;
    # per value two 3-tap passes of 5 operations each. Without: no arithmetic
    bounds = {"plain": _bound(2 * x.numel() * 4 + B * 4, 0.0, "f32"),
              "blur": _bound(2 * x.numel() * 4 + 2 * B * 4,
                             10.0 * x.numel(), "f32")}
    for key, (kern, twin, host) in times.items():
        bound = bounds[key]
        print(f"rotate {B}x{SIZE}x{SIZE}x3 f32 {key}: kernel {kern:.4f} ms "
              f"on the card ({100 * bound[0] / kern:.1f} % of its bound "
              f"{bound[0]:.4f} ms by {bound[1]}), {host:.4f} ms on the host; "
              f"twin {twin:.4f} ms, max |err| {err[key]:.3g}")
    clone_ms = _kernel_times(lambda: x.clone())[0]
    print(f"the same bytes moved by a copy (torch clone of the batch, no "
          f"rotation): {clone_ms:.4f} ms on the card")
    d = {"theta": theta, "sigma": sigma}
    step_ms = _kernel_times(lambda: positive_transform(xv, d))
    copy_ms = _kernel_times(lambda: xv.contiguous())
    print(f"positive_transform on the step's strided view: {step_ms[0]:.4f} "
          f"ms on the card, {step_ms[1]:.4f} ms on the host; the contiguous "
          f"copy it no longer makes ({2 * xv.numel() * 4 / 1e6:.1f} MB "
          f"moved): {copy_ms[0]:.4f} ms on the card")
    print("rotate vs twin: ok (bitwise without blur)")
    return {"max_abs_err": max(err.values()), "times": times,
            "bound": bounds["blur"], "bounds": bounds}


def _check_bn(x, atol_mean, atol_var) -> float:
    import torch

    from hairci_torch.ops.bn_stats import bn_stats, bn_stats_reference

    s, q = bn_stats(x)
    rs, rq = bn_stats_reference(x)
    torch.cuda.synchronize()
    n = x.shape[0]
    mean, rmean = s / n, rs / n
    var, rvar = q / n - mean * mean, rq / n - rmean * rmean
    # the tolerances of tools/bn_stats_bench.py:122-125
    if not (torch.allclose(mean, rmean, rtol=1e-4, atol=atol_mean)
            and torch.allclose(var, rvar, rtol=1e-3, atol=atol_var)):
        raise AssertionError(f"bn_stats differs from its twin at "
                             f"{tuple(x.shape)} {x.dtype}")
    # one launch whose last block adds in index order: the same bits again
    for _ in range(2):
        s2, q2 = bn_stats(x)
        if not (torch.equal(s, s2) and torch.equal(q, q2)):
            raise AssertionError(f"bn_stats differs from run to run at "
                                 f"{tuple(x.shape)} {x.dtype}")
    return max((mean - rmean).abs().max().item(),
               (var - rvar).abs().max().item())


def phase_bn_stats() -> dict:
    import torch

    from hairci_torch.ops.bn_stats import (
        bn_stats,
        bn_stats_reference,
        plan,
        vector_width,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def blocks(x):
        vec = vector_width(x.shape[1], x.element_size(), x.data_ptr())
        log_tg, splits, _ = plan(x.shape[0], x.shape[1], vec, sms)
        tiles = -(-x.shape[1] // (vec << log_tg))
        return (f"{tiles} x {splits} blocks of {256 >> log_tg} row lanes x "
                f"{1 << log_tg} groups of {vec}")

    tool = torch.randn(512 * 56 * 56, 256, device=dev,
                       generator=gen).bfloat16()
    err = _check_bn(tool, 1e-4, 1e-3)
    tool_k, tool_h = _kernel_times(lambda: bn_stats(tool))
    tool_t = _median_ms(lambda: bn_stats_reference(tool))
    print(f"bn_stats {tuple(tool.shape)} bf16 (the tool's shape), "
          f"{blocks(tool)}: kernel {tool_k:.4f} ms on the card "
          f"({tool.numel() * 2 / tool_k / 1e6:.0f} GB/s), {tool_h:.4f} ms on "
          f"the host; twin {tool_t:.4f} ms")
    del tool
    # f32 and inputs that rule out 16-byte loads, against the twin
    for m, c, dtype in ((37632, 256, torch.float32),
                        (192, 2048, torch.float32),
                        (1000, 7, torch.bfloat16), (5000, 24, torch.float32)):
        x = (torch.randn(m, c, device=dev, generator=gen) * 2 + 1).to(dtype)
        err = max(err, _check_bn(x, 1e-4, 1e-3))
    odd = torch.randn(64 * 32 + 1, device=dev, generator=gen)[1:].view(64, 32)
    _check_bn(odd, 1e-4, 1e-3)      # a pointer off the 16-byte grid
    rows = 3 * TRAIN_BATCH
    step_k = step_h = step_t = 0.0
    # the trunk's and the head's BN inputs are all bf16 in the bf16 run
    shapes = [(m, c, n, torch.bfloat16)
              for m, c, n in resnet50_bn_shapes(rows, SIZE)]
    shapes += [(rows, 2048, 1, torch.bfloat16),
               (rows, 1024, 1, torch.bfloat16)]
    for m, c, n, dtype in shapes:
        x = (torch.randn(m, c, device=dev, generator=gen) * 2 + 1).to(dtype)
        err = max(err, _check_bn(x, 1e-4, 1e-3))
        kern, host = _kernel_times(lambda: bn_stats(x))
        twin = _median_ms(lambda: bn_stats_reference(x), runs=20)
        step_k += n * kern
        step_h += n * host
        step_t += n * twin
        floor = m * c * 2 / HBM_BYTES_PER_S * 1e3
        print(f"bn_stats ({m}, {c}) {str(dtype)[6:]} x{n} per forward, "
              f"{blocks(x)}: kernel {kern:.4f} ms on the card (bound "
              f"{floor:.4f}), {host:.4f} ms on the host; twin {twin:.4f} ms")
    count = sum(n for *_, n, _ in shapes)
    print(f"bn_stats, the {count} train-mode BNs of one ResNet-50 SHAM "
          f"forward at {rows} rows ({len(shapes)} shapes), {BACK_TO_BACK} "
          f"calls back to back per shape: kernel {step_k:.3f} ms on the card,"
          f" {step_h:.3f} ms on the host ({1e3 * step_h / count:.1f} us a "
          f"call); twin {step_t:.3f} ms; vs twin and run to run: ok, max "
          f"|err| {err:.3g}")
    torch.cuda.empty_cache()
    # one forward's BN inputs read once (bf16), two f32 vectors written per
    # launch; an add and a fused multiply-add per value
    values = sum(n * m * c for m, c, n, _ in shapes)
    bound = _bound(2 * values + sum(n * 8 * c for _, c, n, _ in shapes),
                   3.0 * values, "f32")
    return {"max_abs_err": err, "step": (step_k, step_t, step_h),
            "tool": (tool_k, tool_t, tool_h), "bound": bound}


def _conv_inputs(gen, B, H, W, cin, cout, dtype, bias=True):
    """x ~ N(0, 1) channels_last, w ~ 0.05 N(0, 1) (the TPU tool's data) and
    a non-zero bias."""
    import torch

    dev = torch.device("cuda")
    x = torch.randn(B, H, W, cin, device=dev, generator=gen).to(dtype)
    w = 0.05 * torch.randn(cout, cin, 3, 3, device=dev, generator=gen)
    b = 0.1 * torch.randn(cout, device=dev, generator=gen) if bias else None
    return x.permute(0, 3, 1, 2), w, b


def _check_conv(x, w, b, stats) -> dict:
    """Kernel against the twin on one input. f32: |err| <= 1e-5 max|ref|
    (two f32 summation orders over 9 * Cin terms). bf16: each output within
    one bf16 ulp of the twin's (|err| <= 2^-7 |ref| + 1e-6 max|ref|) and at
    least 99.9 % of them bitwise equal (both round one f32 sum; they differ
    only where the two sums straddle a rounding boundary). Sums: rtol 1e-5,
    with atol 1e-5 of the largest channel's."""
    import torch

    from hairci_torch.ops.conv3x3 import conv3x3, conv3x3_reference

    got = conv3x3(x, w, b, stats=stats)
    want = conv3x3_reference(x, w, b, stats=stats)
    torch.cuda.synchronize()
    y, ref = (got[0], want[0]) if stats else (got, want)
    tag = f"{tuple(x.shape)} -> {w.shape[0]} {str(x.dtype)[6:]}"
    if (y.shape != ref.shape or y.dtype != x.dtype or not y.is_contiguous(
            memory_format=torch.channels_last)):
        raise AssertionError(f"conv3x3 output {tuple(y.shape)} {y.dtype} "
                             f"strides {y.stride()} at {tag}")
    diff = (y.float() - ref.float()).abs()
    top = ref.float().abs().max().item()
    err = diff.max().item()
    equal = (y == ref).float().mean().item()
    if x.dtype == torch.float32:
        ok = err <= 1e-5 * top
    else:
        ok = bool((diff <= 2.0 ** -7 * ref.float().abs() + 1e-6 * top).all()
                  ) and equal >= 0.999
    if not ok:
        raise AssertionError(f"conv3x3 differs from its twin at {tag}: max "
                             f"|err| {err:.3g} of {top:.3g}, {100 * equal:.4f}"
                             " % bitwise equal")
    if stats:
        for name, a, r in (("sum", got[1], want[1]), ("sumsq", got[2],
                                                      want[2])):
            if not torch.allclose(a, r, rtol=1e-5,
                                  atol=1e-5 * r.abs().max().item()):
                raise AssertionError(
                    f"conv3x3 {name} differs from its twin at {tag}: "
                    f"{(a - r).abs().max().item():.3g} of "
                    f"{r.abs().max().item():.3g}")
    return {"err": err, "equal": equal}


def _check_conv2d_cache(gen) -> None:
    """A ``Conv2d`` of the kernel's shape keeps its packed weights between
    forwards; after an in-place update of the weight (an EMA teacher's, an
    optimizer's) the next no-grad forward must read the new values."""
    import torch

    from hairci_torch.models.resnet import Conv2d
    from hairci_torch.ops.conv3x3 import conv3x3, conv3x3_reference

    conv = Conv2d(64, 64, 3, 1, 1, dtype=torch.bfloat16).cuda()
    other = Conv2d(64, 64, 3, 1, 1, dtype=torch.bfloat16).cuda()
    x = torch.randn(4, 56, 56, 64, device="cuda",
                    generator=gen).bfloat16().permute(0, 3, 1, 2)
    with torch.no_grad():
        first = conv(x)
        packed = conv.packed_weight()
        if conv.packed_weight() is not packed:
            raise AssertionError("Conv2d packed unchanged weights again")
        torch._foreach_mul_([conv.weight], 0.5)             # an EMA update
        torch._foreach_add_([conv.weight],
                            torch._foreach_mul([other.weight], 0.5))
        before = conv3x3.routes["mma"]
        got = conv(x)
        if conv3x3.routes["mma"] != before + 1:
            raise AssertionError("Conv2d did not take the tensor-core kernel")
        want = conv3x3_reference(x, conv.weight)
        fresh = conv3x3(x, conv.weight)
    torch.cuda.synchronize()
    if conv.packed_weight() is packed or torch.equal(got, first):
        raise AssertionError("Conv2d kept stale packed weights")
    equal = (got == want).float().mean().item()
    diff = (got.float() - want.float()).abs()
    top = want.float().abs().max().item()
    if not (torch.equal(got, fresh) and equal >= 0.999 and bool(
            (diff <= 2.0 ** -7 * want.float().abs() + 1e-6 * top).all())):
        raise AssertionError("Conv2d after an in-place weight update differs "
                             "from the twin on the new weights")
    print(f"Conv2d 64->64 after an in-place EMA update of its weight: packed "
          f"anew, equal to the kernel on the new weights, {100 * equal:.4f} "
          f"% of outputs bitwise equal to the twin's")


def phase_conv3x3() -> dict:
    import torch
    import torch.nn.functional as F

    from hairci_torch.ops.conv3x3 import (
        conv3x3,
        conv3x3_reference,
        kernel_route,
        pack_weights,
    )

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    least_equal = 1.0
    took = {}

    def check(x, w, b, stats):
        route = kernel_route(x.shape[1], w.shape[0], x.dtype)
        before = conv3x3.routes[route]
        r = _check_conv(x, w, b, stats)
        if conv3x3.routes[route] != before + 1:
            raise AssertionError(f"conv3x3 did not take the {route} kernel")
        took[f"{tuple(x.shape)}->{w.shape[0]} {str(x.dtype)[6:]}"] = route
        worst[x.dtype] = max(worst[x.dtype], r["err"])
        return r

    # borders and ragged tiles, other channel counts, no bias; the last
    # three are ragged for the tensor-core kernel's 8 x 28 tile
    for B, H, W, cin, cout, bias in ((3, 7, 9, 64, 64, True),
                                     (2, 17, 33, 24, 40, True),
                                     (1, 1, 1, 8, 8, False),
                                     (2, 8, 16, 64, 128, False),
                                     (1, 1, 1, 64, 64, True),
                                     (2, 9, 29, 64, 64, False),
                                     (5, 30, 57, 64, 64, True)):
        for dtype in (torch.float32, torch.bfloat16):
            for stats in (False, True):
                check(*_conv_inputs(gen, B, H, W, cin, cout, dtype, bias),
                      stats)
    _check_conv2d_cache(gen)
    times = {}
    # the TPU tool's shape, the full-width embed's batch of layer1, and the
    # batch the kNN CLI gives the kernel on the main path
    for B in (256, KNN_BATCH, CLI_BATCH):
        for dtype, kind in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
            x, w, b = _conv_inputs(gen, B, 56, 56, 64, 64, dtype)
            for stats in (False, True):
                r = check(x, w, b, stats)
                if dtype == torch.bfloat16:
                    least_equal = min(least_equal, r["equal"])
            # the same result on every run: no atomics in the statistics
            one, two = conv3x3(x, w, b, stats=True), conv3x3(x, w, b,
                                                             stats=True)
            if not all(torch.equal(p, q) for p, q in zip(one, two)):
                raise AssertionError("conv3x3 differs from run to run")
            del one, two
            nbytes = (2 * x.numel() * x.element_size() + 9 * 64 * 64 * 4
                      + 64 * 4)
            bound, by = _bound(nbytes, 2.0 * B * 56 * 56 * 9 * 64 * 64, kind)
            wl, bl = w.to(dtype), b.to(dtype)
            packed = pack_weights(w, dtype)
            with torch.no_grad():
                # weights packed by the caller, as Conv2d hands them over
                ms, host = _kernel_times(
                    lambda: conv3x3(x, w, b, packed=packed))
                pack_ms, pack_host = _kernel_times(
                    lambda: conv3x3(x, w, b))
                stats_ms, _ = _kernel_times(
                    lambda: conv3x3(x, w, b, stats=True, packed=packed))
                # the one PyTorch call that computes the same function
                # (cuDNN); timed here, used nowhere in the port
                lib_ms, lib_host = _kernel_times(
                    lambda: F.conv2d(x, wl, bl, padding=1))
                row = {
                    "ms": ms, "host_ms": host, "packing_ms": pack_ms,
                    "packing_host_ms": pack_host, "stats_ms": stats_ms,
                    "plain_ms": _median_ms(lambda: conv3x3_reference(x, w,
                                                                     b)),
                    "plain_stats_ms": _median_ms(
                        lambda: conv3x3_reference(x, w, b, stats=True)),
                    "library_ms": lib_ms, "library_host_ms": lib_host,
                    "bound_ms": bound, "bound_by": by,
                    "route": kernel_route(64, 64, dtype)}
            times[(B, kind)] = row
            print(f"conv3x3 ({B}, 56, 56, 64) -> 64 {kind}, the "
                  f"{row['route']} kernel, {BACK_TO_BACK} calls back to "
                  f"back: {ms:.4f} ms on the card ({100 * bound / ms:.1f} % "
                  f"of the bound {bound:.4f} ms, by {by}), {host:.4f} ms on "
                  f"the host; packing the weights in the call {pack_ms:.4f} "
                  f"/ {pack_host:.4f} ms; with stats {stats_ms:.4f} ms; twin "
                  f"{row['plain_ms']:.4f} ms, with stats "
                  f"{row['plain_stats_ms']:.4f} ms; F.conv2d {lib_ms:.4f} ms "
                  f"on the card ({100 * bound / lib_ms:.1f} % of the bound), "
                  f"{lib_host:.4f} ms on the host")
            del x, w, b, wl, bl, packed
    print("conv3x3 kernel by shape: " + "; ".join(
        f"{k} {v}" for k, v in took.items()))
    print(f"conv3x3 vs twin: ok; max |err| f32 {worst[torch.float32]:.3g} "
          f"bf16 {worst[torch.bfloat16]:.3g}; bf16 outputs bitwise equal at "
          f"56x56x64: >= {100 * least_equal:.4f} %")
    torch.cuda.empty_cache()
    return {"max_abs_err": worst[torch.bfloat16], "times": times}


def phase_kernels() -> dict:
    return {"topk": phase_topk(), "rotate": phase_rotate(),
            "bn_stats": phase_bn_stats(), "conv3x3": phase_conv3x3()}


# ---------------------------------------------------------------------------
# phase 4: the serving slice through its entry point
# ---------------------------------------------------------------------------

def _wrappers() -> dict:
    from hairci_torch.ops.bn_stats import bn_stats
    from hairci_torch.ops.conv3x3 import conv3x3
    from hairci_torch.ops.rotate import rotate_shear
    from hairci_torch.ops.topk import topk_gallery_search

    return {"topk_gallery_search": topk_gallery_search,
            "rotate_shear": rotate_shear, "bn_stats": bn_stats,
            "conv3x3": conv3x3}


def _reset_counts() -> None:
    """Every kernel's launch count to 0, just before a path is driven."""
    for fn in _wrappers().values():
        fn.launches = 0
        for route in getattr(fn, "routes", {}):
            fn.routes[route] = 0


def _counts() -> dict:
    return {name: fn.launches for name, fn in _wrappers().items()}


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

    _reset_counts()
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
        # one batched search: 256 stored rows, each must find itself
        rows = np.arange(256) * (GALLERY_ROWS // 256)
        batch = stored[torch.from_numpy(rows).to(stored.device)]
        payload = {"embedding": batch.float().cpu().numpy().tolist(), "k": 5}
        before = topk_gallery_search.routes["mma"]
        t0 = time.perf_counter()
        res = _request(server, "/search", payload)
        batched_ms = (time.perf_counter() - t0) * 1e3
        searches += 1
        top1 = [row[0] for row in res["paths"]]
        index_paths = server.service.index.paths
        if top1 != [index_paths[r] for r in rows] or np.asarray(
                res["scores"]).shape != (256, 5):
            raise AssertionError("batched /search: a rank 1 is not the "
                                 "query's own row")
        if topk_gallery_search.routes["mma"] != before + 1:
            raise AssertionError("batched /search did not take the mma "
                                 "route of the top-k kernel")
        print(f"/search by embedding, 256 x {WIDTH} in one request, k=5: "
              f"{batched_ms:.3f} ms HTTP round trip; rank 1 is each row "
              f"itself; served by the mma route")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    launches = dict(topk_gallery_search.routes)
    print(f"topk kernel launches during the serve run: {launches} for "
          f"{searches} searches")
    if sum(launches.values()) != _counts()["topk_gallery_search"] or \
            sum(launches.values()) < searches or min(launches.values()) < 1:
        raise AssertionError("/search did not go through both routes of the "
                             "top-k kernel")

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


# ---------------------------------------------------------------------------
# phase 6: the SHAM training slice through its entry point
# ---------------------------------------------------------------------------

def _write_manifest(workdir: str) -> str:
    """The repo's 64 hair crops, each listed twice: 128 rows, 2 steps of 64
    an epoch."""
    names = sorted(n for n in os.listdir(DATASET) if n.endswith("_hair.png"))
    if len(names) != 64:
        raise AssertionError(f"expected 64 hair crops, found {len(names)}")
    path = os.path.join(workdir, "train.csv")
    with open(path, "w") as f:
        f.write("id,class\n")
        for rep in range(2):
            f.writelines(f"{n},{i}\n" for i, n in enumerate(names))
    return path


def _step_times(recipe, state, images, stage, runs=10, warmup=3):
    """Median host ms per ``train_step`` (each ends in a synchronize)."""
    import torch

    times = []
    for i in range(warmup + runs):
        gen = torch.Generator().manual_seed(1000 + i)
        t0 = time.perf_counter()
        recipe.train_step(state, images, gen, stage=stage, batch_id=0, k=7)
        torch.cuda.synchronize()
        if i >= warmup:
            times.append((time.perf_counter() - t0) * 1e3)
    times.sort()
    return times[len(times) // 2]


def phase_train(workdir: str, kern: dict) -> dict:
    import torch

    from hairci_torch.cli import mainpretrain
    from hairci_torch.ssl import sham

    manifest = _write_manifest(workdir)
    epochs, steps_per_epoch = 3, 128 // TRAIN_BATCH
    argv = ["--mode", "SHAM", "--model", "resnet50", "--size", str(SIZE),
            "--lr", "0.001", "--weight_decay", "1e-4", "--temp", "0.5",
            "--ema", "0.99", "--k", "7", "--seed", "42",
            "--batch_size", str(TRAIN_BATCH), "--epochs", str(epochs),
            "--warm_up_epochs", "2", "--num_workers", "8",
            "--train_annotation", manifest, "--img_dir", DATASET,
            "--save_path", os.path.join(workdir, "out")]
    torch.cuda.reset_peak_memory_stats()
    # the layout of the view the step hands to positive_transform (the rotate
    # kernel gathers at its strides)
    seen, positive_transform = [], sham.positive_transform

    def spy(x, d):
        if not seen:
            seen.append((tuple(x.stride()), x.is_contiguous()))
        return positive_transform(x, d)

    sham.positive_transform = spy
    _reset_counts()
    t0 = time.perf_counter()
    try:
        trainer = mainpretrain.main(argv)
        torch.cuda.synchronize()
    finally:
        sham.positive_transform = positive_transform
    seconds = time.perf_counter() - t0
    launches = _counts()
    print(f"x_pos1 on the SHAM step: strides {seen[0][0]}, contiguous "
          f"{seen[0][1]}")
    steps = epochs * steps_per_epoch
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"mainpretrain SHAM resnet50 {SIZE}px bf16 B={TRAIN_BATCH}: "
          f"{steps} steps over {epochs} epochs in {seconds:.1f} s (model "
          f"build and first-step warmup included); peak memory "
          f"{peak:.2f} GiB; launches {launches}")
    if launches["rotate_shear"] != steps:
        raise AssertionError(f"rotate launches {launches['rotate_shear']} "
                             f"!= {steps} steps")
    if launches["bn_stats"] != 55 * steps:
        raise AssertionError(f"bn_stats launches {launches['bn_stats']} != "
                             f"55 x {steps} steps")
    # forwards that need no gradient go through the conv3x3 kernel: the EMA
    # teacher's, one a step, and one more in each step of the mining epoch
    no_grad_forwards = steps + steps_per_epoch
    if launches["conv3x3"] != 3 * no_grad_forwards:
        raise AssertionError(f"conv3x3 launches {launches['conv3x3']} != 3 x "
                             f"{no_grad_forwards} forwards without gradient")

    with open(os.path.join(trainer.save_path, "metrics.jsonl")) as f:
        metrics = [json.loads(line) for line in f]
    log = os.path.join(trainer.save_path, "training_log.txt")
    for m in metrics:
        print(f"epoch {m['epoch']}: loss {m['loss']:.6f} contrastive "
              f"{m['contrastive_loss']:.6f} triplet {m['triplet_loss']:.6f} "
              f"mse {m['mse_loss']:.6f} violations {m['margin_violations']} "
              f"{m['images_per_sec']:.1f} img/s (host clock, loader "
              f"included)")
    if [m["epoch"] for m in metrics] != list(range(epochs)) or not all(
            math.isfinite(m[k]) for m in metrics for k in m):
        raise AssertionError(f"metrics.jsonl: {metrics}")
    if not (os.path.isfile(log) and os.path.isfile(os.path.join(
            trainer.save_path, "model_ckpt_latest"))):
        raise AssertionError("training_log.txt or model_ckpt_latest missing")
    state, recipe = trainer.state, trainer.recipe
    # the cache starts as zeros; mine writes one row of indices per batch
    neg = state.neg_indices.cpu()
    if not (neg.shape == (steps_per_epoch, TRAIN_BATCH)
            and bool((neg != 0).any(1).all())
            and bool(((neg >= 0) & (neg < TRAIN_BATCH)).all())):
        raise AssertionError(f"neg_indices were not mined: {neg}")

    images, _ = next(iter(trainer.train_loader))
    images = torch.from_numpy(images).cuda()
    step_ms = {stage: _step_times(recipe, state, images, stage)
               for stage in ("warmup", "mined")}
    for stage, ms in step_ms.items():
        print(f"train_step {stage} B={TRAIN_BATCH}: median {ms:.2f} ms/step "
              f"({TRAIN_BATCH * 1e3 / ms:.1f} img/s), host clock, each step "
              f"synchronised")
    k_ms = kern["rotate"]["times"]["blur"][0] + kern["bn_stats"]["step"][0]
    print(f"the two kernels' share of a mined step: {k_ms:.3f} ms of "
          f"{step_ms['mined']:.2f} ms ({100 * k_ms / step_ms['mined']:.2f} %,"
          f" from the kernels' times at these shapes in phase 3)")
    save_path = trainer.save_path
    del trainer, state, images
    torch.cuda.empty_cache()
    return {"launches": launches, "step_ms": step_ms, "peak_gib": peak,
            "save_path": save_path, "manifest": manifest}


# ---------------------------------------------------------------------------
# phase 7: the kNN evaluation slice through its entry point
# ---------------------------------------------------------------------------

def _embed_ms(recipe, state, images, library_conv: bool = False,
              runs: int = 20) -> float:
    """Median device ms of ``recipe.extract_features`` on a uint8 batch.
    ``library_conv`` sends the three 64 -> 64 3x3 convs to F.conv2d (cuDNN)
    instead of the conv3x3 kernel, for this measurement only."""
    from hairci_torch.models.resnet import Conv2d

    convs = [m for m in state.online.modules()
             if isinstance(m, Conv2d) and m.to_kernel]
    if len(convs) != 3:
        raise AssertionError(f"{len(convs)} convs of the kernel's shape in "
                             "ResNet-50, expected 3")
    try:
        for m in convs:
            m.to_kernel = not library_conv
        return _median_ms(lambda: recipe.extract_features(state, images),
                          runs=runs, warmup=3)
    finally:
        for m in convs:
            m.to_kernel = True


def phase_knn(workdir: str, train: dict) -> dict:
    import numpy as np
    import torch

    from hairci_torch.cli import knn_classification
    from hairci_torch.eval.knn import DEFAULT_KS, knn_predict

    batch = CLI_BATCH
    test_csv = os.path.join(workdir, "test.csv")
    with open(train["manifest"]) as f:
        rows = f.read().splitlines()
    with open(test_csv, "w") as f:
        f.write("\n".join(rows[:65]) + "\n")   # the header and 64 images
    out_dir = os.path.join(workdir, "knn_out")
    argv = ["--mode", "SHAM", "--model", "resnet50", "--size", str(SIZE),
            "--dtype", "bfloat16", "--eval_type", "knn",
            "--batch_size", str(batch), "--num_workers", "8",
            "--checkpoint_path", train["save_path"],
            "--train_annotation", train["manifest"],
            "--test_annotation", test_csv, "--img_dir", DATASET,
            "--save_path", out_dir]
    forwards = math.ceil(128 / batch) + math.ceil(64 / batch)
    _reset_counts()
    t0 = time.perf_counter()
    clf = knn_classification.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _counts()
    print(f"knn_classification SHAM resnet50 {SIZE}px bf16, batches of "
          f"{batch}: 128 train + 64 test images, {forwards} forwards, in "
          f"{seconds:.2f} s (model build and checkpoint load included); "
          f"launches {launches}")
    if launches["conv3x3"] != 3 * forwards:
        raise AssertionError(f"conv3x3 launches {launches['conv3x3']} != 3 x "
                             f"{forwards} forwards")
    if launches["bn_stats"] != 0:
        raise AssertionError("an eval-mode BatchNorm took batch statistics")
    with open(os.path.join(out_dir, "knn_evaluation_results.txt")) as f:
        text = f.read()
    accuracy = {}
    for k in DEFAULT_KS:
        head = f"Results for k={k}\n" + "-" * 40 + "\nAccuracy: "
        if text.count(head) != 1:
            raise AssertionError(f"knn_evaluation_results.txt: no block for "
                                 f"k={k}")
        accuracy[k] = float(text.split(head)[1].split("\n")[0])
    print(f"knn_evaluation_results.txt: accuracy by k {accuracy}")
    tr_f, tr_l, te_f, te_l = clf.extracting_features()
    if tr_f.shape != (128, 2048) or te_f.shape != (64, 2048) or \
            tr_f.dtype != np.float32:
        raise AssertionError(f"features {tr_f.shape} {te_f.shape}")
    for f in (tr_f, te_f):
        norms = np.linalg.norm(f, axis=1)
        if not (np.isfinite(f).all() and np.abs(norms - 1).max() < 1e-3):
            raise AssertionError("features are not finite and unit-norm")
    # every test image is in the train set: its nearest neighbour is itself
    self_hit = float(np.mean(knn_predict(tr_f, tr_l, te_f, 1) == te_l))
    print(f"self-retrieval at k=1: {100 * self_hit:.1f} %")
    if self_hit != 1.0:
        raise AssertionError("k=1 self-retrieval is not 100 %")

    # the device's share of the embed: the forwards' device time (CUDA
    # events, same batch shape) against the host clock of a second
    # extraction over both loaders
    images, _ = next(iter(clf.train_loader))
    x = torch.from_numpy(images).cuda()
    fwd_ms = _median_ms(lambda: clf.embed_fn(x), runs=10, warmup=2)
    clf._cached = None
    t0 = time.perf_counter()
    clf.extracting_features()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    idle = 1 - forwards * fwd_ms / wall_ms
    print(f"embed through the loader: {192 / wall_ms * 1e3:.1f} img/s over "
          f"192 images in {wall_ms:.1f} ms (PIL decode, 8 threads); forward "
          f"at batch {batch} {fwd_ms:.3f} ms, so the card is idle an "
          f"estimated {100 * idle:.1f} % of the extraction (not from a "
          f"trace)")
    del clf, x
    torch.cuda.empty_cache()
    return {"launches": launches, "idle": idle}


# ---------------------------------------------------------------------------
# phase 8: kNN at the gallery size of the README's benchmark
# ---------------------------------------------------------------------------

def phase_knn_full() -> None:
    import numpy as np
    import torch

    from hairci_torch.eval.knn import (
        DEFAULT_KS,
        knn_predict_multi,
        ordered_neighbours,
        similarities,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    N, D, C, Q, DUP = GALLERY_ROWS, 2048, 61, 4096, 64

    def unit(x):
        return x / x.norm(dim=1, keepdim=True)

    # rows scatter around their class's centre, so votes are decided by the
    # data and not by which of two f32 summation orders ranks a near-tie
    centres = unit(torch.randn(C, D, device=dev, generator=gen))
    labels = torch.randint(0, C, (N,), device=dev, generator=gen)
    gallery = unit(centres[labels]
                   + unit(torch.randn(N, D, device=dev, generator=gen)))
    # exact ties: rows 1000 .. 1063 repeat rows 0 .. 63 under another label
    gallery[1000:1000 + DUP] = gallery[:DUP]
    labels[1000:1000 + DUP] = (labels[:DUP] + 1) % C
    rows = torch.randint(0, N, (Q,), device=dev, generator=gen)
    rows[:DUP] = torch.arange(DUP, device=dev)
    noise = unit(torch.randn(Q, D, device=dev, generator=gen))
    noise[:DUP] = 0     # these queries equal a duplicated row exactly
    queries = unit(gallery[rows] + 0.5 * noise)
    g_np, l_np, q_np = (t.cpu().numpy() for t in (gallery, labels, queries))

    sims = similarities(queries, gallery)
    first = {}
    for method in ("sort", "topk"):
        first[method] = ordered_neighbours(sims, max(DEFAULT_KS), method)
        ms = _median_ms(lambda: ordered_neighbours(sims, max(DEFAULT_KS),
                                                   method), runs=5, warmup=1)
        print(f"ordered_neighbours {Q} x {N}, k={max(DEFAULT_KS)}, {method}: "
              f"{ms:.2f} ms")
    if not torch.equal(first["sort"], first["topk"]):
        raise AssertionError("the two orderings disagree")
    want = torch.arange(DUP, device=dev)
    if not (torch.equal(first["sort"][:DUP, 0], want)
            and torch.equal(first["sort"][:DUP, 1], want + 1000)):
        raise AssertionError("kNN tie order: the lower index must win")
    mm_ms = _median_ms(lambda: similarities(queries, gallery), runs=5,
                       warmup=1)
    print(f"similarities {Q} x {N} x {D} f32: {mm_ms:.2f} ms "
          f"({2.0 * Q * N * D / mm_ms / 1e9:.1f} TFLOP/s)")
    del sims, first
    torch.cuda.empty_cache()

    for _ in range(3):
        t0 = time.perf_counter()
        preds = knn_predict_multi(g_np, l_np, q_np, DEFAULT_KS, C)
        torch.cuda.synchronize()
        print(f"knn_predict_multi, {N} x {D} gallery, {Q} queries, ks "
              f"{DEFAULT_KS}: {time.perf_counter() - t0:.3f} s "
              f"(host clock; the gallery's copy to the card included)")
    t0 = time.perf_counter()
    cpu = knn_predict_multi(g_np, l_np, q_np[:512], DEFAULT_KS, C,
                            device="cpu")
    print(f"the same on the CPU for 512 queries: "
          f"{time.perf_counter() - t0:.1f} s")
    for k in DEFAULT_KS:
        if not np.array_equal(preds[k][:512], cpu[k]):
            raise AssertionError(f"kNN predictions differ at k={k}")
    # with k=1 and 2 the duplicated rows decide: the lower index's label,
    # then a 1:1 vote that goes to the lower class
    small = knn_predict_multi(g_np, l_np, q_np[:DUP], (1, 2), C)
    if not (np.array_equal(small[1], l_np[:DUP]) and np.array_equal(
            small[2], np.minimum(l_np[:DUP], l_np[1000:1000 + DUP]))):
        raise AssertionError("kNN ties: lower index, then lower class")
    acc = float(np.mean(preds[5] == l_np[rows.cpu().numpy()]))
    print(f"kNN at full size: card == CPU on 512 queries at every k; top-k "
          f"with repair == stable sort on {Q} x {N} scores; ties by index "
          f"and class; accuracy at k=5 {acc:.4f}")
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 9: the embed at full width
# ---------------------------------------------------------------------------

def phase_embed(conv: dict) -> None:
    import numpy as np
    import torch

    from hairci_torch.ops.conv3x3 import conv3x3
    from hairci_torch.ssl.sham import SHAMRecipe

    rng = np.random.default_rng(SEED)
    images = torch.from_numpy(
        rng.integers(0, 256, (KNN_BATCH, SIZE, SIZE, 3), dtype=np.uint8))
    rec = SHAMRecipe(backbone="resnet50", img_size=SIZE,
                     dtype=torch.bfloat16)
    state = rec.create_state(SEED, 8, torch.device("cuda"))
    x = images.cuda()
    before = conv3x3.launches
    feats = rec.extract_features(state, x)
    torch.cuda.synchronize()
    if conv3x3.launches - before != 3 or feats.shape != (KNN_BATCH, 2048):
        raise AssertionError("one eval forward must launch conv3x3 3 times")
    ms = {}
    for name, lib in (("kernel", False), ("F.conv2d", True),
                      ("F.conv2d again", True), ("kernel again", False)):
        ms[name] = _embed_ms(rec, state, x, library_conv=lib)
        print(f"ResNet-50 eval forward {SIZE}px bf16 batch {KNN_BATCH}, 3x3 "
              f"64->64 convs by {name}: {ms[name]:.3f} ms "
              f"({KNN_BATCH * 1e3 / ms[name]:.1f} img/s)")
    # does the host keep ahead of the card? its time to enqueue one forward
    # (no synchronize inside the clock), and the batch the CLI is driven at
    enqueue = []
    for _ in range(10):
        t0 = time.perf_counter()
        rec.extract_features(state, x)
        enqueue.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
    enqueue.sort()
    ms_cli = _embed_ms(rec, state, x[:CLI_BATCH].contiguous())
    print(f"the host enqueues that forward in {enqueue[5]:.3f} ms (median of "
          f"10, host clock); the same forward at batch {CLI_BATCH}: "
          f"{ms_cli:.3f} ms ({CLI_BATCH * 1e3 / ms_cli:.1f} img/s)")
    k_ms = 3 * conv[(KNN_BATCH, "bf16")]["ms"]
    print(f"the conv3x3 kernel's share of that forward: {k_ms:.3f} ms of "
          f"{ms['kernel']:.3f} ms ({100 * k_ms / ms['kernel']:.1f} %, from "
          f"its time at this shape in phase 3)")
    rec32 = SHAMRecipe(backbone="resnet50", img_size=SIZE,
                       dtype=torch.float32)
    cpu = rec32.extract_features(
        rec32.create_state(SEED, 8, torch.device("cpu")), images[:4])
    a, b = feats[:4].float().cpu(), cpu.float()
    cos = torch.nn.functional.cosine_similarity(a, b, dim=1)
    print(f"ResNet-50 features bf16 cuda vs f32 cpu cosine: {cos.tolist()}")
    if not bool((cos >= 0.99).all()):
        raise AssertionError("card and CPU features disagree")
    del state, x
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 10: one training step on the card against the CPU
# ---------------------------------------------------------------------------

def phase_train_parity() -> None:
    import numpy as np
    import torch

    from hairci_torch.ssl.sham import SHAMRecipe

    B = 8
    rng = np.random.default_rng(SEED)
    images = torch.from_numpy(
        rng.integers(0, 256, (B, 256, 256, 3), dtype=np.uint8))
    rec = SHAMRecipe(backbone="resnet50", img_size=SIZE, weight_decay=1e-4,
                     num_batches=1, dtype=torch.float32)
    draws = rec.draw(torch.Generator().manual_seed(SEED), B, 256, 256)
    views = rec.transform.apply(images, draws["views"])
    out = {}
    for dev in ("cuda", "cpu"):
        state = rec.create_state(SEED, B, torch.device(dev))
        t0 = time.perf_counter()
        m = rec.step_on_views(state, *(v.to(dev) for v in views), draws,
                              "warmup")
        loss = float(m["loss"])
        grads = {n: p.grad.detach().cpu()
                 for n, p in state.online.named_parameters()}
        out[dev] = (loss, grads)
        print(f"train parity {dev}: warmup step ResNet-50 {SIZE}px B={B} f32 "
              f"loss {loss:.7f} ({time.perf_counter() - t0:.1f} s)")
    rel = abs(out["cuda"][0] - out["cpu"][0]) / abs(out["cpu"][0])
    gmax = max((out["cuda"][1][n] - g).abs().max().item()
               for n, g in out["cpu"][1].items())
    print(f"train parity: relative loss difference {rel:.3g}, max |grad "
          f"difference| {gmax:.3g} (clipped gradients)")
    if not rel <= 1e-3:
        raise AssertionError(f"card and CPU losses differ by {rel:.3g}")


def kernel_times(root: str) -> int:
    """``python3 chip_smoke.py --kernel-times [DIR]``: the card's and the
    host's time of the bn_stats wrapper over the 55 BN inputs of a SHAM step,
    of a 64 -> 64 ``Conv2d`` forward without gradient (bf16, 56 x 56), of
    ``topk_gallery_search`` at k=5 over a 103,945 x 768 gallery (f32 and
    bf16) for each Q of ``TOPK_SWEEP_Q`` on the route the package picks
    (recorded where the package counts its routes; beside each, under
    ``topk_twin``, the twin's median ms and the route's bound), of
    ``rotate_shear`` on
    the step's (64, 224, 224, 3) f32 batch without and with the blur, and of
    ``positive_transform`` on the step's strided SimCLR view, for the
    ``hairci_torch`` package under DIR (default: this checkout), by this
    script's back-to-back method. For comparing two checkouts on one
    card: run it for each in turn, each in its own process. Prints one JSON
    line; no other phase runs."""
    sys.path.insert(0, os.path.abspath(root))
    phase_device()
    import torch

    import hairci_torch
    from hairci_torch.aug.pipelines import positive_transform
    from hairci_torch.models.resnet import Conv2d
    from hairci_torch.ops.bn_stats import bn_stats
    from hairci_torch.ops.rotate import rotate_shear
    from hairci_torch.ops.topk import (topk_gallery_search,
                                       topk_gallery_search_reference)

    pkg = os.path.dirname(os.path.abspath(hairci_torch.__file__))
    if os.path.dirname(pkg) != os.path.abspath(root):
        raise SystemExit(f"chip_smoke: hairci_torch came from {pkg}")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = 3 * TRAIN_BATCH
    shapes = resnet50_bn_shapes(rows, SIZE) + [(rows, 2048, 1),
                                               (rows, 1024, 1)]
    out = {"package": pkg, "calls": BACK_TO_BACK, "bn_stats": {}, "conv": {},
           "topk": {}, "topk_twin": {}, "rotate": {}}
    card = host = 0.0
    for m, c, n in shapes:
        x = (torch.randn(m, c, device="cuda", generator=gen) * 2
             + 1).bfloat16()
        k, h = _kernel_times(lambda: bn_stats(x))
        out["bn_stats"][f"{m}x{c}"] = [n, k, h]
        card += n * k
        host += n * h
    out["bn_stats"]["step"] = [sum(n for *_, n in shapes), card, host]
    conv = Conv2d(64, 64, 3, 1, 1, dtype=torch.bfloat16).cuda()
    for B in (CLI_BATCH, KNN_BATCH, 256):
        x = _conv_inputs(gen, B, 56, 56, 64, 64, torch.bfloat16)[0]
        with torch.no_grad():
            out["conv"][str(B)] = list(_kernel_times(lambda: conv(x)))
    g32 = torch.randn(GALLERY_ROWS, WIDTH, device="cuda", generator=gen)
    g32 /= g32.norm(dim=1, keepdim=True)
    for name, g in (("f32", g32), ("bf16", g32.bfloat16())):
        for Q in TOPK_SWEEP_Q:
            q = g32[:Q].contiguous()
            before = dict(getattr(topk_gallery_search, "routes", {}))
            times = list(_kernel_times(lambda: topk_gallery_search(q, g, 5)))
            took = [r for r, c in getattr(topk_gallery_search, "routes",
                                          {}).items() if c != before[r]]
            out["topk"][f"{Q} {name}"] = times + took
            out["topk_twin"][f"{Q} {name}"] = [
                _median_ms(lambda: topk_gallery_search_reference(q, g, 5)),
                *_topk_bound(Q, name, took[0] if took else "fma")]
    x = torch.randn(TRAIN_BATCH, SIZE, SIZE, 3, device="cuda", generator=gen)
    theta = torch.linspace(-15, 15, TRAIN_BATCH, device="cuda") * (
        math.pi / 180)
    sigma = torch.rand(TRAIN_BATCH, device="cuda", generator=gen) * 0.4 + 0.1
    xv = _step_view(gen, TRAIN_BATCH)
    d = {"theta": theta, "sigma": sigma}
    out["rotate"] = {
        key: list(_kernel_times(fn)) for key, fn in (
            ("plain", lambda: rotate_shear(x, theta, max_degrees=15.0)),
            ("blur", lambda: rotate_shear(x, theta, max_degrees=15.0,
                                          blur_sigma=sigma)),
            ("positive_transform", lambda: positive_transform(xv, d)))}
    print(json.dumps(out))
    return 0


def main() -> int:
    if not os.path.isdir(os.path.join(REPO, "hairci_torch")):
        raise SystemExit("chip_smoke: hairci_torch/ not found beside "
                         "chip_smoke.py; run it from a checkout of the repo")
    if sys.argv[1:2] == ["--kernel-times"]:
        return kernel_times(sys.argv[2] if len(sys.argv) > 2 else REPO)
    sys.path.insert(0, REPO)
    device = phase_device()
    phase_build()
    kern = phase_kernels()
    # the index, manifest and run dir are written inside the checkout and
    # removed afterwards
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_",
                                     dir=REPO) as workdir:
        encoder, paths, launches = phase_serve(workdir)
        phase_parity(encoder, paths)
        del encoder
        train = phase_train(workdir, kern)
        knn = phase_knn(workdir, train)
    phase_knn_full()
    phase_embed(kern["conv3x3"]["times"])
    phase_train_parity()
    rot, bn, topk = kern["rotate"], kern["bn_stats"], kern["topk"]
    conv = kern["conv3x3"]["times"][(CLI_BATCH, "bf16")]
    # ms (the card's time, calls back to back), host_ms (the wrapper's time
    # on the host), plain_ms, bound_ms and library_ms of a kernel are at one
    # shape: the top-k at Q=1 (its fma route) and, as
    # topk_gallery_search_batched, at Q=256 (its mma route, the batched
    # /search), both on the f32 gallery, each with its own bound, its own
    # route's score error and launches in the serve run; the rotation with blur at the step's
    # batch, the 55 BN inputs of one SHAM forward summed, and the conv at
    # the batch the kNN CLI ran it with (its launches are that run's), bf16,
    # weights packed by the caller as Conv2d does. No single PyTorch call
    # computes the first three (matmul + sort is two, grid_sample is no
    # 3-shear, and var_mean gives other statistics), so their library_ms is
    # null.
    topk_rows = []
    for name, route, Q in (("topk_gallery_search", "fma", 1),
                           ("topk_gallery_search_batched", "mma", 256)):
        kern_ms, plain_ms, host_ms, bound, took = topk["times"][(Q, "f32")]
        if took != route:
            raise AssertionError(f"topk at Q={Q} took the {took} route")
        topk_rows.append(
            {"name": name, "route": "cuda",
             "source": "hairci_torch/ops/csrc/topk.cu",
             "replaces": "hairci/ops/topk_pallas.py:43",
             "launches": launches[route],
             "max_abs_err": topk["max_abs_err"][(route, "f32")],
             "ms": kern_ms, "host_ms": host_ms, "plain_ms": plain_ms,
             "bound_ms": bound[0], "bound_by": bound[1],
             "library_ms": None})
    print(json.dumps({"kernels": topk_rows + [
        {"name": "rotate_shear", "route": "cuda",
         "source": "hairci_torch/ops/csrc/rotate.cu",
         "replaces": "hairci/ops/rotate_pallas.py:70",
         "launches": train["launches"]["rotate_shear"],
         "max_abs_err": rot["max_abs_err"],
         "ms": rot["times"]["blur"][0],
         "host_ms": rot["times"]["blur"][2],
         "plain_ms": rot["times"]["blur"][1],
         "bound_ms": rot["bound"][0], "bound_by": rot["bound"][1],
         "library_ms": None},
        {"name": "bn_stats", "route": "cuda",
         "source": "hairci_torch/ops/csrc/bn_stats.cu",
         "replaces": "tools/bn_stats_bench.py:28",
         "launches": train["launches"]["bn_stats"],
         "max_abs_err": bn["max_abs_err"],
         "ms": bn["step"][0],
         "host_ms": bn["step"][2],
         "plain_ms": bn["step"][1],
         "bound_ms": bn["bound"][0], "bound_by": bn["bound"][1],
         "library_ms": None},
        {"name": "conv3x3", "route": "cuda",
         "source": "hairci_torch/ops/csrc/conv3x3.cu",
         "replaces": "tools/fused_conv_bn_bench.py:47",
         "launches": knn["launches"]["conv3x3"],
         "max_abs_err": kern["conv3x3"]["max_abs_err"],
         "ms": conv["ms"], "host_ms": conv["host_ms"],
         "plain_ms": conv["plain_ms"],
         "bound_ms": conv["bound_ms"], "bound_by": conv["bound_by"],
         "library_ms": conv["library_ms"]}]}))
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
