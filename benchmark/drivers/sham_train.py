"""Training traffic: SHAM steps of the port, as its ``Trainer`` drives them.

A traffic file for this driver gives ``batch`` (B), ``batch_ids`` (the
batches the window cycles over, each one's hard negatives mined once in
set-up), ``first_steps`` and ``first_stage`` (the first steps, which the
reference follows from the seed), ``stage`` (of the window's steps),
``check_steps`` (steps of the window's stage at the end of set-up, which
the reference follows from the program's state) and ``trace_seconds``.

Set-up builds one ``TrainState`` through ``SHAMRecipe.create_state``, loads
the seed's weights into it, makes the seed's batches (uint8, on the host,
moved as the ``Trainer`` moves them: pinned, without a wait), and drives it
through the stages in the ``Trainer``'s order, all through the same
``train_step`` call and feed as the window's: ``first_steps`` steps of
``first_stage`` (the warm-up, whose negatives are a drawn derangement);
one ``mine`` step a batch id, which fills the cache of negatives that the
window's steps read; then, from a copy of the program's state on the host,
``check_steps`` steps of the window's stage on batch ids 0, 1, ... The
window then runs ``stage`` steps over the batch ids in turn, and ends on a
device sync.

What the reference is compared with, once the window has closed: the
first steps from the seed; the negatives the first ``mine`` step cached,
against the reference's own similarity of that batch; the ``check_steps``
steps from the copied state, given the program's cached negatives.
"""

from __future__ import annotations

import gc
import time
from types import SimpleNamespace
from typing import Dict

import torch

from harness import data
from harness.profiling import profiler, read_trace
from reference import sham as sham_ref


def build(cfg, traffic, seed: int, device):
    """The recipe and the ``TrainState`` it creates, with the seed's
    weights loaded into the online model and its EMA teacher."""
    from hairci_torch.ssl.sham import SHAMRecipe

    r, model = cfg["sham"], cfg["model"]
    recipe = SHAMRecipe(
        backbone=model["backbone"], img_size=cfg["img_size"],
        temperature=r["temperature"], learning_rate=r["lr"],
        weight_decay=r["weight_decay"], betas=tuple(r["betas"]),
        ema_momentum=r["ema"], margin_stage1=r["margin_stage1"],
        margin_stage2=r["margin_stage2"], triplet_w=r["triplet_w"],
        mse_w=r["mse_w"], num_batches=traffic["batch_ids"],
        dtype=getattr(torch, cfg["dtype"]),
        mask_ratio_range=tuple(r["mask_ratio_range"]),
        s2r2_weight=r.get("s2r2_weight", 0.0),
        remat=model.get("remat", True))
    state = recipe.create_state(0, traffic["batch"], device)
    leaves = data.make_params(sham_ref.ShamReference(cfg, device).leaves,
                              seed, device)
    state.online.load_state_dict(leaves, strict=True)
    state.ema.load_state_dict(leaves, strict=True)
    return recipe, state


def snapshot(state) -> Dict[str, object]:
    """The program's ``TrainState`` copied to the host: the online and EMA
    state, Adam's moments and step count, the cached negatives."""
    opt = state.optimizer.state
    named = list(state.online.named_parameters())
    cpu = lambda t: t.detach().to("cpu", copy=True)
    return {"online": {n: cpu(t) for n, t in state.online.state_dict().items()},
            "ema": {n: cpu(t) for n, t in state.ema.state_dict().items()},
            "m": {n: cpu(opt[p]["exp_avg"]) for n, p in named},
            "v": {n: cpu(opt[p]["exp_avg_sq"]) for n, p in named},
            "t": int(float(opt[named[0][1]]["step"])),
            "neg": cpu(state.neg_indices)}


def readings(cfg, state, step, plan, m0=None) -> Dict[str, object]:
    """Drive the steps of ``plan`` ((stage, batch id, generator) each)
    through ``step`` and read what the reference is compared with: each
    step's loss, each leaf's first gradient as the optimiser took it
    (Adam's first moment after the first step, less beta1 times the moment
    ``m0`` before it, nought at the start, over 1 - beta1) and each leaf's
    change."""
    named = list(state.online.named_parameters())
    start = {n: p.detach().float().cpu().clone() for n, p in named}
    b1 = cfg["sham"]["betas"][0]
    losses, grad = [], {}
    for s, (stage, b, c) in enumerate(plan):
        losses.append(step(stage, b, c)["loss"])
        if s == 0:
            opt = state.optimizer.state
            m1 = ((n, opt[p]["exp_avg"].float().cpu()) for n, p in named)
            grad = sham_ref.norms(
                (n, (m if m0 is None else m - b1 * m0[n]) / (1 - b1))
                for n, m in m1)
    delta = sham_ref.norms((n, p.detach().float().cpu() - start[n])
                           for n, p in named)
    return {"loss": [float(v) for v in losses], "grad": grad, "delta": delta}


def prepare(cell, seed: int, device, program=None) -> SimpleNamespace:
    """Set-up as a run takes it, from the seed: the program's state driven
    through the first steps, the mining and the check steps, with what the
    reference needs to follow it (``plans``, ``snap``) and the program's
    readings (``prog``). ``step(stage, batch id, generator)`` is the
    window's call and feed; ``program(recipe)``, where given, makes the
    step that replaces ``recipe.train_step`` (the benchmark's own tests
    plant faults through it)."""
    from hairci_torch.aug.ops import to_device

    cfg, tr = cell.config, cell.traffic
    B, n_ids = tr["batch"], tr["batch_ids"]
    k = cfg["sham"]["k"]
    recipe, state = build(cfg, tr, seed, device)
    host = [data.make_images(B, cfg["img_size"], seed, (data.IMAGES, b),
                             device).cpu().numpy() for b in range(n_ids)]
    step_fn = program(recipe) if program else recipe.train_step

    def step(stage: str, b: int, c: int):
        x = to_device(torch.from_numpy(host[b]), device)
        return step_fn(state, x, data.step_generator(seed, c), stage=stage,
                       batch_id=b, k=k)

    # the stages in the Trainer's order: the warm-up steps, the mining of
    # every batch id, steps of the window's stage
    n0 = tr["first_steps"]
    plans = {"start": [(tr["first_stage"], b, b) for b in range(n0)],
             "mine": [("mine", b, n0 + b) for b in range(n_ids)],
             "mined": [(tr["stage"], i % n_ids, n0 + n_ids + i)
                       for i in range(tr["check_steps"])]}
    prog = {"start": readings(cfg, state, step, plans["start"])}
    for stage, b, c in plans["mine"]:
        step(stage, b, c)
    snap = snapshot(state)
    prog["picks"] = snap["neg"][plans["mine"][0][1]]
    prog["mined"] = readings(cfg, state, step, plans["mined"], snap["m"])
    return SimpleNamespace(recipe=recipe, state=state, step=step,
                           next_step=n0 + n_ids + tr["check_steps"],
                           plans=plans, snap=snap, prog=prog)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run(cell, seed: int, seconds: float, trace: bool, device,
        t_start: float, program=None) -> Dict[str, object]:
    """One run of the cell (``program`` as for ``prepare``)."""
    cfg, tr = cell.config, cell.traffic
    B, n_ids = tr["batch"], tr["batch_ids"]
    device = torch.device(device)
    su = prepare(cell, seed, device, program)
    step = su.step
    _sync(device)
    setup_s = time.perf_counter() - t_start

    # the window
    window_losses = []
    prof, traced = None, None
    if trace:
        prof = profiler(device)
        prof.start()
    t0 = tp0 = time.perf_counter()
    n = 0
    while True:
        window_losses.append(step(tr["stage"], n % n_ids,
                                  su.next_step + n)["loss"])
        n += 1
        now = time.perf_counter()
        if prof is not None and traced is None \
                and now - tp0 >= tr["trace_seconds"]:
            _sync(device)
            traced = (time.perf_counter() - tp0, n)
            prof.stop()
        if now - t0 >= seconds:
            break
    _sync(device)
    window_s = time.perf_counter() - t0
    if prof is not None and traced is None:
        traced = (window_s, n)
        prof.stop()
    bad = int((~torch.isfinite(torch.stack(window_losses).float())).sum())
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)

    rec = {"kind": "train", "setup_s": setup_s, "window_s": window_s,
           "steps": n, "images": n * B, "peak_bytes": peak,
           "attempted": n, "failed": bad, "config": cfg, "traffic": tr}
    if prof is not None:
        rec["trace"] = read_trace(prof)
        rec["trace_window_s"], rec["trace_steps"] = traced

    # the reference, once the program's state is freed
    prog, plans, snap = su.prog, su.plans, su.snap
    su = step = window_losses = None
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ref = reference_readings(cfg, tr, seed, device, plans, snap)
    rec["checks"] = sham_ref.compare(prog, ref, cfg["sham"]["k"])
    return rec


def reference_readings(cfg, tr, seed, device, plans, snap,
                       precision: str = "f32") -> Dict[str, object]:
    """The reference's readings, TF32 off: the first steps from the seed,
    the similarity the first ``mine`` step picks by (from the reference's
    own state after those steps) and the check steps from the program's
    copied state ``snap``, given its cached negatives."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    B, k = tr["batch"], cfg["sham"]["k"]
    try:
        ref = sham_ref.ShamReference(cfg, device, precision)
        st = ref.init_state(seed)
        out = {"start": ref.steps(st, seed, B, plans["start"], k)}
        _, b, c = plans["mine"][0]
        out["sims"] = ref.similarity(st, seed, B, b, c)
        st = ref.load_state(snap)
        st["cache"] = {b: snap["neg"][b].to(device)
                       for b in range(len(snap["neg"]))}
        out["mined"] = ref.steps(st, seed, B, plans["mined"], k)
        return out
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


def flops_per_step(cfg, tr) -> float:
    return sham_ref.step_flops(cfg, tr["batch"])
