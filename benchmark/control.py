"""Readings of a cell's compared numbers for many seeds in one process,
without a measured window: the program's (the lower readings of a limit)
and the control's, the reference one precision step below the
configuration's put in the program's place (the upper readings).

    python3 benchmark/control.py --workload NAME --side program|control \
        --seeds 11,12,13

Training cells: the program's set-up steps as a run takes them (the first
steps, the mining, the check steps of the window's stage; the same
``train_step`` call and feed), or the reference computed with every
product's inputs rounded to fp8 (the configuration states bf16) from the
same starts, each against the float32 reference. Retrieval cells: the requests a
run would check (the same sizes, crops and count), answered by the
program's encoder and index, or by the fp8 encoder and a TF32 search (the
gallery is f32). One JSON line a seed; the benchmark's own runs never run
this. ``--fault`` plants one of a training step's faults in the program
(a state left unchanged, half of the batch left out, the negatives read
from another batch's cache or altered where they are cached), for the
readings that bound a limit from above. Both sides take the drivers' own
set-up (``sham_train.prepare``, ``retrieve_closed.serve_setup``), so the
lower readings come from the code a run times.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _unchanged(recipe):
    """A step that returns its state unchanged."""
    import torch

    def step(state, x, gen, **kw):
        keep = [p.detach().clone() for p in state.online.parameters()]
        m = recipe.train_step(state, x, gen, **kw)
        with torch.no_grad():
            for p, k in zip(state.online.parameters(), keep):
                p.copy_(k)
        return m
    return step


def _half_batch(recipe):
    """Half of the batch left out, the mean taken over the rest (its rows
    repeated in the place of the others, so that every shape holds)."""
    import torch

    def step(state, x, gen, **kw):
        half = x[: x.shape[0] // 2]
        return recipe.train_step(state, torch.cat([half, half]), gen, **kw)
    return step


def _wrong_slot(recipe):
    """The window's stage reading the negatives cached for another batch."""
    def step(state, x, gen, stage="warmup", batch_id=0, **kw):
        if stage == "mined":
            batch_id = (batch_id + 1) % state.neg_indices.shape[0]
        return recipe.train_step(state, x, gen, stage=stage,
                                 batch_id=batch_id, **kw)
    return step


def _altered_negatives(recipe):
    """The cached negatives altered where they are made: each row's pick
    moved to the next row's."""
    def step(state, x, gen, stage="warmup", batch_id=0, **kw):
        m = recipe.train_step(state, x, gen, stage=stage, batch_id=batch_id,
                              **kw)
        if stage == "mine":
            state.neg_indices[batch_id] = state.neg_indices[batch_id].roll(1)
        return m
    return step


FAULTS = {"unchanged": _unchanged, "half_batch": _half_batch,
          "wrong_slot": _wrong_slot, "altered_negatives": _altered_negatives}


def train_readings(cell, seed: int, side: str, device, fault=None):
    import torch

    from drivers import sham_train
    from reference import sham as sham_ref

    cfg, tr = cell.config, cell.traffic
    device = torch.device(device)
    su = sham_train.prepare(cell, seed, device, FAULTS[fault] if fault
                            else None)
    prog, plans, snap = su.prog, su.plans, su.snap
    su = None
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    if side == "control":
        c = sham_train.reference_readings(cfg, tr, seed, device, plans, snap,
                                          "fp8")
        prog = {"start": c["start"], "mined": c["mined"],
                "picks": sham_ref.picks(c["sims"], cfg["sham"]["k"])}
    ref = sham_train.reference_readings(cfg, tr, seed, device, plans, snap)
    look = sham_ref.worst_leaves(prog, ref)
    look["losses"] = {part: [prog[part]["loss"], ref[part]["loss"]]
                      for part in ("start", "mined")}
    return sham_ref.compare(prog, ref, cfg["sham"]["k"]), look


def retrieve_readings(cell, seed: int, side: str, device, fault=None):
    import torch

    from drivers.retrieve_closed import answer, schedule, serve_setup
    from harness import data
    from reference import retrieve as ret_ref

    cfg, tr = cell.config, cell.traffic
    reqs = []
    for r in range(tr["sample_requests"]):
        size, start = schedule(tr, r % tr["clients"], r // tr["clients"])
        reqs.append({"size": size, "start": start})
    if side == "control":
        pool = data.make_images(tr["query_pool"], cfg["img_size"], seed,
                                data.QUERIES, device).cpu().numpy()
        answered = ret_ref.control(cfg, seed, device, pool, reqs, tr["k"])
    else:
        enc, index, pool = serve_setup(cfg, tr, seed, torch.device(device))
        answered = []
        for q in reqs:
            *_, emb, scores, idx = answer(enc.extract_features, index.search,
                                          pool, q["size"], q["start"],
                                          tr["k"])
            answered.append({**q, "emb": emb, "scores": scores, "idx": idx})
        enc = index = None
        gc.collect()
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    return ret_ref.check(cfg, seed, device, pool, answered), {}


def main(argv=None, device=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--side", choices=("program", "control"), required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--fault", choices=sorted(FAULTS),
                    help="plant a fault in the program's training step")
    args = ap.parse_args(argv)
    for p in (HERE, ROOT):
        if p not in sys.path:
            sys.path.insert(0, p)
    from harness import spec

    cell = spec.load_cell(args.workload, ROOT, HERE)
    import torch

    if device is None:
        if not torch.cuda.is_available():
            print("no CUDA device", file=sys.stderr)
            return 2
        device = "cuda"
    read = (train_readings if cell.traffic["driver"] == "sham_train"
            else retrieve_readings)
    limits = cell.config["limits"][cell.traffic["driver"]]
    for seed in (int(s) for s in args.seeds.split(",")):
        nums, look = read(cell, seed, args.side, device, args.fault)
        over = [k for k, lim in limits.items() if not nums[k] <= lim]
        line = {"workload": args.workload, "side": args.side,
                "fault": args.fault, "seed": seed, "numbers": nums,
                "limits": limits, "fails": over}
        print(json.dumps({**line, "look": look}), flush=True)
        print(json.dumps(line), file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
