"""Multi-process dry run (the port's counterpart of the JAX package's
``dryrun_multichip``): one process a rank, NCCL and one card a rank on
cards, gloo on the CPU.

    python -m hairci_torch.cli.dryrun_multichip --ranks 4 [--device cpu]

The N ranks form a ``(data, model)`` mesh of ``(N/2, 2)`` ranks when N is
even (``(N, 1)`` otherwise) and run five parts, each rank on its rows of a
global batch of ``2 x`` the ``data`` axis; rank 0 prints one line a part:

  1. SHAM's warmup, mine and mined steps (ResNet-18 at 32 px, f32), the
     batch split over ``data`` and replicated over ``model``;
  2. the tensor-parallel CosFace head (``models.face_vit.tp_margin_logits``):
     the (64 x model, 32) classifier's class rows split over ``model``, the
     embeddings over ``data``; one gradient step keeps each shard's rows,
     and its loss and updated shard are held against the unsharded head's
     (rtol 1e-5 / atol 1e-6);
  3. a DINOv2 step on ViT-Tiny (32-px global, 16-px local views);
  4. a SiameseIM step on ViT-Tiny (64-wide PermuteBN decoder);
  5. the row-sharded gallery search over ``data`` with its rank-1
     self-match check.

Every loss must be finite. The ranks must end with equal parameters, which
rank 0 checks by gathering a checksum of each part's weights.
"""

from __future__ import annotations

import argparse
import socket
import sys
from typing import Dict

import numpy as np
import torch

from hairci_torch.parallel import (
    DATA_AXIS,
    MODEL_AXIS,
    batch_sharding,
    collectives,
    create_mesh,
    model_sharding,
)
from hairci_torch.utils.device import resolve_device

SEED = 0
RAW = 48           # the uint8 images' side
S = 32             # the training views' side


def _say(n: int, text: str) -> None:
    if collectives.is_main_process():
        print(f"dryrun_multichip({n}): {text}", flush=True)


def _same_on_every_rank(module: torch.nn.Module, what: str) -> None:
    """Raise unless every rank holds the same parameters (an f64 checksum
    of each tensor, gathered over the world)."""
    if not collectives.active():
        return
    sums = torch.stack([p.detach().double().sum()
                        for p in module.state_dict().values()])
    every = collectives.all_gather(sums[None], group=torch.distributed.group
                                   .WORLD)
    if not bool((every == every[0]).all()):
        raise AssertionError(f"{what}: the ranks' parameters differ")


def _rows(mesh, x):
    """This rank's rows of a global batch, split over ``data``."""
    return batch_sharding(mesh, x.ndim).local(x)


def part_sham(mesh, dev: torch.device, images: torch.Tensor) -> float:
    """SHAM's three stages on ResNet-18 at 32 px; returns the mined loss."""
    from hairci_torch.aug.pipelines import simclr_transform
    from hairci_torch.ssl import build_recipe

    rec = build_recipe("SHAM", backbone="resnet18", img_size=S,
                       transform=simclr_transform(S), dtype=torch.float32,
                       num_batches=2, warm_up_epochs=2)
    B = images.shape[0]
    state = rec.create_state(SEED, B, dev)
    x = _rows(mesh, images).to(dev)
    for stage in ("warmup", "mine", "mined"):
        m = rec.train_step(state, x, torch.Generator().manual_seed(1),
                           stage=stage, batch_id=0, k=3)
        loss = float(m["loss"])
        if not np.isfinite(loss):
            raise AssertionError(f"non-finite SHAM loss at stage {stage}")
    _same_on_every_rank(state.online, "SHAM")
    return loss


def part_tp(mesh, dev: torch.device, B: int,
            loss_type: str = "CosFace") -> Dict[str, float]:
    """One step of the tensor-parallel margin head: this rank's class rows
    of the weight and its rows of the embeddings; returns the loss and the
    largest differences from the unsharded head's loss and step."""
    from hairci_torch.models.face_vit import margin_logits, tp_margin_logits

    n_model = mesh.shape[MODEL_AXIS]
    num_class, dim = 64 * n_model, 32
    rng = np.random.default_rng(SEED + 10)
    w = torch.from_numpy(rng.normal(size=(num_class, dim))
                         .astype(np.float32)).to(dev)
    emb = torch.from_numpy(rng.normal(size=(B, dim)).astype(np.float32)
                           ).to(dev)
    labels = torch.from_numpy(rng.integers(0, num_class, B)).to(dev)

    def nll(logits, y):   # each row's cross-entropy
        return -torch.log_softmax(logits, dim=-1).gather(1, y[:, None])[:, 0]

    w_shard = model_sharding(mesh, axis=0, ndim=2).local(w).clone()
    w_shard.requires_grad_(True)
    y = _rows(mesh, labels)
    logits = tp_margin_logits(w_shard, _rows(mesh, emb), y, loss_type,
                              mesh.group(MODEL_AXIS))
    # the global batch's mean over the data axis; its gradient, averaged
    # over the data ranks, is the global loss's (parallel.collectives)
    loss = collectives.global_mean(nll(logits, y))
    loss.backward()
    collectives.all_reduce_mean_([w_shard.grad])
    w2 = (w_shard - 0.1 * w_shard.grad).detach()
    loss = loss.item()
    if not np.isfinite(loss):
        raise AssertionError("non-finite TP margin loss")
    if w2.shape != w_shard.shape:
        raise AssertionError(f"the step's shard {tuple(w2.shape)} is not "
                             f"the weight's {tuple(w_shard.shape)}")

    # the unsharded head on the whole batch, on this rank
    w_full = w.clone().requires_grad_(True)
    ref = nll(margin_logits(w_full, emb, labels, loss_type), labels).mean()
    ref.backward()
    want = model_sharding(mesh, axis=0, ndim=2).local(
        (w_full - 0.1 * w_full.grad).detach())
    out = {"loss": loss, "loss_err": abs(loss - ref.item()),
           "step_err": float((w2 - want).abs().max())}
    if not (np.isclose(loss, ref.item(), rtol=1e-5, atol=1e-6)
            and torch.allclose(w2, want, rtol=1e-5, atol=1e-6)):
        raise AssertionError(f"TP margin head differs from the unsharded "
                             f"head's: {out}")
    return out


def part_dinov2(mesh, dev: torch.device, images: torch.Tensor) -> float:
    from hairci_torch.aug.pipelines import dino_transform
    from hairci_torch.ssl import build_recipe

    rec = build_recipe("dinov2", backbone="vit_tiny_patch16", img_size=S,
                       local_size=16, n_local=2, head_out=64,
                       dtype=torch.float32, epochs=1, steps_per_epoch=2,
                       transform=dino_transform(S, 16, 2))
    state = rec.create_state(SEED + 2, images.shape[0], dev)
    m = rec.train_step(state, _rows(mesh, images).to(dev),
                       torch.Generator().manual_seed(3), teacher_temp=0.04,
                       momentum=0.992)
    loss = float(m["loss"])
    if not np.isfinite(loss):
        raise AssertionError("non-finite DINOv2 loss")
    _same_on_every_rank(state.online, "DINOv2")
    return loss


def part_siameseim(mesh, dev: torch.device, images: torch.Tensor) -> float:
    from hairci_torch.ssl import build_recipe

    rec = build_recipe("siameseim", backbone="vit_tiny_patch16", img_size=S,
                       dtype=torch.float32, decoder_dim=64,
                       decoder_num_heads=4)
    state = rec.create_state(SEED + 4, images.shape[0], dev)
    m = rec.train_step(state, _rows(mesh, images).to(dev),
                       torch.Generator().manual_seed(5), momentum=0.996)
    loss = float(m["loss"])
    if not np.isfinite(loss):
        raise AssertionError("non-finite SiameseIM loss")
    _same_on_every_rank(state.online, "SiameseIM")
    return loss


def part_search(mesh, dev: torch.device) -> int:
    """The sharded search of 4 gallery rows as queries: each must find
    itself at rank 1. Returns the gallery's rows."""
    from hairci_torch.retrieval.sharded import sharded_gallery_search

    rng = np.random.default_rng(SEED + 20)
    g = rng.normal(size=(64 * mesh.shape[DATA_AXIS], 16)).astype(np.float32)
    g /= np.linalg.norm(g, axis=1, keepdims=True)
    q = torch.from_numpy(g[:4]).to(dev)
    shard = torch.from_numpy(batch_sharding(mesh, 2).local(g)).to(dev)
    _, idx = sharded_gallery_search(mesh, q, shard, k=5)
    if idx[:, 0].tolist() != [0, 1, 2, 3]:
        raise AssertionError(f"self-match rank-1: {idx[:, 0].tolist()}")
    return g.shape[0]


def run_parts(n: int, dev: torch.device) -> Dict[str, object]:
    """The five parts on this rank (inside the process group, if any)."""
    n_model = 2 if n % 2 == 0 and n > 1 else 1
    mesh = create_mesh(n_data=n // n_model, n_model=n_model)
    n_data = mesh.shape[DATA_AXIS]
    collectives.set_group(mesh.group(DATA_AXIS))
    rng = np.random.default_rng(SEED)
    B = 2 * n_data
    images = torch.from_numpy(rng.integers(0, 256, (B, RAW, RAW, 3),
                                           dtype=np.uint8))
    out: Dict[str, object] = {}
    out["sham"] = part_sham(mesh, dev, images)
    _say(n, f"SHAM staged steps ok, loss={out['sham']:.4f}")
    out["tp"] = part_tp(mesh, dev, B)
    _say(n, f"TP margin head ok (mesh {n_data}x{n_model}), "
            f"loss={out['tp']['loss']:.4f}")
    out["dinov2"] = part_dinov2(mesh, dev, images)
    _say(n, f"DINOv2 ViT dp step ok, loss={out['dinov2']:.4f}")
    out["siameseim"] = part_siameseim(mesh, dev, images)
    _say(n, f"SiameseIM dp step ok, loss={out['siameseim']:.4f}")
    rows = part_search(mesh, dev)
    _say(n, f"sharded gallery search ok ({rows} rows over {n_data} "
            "shards)")
    return out


def _rank(rank: int, n: int, port: int, device: str) -> None:
    torch.set_num_threads(1)
    dev = collectives.init_distributed(f"localhost:{port}", n, rank,
                                       torch.device(device))
    try:
        run_parts(n, dev or torch.device(device))
    finally:
        collectives.shutdown()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def dryrun_multichip(n: int, device: str = "cuda") -> None:
    """Spawn ``n`` ranks (one process a rank; on cards, one card a rank)
    and run the five parts; raises if a rank fails."""
    dev = resolve_device(device)
    if dev.type == "cuda" and torch.cuda.device_count() < n:
        raise SystemExit(f"dryrun_multichip: {n} ranks need {n} cards, "
                         f"found {torch.cuda.device_count()}")
    torch.multiprocessing.spawn(_rank, args=(n, _free_port(), dev.type),
                                nprocs=n)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--ranks", type=int, default=8,
                   help="processes (cards on a GPU machine)")
    p.add_argument("--device", default="cuda",
                   help="cuda (NCCL, one card a rank) or cpu (gloo)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.ranks < 1:
        raise SystemExit("--ranks must be at least 1")
    dryrun_multichip(args.ranks, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
