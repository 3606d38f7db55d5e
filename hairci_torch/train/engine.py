"""Training engine (port of ``hairci/train/engine.py``).

The epoch loop feeds each uint8 batch and its labels to the card through
pinned memory and keeps the step metrics on the card until the epoch ends:
one host sync per epoch. SHAM is staged on the host (warmup -> mine ->
mined, with k adapted from the previous epoch's violations at the
boundary); DINOv2 takes its per-step teacher temperature and momentum at
the global step ``epoch * len(loader) + batch_id``; a recipe with
``momentum_for_epoch`` (BYOL, DenseCL, SiameseIM) takes that epoch's
momentum; every other recipe (SHAM v1 among them) takes the plain step,
with the batch's labels. It writes the
JAX engine's ``training_log.txt`` line (SHAM's, or ``Loss =`` for every
other mode) and ``metrics.jsonl`` (every metric of the step: DINOv2's
``dino_loss``, ``ibot_loss`` and ``koleo_loss``, DenseCL's ``global_loss``
and ``local_loss``, SHAM v1's ``global_loss``, ``local_loss`` and
``recon_loss`` too), and a checkpoint every 50 epochs plus
``model_ckpt_latest``; resume restores the EMA, SHAM's negative cache,
DINOv2's centres and DenseCL's banks too.

Data parallelism (``parallel``): the Trainer runs on a ``(data, model)``
mesh of the process group's ranks (``create_mesh`` from
``--n_model_shards`` unless one is given) and points the collectives at its
``data`` axis. The loader hands each rank its rows of the global batch,
and their labels; every recipe's step (SHAM v1's among them) is the global
batch's, with the same metrics on every rank, and only rank 0 writes the
logs and checkpoints. Every rank restores the same checkpoint, whatever
world size wrote it.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Any, Dict

import numpy as np
import torch

from hairci_torch.aug.ops import to_device
from hairci_torch.parallel import DATA_AXIS, collectives, create_mesh
from hairci_torch.train import checkpoint as ckpt_lib
from hairci_torch.train.state import TrainState

log = logging.getLogger(__name__)


def run_name(args) -> str:
    """Run-dir naming encoding the config (``hairci.train.engine.run_name``)."""
    parts = [
        args.mode,
        getattr(args, "model", "resnet18"),
        f"ep{args.epochs}",
        f"bs{args.batch_size}",
        f"lr{args.lr}",
        f"temp{getattr(args, 'temp', 0.5)}",
    ]
    if getattr(args, "mode", "") == "SHAM":
        parts += [f"warm{args.warm_up_epochs}", f"ema{args.ema}",
                  f"k{args.k}"]
    if getattr(args, "ablation", "None") != "None":
        parts.append(f"abl_{args.ablation.replace(' ', '_')}")
    if getattr(args, "full_face_training", False):
        parts.append("full_face_training")
    return "_".join(str(p) for p in parts)


def step_seed(seed: int, epoch: int, batch_id: int) -> int:
    """The seed of one step's generator (JAX folds epoch and batch into the
    base key the same way)."""
    return int(np.random.SeedSequence([seed, epoch, batch_id])
               .generate_state(1, np.uint64)[0])


class Trainer:
    def __init__(self, recipe, train_loader, args, device: torch.device,
                 checkpoint_every: int = 50, mesh=None):
        self.recipe = recipe
        self.train_loader = train_loader
        self.args = args
        self.device = device
        self.mesh = mesh or create_mesh(
            n_model=getattr(args, "n_model_shards", 1))
        collectives.set_group(self.mesh.group(DATA_AXIS))
        self.checkpoint_every = checkpoint_every
        self.save_path = os.path.join(
            getattr(args, "save_path", "output_dir"), run_name(args))
        self.main = collectives.is_main_process()
        if self.main:
            os.makedirs(self.save_path, exist_ok=True)
        self.log_file = os.path.join(self.save_path, "training_log.txt")
        self.metrics_file = os.path.join(self.save_path, "metrics.jsonl")
        self.start_epoch = 0
        self.prev_margin_violations = 0.0
        self.state: TrainState | None = None

    def create_or_restore_state(self) -> TrainState:
        state = self.recipe.create_state(getattr(self.args, "seed", 42),
                                         self.args.batch_size, self.device)
        if getattr(self.args, "continue_training", False):
            folder = (getattr(self.args, "checkpoint_folder", None)
                      or self.save_path)
            path = ckpt_lib.get_latest_checkpoint(folder)
            if path:
                epoch = ckpt_lib.restore_checkpoint(path, state)
                self.start_epoch = epoch + 1
                log.info("resumed from %s at epoch %d", path, epoch)
        return state

    def train(self) -> TrainState:
        args = self.args
        seed = getattr(args, "seed", 42)
        total_k = getattr(args, "k", 7)
        if len(self.train_loader) == 0:
            raise ValueError(
                f"train loader is empty: {len(self.train_loader.manifest)} "
                f"samples with batch_size={args.batch_size} and "
                f"drop_last={getattr(self.train_loader, 'drop_last', '?')}")
        state = self.state = self.create_or_restore_state()
        is_sham = args.mode == "SHAM"

        for epoch in range(self.start_epoch, args.epochs):
            self.train_loader.set_epoch(epoch)
            epoch_metrics = []
            t0 = time.perf_counter()
            n_images = 0
            if is_sham:
                stage = self.recipe.stage_for_epoch(epoch)
                if stage == "mine":
                    total_k = self.recipe.adapt_k(
                        self.prev_margin_violations, args.batch_size)
                    log.info("epoch %d: mining hard negatives with k=%d",
                             epoch, total_k)
            for batch_id, (images, labels) in enumerate(self.train_loader):
                gen = torch.Generator().manual_seed(
                    step_seed(seed, epoch, batch_id))
                x = to_device(torch.from_numpy(images), self.device)
                if is_sham:
                    metrics = self.recipe.train_step(
                        state, x, gen, stage=stage, batch_id=batch_id,
                        k=total_k)
                elif args.mode == "dinov2":
                    gstep = epoch * len(self.train_loader) + batch_id
                    metrics = self.recipe.train_step(
                        state, x, gen,
                        teacher_temp=self.recipe.teacher_temp(gstep),
                        momentum=self.recipe.momentum(gstep))
                elif hasattr(self.recipe, "momentum_for_epoch"):
                    # the per-epoch cosine momentum (BYOL, DenseCL,
                    # SiameseIM)
                    metrics = self.recipe.train_step(
                        state, x, gen,
                        momentum=self.recipe.momentum_for_epoch(epoch))
                else:
                    y = to_device(torch.from_numpy(
                        np.asarray(labels, np.int64)), self.device)
                    metrics = self.recipe.train_step(state, x, gen, labels=y)
                epoch_metrics.append(metrics)
                n_images += images.shape[0] * self.mesh.shape[DATA_AXIS]
            if not epoch_metrics:
                continue
            # one host sync per epoch
            keys = list(epoch_metrics[0])
            means = torch.stack([torch.stack([m[k].float() for k in keys])
                                 for m in epoch_metrics]).mean(0).tolist()
            stacked: Dict[str, Any] = dict(zip(keys, means))
            if is_sham:
                self.prev_margin_violations = stacked["margin_violations"]
            stacked["epoch"] = epoch
            stacked["images_per_sec"] = n_images / (time.perf_counter() - t0)
            if not self.main:
                continue
            self._log_epoch(epoch, stacked, total_k)

            if (epoch + 1) % self.checkpoint_every == 0:
                ckpt_lib.save_checkpoint(self.save_path,
                                         f"model_ckpt_{epoch + 1}", state,
                                         epoch)
            ckpt_lib.save_checkpoint(self.save_path, "model_ckpt_latest",
                                     state, epoch)
        return state

    def _log_epoch(self, epoch: int, metrics: Dict[str, Any],
                   total_k) -> None:
        with open(self.metrics_file, "a") as f:
            f.write(json.dumps(metrics) + "\n")
        m = metrics.get
        if self.args.mode == "SHAM":
            line = (
                f"\nEpoch {epoch}: Total Loss = {m('loss', 0):.6f}, "
                f"Contrastive Loss = {m('contrastive_loss', 0):.6f}, "
                f"Triplet Loss = {m('triplet_loss', 0):.6f}, "
                f"MSE loss = {m('mse_loss', 0):.6f}, "
                f"Positive distance = {m('pos_dist', 0):.6f}, "
                f"Negative distance = {m('neg_dist', 0):.6f}, "
                f"Margin violations: {m('margin_violations', 0)}, "
                f"Total k: {total_k}\n"
            )
        else:
            line = f"\nEpoch {epoch}: Loss = {m('loss', 0):.6f}\n"
        with open(self.log_file, "a") as f:
            f.write(line)
        log.info("epoch %d: %s", epoch,
                 {k: round(v, 4) if isinstance(v, float) else v
                  for k, v in metrics.items()})
