"""DualViewHair training (port of ``hairci/experiments/dualview/train.py``,
the reference's scripts):
  simple_train.py     -> ``train(loss="infonce")``
  train_ntxent.py     -> ``train(loss="ntxent" | "asymmetric")``
  train_with_queue.py -> ``train(loss="queue")`` (4096-negative MomentumQueue)
  train_enhanced.py   -> ``train(encoder="multiscale" | "partbased",
                                 loss="hybrid")``
  compare_losses.py   -> ``compare_losses()`` (each loss briefly)

    python -m hairci_torch.experiments.dualview.train \\
        --data_root HairPretraining/data/hair_regions --save_path save/dv

The student's view is split as every random op of the port is: a draw half
(``_student_draw``, one CPU ``torch.Generator``: the crop with scale (0.6,
1), the flip, the colour jitter 0.4 / 0.4 / 0.4 / 0.1 with p = 0.8) and an
apply half (``_student_aug``) that takes the draws, so a test can feed
JAX's. Step i of epoch e draws from a generator seeded from (seed, e, i)
(``train.engine.step_seed``; JAX folds e * 10000 + i into its key). The queue's bank and pointer
live on the device beside the state and stay out of the checkpoint, as in
JAX. ``--device`` defaults to cuda and raises without a card; the run is
full f32 (no TF32 in cuDNN's convs or the matmuls).
"""

from __future__ import annotations

import argparse
import logging
import os
from typing import Dict, Optional

import torch

from hairci_torch.aug import ops
from hairci_torch.aug.pipelines import Draws, ViewConfig
from hairci_torch.eval.knn import full_f32
from hairci_torch.experiments.dualview.data import PairLoader
from hairci_torch.experiments.dualview.losses import (
    MomentumQueue,
    asymmetric_ntxent_loss,
    ntxent_loss_symmetric,
)
from hairci_torch.experiments.dualview.models import (
    DualViewHairModel,
    contrastive_loss,
)
from hairci_torch.train.engine import step_seed
from hairci_torch.utils.device import DeviceLike, resolve_device

log = logging.getLogger(__name__)

LOSSES = ("infonce", "ntxent", "asymmetric", "queue", "hybrid")


def _student_view(size: int) -> ViewConfig:
    """RandomResizedCrop(scale 0.6-1) + flip + ColorJitter(0.4, 0.4, 0.4,
    0.1) with p = 0.8, then normalise (``simple_dataloader.py:63``)."""
    return ViewConfig(size=size, crop_scale=(0.6, 1.0), cj_bright=0.4,
                      cj_contrast=0.4, cj_sat=0.4, cj_hue=0.1,
                      grayscale_p=0.0, blur_p=0.0)


def _student_draw(gen: torch.Generator, B: int, H: int, W: int) -> Draws:
    """The draw half of the student's view (small CPU tensors)."""
    return _student_view(H).draw(gen, B, H, W)


def _student_aug(x: torch.Tensor, draws: Draws) -> torch.Tensor:
    """The apply half: uint8 (B, S, S, 3) -> the normalised f32 view at S."""
    return _student_view(x.shape[1]).apply(x, draws)


def _teacher_aug(x: torch.Tensor) -> torch.Tensor:
    """The teacher's view: resize only (on the host), then normalise."""
    return ops.normalize(ops.to_float(x))


def make_train_step(model: DualViewHairModel, loss: str = "infonce",
                    queue: Optional[MomentumQueue] = None):
    """``step(state, batch, draws[, bank, ptr])`` on a uint8 ``batch`` of
    ``full`` and ``hair`` images on the state's device: the student's view
    from ``draws``, the teacher's, then ``model.update``. Returns the
    metrics (``loss``; with ``hybrid`` its three terms too), and with
    ``queue`` the bank and pointer after the teacher's projections were
    enqueued (the loss reads the bank as it was). ``step.on_views`` takes
    the two views ready-made."""
    if loss not in LOSSES:
        raise ValueError(loss)
    T = model.temperature

    def on_views(state, full, hair, bank=None, ptr=None):
        terms: Dict[str, torch.Tensor] = {}

        def loss_fn(student, teacher):
            if loss == "infonce":
                return contrastive_loss(student, teacher, T)
            if loss == "ntxent":
                return ntxent_loss_symmetric(student, teacher, T)
            if loss == "asymmetric":
                return asymmetric_ntxent_loss(student, teacher, T)
            if loss == "queue":
                return queue.loss(student, teacher, bank, T)
            from hairci_torch.experiments.dualview.enhanced import hybrid_loss

            total, parts = hybrid_loss(student, teacher, T)
            terms.update({k: v.detach() for k, v in parts.items()})
            return total

        l, teacher = model.update(state, full, hair, loss_fn)
        out = {"loss": l, **terms}
        if loss == "queue":
            bank, ptr = queue.enqueue(bank, ptr, teacher)
            return out, bank, ptr
        return out

    def step(state, batch, draws, bank=None, ptr=None):
        return on_views(state, _student_aug(batch["full"], draws),
                        _teacher_aug(batch["hair"]), bank, ptr)

    step.on_views = on_views
    return step


def train(data_root: str, epochs: int = 10, batch_size: int = 32,
          size: int = 224, loss: str = "infonce", seed: int = 42,
          learning_rate: float = 1e-3, dtype: torch.dtype = torch.float32,
          encoder: str = "resnet", save_path: Optional[str] = None,
          device: DeviceLike = None) -> Dict:
    """Train on the (full, hair) pairs under ``data_root``; returns the
    model, the state and the mean loss of each epoch. With ``save_path``,
    ``<save_path>/dualview_latest`` holds the state (``torch.save``)."""
    device = resolve_device(device)
    model = DualViewHairModel(learning_rate=learning_rate, dtype=dtype,
                              encoder=encoder)
    loader = PairLoader(data_root, batch_size, size)
    queue = MomentumQueue(model.projection_dim) if loss == "queue" else None
    step = make_train_step(model, loss, queue)
    # JAX draws a sample batch here for its init, which moves the loader's
    # shuffle on by one epoch: kept, so that the batches are JAX's
    next(iter(loader))
    state = model.create_state(seed, device)
    bank, ptr = queue.init(device) if queue else (None, None)
    history = []
    for epoch in range(epochs):
        losses = []
        for i, batch in enumerate(loader):
            B = batch["full"].shape[0]
            gen = torch.Generator().manual_seed(step_seed(seed, epoch, i))
            draws = _student_draw(gen, B, size, size)
            batch = {k: ops.to_device(torch.from_numpy(v), device)
                     for k, v in batch.items()}
            if queue:
                m, bank, ptr = step(state, batch, draws, bank, ptr)
            else:
                m = step(state, batch, draws)
            losses.append(m["loss"])
        avg = float(torch.stack(losses).mean())
        history.append(avg)
        log.info("epoch %d: loss %.4f", epoch, avg)
    if save_path:
        from hairci_torch.train.checkpoint import save_checkpoint

        os.makedirs(save_path, exist_ok=True)
        save_checkpoint(save_path, "dualview_latest", state, epoch=epochs)
        log.info("saved checkpoint to %s/dualview_latest", save_path)
    return {"model": model, "state": state, "history": history}


def compare_losses(data_root: str, epochs: int = 2, **kw) -> Dict[str, list]:
    """``compare_losses.py``: short runs of each loss variant."""
    return {name: train(data_root, epochs=epochs, loss=name, **kw)["history"]
            for name in ("infonce", "ntxent", "asymmetric", "queue")}


def main(argv=None) -> Dict:
    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser()
    p.add_argument("--data_root", required=True)
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--size", type=int, default=224)
    p.add_argument("--loss", default="infonce", choices=list(LOSSES))
    p.add_argument("--encoder", default="resnet",
                   choices=["resnet", "multiscale", "partbased"])
    p.add_argument("--save_path", default=None)
    p.add_argument("--device", default=None,
                   help="cuda (the default; raises without a card) or cpu")
    args = p.parse_args(argv)
    with full_f32("float32"):
        return train(args.data_root, args.epochs, args.batch_size, args.size,
                     args.loss, encoder=args.encoder,
                     save_path=args.save_path, device=args.device)


if __name__ == "__main__":
    main()
