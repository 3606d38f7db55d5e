"""Pretraining entry point of the port (``hairci/cli/mainpretrain.py``):
the same flags and YAML, SHAM only so far.

    python -m hairci_torch.cli.mainpretrain --mode SHAM --model resnet50 \\
        --size 224 --train_annotation data_train.csv --img_dir images/

``--model`` is resnet18, resnet50 or vit_b_16 (ViT-B/16 with block remat);
``--S2R2`` adds the Smooth-AP term at weight 1. ``--device`` defaults to
cuda and raises without a card; ``--device cpu`` runs the kernels' plain
twins. Other modes exit with "not yet ported".
"""

from __future__ import annotations

import logging
import random

import numpy as np
import torch

from hairci_torch.data import DataLoader, load_manifest
from hairci_torch.eval.knn import full_f32
from hairci_torch.ssl import build_recipe
from hairci_torch.train.engine import Trainer
from hairci_torch.utils.config import parse_pretrain_args
from hairci_torch.utils.device import resolve_device


def set_seed(seed: int) -> None:
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def build_recipe_from_args(args, num_batches: int):
    if args.mode != "SHAM":
        raise SystemExit(f"mode {args.mode!r} is not yet ported "
                         "(hairci_torch trains SHAM only)")
    return build_recipe(
        "SHAM", backbone=args.model, img_size=args.size,
        temperature=args.temp, learning_rate=args.lr,
        weight_decay=args.weight_decay, betas=(args.beta1, args.beta2),
        ema_momentum=args.ema, warm_up_epochs=args.warm_up_epochs,
        ablation=args.ablation, num_batches=num_batches,
        s2r2_weight=1.0 if args.S2R2 else 0.0,
        dtype=torch.bfloat16 if args.dtype == "bfloat16" else torch.float32)


def main(argv=None) -> Trainer:
    """Parse, train, and return the Trainer (its ``state`` holds the model)."""
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    args = parse_pretrain_args(argv)
    device = resolve_device(args.device)
    set_seed(args.seed)
    if not args.train_annotation or not args.img_dir:
        raise SystemExit("--train_annotation and --img_dir are required")
    manifest = load_manifest(args.train_annotation, args.img_dir)
    raw_size = max(args.size, int(args.size * 256 / 224))  # room for the crop
    loader = DataLoader(
        manifest, batch_size=args.batch_size, size=raw_size,
        mode="raw_resize", shuffle=True, drop_last=True, seed=args.seed,
        num_workers=args.num_workers)
    recipe = build_recipe_from_args(args, num_batches=len(loader))
    with full_f32(args.dtype):
        trainer = Trainer(recipe, loader, args, device)
        trainer.train()
    return trainer


if __name__ == "__main__":
    main()
