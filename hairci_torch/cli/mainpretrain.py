"""Pretraining entry point of the port (``hairci/cli/mainpretrain.py``):
the same flags and YAML.

    python -m hairci_torch.cli.mainpretrain --mode SHAM --model resnet50 \\
        --size 224 --train_annotation data_train.csv --img_dir images/

``--mode`` is SHAM, simclr, S2R2 (SimCLR with the Smooth-AP term),
simclr_supcon (SupCon on a CIFAR-stem ResNet), mae or simMIM (the masked-
image recipes, always on ViT-B/16), dinov2 (ViT-S/16 with LayerScale and
the DINO/iBOT head), MSN (ViT-B/16), BYOL or DenseCL (both ResNet-50, with
the per-epoch cosine momentum), or siameseim (ViT-B/16 with the 512-wide
PermuteBN decoder, the per-epoch cosine momentum): ``--model`` is not
passed to the last seven, which take ``--epochs`` and the loader's length
for their schedules, as in the JAX CLI. SHAM v1 is no mode of either
package's CLI (``build_recipe("SHAM_v1")`` and the ``Trainer``).
``--model`` is resnet18, resnet50 or vit_b_16 (for SHAM, ViT-B/16 with
block remat); ``--S2R2`` adds the Smooth-AP term at weight 1 to SHAM and
SimCLR. SHAM drops the last partial batch; every other mode pads it to the
batch size by repeating its last row, as the JAX CLI does. ``--device``
defaults to cuda and raises without a card; ``--device cpu`` runs the
kernels' plain twins. Every mode of the JAX CLI is ported; an ``args``
with another mode exits with "not yet ported".

Several processes, one a card (``--device cpu``: gloo on the CPU)::

    python -m hairci_torch.cli.mainpretrain --mode SHAM --model resnet50 \
        --num_processes 4 --process_index $i --coordinator host0:29500 ...

rendezvous at ``--coordinator`` (NCCL on cards; rank i takes card
``i % device_count`` of its host) and train data-parallel on a ``(data,
model)`` mesh of ``--num_processes / --n_model_shards`` by
``--n_model_shards`` ranks. ``--batch_size`` is the global batch: each rank
decodes and trains on its rows of the batch the one-process run sees, and
the step of every mode is that run's (each recipe in ``ssl/`` says how).
The batch is split over ``data`` only, as in JAX. A batch the ``data`` axis
does not divide is refused: JAX shrinks the axis to ``gcd(batch,
devices)`` instead, but a process that owns a card cannot sit idle without
changing the result.
"""

from __future__ import annotations

import logging

import torch

from hairci_torch.data import DataLoader, load_manifest
from hairci_torch.eval.knn import full_f32
from hairci_torch.parallel import DATA_AXIS, collectives, create_mesh
from hairci_torch.ssl import build_recipe
from hairci_torch.train.engine import Trainer
from hairci_torch.utils.config import parse_pretrain_args
from hairci_torch.utils.device import resolve_device
from hairci_torch.utils.seeding import set_seed

__all__ = ["PORTED_MODES", "build_recipe_from_args", "check_data_parallel",
           "main", "set_seed"]

PORTED_MODES = ("SHAM", "simclr", "S2R2", "simclr_supcon", "mae", "simMIM",
                "dinov2", "MSN", "BYOL", "DenseCL", "siameseim")


def check_data_parallel(args) -> None:
    """Exit when several processes were asked for a mesh or a batch the
    ranks cannot split; run before the rendezvous."""
    n = args.num_processes or 1
    if n <= 1:
        return
    where = f"--num_processes {n}"
    if n % args.n_model_shards:
        raise SystemExit(f"{where} does not divide by --n_model_shards "
                         f"{args.n_model_shards}")
    w = n // args.n_model_shards
    if args.batch_size % w:
        raise SystemExit(
            f"--batch_size {args.batch_size} does not split over the W={w} "
            f"data-parallel ranks ({where}, --n_model_shards "
            f"{args.n_model_shards}): give a multiple of {w}")


def build_recipe_from_args(args, num_batches: int):
    """The mode dispatch of ``hairci/cli/mainpretrain.py``."""
    common = dict(
        img_size=args.size, learning_rate=args.lr,
        weight_decay=args.weight_decay, betas=(args.beta1, args.beta2),
        dtype=torch.bfloat16 if args.dtype == "bfloat16" else torch.float32)
    mode = args.mode
    if mode in ("simclr", "S2R2"):
        s2r2 = 1.0 if (mode == "S2R2" or args.S2R2) else 0.0
        return build_recipe("simclr", backbone=args.model,
                            temperature=args.temp, s2r2_weight=s2r2,
                            **common)
    if mode == "SHAM":
        return build_recipe(
            "SHAM", backbone=args.model, temperature=args.temp,
            ema_momentum=args.ema, warm_up_epochs=args.warm_up_epochs,
            ablation=args.ablation, num_batches=num_batches,
            s2r2_weight=1.0 if args.S2R2 else 0.0, **common)
    if mode == "simclr_supcon":
        # as in the JAX CLI: the backbone and --temp are not passed, so
        # SupCon trains a CIFAR-stem ResNet-18 at its temperature of 0.07
        return build_recipe(mode, **common)
    if mode in ("mae", "simMIM", "dinov2", "MSN", "BYOL", "DenseCL",
                "siameseim"):
        # as in the JAX CLI: no backbone is passed, so dinov2 trains
        # vit_small_patch16, BYOL and DenseCL resnet50 and the others
        # vit_base_patch16 whatever --model says; the run's length goes to
        # the schedules
        return build_recipe(mode, epochs=args.epochs,
                            steps_per_epoch=num_batches, **common)
    raise SystemExit(f"mode {mode!r} is not yet ported; ported: "
                     f"{', '.join(PORTED_MODES)}")


def main(argv=None) -> Trainer:
    """Parse, train, and return the Trainer (its ``state`` holds the model)."""
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    args = parse_pretrain_args(argv)
    check_data_parallel(args)
    device = resolve_device(args.device)
    if not args.train_annotation or not args.img_dir:
        raise SystemExit("--train_annotation and --img_dir are required")
    device = collectives.init_distributed(
        args.coordinator, args.num_processes, args.process_index, device)
    try:
        set_seed(args.seed)
        mesh = create_mesh(n_model=args.n_model_shards)
        manifest = load_manifest(args.train_annotation, args.img_dir)
        drop_last = args.mode == "SHAM"
        raw_size = max(args.size, int(args.size * 256 / 224))  # crop room
        loader = DataLoader(
            manifest, batch_size=args.batch_size, size=raw_size,
            mode="raw_resize", shuffle=True, drop_last=drop_last,
            pad_last=not drop_last, seed=args.seed,
            num_workers=args.num_workers,
            shard_index=mesh.coordinate(DATA_AXIS),
            shard_count=mesh.shape[DATA_AXIS])
        recipe = build_recipe_from_args(args, num_batches=len(loader))
        with full_f32(args.dtype):
            trainer = Trainer(recipe, loader, args, device, mesh=mesh)
            trainer.train()
    finally:
        if (args.num_processes or 1) > 1:
            collectives.shutdown()
    return trainer


if __name__ == "__main__":
    main()
