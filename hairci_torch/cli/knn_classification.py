"""Evaluation entry point of the port (``hairci/cli/knn_classification.py``):
the same flags and YAML.

    python -m hairci_torch.cli.knn_classification --mode SHAM \\
        --model resnet50 --eval_type knn --checkpoint_path output_dir/run \\
        --train_annotation train.csv --test_annotation test.csv \\
        --img_dir images/ --save_path classification_output_dir

Manifests -> ``DataLoader(mode="center_crop")`` -> the recipe's
``extract_features`` (``knn_transform`` + the backbone in eval mode) over
both loaders, L2-normalized -> one of four evaluations:

  * ``knn``: kNN for k in {5, 10, 20, 27, 30, 40, 642} in one pass ->
    ``knn_evaluation_results.txt``;
  * ``linear_prob``: the L-BFGS linear probe -> ``linear_probe_results.txt``;
  * ``visualization``: the 2-D projection of the test split ->
    ``umap_test.npz`` (and ``umap_test.png`` where matplotlib imports);
  * ``inter_intra_distance``: intra/inter-class variance of both splits ->
    ``variance_analysis_both.txt``.

``--mode`` is SHAM, simclr, simclr_supcon, mae, simMIM, dinov2, MSN,
DenseCL or siaMIM, every mode of the JAX CLI (BYOL is no evaluation mode
there, and SHAM v1 no mode of either CLI). mae and simMIM are ViT-B/16
whatever ``--model`` says (resnet18, resnet50 and vit_b_16 all mean
``vit_base_patch16``: the JAX package's ``VIT_CONFIGS`` lacks
``vit_b_16``). ``--device`` defaults
to cuda and raises without a card; ``--device cpu`` runs the kernels' plain
twins. ``--model`` is resnet18,
resnet50 or vit_b_16. ``--checkpoint_path`` takes a checkpoint of the
port's Trainer (the file, its run directory or its ``checkpoints/`` folder,
resolved to the newest), or a reference-trained ``.pth``/``.pt``: SHAM or
SimCLR on a ResNet, SimCLR on ``vit_b_16`` (a torchvision-layout ViT, read
by ``models.convert.torchvision_vit_state_dict``), or SupCon. A reference
``.pth`` of SHAM on a ViT exits: that layout is known for ResNets only (the
JAX package's ``convert_sham2`` reads ResNets only). A reference MAE
``.pth`` (timm encoder + lightly decoder) and SimMIM ``.pth`` (torchvision
ViT + linear decoder) are read by ``mae_state_dict`` / ``simmim_state_dict``.
dinov2 is ViT-S/16 with LayerScale whatever ``--model`` says; its features
are the student's. MSN is ViT-B/16 (resnet18, resnet50 and vit_b_16 all
mean ``vit_base_patch16``; the JAX recipe raises ``KeyError`` on
``vit_b_16``); its features are the EMA target branch's, which a Trainer
checkpoint restores with the online one. A reference DINOv2 ``.pth``
(student and teacher) and MSN ``.pth`` (anchor and target) are read by
``dinov2_state_dict`` / ``msn_state_dict`` into the online and EMA branches.
DenseCL's features are the online trunk's pooled ones; a reference DenseCL
``.pth`` (both branches) is read by ``densecl_state_dict``, and is ResNet-50
only, as ``convert_densecl`` reads it: with another ``--model`` the CLI
exits naming ``--model resnet50``. siaMIM is the ``siameseim`` recipe on
ViT-B/16 whatever ``--model`` says; its features are the online encoder's
raw cls token (no final norm). A reference SiameseIM ``.pth`` is read by
``siameseim_state_dict`` into both branches; where its decoder blocks'
norms (``siameseim_block_norm``) differ from the recipe's, the recipe is
built again with the file's ``block_norm``, as the JAX CLI does.
``--SHAM_mode`` is parsed and read by no mode, as in the JAX CLI.
"""

from __future__ import annotations

import argparse
import logging
import os

import torch

from hairci_torch.data import DataLoader, load_manifest
from hairci_torch.eval.classifier import Classifier
from hairci_torch.eval.knn import full_f32
from hairci_torch.models.convert import (
    densecl_state_dict,
    dinov2_state_dict,
    load_torch_state_dict,
    mae_state_dict,
    msn_state_dict,
    sham2_state_dict,
    siameseim_block_norm,
    siameseim_state_dict,
    simmim_state_dict,
    supcon_state_dict,
    torchvision_vit_state_dict,
)
from hairci_torch.ssl import build_recipe
from hairci_torch.train import checkpoint as ckpt_lib
from hairci_torch.utils.config import merge_config_with_args
from hairci_torch.utils.device import resolve_device
from hairci_torch.utils.seeding import set_seed

EVAL_MODES = ["mae", "simclr", "simclr_supcon", "dinov2", "simMIM",
              "siaMIM", "SHAM", "DenseCL", "MSN"]


def build_eval_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Self-supervised/Supervised Trainer Arguments "
                    "(hairci_torch eval)")
    p.add_argument("--save_path", type=str,
                   default="classification_output_dir")
    p.add_argument("--size", type=int, default=224)
    p.add_argument("--train_annotation", type=str)
    p.add_argument("--test_annotation", type=str)
    p.add_argument("--img_dir", type=str)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--mode", type=str, default="simclr_supcon",
                   choices=EVAL_MODES)
    p.add_argument("--model", type=str, default="resnet18",
                   choices=["resnet18", "resnet50", "vit_b_16"])
    p.add_argument("--checkpoint_path", type=str, default=None)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device: cuda (default) or cpu")
    p.add_argument("--SHAM_mode", type=str, default="embedding",
                   choices=["embedding", "reconstruction"])
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--config", type=str)
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--eval_type", default=None, type=str,
                   choices=["knn", "linear_prob", "visualization",
                            "inter_intra_distance"])
    p.add_argument("--dtype", type=str, default="bfloat16",
                   choices=["bfloat16", "float32"])
    return p


def recipe_for_eval(args, **recipe_kw):
    mode = "siameseim" if args.mode == "siaMIM" else args.mode
    return build_recipe(
        mode, backbone=args.model, img_size=args.size,
        dtype=torch.bfloat16 if args.dtype == "bfloat16" else torch.float32,
        **recipe_kw)


def _reference_state_dict(args, path: str, model):
    """A reference-trained ``.pth`` in the key layout of ``model`` (the
    recipe's online module): a state dict for both branches, or a pair
    (online, EMA) for the recipes whose file holds both."""
    sd = load_torch_state_dict(path)
    if args.mode == "simclr_supcon":
        return supcon_state_dict(sd)
    if args.mode == "DenseCL" and args.model != "resnet50":
        raise SystemExit(
            f"a reference DenseCL .pth holds ResNet-50 trunks (as hairci's "
            f"convert_densecl reads them); pass --model resnet50, not "
            f"--model {args.model}")
    readers = {"mae": mae_state_dict, "simMIM": simmim_state_dict,
               "dinov2": dinov2_state_dict, "MSN": msn_state_dict,
               "DenseCL": densecl_state_dict, "siaMIM": siameseim_state_dict}
    if args.mode in readers:
        try:
            return readers[args.mode](sd, model)
        except KeyError as e:
            raise SystemExit(f"{path}: not a reference {args.mode} .pth "
                             f"(missing {e})") from e
    if args.model.startswith("vit"):
        if args.mode == "SHAM":
            raise SystemExit(
                "a reference .pth of SHAM on a ViT cannot be read: the "
                "reference layout is known for ResNet backbones only (as in "
                "hairci's convert_sham2); evaluate a checkpoint of this "
                "package's Trainer instead")
        # SimCLR's ViTWrapper: backbone.{conv_proj, class_token, encoder.*}
        backbone = {k[len("backbone."):]: v for k, v in sd.items()
                    if k.startswith("backbone.")}
        try:
            vit = torchvision_vit_state_dict(backbone, model.backbone)
        except KeyError as e:
            raise SystemExit(
                f"{path}: not a reference SimCLR .pth on a torchvision ViT "
                f"(missing {e})") from e
        # + projection_head.layers.*, which sham2_state_dict keeps
        return {**{f"backbone.{k}": v for k, v in vit.items()},
                **sham2_state_dict(sd)}
    # SHAM and SimCLR: backbone.{0,1,4-7} + projection_head.layers.*
    return sham2_state_dict(sd)


def load_state(recipe, args, device: torch.device):
    """A seeded random state, then the checkpoint's weights over it.
    Returns (recipe, state): a reference SiameseIM ``.pth`` whose decoder
    blocks have the other norm rebuilds the recipe with the file's."""
    path = args.checkpoint_path
    reference = path and path.endswith((".pth", ".pt"))
    if reference and args.mode == "siaMIM":
        try:
            want = siameseim_block_norm(load_torch_state_dict(path))
        except ValueError as e:
            raise SystemExit(f"{path}: {e}") from e
        if want != recipe.block_norm:
            recipe = recipe_for_eval(args, block_norm=want)
    state = recipe.create_state(args.seed, min(args.batch_size, 8), device)
    if reference:
        sd = _reference_state_dict(args, path, state.online)
        online_sd, ema_sd = sd if isinstance(sd, tuple) else (sd, sd)
        state.online.load_state_dict(online_sd)
        if state.ema is not None:
            state.ema.load_state_dict(ema_sd)
        logging.info("torch checkpoint loaded from %s", path)
    elif path:
        # a run dir or its checkpoints/ folder resolves to the newest one
        for cand in (path, os.path.join(path, "checkpoints")):
            latest = ckpt_lib.get_latest_checkpoint(cand)
            if latest:
                path = latest
                break
        ckpt_lib.restore_weights(path, state)
        logging.info("checkpoint loaded from %s", path)
    else:
        logging.warning("no --checkpoint_path; evaluating random init")
    return recipe, state


def main(argv=None) -> Classifier:
    """Parse, evaluate, and return the Classifier (its cached features and
    labels are what the result file was written from)."""
    logging.basicConfig(level=logging.INFO)
    parser = build_eval_parser()
    args = parser.parse_args(argv)
    args = merge_config_with_args(args, parser, argv)
    if args.eval_type is None:
        raise SystemExit("--eval_type is required")
    recipe = recipe_for_eval(args)
    device = resolve_device(args.device)
    set_seed(args.seed)

    # deterministic eval loaders: exact CenterCrop(size) on the host,
    # normalize on the device inside the recipe's extract_features
    loaders = [DataLoader(load_manifest(annotation, args.img_dir),
                          args.batch_size, size=args.size, mode="center_crop",
                          shuffle=False, num_workers=args.num_workers)
               for annotation in (args.train_annotation, args.test_annotation)]
    recipe, state = load_state(recipe, args, device)

    def embed_fn(images):
        return recipe.extract_features(state, images)

    clf = Classifier(embed_fn, *loaders, args.save_path,
                     batch_size=args.batch_size, device=device)
    with full_f32(args.dtype):
        if args.eval_type == "knn":
            clf.knn_eval()
        elif args.eval_type == "linear_prob":
            clf.linear_probe_eval()
        elif args.eval_type == "visualization":
            clf.save_umap(split="test")
        else:
            clf.compute_intra_inter_variance(split="both")
    return clf


if __name__ == "__main__":
    main()
