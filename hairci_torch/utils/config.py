"""CLI + YAML config of the port (the flags of ``hairci/utils/config.py``).

The same flags, defaults and precedence (explicit CLI > YAML > argparse
default), with ``--device`` defaulting to ``cuda``. The port cannot import
``hairci.utils``, whose package imports JAX, so the parser lives here; and
``yaml`` is imported only when ``--config`` names a file, so a run given
its values as flags needs no ``yaml``.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional, Set

# reference modes (`mainpretrain.py:30-83`) + "siameseim": the reference
# trains SiameseIM via the external repo's main_pretrain.py
# (`scripts/train_hair_repsentation.sh`); hairci has the trainer in-tree
PRETRAIN_MODES = ["mae", "simclr", "simclr_supcon", "dinov2", "simMIM",
                  "SHAM", "S2R2", "DenseCL", "MSN", "BYOL", "siameseim"]
ABLATIONS = ["None", "randomly", "fixed_hard", "fixed_margin_0_7",
             "fixed_margin_0_5", "No_MSE", "No_Triplet",
             "No masked positive", "No_pos_transform"]


def build_pretrain_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Self-supervised/Supervised Trainer Arguments "
                    "(hairci_torch)")
    # Training config (flag parity with mainpretrain.py:34-50)
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device: cuda (default) or cpu")
    p.add_argument("--device_id", type=int, default=0)
    p.add_argument("--save_path", type=str, default="output_dir")
    p.add_argument("--size", type=int, default=224)
    p.add_argument("--train_annotation", type=str)
    p.add_argument("--test_annotation", type=str)
    p.add_argument("--img_dir", type=str)
    p.add_argument("--img_dir_origin", type=str, default=None)
    p.add_argument("--continue_training", action="store_true")
    p.add_argument("--checkpoint_folder", type=str, default=None)
    p.add_argument("--training_settings", type=int, default=1,
                   choices=[1, 2, 3, 4])
    p.add_argument("--full_face_training", action="store_true")
    p.add_argument("--multi_view", action="store_true")
    p.add_argument("--no_contrastive_loss", action="store_true")
    # optimization
    p.add_argument("--lr", type=float, default=0.001)
    p.add_argument("--weight_decay", type=float, default=1e-4)
    p.add_argument("--beta1", type=float, default=0.9)
    p.add_argument("--beta2", type=float, default=0.999)
    # loss
    p.add_argument("--temp", type=float, default=0.5)
    # model
    p.add_argument("--mode", type=str, default="simclr_supcon",
                   choices=PRETRAIN_MODES)
    p.add_argument("--model", type=str, default="resnet18",
                   choices=["resnet18", "resnet50", "vit_b_16"])
    # optional
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--config", type=str)
    p.add_argument("--num_workers", type=int, default=4)
    # negative sampling
    p.add_argument("--negative_sampling", action="store_true")
    p.add_argument("--warm_up_epochs", default=20, type=int)
    p.add_argument("--ema", type=float, default=0.99)
    p.add_argument("--k", type=int, default=15, choices=[3, 5, 7, 11, 15])
    # retrieval setting
    p.add_argument("--S2R2", action="store_true")
    # ablation study
    p.add_argument("--ablation", default="None", choices=ABLATIONS)
    # extras of the JAX package (not in the reference)
    p.add_argument("--dtype", type=str, default="bfloat16",
                   choices=["bfloat16", "float32"])
    # multi-device flags of the JAX package: one process a card, with the
    # batch split over the `data` axis (cli/mainpretrain.py)
    p.add_argument("--n_model_shards", type=int, default=1,
                   help="size of the `model` mesh axis")
    p.add_argument("--coordinator", type=str, default=None,
                   help="host:port of process 0 for multi-host init")
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_index", type=int, default=None)
    return p


def _explicit_dests(parser: argparse.ArgumentParser,
                    argv: List[str]) -> Set[str]:
    """Which dests were explicitly given on the command line."""
    explicit = set()
    for action in parser._actions:  # noqa: SLF001
        for opt in action.option_strings:
            if any(a == opt or a.startswith(opt + "=") for a in argv):
                explicit.add(action.dest)
    return explicit


def merge_config_with_args(args: argparse.Namespace,
                           parser: argparse.ArgumentParser,
                           argv: Optional[List[str]] = None
                           ) -> argparse.Namespace:
    """YAML overrides defaults but never explicit CLI flags."""
    if not (args.config and os.path.exists(args.config)):
        return args
    import yaml

    with open(args.config) as f:
        cfg = yaml.safe_load(f) or {}
    explicit = _explicit_dests(parser, argv if argv is not None else sys.argv[1:])
    for key, value in cfg.items():
        if not hasattr(args, key):
            continue
        if key in explicit:
            continue
        setattr(args, key, value)
    return args


def parse_pretrain_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = build_pretrain_parser()
    args = parser.parse_args(argv)
    return merge_config_with_args(args, parser, argv)
