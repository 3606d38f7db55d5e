"""Checkpoints (port of ``hairci/train/checkpoint.py``).

A checkpoint is one ``torch.save`` file holding the online module's state,
the optimizer, the step and the epoch, and the EMA module's state, the
mined-negative cache and the ``extra`` tensors where the state has them
(SHAM: EMA and cache; DINOv2: EMA and centres; MSN, BYOL and SHAM v1:
EMA; SiameseIM: EMA with its PermuteBN running statistics; DenseCL: EMA,
both banks and their integer pointers, so a resumed run writes the ring
where it stopped): everything resume needs, restored on the online
module's device. SHAM, SimCLR, SupCon, MAE and SimMIM checkpoints keep the key
sets they always had. The cadence
follows the JAX engine: ``model_ckpt_<epoch>`` every 50 epochs plus
``model_ckpt_latest`` each epoch. JAX's Orbax directories cannot be read here (no JAX).
Under data parallelism the state is the same on every rank and holds
nothing of the world size (the negative cache is the global batch's): rank
0 alone writes it (``train.engine``), and every rank of a run at any world
size restores it.
"""

from __future__ import annotations

import os
import re
from typing import Optional

import torch

from hairci_torch.train.state import TrainState

PERIODIC_RE = re.compile(r"model_ckpt_(\d+)$")


def save_checkpoint(save_path: str, name: str, state: TrainState,
                    epoch: int) -> str:
    """Write ``<save_path>/<name>`` atomically; returns its path."""
    path = os.path.abspath(os.path.join(save_path, name))
    tmp = path + ".tmp"
    # the keys in the order a SHAM checkpoint has always had them
    ckpt = {"online": state.online.state_dict(),
            "ema": None if state.ema is None else state.ema.state_dict(),
            "optimizer": state.optimizer.state_dict(),
            "neg_indices": state.neg_indices,
            "extra": state.extra,
            "step": state.step,
            "epoch": epoch}
    torch.save({k: v for k, v in ckpt.items() if v is not None}, tmp)
    os.replace(tmp, path)
    return path


def restore_checkpoint(path: str, state: TrainState) -> int:
    """Load ``path`` into ``state`` in place; returns the saved epoch."""
    device = next(state.online.parameters()).device
    ckpt = torch.load(path, map_location=device, weights_only=True)
    state.online.load_state_dict(ckpt["online"])
    if state.ema is not None:
        state.ema.load_state_dict(ckpt["ema"])
    state.optimizer.load_state_dict(ckpt["optimizer"])
    if state.neg_indices is not None:
        state.neg_indices.copy_(ckpt["neg_indices"])
    if state.extra is not None:
        for key in state.extra:
            state.extra[key] = ckpt["extra"][key]
    state.step = int(ckpt["step"])
    return int(ckpt["epoch"])


def restore_weights(path: str, state: TrainState) -> None:
    """Load the models of a Trainer checkpoint (evaluation): the online
    module, and the EMA where both the state and the file have one (MSN's
    features come from it), as the JAX package's ``restore_params_only``
    restores params and EMA params; the optimizer, the negative cache and
    the ``extra`` tensors stay as they are."""
    device = next(state.online.parameters()).device
    ckpt = torch.load(path, map_location=device, weights_only=True)
    state.online.load_state_dict(ckpt["online"])
    if state.ema is not None and "ema" in ckpt:
        state.ema.load_state_dict(ckpt["ema"])


def get_latest_checkpoint(folder: str) -> Optional[str]:
    """``model_ckpt_latest`` if present, else the highest-numbered periodic
    checkpoint, else None."""
    if not os.path.isdir(folder):
        return None
    latest = os.path.join(folder, "model_ckpt_latest")
    if os.path.isfile(latest):
        return latest
    best, best_n = None, -1
    for entry in os.listdir(folder):
        m = PERIODIC_RE.match(entry)
        if m and int(m.group(1)) > best_n:
            best, best_n = os.path.join(folder, entry), int(m.group(1))
    return best
