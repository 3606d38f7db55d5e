"""The reference of the retrieval cells: the plain float32 ViT forward of
``reference.vit`` for the embeddings, and an exact float64 top-k over the
seed's gallery for the answers.

Numbers compared, each the worst over the sampled requests' rows:
  ``embed``: |e_program - e_reference|, both unit vectors (the encoder:
      bf16 ViT-B/16, the final-normed class token, normalised);
  ``topk``: how far a returned score lies from the exact score of the
      returned row, or from the exact k-th best score at its rank, for the
      program's own query embedding (the top-k kernel; ties may pick
      either row).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from harness import data
from reference import vit
from reference.nn import Precision

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


def leaves(cfg) -> List[data.Leaf]:
    """The encoder's state: the trunk with the ``fc_norm`` it carries."""
    return vit.spec(cfg["model"]["arch"], cfg["img_size"], prefix="",
                    fc_norm=True)


def embed(cfg, P: Precision, params, images: np.ndarray, device,
          block: int = 64) -> torch.Tensor:
    """uint8 (n, S, S, 3) -> (n, D) unit rows, in blocks of rows."""
    mean = torch.tensor(MEAN, device=device)
    std = torch.tensor(STD, device=device)
    out = []
    with torch.no_grad():
        for s in range(0, len(images), block):
            x = torch.as_tensor(images[s:s + block], device=device)
            x = (x.float() / 255.0 - mean) / std
            f = vit.features(cfg["model"]["arch"], P, params, x, prefix="")
            out.append(f / torch.linalg.vector_norm(f, dim=1, keepdim=True))
    return torch.cat(out)


def _with_tf32(flag: bool):
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = flag
    torch.backends.cudnn.allow_tf32 = flag
    return old


def check(cfg, seed: int, device, pool: np.ndarray,
          sample: List[dict]) -> Dict[str, float]:
    """The numbers compared, over ``sample`` (finished requests: their
    crops' place in ``pool`` and what the program returned)."""
    old = _with_tf32(False)
    try:
        params = data.make_params(leaves(cfg), seed, device)
        gallery = data.make_gallery(cfg["serve"]["gallery_rows"],
                                    cfg["model"]["arch"]["width"], seed,
                                    device).double()
        worst_e, worst_t = 0.0, 0.0
        for q in sample:
            imgs = pool[q["start"]:q["start"] + q["size"]]
            ref = embed(cfg, Precision("f32"), params, imgs, device)
            e = torch.as_tensor(np.asarray(q["emb"]), device=device).float()
            worst_e = max(worst_e, float(torch.linalg.vector_norm(
                e - ref, dim=1).max()))
            worst_t = max(worst_t, _topk_gap(e, gallery, q["scores"],
                                             q["idx"]))
        return {"embed": worst_e, "topk": worst_t}
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = old


def _topk_gap(e: torch.Tensor, gallery: torch.Tensor, scores, idx) -> float:
    q = e.double()
    q = q / torch.linalg.vector_norm(q, dim=1, keepdim=True)
    exact = q @ gallery.T
    k = np.asarray(idx).shape[1]
    best = torch.topk(exact, k, dim=1).values
    s = torch.as_tensor(np.asarray(scores), device=e.device).double()
    i = torch.as_tensor(np.asarray(idx), device=e.device).long()
    if bool((i < 0).any()) or bool((i >= gallery.shape[0]).any()):
        return float("inf")
    at = exact.gather(1, i)
    return float(torch.maximum((s - at).abs(), (s - best).abs()).max())


def control(cfg, seed: int, device, pool: np.ndarray, sample: List[dict],
            k: int) -> List[dict]:
    """The reference put in the program's place one precision step down:
    the encoder with every product's inputs rounded to fp8 (the cell states
    bf16), the search as an f32 product in TF32 (the gallery is f32)."""
    params = data.make_params(leaves(cfg), seed, device)
    gallery = data.make_gallery(cfg["serve"]["gallery_rows"],
                                cfg["model"]["arch"]["width"], seed, device)
    out = []
    old = _with_tf32(True)
    try:
        for q in sample:
            imgs = pool[q["start"]:q["start"] + q["size"]]
            e = embed(cfg, Precision("fp8"), params, imgs, device)
            s, i = torch.topk(e @ gallery.T, k, dim=1)
            out.append({**q, "emb": e.cpu().numpy(),
                        "scores": s.cpu().numpy(), "idx": i.cpu().numpy()})
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = old
    return out
