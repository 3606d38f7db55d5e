"""Quantitative retrieval evaluation (port of
``hairci/experiments/dualview/quantitative_eval.py``, the reference's
``quantitative_eval.py:161-236``): a benchmark JSON -> Recall@K and mAP@K
for K in {10, 20, 50}, and the top-100 result JSON in the Visualizer
schema. The search is the port's ``GalleryIndex`` at k = 100 (its chunked
product: the top-k kernel serves k <= 8).

    python -m hairci_torch.experiments.dualview.quantitative_eval \\
        --db_path data/hair_regions --benchmark bench.json --model dualview \\
        --ckpt_path save/dv/dualview_latest --out log_json/top100.json

``--model dualview`` reads the port's own checkpoint of a
``DualViewHairModel`` (``torch.save``, written by ``train --save_path``;
JAX's Orbax directories need JAX), ``--model vit`` the ``HairEncoder``
(``.pth``). ``--device`` defaults to cuda and raises without a card; the
run is full f32 (no TF32).
"""

from __future__ import annotations

import argparse
import glob
import logging
import os
from typing import Callable, Dict, List, Sequence

import numpy as np
import torch

from hairci_torch.eval.knn import full_f32
from hairci_torch.eval.retrieval_metrics import (
    load_benchmark,
    recall_map_at_k,
    save_top100_results,
)
from hairci_torch.retrieval.index import GalleryIndex
from hairci_torch.utils.device import DeviceLike, resolve_device

log = logging.getLogger(__name__)


def evaluate(
    index: GalleryIndex,
    embed_query: Callable[[str], np.ndarray],
    benchmark: List[Dict],
    database_root: str,
    ks: Sequence[int] = (10, 20, 50),
    out_json: str = "log_json/dualviewhair_top100_results.json",
) -> Dict:
    """Runs the benchmark; query names are mapped ``<x>.jpg ->
    <x>_hair.png`` like the reference (``quantitative_eval.py:170-171``)."""
    queries, retrieved, gts = [], [], []
    for item in benchmark:
        qname = os.path.basename(item["query_image"])[:-4] + "_hair.png"
        qpath = os.path.join(database_root, qname)
        if not os.path.exists(qpath):
            log.warning("missing query %s", qpath)
            continue
        gt = [os.path.basename(g)[:-4] + "_hair.png"
              for g in item["ground_truth"]]
        feat = embed_query(qpath)
        _, paths = index.search_paths(feat[None], max(100, max(ks)))
        queries.append(qname)
        retrieved.append([os.path.basename(p) for p in paths[0]])
        gts.append(gt)
    results = recall_map_at_k(retrieved, gts, ks)
    save_top100_results(queries, retrieved, out_json)
    for k in ks:
        log.info("mAP@%d: %.4f  R@%d: %.4f", k, results["mAP"][k], k,
                 results["Recall"][k])
    return results


def _dualview_embedder(ckpt_path: str, encoder: str, size: int,
                       batch_size: int = 64, tower: str = "student",
                       device: DeviceLike = None):
    """(build_index, embed_query) over a trained ``DualViewHairModel``
    checkpoint (the reference's ``quantitative_eval_enhanced.py``): the
    embedding of the resized, normalised image, in eval mode. ``tower``:
    the student (the default, the reference's feature extraction) or the
    EMA teacher."""
    from hairci_torch.data.loader import decode_image
    from hairci_torch.experiments.dualview.models import DualViewHairModel
    from hairci_torch.experiments.dualview.train import _teacher_aug
    from hairci_torch.train.checkpoint import restore_checkpoint

    device = resolve_device(device)
    model = DualViewHairModel(encoder=encoder)
    state = model.create_state(0, device)
    if ckpt_path:
        restore_checkpoint(ckpt_path, state)

    def embed(imgs: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(np.require(imgs, requirements=["C", "W"])
                             ).to(device)
        return model.get_embeddings(state, _teacher_aug(x),
                                    use_teacher=(tower == "teacher")
                                    ).cpu().numpy()

    def embed_query(path: str) -> np.ndarray:
        return embed(decode_image(path, "raw_resize", size)[None])[0]

    def build_index(db_path: str) -> GalleryIndex:
        paths = sorted(glob.glob(os.path.join(db_path, "*_hair.png")))
        if not paths:
            paths = sorted(glob.glob(os.path.join(db_path, "*")))
        embs = [embed(np.stack([decode_image(p, "raw_resize", size)
                                for p in paths[i:i + batch_size]]))
                for i in range(0, len(paths), batch_size)]
        return GalleryIndex(np.concatenate(embs), paths, device=device)

    return build_index, embed_query


def main(argv=None) -> Dict:
    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser()
    p.add_argument("--db_path", required=True,
                   help="database image folder (hair crops)")
    p.add_argument("--benchmark", required=True, help="benchmark JSON")
    p.add_argument("--ckpt_path", default=None)
    p.add_argument("--embed_dir", default="save/dualview_embeddings")
    p.add_argument("--out", default="log_json/dualviewhair_top100_results.json")
    p.add_argument("--model", default="vit", choices=["vit", "dualview"],
                   help="vit = HairEncoder .pth (quantitative_eval.py); "
                        "dualview = the port's DualViewHairModel checkpoint "
                        "(quantitative_eval_enhanced.py)")
    p.add_argument("--encoder", default="resnet",
                   choices=["resnet", "multiscale", "partbased"])
    p.add_argument("--size", type=int, default=224)
    p.add_argument("--tower", default="student",
                   choices=["student", "teacher"],
                   help="which DualView tower embeds: student matches the "
                        "reference's feature extraction (default)")
    p.add_argument("--device", default=None,
                   help="cuda (the default; raises without a card) or cpu")
    args = p.parse_args(argv)

    with full_f32("float32"):
        if args.model == "dualview":
            build_index, embed_query = _dualview_embedder(
                args.ckpt_path, args.encoder, args.size, tower=args.tower,
                device=args.device)
            index = build_index(args.db_path)
        else:
            from hairci_torch.retrieval.encoders import HairEncoder

            enc = HairEncoder(args.ckpt_path, batch_size=64,
                              device=args.device)
            if enc.embeddings_exist(args.embed_dir):
                index = enc.load_embeddings(args.embed_dir)
            else:
                index = enc.extract_dataset_features(args.db_path,
                                                     args.embed_dir)
            embed_query = enc.encode_single_image
        bench = load_benchmark(args.benchmark)
        return evaluate(index, embed_query, bench, args.db_path,
                        out_json=args.out)


if __name__ == "__main__":
    main()
