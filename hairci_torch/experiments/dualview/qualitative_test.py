"""Qualitative retrieval grids (port of
``hairci/experiments/dualview/qualitative_test.py``, the reference's
``qualitative_test.py``): random queries -> matplotlib grids of the query
and its top-k retrieved images. matplotlib is imported inside
``render_grids`` only.

    python -m hairci_torch.experiments.dualview.qualitative_test \
        --db_path data/hair_regions --out_dir save/qualitative

The embeddings are the ``HairEncoder``'s (``--ckpt_path`` a ``.pth``);
``--device`` defaults to cuda and raises without a card.
"""

from __future__ import annotations

import argparse
import logging
import os
import random
from typing import List

import numpy as np

log = logging.getLogger(__name__)


def render_grids(index, embed_query, out_dir: str, num_queries: int = 5,
                 top_k: int = 5, seed: int = 42) -> List[str]:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from PIL import Image

    os.makedirs(out_dir, exist_ok=True)
    rng = random.Random(seed)
    queries = rng.sample(index.paths, min(num_queries, len(index)))
    outs = []
    for qi, qpath in enumerate(queries):
        feat = embed_query(qpath)
        scores, paths = index.search_paths(np.asarray(feat)[None], top_k + 1)
        fig, axes = plt.subplots(1, top_k + 1,
                                 figsize=(3 * (top_k + 1), 3.2))
        entries = [(qpath, None)] + list(zip(paths[0][1:], scores[0][1:]))
        for ax, (p, s) in zip(axes, entries):
            ax.imshow(Image.open(p).convert("RGB"))
            ax.set_title("query" if s is None else f"{s:.3f}", fontsize=9)
            ax.axis("off")
        out = os.path.join(out_dir, f"qualitative_{qi}.png")
        fig.savefig(out, dpi=150, bbox_inches="tight")
        plt.close(fig)
        outs.append(out)
        log.info("saved %s", out)
    return outs


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser()
    p.add_argument("--db_path", required=True)
    p.add_argument("--ckpt_path", default=None)
    p.add_argument("--embed_dir", default="save/dualview_embeddings")
    p.add_argument("--out_dir", default="save/qualitative")
    p.add_argument("--num_queries", type=int, default=5)
    p.add_argument("--top_k", type=int, default=5)
    p.add_argument("--device", default=None,
                   help="cuda (the default; raises without a card) or cpu")
    args = p.parse_args(argv)

    from hairci_torch.retrieval.encoders import HairEncoder

    enc = HairEncoder(args.ckpt_path, batch_size=64, device=args.device)
    if enc.embeddings_exist(args.embed_dir):
        index = enc.load_embeddings(args.embed_dir)
    else:
        index = enc.extract_dataset_features(args.db_path, args.embed_dir)
    render_grids(index, enc.encode_single_image, args.out_dir,
                 args.num_queries, args.top_k)


if __name__ == "__main__":
    main()
