"""Hair- and face-retrieval CLIs (port of ``hairci/cli/retrieval.py``), same
flags: extract-or-load embeddings, or import a FAISS flat index the reference
persisted (``--faiss_index``), then single-query retrieval or visualization
grids.

    python -m hairci_torch.cli.retrieval --data_path DIR [--device cuda|cpu]
    python -m hairci_torch.cli.face_retrieval --data_path DIR [--model_name VITs]

``--device`` defaults to cuda and raises without a card.
"""

from __future__ import annotations

import argparse
import logging
import os
import random

log = logging.getLogger(__name__)


def build_retrieval_parser(kind: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=f"{kind.capitalize()} Image Retrieval Inference")
    p.add_argument("--ckpt_path", type=str, default=None)
    if kind == "hair":
        p.add_argument("--model_name", type=str, default="vit_base_patch16",
                       choices=["vit_base_patch16", "sim_vit_base_patch16"])
    else:
        p.add_argument("--model_name", type=str, default="VIT",
                       choices=["VIT", "VITs"])
    p.add_argument("--data_path", type=str, required=True)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--num_workers", type=int, default=8)
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default cuda; no silent CPU path)")
    p.add_argument("--embed_save_dir", type=str, default="save/embeddings")
    p.add_argument("--query_image", type=str, default=None)
    p.add_argument("--top_k", type=int, default=5)
    p.add_argument("--num_queries", type=int, default=5)
    p.add_argument("--save_visualization", action="store_true")
    p.add_argument("--vis_save_dir", type=str, default="save/visualizations")
    p.add_argument("--random_seed", type=int, default=42)
    p.add_argument("--extract_only", action="store_true")
    p.add_argument("--retrieve_only", action="store_true")
    p.add_argument("--force_extract", action="store_true")
    p.add_argument("--faiss_index", type=str, default=None,
                   help="import a reference-built FAISS flat index "
                        "(+ its paths .pkl, discovered by the reference's "
                        "naming) as the gallery instead of extracting")
    return p


def _visualize(index, encoder, args) -> None:
    """Retrieval grids (`hair_encoder.py:215-346` HairRetrievalVisualizer)."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        from PIL import Image
    except ImportError:
        log.warning("matplotlib unavailable; skipping visualization")
        return
    rng = random.Random(args.random_seed)
    queries = rng.sample(index.paths, min(args.num_queries, len(index)))
    os.makedirs(args.vis_save_dir, exist_ok=True)
    for qi, qpath in enumerate(queries):
        feat = encoder.encode_single_image(qpath)
        paths, scores = encoder.retrieve_similar_images(feat, index,
                                                        args.top_k + 1)
        fig, axes = plt.subplots(1, args.top_k + 1,
                                 figsize=(3 * (args.top_k + 1), 3.2))
        for ax, (p, s) in zip(
                axes, [(qpath, 1.0)] + list(zip(paths, scores))[1:]):
            ax.imshow(Image.open(p).convert("RGB"))
            ax.set_title("query" if p == qpath else f"{s:.3f}", fontsize=9)
            ax.axis("off")
        out = os.path.join(args.vis_save_dir, f"retrieval_{qi}.png")
        fig.savefig(out, dpi=150, bbox_inches="tight")
        plt.close(fig)
        log.info("saved %s", out)


def run(kind: str, argv=None) -> None:
    logging.basicConfig(level=logging.INFO)
    args = build_retrieval_parser(kind).parse_args(argv)

    from hairci_torch.retrieval.encoders import FaceEncoder, HairEncoder

    encoder_cls = HairEncoder if kind == "hair" else FaceEncoder
    encoder = encoder_cls(args.ckpt_path, args.model_name, device=args.device,
                          batch_size=args.batch_size)
    should_extract = not args.retrieve_only and (
        args.force_extract or not encoder.embeddings_exist(args.embed_save_dir))
    if args.faiss_index and (args.force_extract or args.extract_only):
        raise SystemExit(
            "--faiss_index loads a prebuilt gallery and skips extraction; "
            "it cannot be combined with --force_extract/--extract_only")
    if args.faiss_index:
        # the reference demo's artifacts load as the gallery
        # (app/inference.py:96-98; see retrieval/faiss_io.py)
        from hairci_torch.retrieval.faiss_io import load_faiss_flat

        index = load_faiss_flat(args.faiss_index, device=encoder.device)
    elif should_extract:
        index = encoder.extract_dataset_features(args.data_path,
                                                 args.embed_save_dir)
    elif not args.extract_only:
        index = encoder.load_embeddings(args.embed_save_dir)
    else:
        index = None

    if args.extract_only or index is None:
        return
    if args.save_visualization:
        _visualize(index, encoder, args)
    else:
        qpath = args.query_image or index.paths[0]
        feat = encoder.encode_single_image(qpath)
        paths, scores = encoder.retrieve_similar_images(feat, index,
                                                        args.top_k)
        print(f"Query: {qpath}")
        for rank, (p, s) in enumerate(zip(paths, scores), 1):
            print(f"  {rank}. {p}  (similarity {s:.4f})")


if __name__ == "__main__":
    run("hair")
