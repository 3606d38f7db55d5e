"""Interactive demo (port of ``hairci/serve/demo.py``; the reference's Gradio
app, ``HairPretraining/app/inference.py`` + ``app/app.py``): segment ->
embed -> retrieve, end to end.

  - ``parsing_image`` (``inference.py:145-185``): the hair mask of
    ``preprocess/face_toolkit.hair_mask`` (facer RetinaFace + FaRL/LaPa
    class 10, its models loaded once a process on ``device``, default
    cuda; the Otsu threshold of the luminance where facer is not
    installed) -> the hair on a black background and a white-background
    display image. A query in which facer finds no face also gets the Otsu
    mask, as in the JAX package.
  - ``DemoPipeline.build_index`` (``inference.py:79-100``): the encoder's
    gallery (``embeddings.npy`` + ``image_paths.txt``), or a FAISS flat
    index the reference's demo persisted (``index_hair_region.index`` +
    ``paths_hair_region.pkl``) after checking its width against the
    encoder's, on the encoder's device.
  - ``DemoPipeline.retrieve`` (``inference.py:103-131``): the query's hair
    region -> the encoder on its device -> the top-k search (the CUDA top-k
    kernel on a card) -> hole-filled white-background display images.
  - ``launch_gradio`` (``app/app.py:31-97``): the UI; gradio is imported
    there only.
"""

from __future__ import annotations

import logging
import os
from typing import List, Optional, Tuple

import numpy as np
from PIL import Image

from hairci_torch.preprocess.face_toolkit import hair_mask, luminance_mask
from hairci_torch.retrieval.index import GalleryIndex
from hairci_torch.utils.device import DeviceLike

log = logging.getLogger(__name__)

FAISS_ARTIFACT = "index_hair_region.index"


def parsing_image(image: np.ndarray, device: DeviceLike = None
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """(hair region on black, hair display on white) uint8 arrays of an RGB
    uint8 image."""
    mask = hair_mask(image, device)
    if mask is None:
        log.warning("no face found in the query; luminance-threshold mask")
        mask = luminance_mask(image)
    hair_region = image * mask[..., None].astype(np.uint8)
    hair_display = np.where(mask[..., None], image, 255).astype(np.uint8)
    return hair_region, hair_display


def fill_holes_display(image: np.ndarray) -> np.ndarray:
    """White-background rendering with the mask's holes filled
    (``inference.py:118-126``)."""
    from scipy.ndimage import binary_fill_holes

    filled = binary_fill_holes(image.sum(axis=-1) > 0)
    return np.where(filled[..., None], image, 255).astype(np.uint8)


class DemoPipeline:
    """``general_pipeline`` (``inference.py:190-246``) over one of the
    port's retrieval encoders; the index lives on the encoder's device."""

    def __init__(self, encoder, index_dir: str = "save/demo_index"):
        self.encoder = encoder
        self.index_dir = index_dir
        self.index: Optional[GalleryIndex] = None

    def build_index(self, dataset_path: str, force: bool = False
                    ) -> GalleryIndex:
        from hairci_torch.retrieval.faiss_io import load_faiss_flat

        device = self.encoder.device
        faiss_file = os.path.join(self.index_dir, FAISS_ARTIFACT)
        if not force and GalleryIndex.exists(self.index_dir):
            self.index = GalleryIndex.load(self.index_dir, device=device)
        elif not force and os.path.exists(faiss_file):
            # artifacts the reference demo persisted (inference.py:96-98).
            # Its gallery was embedded by the REFERENCE's model and queries
            # go through self.encoder, so the spaces match only where the
            # checkpoint is the same model's
            self.index = load_faiss_flat(faiss_file, device=device)
            log.info("imported reference faiss artifact %s (%d vectors, "
                     "dim %d)", faiss_file, len(self.index), self.index.dim)
            if self.encoder.feature_dim != self.index.dim:
                raise ValueError(
                    f"{faiss_file}: gallery dim {self.index.dim} != encoder "
                    f"output dim {self.encoder.feature_dim}. The imported "
                    "gallery was embedded by a different model: load the "
                    "matching torch checkpoint or rebuild the index with "
                    "force=True.")
        else:
            self.index = self.encoder.extract_dataset_features(
                dataset_path, self.index_dir)
        return self.index

    def retrieve(self, image: np.ndarray, k: int = 5
                 ) -> Tuple[List[np.ndarray], List[float], List[str]]:
        """Segment the RGB uint8 ``image``, embed its hair region, and return
        the top-k display images, scores and paths."""
        if self.index is None:
            raise RuntimeError("call build_index first")
        hair_region, _ = parsing_image(image, self.encoder.device)
        os.makedirs(self.index_dir, exist_ok=True)
        tmp = os.path.join(self.index_dir, "_query.png")
        Image.fromarray(hair_region).save(tmp)
        feat = self.encoder.encode_single_image(tmp)
        paths, scores = self.encoder.retrieve_similar_images(
            feat, self.index, k)
        images = []
        for p in paths:
            with Image.open(p) as im:
                images.append(fill_holes_display(np.asarray(im.convert("RGB"))))
        return images, [float(s) for s in scores], paths


def launch_gradio(pipeline: DemoPipeline, checkpoints: dict | None = None,
                  **launch_kw):
    """The Gradio UI (``app/app.py:31-97``): a query image in, the top-5
    images and scores out. Raises ImportError where gradio is not
    installed."""
    import gradio as gr

    def run(img):
        images, scores, _ = pipeline.retrieve(np.asarray(img), k=5)
        return [(Image.fromarray(im), f"{s:.3f}")
                for im, s in zip(images, scores)]

    with gr.Blocks(title="Hair-centric retrieval demo") as demo:
        gr.Markdown("# Hair-centric image retrieval")
        with gr.Row():
            input_img = gr.Image(label="Query image")
            gallery = gr.Gallery(label="Top-5 retrieved", columns=5)
        input_img.change(run, inputs=input_img, outputs=gallery)
    return demo.launch(**launch_kw)
