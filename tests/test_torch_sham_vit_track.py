"""The 36-step SHAM loss track on ViT-B/16 with the S2R2 term: the checks
of tests/test_torch_sham_track.py (re-synced losses and mined indices,
the optimizer on JAX's gradients, the free-running tracks) with both
packages' ``vit_base_patch16`` cut to patch 8, width 64, depth 2, 2 heads
and the SHAM head to (64, 64, 32), at 64 px (64 tokens; the hair masking's
32 px patches are 4 an image), block remat as the recipe builds it. A file
of its own so that the suite's workers run the two tracks side by side.
``python tests/test_torch_sham_vit_track.py`` prints the track."""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_sham_track import (  # noqa: E402
    NUM_BATCHES,
    S,
    WARM,
    capture_grads,
    check_track,
    hair_views,
    run_track,
)
from test_torch_sham_vit import _random_variables, _tiny  # noqa: E402

from hairci.ssl.sham import SHAMRecipe as JaxSHAMRecipe  # noqa: E402
from hairci_torch.ssl.sham import SHAMRecipe  # noqa: E402

torch.set_num_threads(1)
# the free-running tracks' largest relative loss gap of a step: 4.4e-3
# measured; a ViT has no BN before its head, so the two runs stay close
FREE_RTOL = 0.02
TITLE = ("SHAM ViT-B/16 + S2R2 (patch 8, width 64, depth 2), 64 px, B=8: "
         "36 steps")


def vit_track():
    with pytest.MonkeyPatch.context() as mp:
        _tiny(mp)
        capture_grads(mp)
        kw = dict(backbone="vit_b_16", img_size=S, weight_decay=1e-4,
                  num_batches=NUM_BATCHES, warm_up_epochs=WARM,
                  s2r2_weight=1.0)
        jrec = JaxSHAMRecipe(**kw)
        rec = SHAMRecipe(**kw)
        views = hair_views(S, seed=1)
        rng = np.random.default_rng(1)
        start = (*_random_variables(jrec.module, views[0][0], rng),
                 *_random_variables(jrec.module, views[0][0], rng))
        return run_track(jrec, rec, "vit_b_16", start, views, S)


def test_sham_vit_s2r2_loss_track_matches_jax():
    check_track(vit_track(), TITLE, FREE_RTOL)


if __name__ == "__main__":
    check_track(vit_track(), TITLE, FREE_RTOL)
