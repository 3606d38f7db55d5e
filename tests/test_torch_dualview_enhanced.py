"""The enhanced DualViewHair encoders' steps in the port against the JAX
package on the CPU, ResNet-18 cut to one block a stage, B=16, from JAX's
state and on JAX's own student view: one ``multiscale`` step with
``hybrid_loss`` (its three terms too) at 64 px against JAX's jitted
``make_train_step``, and one ``partbased`` step with ``infonce`` at 128 px
(a 4 x 4 last map: every strip one row) against JAX's step run op by op
(jitted, XLA:CPU is 2 % off its own op-by-op run there); the reasons, the
measurements and the tolerances are in ``test_torch_dualview.py``'s
docstring. At these sizes a step's gradients move by up to 20 % when the
weights move by 1e-5 of themselves, in either package (ReLU and max
choices that lie within that band flip), and the two packages' forwards
lie about 1e-5 apart: so the comparison holds only where no choice falls
in the band. Measured on a CPU, it does (port and JAX within 2.2e-5 of a
tensor's largest gradient); it does not for ``multiscale`` at 128 px
(0.85 % at B=16 op by op) or at 64 px, B=8 (3.7 % jitted).
Then the cross-view alignment block, the converters' key sets at full
ResNet-50 width, and the part-based encoder's empty strips below 128 px."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hairci.experiments.dualview.enhanced as jenh
from hairci_torch.experiments.dualview import enhanced, models
from hairci_torch.models.convert import (
    cross_view_alignment_state_dict_from_jax,
    dualview_state_dict_from_jax,
)
from test_torch_distill import random_tree
from test_torch_dualview import blocky, check_step_against_jax, cut, jax_step_run
from test_torch_supcon import _close

torch.set_num_threads(1)


@pytest.mark.parametrize("encoder,loss,S,jit", [
    ("multiscale", "hybrid", 64, True), ("partbased", "infonce", 128, False)])
def test_enhanced_step_matches_jax(encoder, loss, S, jit, monkeypatch):
    cut(monkeypatch)
    run = jax_step_run(encoder, loss, S=S, B=16, jit=jit, jax_view=True)
    m = check_step_against_jax(run)
    if loss == "hybrid":
        assert set(m) == {"loss", "contrastive", "align", "uniform"}
        total = m["contrastive"] + 0.5 * m["align"] + 0.1 * m["uniform"]
        _close("hybrid terms", total, run["aux"]["loss"], 1e-4, 1e-7)


def test_cross_view_alignment_matches_jax():
    rng = np.random.default_rng(8)
    s, t = (rng.normal(size=(5, 256)).astype(np.float32) for _ in range(2))
    jm = jenh.CrossViewAlignment()
    params = random_tree(jax.eval_shape(lambda: jm.init(
        jax.random.key(0), s, t)), rng)["params"]
    want = jax.jit(lambda p: jm.apply({"params": p}, s, t))(params)
    module = enhanced.CrossViewAlignment()
    module.load_state_dict(cross_view_alignment_state_dict_from_jax(params),
                           strict=True)
    got = module(torch.from_numpy(s), torch.from_numpy(t))
    _close("aligned", got, want, 1e-5)


@pytest.mark.parametrize("encoder", ["resnet", "multiscale", "partbased"])
def test_full_width_encoders_convert_strictly(encoder):
    """The converter's key set is the port's at ResNet-50 full width (shapes
    only: no forward), and a part-based strip is empty below 128 px, as in
    JAX (NaN)."""
    from hairci.experiments.dualview.models import HairstyleEncoder

    jm = (HairstyleEncoder() if encoder == "resnet"
          else jenh.ENCODERS[encoder]())
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.key(0), jnp.zeros((1, 64, 64, 3)), train=True))
    sd = dualview_state_dict_from_jax(
        jax.tree_util.tree_map(lambda a: np.zeros(a.shape, a.dtype), shapes),
        encoder)
    with torch.device("meta"):
        module = models.DualViewHairModel(encoder=encoder).build_encoder()
    own = module.state_dict()
    assert set(sd) == set(own)
    assert all(tuple(sd[k].shape) == tuple(own[k].shape) for k in own)
    heads = {"resnet": ("proj_fc2.weight", (128, 256)),
             "multiscale": ("emb.weight", (256, 4096)),
             "partbased": ("part_heads.3.weight", (64, 2048))}[encoder]
    assert tuple(own[heads[0]].shape) == heads[1]


def test_partbased_strips_are_empty_below_128_px(monkeypatch):
    cut(monkeypatch)
    module = enhanced.PartBasedHairEncoder(backbone_name="resnet18").eval()
    x = torch.from_numpy(blocky(np.random.default_rng(9), 2, 64))
    with torch.no_grad():
        e = module(x, return_embedding=True)       # a 2 x 2 last map
    assert torch.isnan(e[:, 2 * 64:]).all() and torch.isfinite(e[:, :128]).all()
