"""SHAM v1 in the port (``hairci_torch/ssl/sham_v1.py``) against the JAX
package's ``SHAMv1Recipe``: ``CrossAttention`` and ``CrossBlock`` (f32
scores in f32 and bf16), the projectors with flax's tanh GELU, the masked
encode, the decoder, the alignment and the features, one step in each
``sham_mode`` from identical weights, views and mask (every metric, every
gradient, the teacher's EMA taken BEFORE the step, the weights after Adam
with the global-norm clip), and both modes through ``build_recipe`` and
the ``Trainer`` on the CPU, which is the only way either package reaches
the recipe: neither CLI has a ``SHAM_v1`` mode.

Both packages' ``vit_base_patch16`` is cut to depth 2 at width 192, 3
heads, on 64-px views (a 4 x 4 grid, 4 tokens kept of 16). One jitted JAX
step for each mode. The step is compared at rtol 1e-4 (the EMA and the
optimizer on JAX's gradients at 1e-6), the building blocks in f32 at rtol
1e-5, in bf16 to bf16's rounding."""

import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import hairci.models.vit as jax_vit
import hairci.ssl.sham_v1 as jax_sham_v1
import hairci_torch.models.vit as port_vit
from hairci.cli import knn_classification as jax_eval_cli
from hairci.models.masking import random_token_mask
from hairci.train.state import TrainState as JaxTrainState
from hairci.utils.config import PRETRAIN_MODES as JAX_PRETRAIN_MODES
from hairci_torch.aug.pipelines import knn_transform
from hairci_torch.cli import knn_classification
from hairci_torch.data import DataLoader, load_manifest
from hairci_torch.models.convert import (
    _cross_block_from_jax,
    sham_v1_state_dict_from_jax,
)
from hairci_torch.models.masking import random_token_mask_from_noise
from hairci_torch.ssl import build_recipe
from hairci_torch.ssl.sham_v1 import SHAMv1Recipe
from hairci_torch.train.engine import Trainer
from hairci_torch.train.optim import clip_grad_global_norm_
from hairci_torch.utils.config import PRETRAIN_MODES
from test_torch_distill import random_tree
from test_torch_mae import IMG_DIR, manifests
from test_torch_supcon import _close

torch.set_num_threads(1)
B, S = 4, 64
TINY = (16, 192, 2, 3)            # patch, width, depth, heads
N = (S // 16) ** 2
MODES = ("embedding", "reconstruction")
MOMENTUM = 0.9    # the EMA's move shows above the tolerance
WD = 0.5          # one step's decay (lr * wd) shows above the tolerance
CPU = torch.device("cpu")


def _t(a):
    return torch.from_numpy(np.array(a))


def tiny(mp, port_only=False):
    for pkg in (port_vit,) if port_only else (port_vit, jax_vit):
        mp.setitem(pkg.VIT_CONFIGS, "vit_base_patch16", TINY)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_attention_and_block_match_jax(dtype):
    """Scores in f32 whatever the dtype, k before v in ``kv``, pre-norm
    with ``norm_q``, ``norm_kv`` and ``norm2``."""
    rng = np.random.default_rng(0)
    q = rng.normal(size=(3, 9, 32)).astype(np.float32)
    kv = rng.normal(size=(3, 11, 32)).astype(np.float32)
    jdt = jnp.dtype(dtype)
    tdt = getattr(torch, dtype)
    tol = (dict(rtol=1e-5, atol=1e-5) if dtype == "float32"
           else dict(rtol=2 ** -7, atol=3e-2))
    blk = jax_vit.CrossBlock(4, dtype=jdt)
    p = random_tree(jax.eval_shape(lambda: blk.init(
        jax.random.key(0), jnp.asarray(q), jnp.asarray(kv))), rng)["params"]
    sd = {}
    _cross_block_from_jax(sd, "b", p)
    port = port_vit.CrossBlock(32, 4, tdt)
    port.load_state_dict({k[2:]: v for k, v in sd.items()}, strict=True)
    # the attention alone, on the normed inputs the block hands it
    xattn = jax_vit.CrossAttention(4, dtype=jdt)
    want = xattn.apply({"params": p["xattn"]}, jnp.asarray(q),
                       jnp.asarray(kv))
    got = port.xattn(_t(q), _t(kv))
    assert got.dtype == tdt and want.dtype == jdt
    np.testing.assert_allclose(got.float().detach().numpy(),
                               np.asarray(want.astype(jnp.float32)), **tol)
    want = blk.apply({"params": p}, jnp.asarray(q, jdt), jnp.asarray(kv))
    got = port(_t(q).to(tdt), _t(kv))
    assert got.dtype == tdt
    np.testing.assert_allclose(got.float().detach().numpy(),
                               np.asarray(want.astype(jnp.float32)), **tol)


@pytest.fixture(scope="module", params=MODES)
def jax_run(request):
    """JAX's step, its pieces and features from a seeded state whose
    teacher is apart from the student; views are seeded arrays handed to
    both, the mask comes from JAX's key."""
    mode = request.param
    with pytest.MonkeyPatch.context() as mp:
        tiny(mp)
        orig = JaxTrainState.apply_gradients
        mp.setattr(JaxTrainState, "apply_gradients",
                   lambda self, grads, **kw: orig(self, grads, **kw).replace(
                       neg_indices=grads))
        rng = np.random.default_rng(1)
        vs, vt = (rng.normal(size=(B, S, S, 3)).astype(np.float32)
                  for _ in range(2))
        jrec = jax_sham_v1.SHAMv1Recipe(img_size=S, sham_mode=mode,
                                        dtype=jnp.float32, weight_decay=WD,
                                        ema_momentum=MOMENTUM)
        jrec.transform = lambda key, images: [jnp.asarray(vs),
                                              jnp.asarray(vt)]
        key = jax.random.key(9)
        _, k_mask = jax.random.split(key)
        noise = np.asarray(jax.random.uniform(k_mask, (B, N)))
        ids_keep, ids_restore, mask = random_token_mask(k_mask, B, N, 0.75)
        sample = jnp.zeros((B, S, S, 3), jnp.uint8)
        shapes = jax.eval_shape(lambda: jrec.create_state(
            jax.random.key(0), sample))
        params, ema = (random_tree(shapes.params, rng) for _ in range(2))
        state = JaxTrainState(
            step=jnp.zeros((), jnp.int32), params=params, batch_stats={},
            opt_state=jrec.tx.init(params), tx=jrec.tx, ema_params=ema,
            ema_batch_stats={})
        new, aux = jax.device_get(jax.jit(jrec.train_step)(
            state, {"image": sample}, key))
        # the pieces, eagerly, from the start state
        m, v = jrec.module, {"params": params}
        _, pooled, patches = m.apply(v, jnp.asarray(vs), ids_keep=ids_keep,
                                     method=m.encode)
        t_patches = m.apply(v, jnp.asarray(vt), method=m.encode)[2]
        pieces = {
            "pooled": pooled, "patches": patches,
            "global": m.apply(v, pooled, method=m.proj_global),
            "local": m.apply(v, t_patches, method=m.proj_local),
            "pixels": m.apply(v, patches, ids_restore,
                              method=m.decode_masked),
            "aligned": m.apply(v, t_patches, t_patches[:, ::-1],
                               jnp.ones((1, N, TINY[1])), method=m.align),
            "t_patches": t_patches}
        images = rng.integers(0, 256, (3, S + 8, S + 8, 3), dtype=np.uint8)
        feats = jrec.extract_features(state, jnp.asarray(images))
        out = jax.device_get(dict(
            views=(vs, vt), noise=noise,
            mask=(ids_keep, ids_restore, mask), start=params, ema=ema,
            new=new, aux=aux, pieces=pieces, images=images, feats=feats))
    return {"mode": mode, **out}


def _port_state(run, mp):
    tiny(mp, port_only=True)
    rec = SHAMv1Recipe(img_size=S, sham_mode=run["mode"],
                       dtype=torch.float32, weight_decay=WD,
                       ema_momentum=MOMENTUM)
    state = rec.create_state(0, B, CPU)
    state.online.load_state_dict(sham_v1_state_dict_from_jax(run["start"]),
                                 strict=True)
    state.ema.load_state_dict(sham_v1_state_dict_from_jax(run["ema"]),
                              strict=True)
    return rec, state


def _mask(run):
    got = random_token_mask_from_noise(_t(run["noise"]), 0.75)
    for g, w in zip(got, run["mask"]):
        np.testing.assert_array_equal(g.numpy(), w)
    return got


def test_pieces_and_features_match_jax(jax_run, monkeypatch):
    """encode (masked), proj_global, proj_local (flax's tanh GELU, which
    the exact erf misses by more than the tolerance), decode_masked, align
    and extract_features."""
    rec, state = _port_state(jax_run, monkeypatch)
    m, want = state.online, jax_run["pieces"]
    ids_keep, ids_restore, _ = _mask(jax_run)
    vs, vt = (_t(v) for v in jax_run["views"])
    with torch.no_grad():
        _, pooled, patches = m.encode(vs, ids_keep)
        _close("pooled", pooled, want["pooled"], 1e-5)
        _close("patches", patches, want["patches"], 1e-5)
        _close("proj_global", m.proj_global(_t(want["pooled"])),
               want["global"], 1e-5)
        t_patches = _t(want["t_patches"])
        local = m.proj_local(t_patches)
        _close("proj_local", local, want["local"], 1e-5)
        h = m.proj_local_ln(F.linear(t_patches, m.proj_local_fc.weight,
                                     m.proj_local_fc.bias))
        assert (F.gelu(h) - local).abs().max() > 1e-4
        _close("decode_masked", m.decode_masked(_t(want["patches"]),
                                                ids_restore),
               want["pixels"], 1e-5)
        _close("align", m.align(t_patches, t_patches.flip(1),
                                torch.ones(1, N, TINY[1])),
               want["aligned"], 1e-5)
    feats = rec.extract_features(state, _t(jax_run["images"]))
    assert feats.shape == (3, TINY[1])
    _close("features", feats, jax_run["feats"], 1e-5)


def test_step_matches_jax(jax_run, monkeypatch):
    rec, state = _port_state(jax_run, monkeypatch)
    new, aux = jax_run["new"], jax_run["aux"]
    metrics = rec.step_on_views(state, *(_t(v) for v in jax_run["views"]),
                                *_mask(jax_run))
    assert set(metrics) == set(aux) == {"loss", "global_loss",
                                        "local_loss"} | (
        {"recon_loss"} if jax_run["mode"] == "reconstruction" else set())
    for k, v in aux.items():
        _close(k, metrics[k], v, 1e-4, 1e-7)
    assert state.step == 1
    g = sham_v1_state_dict_from_jax(new.neg_indices)
    # the port's gradients are clipped in place: JAX's raw ones, clipped
    norm = torch.sqrt(sum((v.double() ** 2).sum() for v in g.values()))
    assert norm > 1.0                   # the clip acts
    for name, p in state.online.named_parameters():
        _close(f"grad {name}", p.grad, g[name] / norm.float(), 1e-4)
    if jax_run["mode"] == "embedding":
        assert not state.online.decoder_pred.weight.grad.any()
    # the teacher: the EMA of the parameters BEFORE the step
    ema = sham_v1_state_dict_from_jax(new.ema_params)
    for name, v in state.ema.state_dict().items():
        _close(f"ema {name}", v, ema[name], 1e-6, 1e-7)
    after = sham_v1_state_dict_from_jax(new.params)
    for name, p in state.online.named_parameters():
        gn = g[name].numpy()
        clear = np.abs(gn) > max(1e-3 * np.abs(gn).max(), 1e-6)
        _close(name, p.detach()[clear], after[name][clear], 1e-4)

    # the clip and the optimizer on JAX's gradients: every weight
    _, state = _port_state(jax_run, monkeypatch)
    for name, p in state.online.named_parameters():
        p.grad = g[name].clone()
    clip_grad_global_norm_(state.online.parameters(), 1.0)
    state.optimizer.step()
    for name, p in state.online.named_parameters():
        _close(f"param {name}", p, after[name], 1e-6, 1e-6)


@pytest.mark.parametrize("mode", MODES)
def test_trainer_trains_both_modes(mode, tmp_path, monkeypatch):
    """``build_recipe("SHAM_v1", sham_mode=...)`` through the ``Trainer``
    for 2 epochs of 3 batches of 4 (the last padded): the plain step with
    the batch's labels, which it ignores; every metric finite in
    ``metrics.jsonl``, JAX's ``Loss =`` line, a checkpoint with the
    teacher; the features are the student's."""
    tiny(monkeypatch, port_only=True)
    train_csv, _ = manifests(tmp_path)
    seen = []
    step = SHAMv1Recipe.train_step

    def spy(self, state, images, gen, labels=None):
        seen.append(labels is not None and labels.shape == (4,))
        return step(self, state, images, gen, labels=labels)

    monkeypatch.setattr(SHAMv1Recipe, "train_step", spy)
    rec = build_recipe("SHAM_v1", img_size=S, sham_mode=mode,
                       dtype=torch.float32)
    loader = DataLoader(load_manifest(train_csv, str(IMG_DIR)), 4,
                        size=S + 8, mode="raw_resize", shuffle=True,
                        drop_last=False, pad_last=True, seed=42,
                        num_workers=1)
    args = types.SimpleNamespace(
        mode="SHAM_v1", model="vit_b_16", epochs=2, batch_size=4, lr=1e-3,
        temp=0.5, seed=42, save_path=str(tmp_path / "out"))
    trainer = Trainer(rec, loader, args, CPU)
    state = trainer.train()
    assert seen == [True] * 6 and state.step == 6
    with open(f"{trainer.save_path}/metrics.jsonl") as f:
        metrics = [json.loads(line) for line in f]
    keys = {"loss", "global_loss", "local_loss"} | (
        {"recon_loss"} if mode == "reconstruction" else set())
    for m in metrics:
        assert keys <= set(m) and all(np.isfinite(m[k]) for k in keys)
    with open(f"{trainer.save_path}/training_log.txt") as f:
        assert f.read().count(": Loss = ") == 2
    ckpt = torch.load(f"{trainer.save_path}/model_ckpt_latest",
                      weights_only=True)
    assert set(ckpt) == {"online", "ema", "optimizer", "step", "epoch"}
    images = torch.from_numpy(next(iter(loader))[0])
    with torch.no_grad():
        want = state.online.backbone(knn_transform(images, S), pool=True)
    np.testing.assert_array_equal(
        rec.extract_features(state, images).numpy(), want.numpy())


def test_sham_v1_is_no_cli_mode():
    """Neither package's CLIs offer SHAM v1 (their choices agree); the
    evaluation CLIs parse ``--SHAM_mode`` and read it nowhere."""
    assert "SHAM_v1" not in JAX_PRETRAIN_MODES
    assert sorted(PRETRAIN_MODES) == sorted(JAX_PRETRAIN_MODES)
    assert knn_classification.EVAL_MODES == jax_eval_cli.EVAL_MODES
    assert "SHAM_v1" not in knn_classification.EVAL_MODES
    for cli in (knn_classification, jax_eval_cli):
        with pytest.raises(SystemExit):
            cli.build_eval_parser().parse_args(["--mode", "SHAM_v1"])
        args = cli.build_eval_parser().parse_args(
            ["--mode", "siaMIM", "--SHAM_mode", "reconstruction"])
        assert args.SHAM_mode == "reconstruction"
