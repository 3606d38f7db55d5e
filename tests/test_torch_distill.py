"""The port's distillation losses (hairci_torch/losses/distill.py), its
schedules, the DINO head and the LayerScale ViT against the JAX package on
the CPU: every loss and its gradients at rtol 1e-5 (Sinkhorn at 0 and 3
iterations; KoLeo with duplicated rows, which must stay finite), the
schedules at the engine's steps exactly, and ``DINOHead`` and a ViT with
LayerScale in f32 (rtol 1e-5) and bf16 (bf16-scale tolerances, stated at
each check)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hairci.losses.distill as jd
import hairci.train.schedules as js
import hairci.models.heads as jheads
from hairci.models.heads import DINOHead as JaxDINOHead
from hairci.models.vit import VisionTransformer as JaxViT
from hairci.ssl.dinov2 import DINOv2Recipe as JaxDINOv2Recipe
from hairci_torch.losses import distill as pd
from hairci_torch.models.convert import vit_state_dict_from_jax
from hairci_torch.models import heads as port_heads
from hairci_torch.models.heads import DINOHead
from hairci_torch.models.vit import VisionTransformer
from hairci_torch.ssl.dinov2 import DINOv2Recipe
from hairci_torch.train import schedules as ps

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-6)


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), requires_grad=grad)


def _rng(seed):
    return np.random.default_rng(seed)


def _normal(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def close(got, want, name="", **tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), err_msg=name,
                               **(tol or TOL))


def check_grads(jax_fn, torch_fn, arrays, argnums, has_aux=False):
    """The value and the gradients w.r.t. ``argnums`` of a scalar function
    in both packages on the same arrays, JAX's in one compile. With
    ``has_aux`` both functions return (value, aux): the aux pair (port's,
    JAX's) is returned."""
    out, jgrads = jax.jit(jax.value_and_grad(
        jax_fn, argnums=argnums, has_aux=has_aux))(
            *[jnp.asarray(a) for a in arrays])
    ts = [_t(a, grad=i in argnums) for i, a in enumerate(arrays)]
    got = torch_fn(*ts)
    (want, jaux), (got, aux) = ((out, got) if has_aux
                                else ((out, None), (got, None)))
    got.backward()
    close(got, want, "value")
    for i, g in zip(argnums, jgrads):
        # no gradient through a detached input: JAX's stop_gradient gives 0
        close(torch.zeros_like(ts[i]) if ts[i].grad is None else ts[i].grad,
              g, f"grad {i}")
    return (aux, jaux) if has_aux else got


def test_cosine_losses_match_jax():
    rng = _rng(0)
    p, z = _normal(rng, 6, 16), _normal(rng, 6, 16)
    check_grads(jd.negative_cosine_similarity, pd.negative_cosine_similarity,
                [p, z], (0, 1))
    for reduction in ("mean", "sum", "none"):
        check_grads(
            lambda a, b: jnp.sum(jd.distillation_loss(a, b, reduction)),
            lambda a, b: torch.sum(pd.distillation_loss(a, b, reduction)),
            [p, z], (0, 1))


def test_dino_loss_and_centre_match_jax():
    """Two teacher views, four student views (same-view pairs skipped), a
    centre away from zero, a warmed-up temperature."""
    rng = _rng(1)
    B, K = 5, 32
    teacher = [_normal(rng, B, K, scale=3) for _ in range(2)]
    student = [_normal(rng, B, K, scale=3) for _ in range(4)]
    center = _normal(rng, 1, K)

    def jfn(*xs):
        return jd.dino_loss(tuple(xs[:2]), tuple(xs[2:6]), xs[6],
                            teacher_temp=0.055)

    def pfn(*xs):
        return pd.dino_loss(xs[:2], xs[2:6], xs[6], teacher_temp=0.055)

    # the loss, its gradients and the new centre from one JAX compile
    got, want = check_grads(jfn, pfn, teacher + student + [center],
                            (0, 1, 2, 3, 4, 5), has_aux=True)
    close(got, want, "centre")
    assert not got.requires_grad


def test_ibot_patch_loss_and_centre_match_jax():
    rng = _rng(2)
    B, N, K = 3, 7, 24
    t, s = _normal(rng, B, N, K, scale=3), _normal(rng, B, N, K, scale=3)
    mask = rng.uniform(size=(B, N)) < 0.4
    center = _normal(rng, 1, K)
    # the loss, its gradients and the new centre from one JAX compile
    got, want = check_grads(
        lambda a, b: jd.ibot_patch_loss(a, b, jnp.asarray(mask),
                                        jnp.asarray(center), 0.06),
        lambda a, b: pd.ibot_patch_loss(a, b, _t(mask), _t(center), 0.06),
        [t, s], (1,), has_aux=True)
    close(got, want, "centre")


def test_koleo_matches_jax():
    rng = _rng(3)
    check_grads(jd.koleo_loss, pd.koleo_loss, [_normal(rng, 8, 16)], (0,))


def test_koleo_with_duplicate_rows_stays_finite():
    """Every row repeated: the nearest neighbour lies at distance 0 up to
    rounding, where log(d^2 + eps) is rounding noise in either package (the
    state DINOv2's LayerScale 1e-5 starts near). The squared form keeps the
    value and the gradient finite; both packages' values lie between
    -0.5 log(1e-6 + eps) and -0.5 log(eps)."""
    rng = _rng(3)
    z = _normal(rng, 4, 16)
    z = np.concatenate([z, z])
    zt = _t(z, grad=True)
    got = pd.koleo_loss(zt)
    got.backward()
    want, jgrad = jax.jit(jax.value_and_grad(jd.koleo_loss))(jnp.asarray(z))
    assert torch.isfinite(zt.grad).all() and np.isfinite(jgrad).all()
    for v in (got.item(), float(want)):
        assert -0.5 * np.log(1e-6 + 1e-8) <= v <= -0.5 * np.log(1e-8), v


@pytest.mark.parametrize("iterations", [0, 3])
def test_msn_loss_and_sinkhorn_match_jax(iterations):
    """``msn_loss`` (its gradients w.r.t. the anchors and the prototypes)
    and ``_sinkhorn`` alone, at 0 and 3 iterations; anchors are three
    views of the targets' batch."""
    rng = _rng(4)
    T, D, K = 4, 16, 12
    anchors, targets = _normal(rng, 3 * T, D), _normal(rng, T, D)
    protos = _normal(rng, K, D)
    check_grads(
        lambda a, t, p: jd.msn_loss(a, t, p,
                                    sinkhorn_iterations=iterations),
        lambda a, t, p: pd.msn_loss(a, t, p,
                                    sinkhorn_iterations=iterations),
        [anchors, targets, protos], (0, 2))
    probs = jax.nn.softmax(jnp.asarray(_normal(rng, T, K, scale=4)), axis=-1)
    close(pd._sinkhorn(_t(probs), iterations),
          jd._sinkhorn(probs, iterations), "sinkhorn")


def test_schedules_match_jax_exactly():
    for steps in (1, 2, 7, 300):
        for step in range(steps + 3):
            assert ps.cosine_schedule(step, steps, 0.992, 1.0) == \
                js.cosine_schedule(step, steps, 0.992, 1.0)
            assert ps.linear_warmup_schedule(step, steps, 0.04, 0.07) == \
                js.linear_warmup_schedule(step, steps, 0.04, 0.07)
    for total in (1, 2, 10):
        for epoch in range(total + 2):
            assert ps.margin_decay(epoch, total) == js.margin_decay(epoch,
                                                                    total)
            assert ps.linear_increase_alpha(epoch, total) == \
                js.linear_increase_alpha(epoch, total)
    # the DINOv2 recipe's teacher temperature and momentum at every global
    # step the engine gives (epoch * steps_per_epoch + batch_id)
    for epochs, spe in ((100, 3), (2, 5), (40, 1)):
        port = DINOv2Recipe(epochs=epochs, steps_per_epoch=spe)
        ref = JaxDINOv2Recipe(epochs=epochs, steps_per_epoch=spe)
        assert port.n_masked == ref.n_masked == 80
        for gstep in range(epochs * spe + 1):
            assert port.teacher_temp(gstep) == ref.teacher_temp(gstep)
            assert port.momentum(gstep) == ref.momentum(gstep)
    assert port.teacher_temp(0) == 0.04 and port.momentum(0) == 0.992


# ---------------------------------------------------------------------------
# the DINO head and the LayerScale ViT
# ---------------------------------------------------------------------------

def random_tree(shapes, rng, gamma=None):
    """Seeded numpy values in ``shapes`` (a tree of shapes, as
    ``jax.eval_shape`` gives): kernels of variance 1/fan_in, LayerNorm
    scales and BN variances away from 1, LayerScale gammas random (or
    ``gamma``), biases and BN means small, tokens, position tables and
    prototypes of unit scale."""
    def leaf(path, s):
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "kernel":
            v = rng.normal(0, np.prod(s.shape[:-1]) ** -0.5, s.shape)
        elif name in ("scale", "var"):
            v = rng.uniform(0.5, 1.5, s.shape)
        elif name == "gamma":
            v = (np.full(s.shape, gamma) if gamma is not None
                 else rng.uniform(0.2, 1.0, s.shape))
        elif name in ("bias", "mean"):
            v = rng.normal(0, 0.1, s.shape)
        else:
            v = rng.normal(0, 0.5, s.shape)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def random_params(init_fn, rng):
    """``random_tree`` in the shapes of ``init_fn()``'s params (traced, not
    run)."""
    return random_tree(jax.eval_shape(init_fn), rng)["params"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dino_head_matches_jax(dtype):
    """(B, D) and (B, N, D) inputs. bf16 runs fc1..fc3 in bf16 in both
    packages, where XLA and torch round the GELU differently: the logits
    (cosines in [-1, 1]) agree within 2e-2 there."""
    D, out = 48, 96
    rng = _rng(5)
    jhead = JaxDINOHead(out_dim=out, dtype=getattr(jnp, dtype))
    params = random_params(lambda: jhead.init(jax.random.key(0),
                                              jnp.zeros((2, D))), rng)
    apply = jax.jit(jhead.apply)
    head = DINOHead(D, out_dim=out, dtype=getattr(torch, dtype))
    head.load_state_dict({
        **{f"{fc}.{n}": _t(params[fc][k].T if k == "kernel" else
                           params[fc][k])
           for fc in ("fc1", "fc2", "fc3") for n, k in (("weight", "kernel"),
                                                        ("bias", "bias"))},
        "prototypes": _t(params["prototypes"])}, strict=True)
    tol = TOL if dtype == "float32" else dict(rtol=0, atol=2e-2)
    for shape in ((6, D), (3, 5, D)):
        x = _normal(rng, *shape)
        want = apply({"params": params}, jnp.asarray(x))
        with torch.no_grad():
            got = head(_t(x))
        assert got.dtype == torch.float32 and got.shape == shape[:-1] + (out,)
        close(got, want, f"{dtype} {shape}", **tol)


TINY = dict(patch_size=8, embed_dim=64, depth=2, num_heads=4, img_size=32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layerscale_vit_matches_jax(dtype):
    """A ViT with LayerScale at gammas away from 1e-5 (else the blocks
    barely show): the tokens. In bf16 the f32 gamma makes
    the residual stream f32 in both packages; the normalised cls features
    agree at the bf16 ViT test's 3e-2 (tests/test_torch_vit.py)."""
    rng = _rng(6)
    jvit = JaxViT(**TINY, init_values=1e-5, dtype=getattr(jnp, dtype))
    params = random_params(lambda: jvit.init(
        jax.random.key(1), jnp.zeros((1, 32, 32, 3)), train=False), rng)
    vit = VisionTransformer(**TINY, init_values=1e-5,
                            dtype=getattr(torch, dtype),
                            param_dtype=torch.float32)
    vit.load_state_dict(vit_state_dict_from_jax(params, TINY["depth"]),
                        strict=True)
    assert vit.blocks[1].ls2.gamma.dtype == torch.float32
    x = _normal(rng, 3, 32, 32, 3)
    want = np.asarray(jax.jit(lambda p, v: jvit.apply(
        {"params": p}, v, train=False))(params, x))
    with torch.no_grad():
        got = vit.eval()(_t(x)).numpy()
        block_out = vit.blocks[0](torch.zeros(1, 17, 64,
                                              dtype=getattr(torch, dtype)))
    assert block_out.dtype == torch.float32
    if dtype == "float32":
        close(got, want, "tokens")
    else:
        a, b = (v[:, 0] / np.linalg.norm(v[:, 0], axis=-1, keepdims=True)
                for v in (got, want.astype(np.float32)))
        np.testing.assert_allclose(a, b, atol=3e-2)
    # without LayerScale: no gamma, and the residual stays in the dtype
    plain = VisionTransformer(**TINY, dtype=torch.bfloat16)
    assert not any("ls" in k.split(".")[2:3][0] for k in plain.state_dict()
                   if k.startswith("blocks."))
    assert plain.blocks[0](torch.zeros(1, 17, 64, dtype=torch.bfloat16)
                           ).dtype == torch.bfloat16


@pytest.mark.parametrize("name", ["Prototypes", "RankingHeadMLP"])
def test_loose_heads_and_gradients_match_jax(name):
    """``Prototypes`` (cosine logits against 24 prototypes of width 16) and
    ``RankingHeadMLP`` (16-wide pairs, 32 hidden) from JAX's params: the
    output and the gradients w.r.t. the inputs and every parameter at rtol
    1e-5."""
    rng = _rng(10)
    a, b = _normal(rng, 5, 16), _normal(rng, 5, 16)
    if name == "Prototypes":
        jm, module = jheads.Prototypes(24, 16), port_heads.Prototypes(24, 16)
        inputs = (a,)
    else:
        jm, module = jheads.RankingHeadMLP(hidden=32), \
            port_heads.RankingHeadMLP(16, hidden=32)
        inputs = (a, b)
    params = random_params(lambda: jm.init(jax.random.key(0), *inputs), rng)
    r = _normal(rng, *np.asarray(jax.eval_shape(
        lambda: jm.apply({"params": params}, *inputs)).shape))

    def jax_loss(p, *xs):
        return jnp.sum(jm.apply({"params": p}, *xs) * r)

    value, (gp, *gx) = jax.jit(jax.value_and_grad(
        jax_loss, argnums=tuple(range(len(inputs) + 1))))(params, *inputs)
    if name == "Prototypes":
        module.protos.data.copy_(_t(params["protos"]))
    else:
        for fc in ("fc1", "fc2"):
            getattr(module, fc).weight.data.copy_(
                _t(np.asarray(params[fc]["kernel"]).T))
            getattr(module, fc).bias.data.copy_(_t(params[fc]["bias"]))
    xs = [_t(x, grad=True) for x in inputs]
    out = module(*xs)
    assert out.dtype == torch.float32
    loss = (out * _t(r)).sum()
    loss.backward()
    close(loss, value, "value")
    for x, g in zip(xs, gx):
        close(x.grad, g, "input grad")
    if name == "Prototypes":
        close(module.protos.grad, gp["protos"], "protos grad")
    else:
        for fc in ("fc1", "fc2"):
            close(getattr(module, fc).weight.grad,
                  np.asarray(gp[fc]["kernel"]).T, f"{fc} kernel grad")
            close(getattr(module, fc).bias.grad, gp[fc]["bias"],
                  f"{fc} bias grad")
