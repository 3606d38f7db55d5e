"""MSN, MAE, SimMIM and SHAM v1 (both modes) under data parallelism: two
gloo ranks on the CPU compute what one process computes on the global
batch, and what JAX's jitted step computes with the batch sharded over the
8 virtual CPU devices ``tests/conftest.py`` forces.

Both packages' ``vit_tiny_patch16`` is cut to 4 blocks at 32 px, width 192
and 3 heads kept (the cut of ``tests/test_torch_dp_distill.py``: a 2 x 2
grid), MAE's decoder to ``tests/test_torch_mae.py``'s tiny one; f32; the
global batch is 16 uint8 images of 48 px. MSN takes two 16-px focal views
and a target momentum of 0.9, so that the EMA shows; its head keeps its
2048 widths and 1,024 prototypes. SHAM v1's teacher momentum is 0.9 too.

The weights are seeded random values (``tests/test_torch_distill.py``'s
``random_tree``), MSN's target branch and SHAM v1's teacher apart from the
online ones. The port draws the views for the global batch from one
generator; the token masks' noise is JAX's, drawn from its key for the
global batch; JAX gets the port's views through its batch, so that they
are sharded with it. Each rank feeds its rows ``[8 r, 8 r + 8)`` to
``train_step``. A token mask keeps the same number of tokens in every
image, so the masked means of the steps cannot tell a sum over the global
mask count from a mean of the ranks' means: ``recon`` holds the masked MSE
(with ``norm_pix``) and L1 on seeded patches whose masks the ranks hold in
different counts.

Held at ``tests/test_dp_equivalence.py``'s tolerances for a step compared
through its gradients (``tests/test_torch_dp_distill.py``): the loss and
its terms at rtol 3e-4 / atol 1e-5; the gradients the optimizer receives
(the mean over the ranks; clipped for SHAM v1, JAX's clipped as its
optimizer clips them) by their norm at rtol 2e-3 and leaf-wise within
2e-3 of that norm; MSN's BN running statistics, after its anchor and its
focal pass, and both momentum branches at rtol 1e-5 / atol 1e-6; and the
parameters, statistics and momentum branches of the two ranks bit for
bit. Measured here, the norm of the difference between the two ranks'
averaged gradients and either reference's is at most 2.7e-6 of the
reference's norm. One spawn of two gloo processes computes every two-rank
case; JAX's five compiles run side by side in threads meanwhile.
"""

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from hairci_torch.parallel import collectives
from test_torch_dp import _free_port, _images
from test_torch_dp_distill import _flat, _unflat
from test_torch_dp_vit import _grads_close

torch.set_num_threads(1)
B, S, RAW, W = 16, 32, 48, 2
TINY_VIT = (16, 192, 4, 3)        # patch, width, depth, heads
FOCAL, N_FOCAL, MOM = 16, 2, 0.9
CASES = ["msn", "mae", "simmim", "sham_v1_embedding",
         "sham_v1_reconstruction"]
MODES = {"msn": "MSN", "mae": "mae", "simmim": "simMIM",
         "sham_v1_embedding": "SHAM_v1", "sham_v1_reconstruction": "SHAM_v1"}


def _cut(mp=None):
    """Both packages' ViT-Tiny to 4 blocks and MAE's decoder to the tiny
    one through the monkeypatch ``mp``; without one, the port's alone (a
    spawned rank, which imports no JAX)."""
    import hairci_torch.models.vit as port_vit
    import hairci_torch.ssl.mae as port_mae
    from test_torch_mae import TINY_DECODER

    if mp is None:
        port_vit.VIT_CONFIGS["vit_tiny_patch16"] = TINY_VIT
        port_mae.DECODER = TINY_DECODER
        return
    import hairci.models.vit as jax_vit
    import hairci.ssl.mae as jax_mae
    from test_torch_mae import TinyDecoder

    for vit in (port_vit, jax_vit):
        mp.setitem(vit.VIT_CONFIGS, "vit_tiny_patch16", TINY_VIT)
    mp.setattr(port_mae, "DECODER", TINY_DECODER)
    mp.setattr(jax_mae, "MAEDecoder", TinyDecoder)


def _recipe(case, jax=False):
    """The port's recipe of ``case``, or JAX's."""
    if jax:
        import jax.numpy as jnp

        from hairci.ssl import build_recipe
        dtype = jnp.float32
    else:
        from hairci_torch.ssl import build_recipe
        dtype = torch.float32
    kw = dict(backbone="vit_tiny_patch16", img_size=S, weight_decay=1e-4,
              dtype=dtype)
    if case == "msn":
        kw.update(focal_size=FOCAL, n_focal=N_FOCAL, ema_momentum=MOM)
    elif case.startswith("sham_v1"):
        kw.update(sham_mode=case.split("_")[-1], ema_momentum=MOM)
    return build_recipe(MODES[case], **kw)


def _converter(case):
    from hairci_torch.models import convert

    if case == "msn":
        return convert.msn_state_dict_from_jax
    fn = {"mae": convert.mae_state_dict_from_jax,
          "simmim": convert.simmim_state_dict_from_jax}.get(
              case, convert.sham_v1_state_dict_from_jax)
    return lambda params, stats=None: fn(params)


def port_step(case, setup, images):
    """One port step of ``case`` on ``images`` (this rank's rows under a
    process group) from the shared state: metrics, gradients, new state."""
    rec = _recipe(case)
    state = rec.create_state(0, B, torch.device("cpu"))
    s = setup[case]
    state.online.load_state_dict(s["online"], strict=True)
    if state.ema is not None:
        state.ema.load_state_dict(s["ema"], strict=True)
    rec.draw = lambda gen, b, h, w: (
        s["draws"] if b == B else pytest.fail(f"drew {b}"))
    collectives.calls.update(all_gather=0, all_reduce=0)
    m = rec.train_step(state, torch.from_numpy(images), None)
    return {"metrics": {k: float(v) for k, v in m.items()},
            "grads": {n: p.grad.clone()
                      for n, p in state.online.named_parameters()},
            "state": {k: v.clone() for k, v in
                      state.online.state_dict().items()},
            "ema": None if state.ema is None else {
                k: v.clone() for k, v in state.ema.state_dict().items()},
            "calls": dict(collectives.calls)}


def recon_case(rank=None):
    """The masked MSE (``norm_pix``) plus the masked L1 on seeded (B, N, P)
    patches whose masks the ranks hold in different counts (the first half
    of the rows mostly masked, the second mostly not): rank r's rows under
    a process group, all rows in one process. Returns the loss, the
    predictions' gradient and the mask count."""
    from hairci_torch.losses.recon import masked_l1_loss, masked_mse_loss

    rng = np.random.default_rng(31)
    N, P = 16, 12
    pred, target = (torch.from_numpy(rng.normal(size=(B, N, P)).astype(
        np.float32)) for _ in range(2))
    p = np.repeat([0.8, 0.2], B // 2)[:, None]
    mask = torch.from_numpy((rng.uniform(size=(B, N)) < p).astype(
        np.float32))
    rows = slice(None) if rank is None else slice(rank * B // W,
                                                  (rank + 1) * B // W)
    x = pred[rows].clone().requires_grad_(True)
    loss = (masked_mse_loss(x, target[rows], mask[rows], norm_pix=True)
            + masked_l1_loss(x, target[rows], mask[rows]))
    loss.backward()
    return {"loss": loss.item(), "grad": x.grad, "count": float(
        mask[rows].sum())}


def _worker(rank, setup_path, port, out_dir):
    import torch.distributed as dist

    torch.set_num_threads(1)
    _cut()
    setup = torch.load(setup_path, weights_only=False)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=W)
    rows = _images()[rank * B // W:(rank + 1) * B // W]
    out = {case: port_step(case, setup, rows) for case in CASES}
    out["recon"] = recon_case(rank)
    torch.save(out, os.path.join(out_dir, f"steps{rank}.pt"))
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the shared state and JAX's steps
# ---------------------------------------------------------------------------

def _setup():
    """Seeded states of both packages, the port's draws (JAX's mask noise
    among them) and the global views JAX takes in its batch."""
    import jax
    import jax.numpy as jnp

    from test_torch_distill import random_tree

    rng = np.random.default_rng(0)
    images = torch.from_numpy(_images())
    sample = jnp.zeros((B, RAW, RAW, 3), jnp.uint8)
    _, k_mask = jax.random.split(jax.random.key(7))
    setup, jax_in = {}, {}
    for i, case in enumerate(CASES):
        jrec = _recipe(case, jax=True)
        shapes = jax.eval_shape(lambda: jrec.create_state(jax.random.key(0),
                                                          sample))
        trees = [random_tree(shapes.params, rng),
                 random_tree(shapes.batch_stats, rng)]
        if case in ("msn",) or case.startswith("sham_v1"):
            trees += [random_tree(shapes.params, rng),
                      random_tree(shapes.batch_stats, rng)]
        rec = _recipe(case)
        draws = rec.draw(torch.Generator().manual_seed(11 + i), B, RAW, RAW)
        draws["noise"] = torch.from_numpy(np.array(jax.random.uniform(
            k_mask, (B, rec.num_patches))))
        views = rec.transform.apply(images, draws["views"])
        jax_in[case] = {"trees": trees, "views": _flat(views),
                        "shapes": [tuple(v.shape[1:]) for v in views]}
        sd = _converter(case)
        setup[case] = {"online": sd(*trees[:2]), "draws": draws,
                       "ema": sd(*trees[2:]) if len(trees) > 2 else None}
    return setup, jax_in


def _jax_references(jax_in):
    """JAX's jitted steps, the state replicated and the batch sharded over
    the 8 devices: metrics, gradients, the new state as port tensors."""
    import jax
    import jax.numpy as jnp
    import optax

    from hairci.parallel import (
        batch_sharding,
        create_mesh,
        replicated_sharding,
    )
    from hairci.train.state import TrainState as JaxTrainState

    mesh = create_mesh(n_data=8, n_model=1)

    def run(case):
        jrec = _recipe(case, jax=True)
        j = jax_in[case]
        jrec.transform = lambda k, x: _unflat(x, j["shapes"])
        params, stats = j["trees"][:2]
        state = JaxTrainState(
            step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
            opt_state=jrec.tx.init(params), tx=jrec.tx)
        if len(j["trees"]) > 2:
            state = state.replace(ema_params=j["trees"][2],
                                  ema_batch_stats=j["trees"][3])
        state = jax.device_put(state, replicated_sharding(mesh))
        batch = {"image": jax.device_put(j["views"],
                                         batch_sharding(mesh, 2))}
        new, aux = jax.device_get(jax.jit(jrec.train_step)(
            state, batch, jax.random.key(7)))
        grads = new.neg_indices
        if case.startswith("sham_v1"):
            grads, _ = optax.clip_by_global_norm(1.0).update(
                grads, optax.EmptyState())
        sd = _converter(case)
        return {"metrics": {k: float(v) for k, v in aux.items()},
                "grads": sd(jax.device_get(grads), stats),
                "state": sd(new.params, new.batch_stats),
                "ema": (sd(new.ema_params, new.ema_batch_stats)
                        if len(j["trees"]) > 2 else None)}

    with pytest.MonkeyPatch.context() as mp:
        orig = JaxTrainState.apply_gradients
        # keep the raw gradients in the state's unused ``neg_indices``
        mp.setattr(JaxTrainState, "apply_gradients",
                   lambda self, grads, **kw: orig(self, grads, **kw).replace(
                       neg_indices=grads))
        with ThreadPoolExecutor(len(CASES)) as pool:
            return dict(zip(CASES, pool.map(run, CASES)))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        _cut(mp)
        return _runs(tmp_path_factory)


def _runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("dpmim")
    setup, jax_in = _setup()
    setup_path = str(out / "setup.pt")
    torch.save(setup, setup_path)
    ctx = torch.multiprocessing.start_processes(
        _worker, args=(setup_path, _free_port(), str(out)), nprocs=W,
        join=False, start_method="spawn")
    try:
        jax_out = _jax_references(jax_in)
        single = {case: port_step(case, setup, _images()) for case in CASES}
        single["recon"] = recon_case()
    finally:
        while not ctx.join():
            pass
    ranks = [torch.load(str(out / f"steps{r}.pt"), weights_only=False)
             for r in range(W)]
    return dict(single=single, jax=jax_out, ranks=ranks)


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

def _ref(runs, case, ref):
    return runs["single" if ref == "one_process" else "jax"][case]


@pytest.mark.parametrize("ref", ["one_process", "jax"])
@pytest.mark.parametrize("case", CASES)
def test_two_ranks_step_matches(runs, case, ref):
    """The loss and every term, and the averaged gradients."""
    got, want = runs["ranks"][0][case], _ref(runs, case, ref)
    assert set(got["metrics"]) == set(want["metrics"])
    for k, v in want["metrics"].items():
        np.testing.assert_allclose(got["metrics"][k], v, rtol=3e-4,
                                   atol=1e-5, err_msg=k)
    assert set(got["grads"]) <= set(want["grads"])
    _grads_close(got["grads"], {n: want["grads"][n] for n in got["grads"]},
                 rtol=2e-3)


@pytest.mark.parametrize("ref", ["one_process", "jax"])
@pytest.mark.parametrize("case", ["msn", "sham_v1_embedding",
                                  "sham_v1_reconstruction"])
def test_two_ranks_statistics_and_momentum_branch_match(runs, case, ref):
    """MSN's head BN running statistics after its two passes over the
    global batch's anchors and focal views, and the momentum branch
    (MSN's target, SHAM v1's teacher) after its EMA."""
    got, want = runs["ranks"][0][case], _ref(runs, case, ref)
    running = [n for n in got["state"] if "running" in n]
    assert len(running) == (4 if case == "msn" else 0)
    for name in running:
        np.testing.assert_allclose(got["state"][name].numpy(),
                                   want["state"][name].numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=name)
    for name, t in got["ema"].items():
        np.testing.assert_allclose(t.numpy(), want["ema"][name].numpy(),
                                   rtol=1e-5, atol=1e-6,
                                   err_msg=f"ema {name}")


def test_two_ranks_masked_means_match_one_process(runs):
    """The masked MSE and L1 are sums over every rank's masked patches over
    the global mask count, not means of the ranks' means: with the ranks
    holding different counts, the one-process loss (rtol 1e-6), and each
    rank's rows of the gradient of the sum of both ranks' (replicated)
    losses, W times the one-process gradient, at rtol 1e-5."""
    one = runs["single"]["recon"]
    counts = [runs["ranks"][r]["recon"]["count"] for r in range(W)]
    assert counts[0] != counts[1] and sum(counts) == one["count"]
    for r in range(W):
        got = runs["ranks"][r]["recon"]
        np.testing.assert_allclose(got["loss"], one["loss"], rtol=1e-6)
        want = W * one["grad"][r * B // W:(r + 1) * B // W]
        np.testing.assert_allclose(got["grad"].numpy(), want.numpy(),
                                   rtol=1e-5,
                                   atol=1e-5 * float(want.abs().max()))


@pytest.mark.parametrize("case", CASES)
def test_two_ranks_hold_equal_state(runs, case):
    """Parameters, statistics and momentum branch bit for bit on both
    ranks, with the same metrics; the step went through the collectives
    (SHAM v1's NT-Xent gathers its pairs; the others reduce)."""
    a, b = (runs["ranks"][r][case] for r in range(W))
    assert a["metrics"] == b["metrics"]
    for part in ("state", "ema"):
        for name, t in (a[part] or {}).items():
            assert torch.equal(t, b[part][name]), f"{part} {name}"
    assert a["calls"]["all_gather"] == (1 if case.startswith("sham_v1")
                                        else 0)
    assert a["calls"]["all_reduce"] > 0
    assert runs["single"][case]["calls"] == {"all_gather": 0,
                                             "all_reduce": 0}
