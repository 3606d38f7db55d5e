"""SHAM and SimCLR on the ViT with S2R2 under data parallelism: two gloo
ranks on the CPU compute what one process computes on the global batch,
and what JAX's jitted step computes with the batch sharded over the 8
virtual CPU devices ``tests/conftest.py`` forces. Smooth-AP (``losses.
ranking.s2r2_loss``) on two ranks against one-process autograd.

Both packages' ``vit_base_patch16`` is cut to patch 8, width 64, depth 2,
2 heads at 32 px (a 4 x 4 grid), with the SHAM head (64, 64, 32) and the
SimCLR head (64, 32); the global batch is 16 uint8 images of 48 px, f32,
``s2r2_weight`` 1, SHAM's block remat on (its default). The weights are
seeded random values (``tests/test_torch_sham_vit.py``'s), the EMA teacher
apart from the student. The port draws the views for the global batch from
one generator; SHAM's permutation, positive and mask draws are JAX's, from
its keys; JAX gets the port's views through its batch, so that they are
sharded with it. Each rank feeds its rows ``[8 r, 8 r + 8)`` to
``train_step``.

What is held, at ``tests/test_dp_equivalence.py``'s tolerances: the loss
at rtol 2e-4 / atol 1e-5; the gradients the optimizer receives (the mean
over the ranks, clipped for SHAM) as that file holds an SGD update, their
norm at rtol 1e-3 and their leaf-wise difference within 1e-3 of that norm
-- the gradients, not the update after AdamW, whose first step moves a
weight by about lr times the sign of its gradient and so turns rounding
noise on the gradients that are truly 0 here (the key part of the qkv
bias, the final norm's bias, which the head's BN cancels) into lr-sized
moves; the head's BN running stats at rtol 1e-5; ``neg_indices`` equal
(no EMA similarity of the mine stage lies within 1e-5 of another at this
size); and the parameters, BN statistics and negative cache of the two
ranks bit for bit. One spawn of two gloo processes computes every
two-rank case; the four JAX compiles (about 20 s each) run side by side in
threads meanwhile.
"""

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from hairci_torch.losses.ranking import s2r2_loss
from hairci_torch.parallel import collectives
from test_torch_dp import _free_port, _images

torch.set_num_threads(1)
B, S, RAW, W = 16, 32, 48, 2
TINY_VIT = (8, 64, 2, 2)          # patch, width, depth, heads
SHAM_HEAD = (64, 64, 32)
SIMCLR_HEAD = (64, 32)
CASES = ["SHAM_warmup", "SHAM_mine", "SHAM_mined", "simclr"]
SAP = {"k_views": (2, 3), "rows": 8, "dim": 32}   # Smooth-AP's inputs


def _cut_port():
    import hairci_torch.models.heads as port_heads
    import hairci_torch.models.vit as port_vit
    import hairci_torch.ssl.sham as port_sham

    port_vit.VIT_CONFIGS["vit_base_patch16"] = TINY_VIT
    port_sham._PROJ_DIMS["vit_b_16"] = SHAM_HEAD
    port_heads.SIMCLR_PROJ_DIMS["vit_b_16"] = SIMCLR_HEAD


def _recipe(case):
    from hairci_torch.ssl import build_recipe

    if case == "simclr":
        return build_recipe("simclr", backbone="vit_b_16", img_size=S,
                            weight_decay=1e-4, s2r2_weight=1.0)
    return build_recipe("SHAM", backbone="vit_b_16", img_size=S,
                        weight_decay=1e-4, num_batches=2, warm_up_epochs=2,
                        s2r2_weight=1.0)


def port_step(case, setup, images):
    """One port step of ``case`` on ``images`` (this rank's rows under a
    process group) from the shared weights: metrics, the gradients the
    optimizer took, the new state."""
    _cut_port()
    rec = _recipe(case)
    state = rec.create_state(0, B, torch.device("cpu"))
    collectives.calls.update(all_gather=0, all_reduce=0)
    if case == "simclr":
        state.online.load_state_dict(setup["simclr"])
        metrics = rec.train_step(state, torch.from_numpy(images),
                                 torch.Generator().manual_seed(7))
    else:
        state.online.load_state_dict(setup["online"])
        state.ema.load_state_dict(setup["ema"])
        state.neg_indices.copy_(setup["neg"])
        rec.draw = lambda gen, b, h, w: (
            setup["sham_draws"] if b == B else pytest.fail(f"drew {b}"))
        metrics = rec.train_step(state, torch.from_numpy(images), None,
                                 stage=case.split("_")[1], batch_id=1, k=3)
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": {n: p.grad.clone()
                      for n, p in state.online.named_parameters()},
            "state": {k: v.clone() for k, v in
                      state.online.state_dict().items()},
            "neg": None if state.neg_indices is None
            else state.neg_indices.clone(),
            "calls": dict(collectives.calls)}


def _sap_inputs(k):
    rng = np.random.default_rng(20 + k)
    return torch.from_numpy(rng.normal(
        size=(k * SAP["rows"] * W, SAP["dim"])).astype(np.float32))


def _sap_rows(k, r):
    """Rank r's rows of each view of the global [v1; v2; ...]."""
    b, n = SAP["rows"], SAP["rows"] * W
    return torch.cat([torch.arange(v * n + r * b, v * n + r * b + b)
                      for v in range(k)])


def sap_grad(k, r=None):
    """Smooth-AP's loss and the gradient of its input rows: rank r's rows
    under a process group, every row in one process."""
    e = _sap_inputs(k)
    e = (e if r is None else e[_sap_rows(k, r)]).requires_grad_(True)
    loss = s2r2_loss(e, tau=0.05, k_views=k)
    loss.backward()
    return loss.item(), e.grad


def _worker(rank, setup_path, port, out_dir):
    import torch.distributed as dist

    torch.set_num_threads(1)
    setup = torch.load(setup_path, weights_only=False)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=W)
    rows = _images()[rank * B // W:(rank + 1) * B // W]
    out = {case: port_step(case, setup, rows) for case in CASES}
    out["sap"] = {k: sap_grad(k, rank) for k in SAP["k_views"]}
    torch.save(out, os.path.join(out_dir, f"steps{rank}.pt"))
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the references, computed here while the ranks run
# ---------------------------------------------------------------------------

def _cut_jax(mp):
    import hairci.models.vit as jax_vit
    import hairci.ssl.sham as jax_sham
    import hairci.ssl.simclr as jax_simclr

    mp.setitem(jax_vit.VIT_CONFIGS, "vit_base_patch16", TINY_VIT)
    mp.setitem(jax_sham._PROJ_DIMS, "vit_b_16", SHAM_HEAD)
    mp.setitem(jax_simclr._PROJ_DIMS, "vit_base_patch16", SIMCLR_HEAD)


def _jax_references(np_vars, setup, sham_views, simclr_views):
    """JAX's jitted step of each case, the state replicated and the views
    sharded over the 8 devices: the loss, the gradients (clipped for SHAM,
    as its optimizer clips them) and the new state, as port state dicts."""
    import jax
    import jax.numpy as jnp
    import optax

    from hairci.parallel import (
        batch_sharding,
        create_mesh,
        replicated_sharding,
    )
    from hairci.ssl.sham import SHAMRecipe as JaxSHAMRecipe
    from hairci.ssl.simclr import SimCLRRecipe as JaxSimCLRRecipe
    from hairci.train.state import TrainState as JaxTrainState
    from hairci_torch.models.convert import (
        sham_state_dict_from_jax,
        simclr_state_dict_from_jax,
    )

    mesh = create_mesh(n_data=8, n_model=1)
    key = jax.random.key(7)

    def two_views(key, x):     # the views come in the batch, (B, 2, ...)
        return [x[:, 0], x[:, 1]]

    jrec = JaxSHAMRecipe(backbone="vit_b_16", img_size=S, weight_decay=1e-4,
                         num_batches=2, warm_up_epochs=2, s2r2_weight=1.0,
                         dtype=jnp.float32)
    jrec.transform = two_views
    params, stats, ema_params, ema_stats = np_vars["sham"]
    sham_state = jax.device_put(JaxTrainState(
        step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
        opt_state=jrec.tx.init(params), tx=jrec.tx, ema_params=ema_params,
        ema_batch_stats=ema_stats,
        neg_indices=jnp.asarray(setup["neg"].numpy(), jnp.int32)),
        replicated_sharding(mesh))
    sham_step = jax.jit(jrec.train_step, static_argnames="stage")
    srec = JaxSimCLRRecipe(backbone="vit_base_patch16", img_size=S,
                           weight_decay=1e-4, dtype=jnp.float32,
                           s2r2_weight=1.0)
    srec.transform = two_views
    params, stats = np_vars["simclr"]
    simclr_state = jax.device_put(JaxTrainState(
        step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
        opt_state=srec.tx.init(params), tx=srec.tx),
        replicated_sharding(mesh))
    simclr_step = jax.jit(srec.train_step)

    def batch(views):
        return {"image": jax.device_put(np.stack(views, 1),
                                        batch_sharding(mesh, 5))}

    def run(case):
        if case == "simclr":
            new, aux = jax.device_get(simclr_step(
                simclr_state, batch(simclr_views), key))
            stats = np_vars["simclr"][1]
            return {"loss": float(aux["loss"]),
                    "grads": simclr_state_dict_from_jax(
                        new.extra, stats, "vit_b_16"),
                    "state": simclr_state_dict_from_jax(
                        new.params, new.batch_stats, "vit_b_16")}
        new, aux = jax.device_get(sham_step(
            sham_state, batch(sham_views), key, stage=case.split("_")[1],
            batch_id=1, k=3))
        clipped, _ = optax.clip_by_global_norm(1.0).update(
            new.extra, optax.EmptyState())
        return {"loss": float(aux["loss"]),
                "grads": sham_state_dict_from_jax(
                    jax.device_get(clipped), np_vars["sham"][1], "vit_b_16"),
                "state": sham_state_dict_from_jax(
                    new.params, new.batch_stats, "vit_b_16"),
                "neg": torch.from_numpy(np.asarray(new.neg_indices))}

    with pytest.MonkeyPatch.context() as mp:
        _cut_jax(mp)
        orig = JaxTrainState.apply_gradients
        # keep the raw gradients in the state's unused ``extra``
        mp.setattr(JaxTrainState, "apply_gradients",
                   lambda self, grads, **kw: orig(self, grads, **kw).replace(
                       extra=grads))
        with ThreadPoolExecutor(len(CASES)) as pool:
            return dict(zip(CASES, pool.map(run, CASES)))


def _shared_setup():
    """Seeded weights (numpy for JAX, state dicts for the port), the port's
    view draws and JAX's SHAM draws, and the global views each gets."""
    import jax
    import jax.numpy as jnp

    from hairci.ssl.sham import SHAMRecipe as JaxSHAMRecipe
    from hairci.ssl.simclr import SimCLRRecipe as JaxSimCLRRecipe
    from hairci_torch.models.convert import (
        sham_state_dict_from_jax,
        simclr_state_dict_from_jax,
    )
    from test_torch_sham_vit import _random_variables

    rng = np.random.default_rng(0)
    x = np.zeros((B, S, S, 3), np.float32)
    with pytest.MonkeyPatch.context() as mp:
        _cut_jax(mp)
        sham_module = JaxSHAMRecipe(backbone="vit_b_16", img_size=S).module
        sham = (_random_variables(sham_module, x, rng)
                + _random_variables(sham_module, x, rng))
        simclr = _random_variables(JaxSimCLRRecipe(
            backbone="vit_base_patch16", img_size=S,
            dtype=jnp.float32).module, x, rng)
    neg = torch.from_numpy(np.stack([np.roll(np.arange(B), 1),
                                     np.roll(np.arange(B), 5)]))

    def t(a):
        return torch.from_numpy(np.array(a))

    # SHAM's draws inside the step, from JAX's keys (tests/test_torch_sham.py)
    _, k_neg, k_pt, k_mask = jax.random.split(jax.random.key(7), 4)
    k1, k2 = jax.random.split(k_pt)
    k_ratio, k_score = jax.random.split(k_mask)
    _cut_port()
    rec = _recipe("SHAM_warmup")
    images = torch.from_numpy(_images())
    sham_draws = {
        "views": rec.transform.draw(torch.Generator().manual_seed(11), B,
                                    RAW, RAW),
        "perm": t(jax.random.permutation(k_neg, B)).long(),
        "positive": {
            "theta": t(jax.random.uniform(k1, (B,), minval=-15.0,
                                          maxval=15.0) * (np.pi / 180)),
            "sigma": t(jax.random.uniform(jax.random.split(k2)[1], (B,),
                                          minval=0.1, maxval=0.5))},
        "mask": {"ratio": t(jax.random.uniform(k_ratio, (B,), minval=0.1,
                                               maxval=0.5)),
                 "scores": t(jax.random.uniform(k_score, (B, 1)))},
    }
    setup = {
        "online": sham_state_dict_from_jax(*sham[:2], "vit_b_16"),
        "ema": sham_state_dict_from_jax(*sham[2:], "vit_b_16"),
        "simclr": simclr_state_dict_from_jax(*simclr, "vit_b_16"),
        "neg": neg, "sham_draws": sham_draws}
    srec = _recipe("simclr")
    simclr_views = srec.transform.apply(images, srec.draw(
        torch.Generator().manual_seed(7), B, RAW, RAW)["views"])
    sham_views = rec.transform.apply(images, sham_draws["views"])
    return setup, {"sham": sham, "simclr": simclr}, \
        [v.numpy() for v in sham_views], [v.numpy() for v in simclr_views]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("dpvit")
    setup, np_vars, sham_views, simclr_views = _shared_setup()
    setup_path = str(out / "setup.pt")
    torch.save(setup, setup_path)
    ctx = torch.multiprocessing.start_processes(
        _worker, args=(setup_path, _free_port(), str(out)), nprocs=W,
        join=False, start_method="spawn")
    try:
        jax_out = _jax_references(np_vars, setup, sham_views, simclr_views)
        single = {case: port_step(case, setup, _images()) for case in CASES}
        single["sap"] = {k: sap_grad(k) for k in SAP["k_views"]}
    finally:
        while not ctx.join():
            pass
    ranks = [torch.load(str(out / f"steps{r}.pt"), weights_only=False)
             for r in range(W)]
    return dict(setup=setup, single=single, jax=jax_out, ranks=ranks)


# ---------------------------------------------------------------------------
# the steps
# ---------------------------------------------------------------------------

def _grads_close(got, want, rtol=1e-3):
    """test_dp_equivalence's rule for an SGD update, on the gradients: the
    norms at ``rtol``, the leaf-wise difference within ``rtol`` of the
    reference's norm."""
    names = list(got)

    def norm(tree, other=None):
        return float(np.sqrt(sum(
            float(((tree[n] - (0 if other is None else other[n])).double()
                   ** 2).sum()) for n in names)))

    n_got, n_want = norm(got), norm(want)
    assert n_want > 0
    np.testing.assert_allclose(n_got, n_want, rtol=rtol)
    diff = norm(got, want)
    assert diff <= rtol * n_want, f"gradients diverged: {diff} of {n_want}"


@pytest.mark.parametrize("ref", ["one_process", "jax"])
@pytest.mark.parametrize("case", CASES)
def test_two_ranks_vit_step_matches(runs, case, ref):
    got = runs["ranks"][0][case]
    want = runs["single"][case] if ref == "one_process" else runs["jax"][case]
    want_loss = (want["metrics"]["loss"] if ref == "one_process"
                 else want["loss"])
    np.testing.assert_allclose(got["metrics"]["loss"], want_loss, rtol=2e-4,
                               atol=1e-5)
    # JAX's converted tree also holds the BN statistics it was given
    assert set(got["grads"]) <= set(want["grads"])
    _grads_close(got["grads"], {n: want["grads"][n] for n in got["grads"]})
    running = [n for n in got["state"] if "running" in n]
    assert len(running) == 4          # the head's two BNs
    for name in running:
        np.testing.assert_allclose(got["state"][name].numpy(),
                                   want["state"][name].numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=name)


@pytest.mark.parametrize("case", CASES)
def test_two_ranks_vit_metrics_match_one_process(runs, case):
    """Every logged metric is the global batch's, the same on both
    ranks."""
    got = [runs["ranks"][r][case]["metrics"] for r in range(W)]
    assert got[0] == got[1]
    want = runs["single"][case]["metrics"]
    assert set(got[0]) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[0][k], v, rtol=2e-4, atol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("case", CASES)
def test_two_ranks_vit_hold_equal_state(runs, case):
    a, b = (runs["ranks"][r][case] for r in range(W))
    for name, t in a["state"].items():
        assert torch.equal(t, b["state"][name]), name
    if a["neg"] is not None:
        assert torch.equal(a["neg"], b["neg"])
    # the step went through the collectives: Smooth-AP's gather among them
    want = {"SHAM_warmup": 3, "SHAM_mine": 4, "SHAM_mined": 3, "simclr": 2}
    assert a["calls"]["all_gather"] == want[case]
    assert a["calls"]["all_reduce"] > 0
    assert runs["single"][case]["calls"] == {"all_gather": 0,
                                             "all_reduce": 0}


@pytest.mark.parametrize("ref", ["one_process", "jax"])
def test_vit_mined_indices_are_global(runs, ref):
    got = runs["ranks"][0]["SHAM_mine"]["neg"]
    want = runs["single" if ref == "one_process" else "jax"]["SHAM_mine"][
        "neg"]
    assert torch.equal(got, want.long())
    assert torch.equal(runs["ranks"][0]["SHAM_mined"]["neg"],
                       runs["setup"]["neg"])


# ---------------------------------------------------------------------------
# Smooth-AP
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", SAP["k_views"])
def test_smooth_ap_two_ranks_matches_one_process(runs, k):
    """Each rank ranks its queries against every rank's keys in the global
    order: the loss is the one-process loss, and each rank's input
    gradient is its rows of the gradient of the sum of both ranks'
    (replicated) losses, W times the one-process gradient
    (``parallel.collectives``), at rtol 1e-5."""
    loss1, g1 = runs["single"]["sap"][k]
    for r in range(W):
        loss, g = runs["ranks"][r]["sap"][k]
        np.testing.assert_allclose(loss, loss1, rtol=1e-6)
        want = W * g1[_sap_rows(k, r)]
        np.testing.assert_allclose(g.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-5 * float(want.abs().max()))
