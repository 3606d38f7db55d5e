"""The tensor-parallel margin head (``models.face_vit.tp_margin_logits``)
and the port's ``dryrun_multichip`` on four gloo ranks on the CPU.

The four ranks form a 2 x 2 ``(data, model)`` mesh, the collectives'
default group pointed at the ``data`` axis (as the Trainer points it), so
that the head's collectives must name the ``model`` group themselves. The
(64, 32) classifier's class rows are split over ``model``, the 16
embeddings and labels over ``data``, as ``tests/test_dp_equivalence.py``'s
TP case shards them. Each rank's loss is its rows' term of the global
batch's mean, ``sum / 16``; summed over the ``data`` axis it is the loss,
and so is the weight shard's gradient summed over ``data``. Held against
JAX's unsharded ``margin_logits`` and its ``value_and_grad`` at that
file's tolerances: logits rtol 1e-5 / atol 1e-6, loss rtol 1e-5, the
weight's and the embeddings' gradients rtol 1e-4 / atol 1e-7 -- the
weight's gradient not scaled by the ``model`` group's size, the
embeddings' the sum of both class shards' parts. CosFace (JAX's case),
ArcFace and Softmax with a bias. The same spawn runs the dry run's five
parts on the same four ranks (its TP part holds its own step against the
unsharded head); the CLI itself runs once on two ranks.
"""

import contextlib
import io
import os

import numpy as np
import pytest
import torch

from hairci_torch.cli import dryrun_multichip
from hairci_torch.parallel import collectives
from test_torch_dp import _free_port

torch.set_num_threads(1)
C, D, B, W = 64, 32, 16, 4
N_DATA, N_MODEL = 2, 2
LOSSES = ("CosFace", "ArcFace", "Softmax")


def _inputs():
    rng = np.random.default_rng(0)
    w = rng.normal(size=(C, D)).astype(np.float32)
    emb = rng.normal(size=(B, D)).astype(np.float32)
    label = rng.integers(0, C, B).astype(np.int32)
    bias = rng.normal(size=(C,)).astype(np.float32)
    return w, emb, label, bias


def _tp_case(mesh, loss_type):
    """This rank's logits, loss term and gradients of the TP head."""
    import torch.distributed as dist

    from hairci_torch.models.face_vit import tp_margin_logits
    from hairci_torch.parallel import (
        DATA_AXIS,
        MODEL_AXIS,
        batch_sharding,
        model_sharding,
    )

    w, emb, label, bias = (torch.from_numpy(a) for a in _inputs())
    w_shard = model_sharding(mesh, 0, 2).local(w).clone().requires_grad_()
    b_shard = model_sharding(mesh, 0, 1).local(bias)
    e = batch_sharding(mesh, 2).local(emb).clone().requires_grad_()
    y = batch_sharding(mesh, 1).local(label).long()
    collectives.calls.update(all_gather=0, all_reduce=0)
    logits = tp_margin_logits(
        w_shard, e, y, loss_type, mesh.group(MODEL_AXIS),
        bias_shard=b_shard if loss_type == "Softmax" else None)
    term = -torch.log_softmax(logits, -1).gather(1, y[:, None]).sum() / B
    term.backward()
    calls = dict(collectives.calls)
    loss = term.detach().clone()
    dist.all_reduce(loss, group=mesh.group(DATA_AXIS))
    gw = w_shard.grad.clone()
    dist.all_reduce(gw, group=mesh.group(DATA_AXIS))
    return {"logits": logits.detach(), "loss": float(loss), "gw": gw,
            "ge": e.grad.clone(), "calls": calls,
            "data": mesh.coordinate(DATA_AXIS),
            "model": mesh.coordinate(MODEL_AXIS)}


def _worker(rank, port, out_dir):
    from hairci_torch.parallel import DATA_AXIS, create_mesh

    torch.set_num_threads(1)
    collectives.init_distributed(f"localhost:{port}", W, rank,
                                 torch.device("cpu"))
    try:
        mesh = create_mesh(n_data=N_DATA, n_model=N_MODEL)
        collectives.set_group(mesh.group(DATA_AXIS))
        out = {t: _tp_case(mesh, t) for t in LOSSES}
        x = torch.ones(2, 3)
        out["refused"] = []
        for fn in (collectives.gather_from_group, collectives.copy_to_group):
            with pytest.raises(ValueError, match="needs its group"):
                fn(x, None)
            out["refused"].append(fn.__name__)
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            out["dryrun"] = dryrun_multichip.run_parts(W, torch.device("cpu"))
        out["dryrun_text"] = text.getvalue()
        torch.save(out, os.path.join(out_dir, f"tp{rank}.pt"))
    finally:
        collectives.shutdown()


def _jax_reference(loss_type):
    import jax
    import jax.numpy as jnp

    from hairci.models.face_vit import margin_logits

    w, emb, label, bias = (jnp.asarray(a) for a in _inputs())
    b = bias if loss_type == "Softmax" else None

    def loss_fn(w, emb):
        logits = margin_logits(w, emb, label, loss_type, bias=b)
        logp = jax.nn.log_softmax(logits, axis=-1)
        return -jnp.mean(jnp.take_along_axis(logp, label[:, None], 1))

    logits = jax.jit(lambda w, emb: margin_logits(w, emb, label, loss_type,
                                                  bias=b))(w, emb)
    v, (gw, ge) = jax.jit(jax.value_and_grad(loss_fn, argnums=(0, 1)))(
        w, emb)
    return {"logits": np.asarray(logits), "loss": float(v),
            "gw": np.asarray(gw), "ge": np.asarray(ge)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("tp")
    ctx = torch.multiprocessing.start_processes(
        _worker, args=(_free_port(), str(out)), nprocs=W, join=False,
        start_method="spawn")
    try:
        jax_out = {t: _jax_reference(t) for t in LOSSES}
    finally:
        while not ctx.join():
            pass
    ranks = [torch.load(str(out / f"tp{r}.pt"), weights_only=False)
             for r in range(W)]
    return {"jax": jax_out, "ranks": ranks}


def _rows(r):
    """(data rows, class rows) of a rank's shards."""
    b, c = B // N_DATA, C // N_MODEL
    return (slice(r["data"] * b, (r["data"] + 1) * b),
            slice(r["model"] * c, (r["model"] + 1) * c))


@pytest.mark.parametrize("loss_type", LOSSES)
def test_tp_head_logits_and_loss_match_unsharded_jax(runs, loss_type):
    want = runs["jax"][loss_type]
    for r in runs["ranks"]:
        got = r[loss_type]
        rows, _ = _rows(got)
        # every class, gathered over the model group, in class order
        np.testing.assert_allclose(got["logits"].numpy(),
                                   want["logits"][rows], rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)


@pytest.mark.parametrize("loss_type", LOSSES)
def test_tp_head_gradients_match_unsharded_jax(runs, loss_type):
    """The weight shard's gradient is its rows of the unsharded gradient,
    not the model group's size times it; the embeddings' is the sum of
    both class shards' parts."""
    want = runs["jax"][loss_type]
    for r in runs["ranks"]:
        got = r[loss_type]
        rows, cls = _rows(got)
        np.testing.assert_allclose(got["gw"].numpy(), want["gw"][cls],
                                   rtol=1e-4, atol=1e-7)
        np.testing.assert_allclose(got["ge"].numpy(), want["ge"][rows],
                                   rtol=1e-4, atol=1e-7)
        # one gather of the logits forward; the embeddings' all-reduce
        # backward; nothing else
        assert got["calls"] == {"all_gather": 1, "all_reduce": 1}


def test_tp_collectives_need_their_group(runs):
    """Under a process group neither TP collective falls back to the
    default (data) group."""
    for r in runs["ranks"]:
        assert r["refused"] == ["gather_from_group", "copy_to_group"]
    x = torch.ones(2, 3)
    assert collectives.gather_from_group(x, None) is x
    assert collectives.copy_to_group(x, None) is x


def test_dryrun_parts_on_four_ranks(runs):
    """The five parts on the 2 x 2 mesh: one line each from rank 0, finite
    losses, the same on every rank, the TP step equal to the unsharded
    head's."""
    lines = runs["ranks"][0]["dryrun_text"].splitlines()
    assert [line.split(": ")[1].split(" ok")[0] for line in lines] == [
        "SHAM staged steps", "TP margin head", "DINOv2 ViT dp step",
        "SiameseIM dp step", "sharded gallery search"]
    assert all(line.startswith("dryrun_multichip(4): ") for line in lines)
    assert "(mesh 2x2)" in lines[1] and "128 rows over 2 shards" in lines[4]
    assert runs["ranks"][1]["dryrun_text"] == ""
    outs = [r["dryrun"] for r in runs["ranks"]]
    for key in ("sham", "dinov2", "siameseim"):
        assert np.isfinite(outs[0][key])
        assert all(o[key] == outs[0][key] for o in outs)
    assert outs[0]["tp"]["loss_err"] <= 1e-5 * abs(outs[0]["tp"]["loss"])


def test_dryrun_cli_on_two_ranks(capfd):
    """``python -m hairci_torch.cli.dryrun_multichip --ranks 2 --device
    cpu``: two gloo processes, a (1, 2) mesh, five lines."""
    assert dryrun_multichip.main(["--ranks", "2", "--device", "cpu"]) == 0
    lines = [line for line in capfd.readouterr().out.splitlines()
             if line.startswith("dryrun_multichip(2): ")]
    assert len(lines) == 5 and "(mesh 1x2)" in lines[1]
    assert "64 rows over 1 shards" in lines[4]
    assert not collectives.active()
