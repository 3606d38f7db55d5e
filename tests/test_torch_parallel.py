"""The port's ``parallel/`` (``hairci_torch/parallel``): the (data, model)
mesh over a process group, shardings, the collectives and their gradients,
the global BatchNorm statistics, and the loader's and the draws' shards.

The counterparts of ``tests/test_mesh.py``'s four tests run on two gloo
ranks on the CPU (one spawn computes every case, the asserts follow): a
(2, 1) and a (1, 2) mesh, a batch-sharded matmul, the class-sharded margin
logits, and ``shard_batch`` of a dict. Each collective's gradient is held
against one-process autograd of the sum of both ranks' losses, the loss
being different on each rank, at rtol 1e-6; the 2-rank BatchNorm against
one BatchNorm over both ranks' rows (output, running stats and input
gradient at rtol 1e-5). ``shard_for_host`` is held bitwise against JAX's.
"""

import os
import socket

import numpy as np
import pytest
import torch

from hairci_torch.aug.pipelines import shard_draws, simclr_transform
from hairci_torch.data import DataLoader, load_manifest
from hairci_torch.models.norm import BatchNorm
from hairci_torch.parallel import (
    DATA_AXIS,
    MODEL_AXIS,
    batch_sharding,
    collectives,
    create_mesh,
    local_mesh_size,
    model_sharding,
    replicated_sharding,
    shard_batch,
)
from hairci_torch.parallel.mesh import Mesh, Sharding

torch.set_num_threads(1)
W = 2


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _x(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _loss(r, y):
    """A different loss on each rank, so the gradient's cross-rank terms
    show."""
    c = torch.from_numpy(_x(10 + r, tuple(y.shape)))
    return (c * y).sum() + (r + 1) * (y ** 2).sum()


def _bn_input(r):
    return torch.from_numpy(_x(20 + r, (6, 5, 3, 3)) * 2 + 1)


def _bn_residual(r):
    return torch.from_numpy(_x(70 + r, (6, 5, 3, 3)))


def _fused_bn():
    """A train-mode BatchNorm(5) with a scale and bias away from their
    init, so that the ReLU's mask and every gradient term show."""
    bn = BatchNorm(5).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(_x(80, (5,))).abs() + 0.5)
        bn.bias.copy_(torch.from_numpy(_x(81, (5,))))
    return bn


def _worker(rank, port, out_dir):
    torch.set_num_threads(1)
    collectives.init_distributed(f"localhost:{port}", W, rank)
    out = {"main": collectives.is_main_process(), "rank": collectives.rank(),
           "world": collectives.world()}
    # test_mesh.py: mesh shapes, and the meshes the world cannot hold
    mesh, mesh2 = create_mesh(), create_mesh(n_model=2)
    out["shapes"] = (dict(mesh.shape), dict(mesh2.shape))
    out["coords"] = (mesh.coordinate(DATA_AXIS), mesh2.coordinate(MODEL_AXIS))
    out["raises"] = []
    for kw in ({"n_data": 4}, {"n_model": 3}, {"n_data": 1}):
        try:
            create_mesh(**kw)
            out["raises"].append(None)
        except ValueError as e:
            out["raises"].append(str(e))
    # a batch-sharded matmul, gathered
    x, w = _x(0, (16, 8)), _x(1, (8, 4))
    local = batch_sharding(mesh, 2).local(torch.from_numpy(x))
    out["matmul"] = collectives.all_gather(
        local @ replicated_sharding(mesh).local(torch.from_numpy(w)))
    # the class-sharded classifier over (data=1, model=2)
    wc, xc = _x(0, (16, 8)), _x(1, (4, 8))
    w_local = model_sharding(mesh2, axis=0, ndim=2).local(torch.from_numpy(wc))
    x_local = batch_sharding(mesh2, 2).local(torch.from_numpy(xc))
    out["tp_shapes"] = (tuple(w_local.shape), tuple(x_local.shape))
    out["logits"] = collectives.all_gather(
        (x_local @ w_local.T).T.contiguous(), mesh2.group(MODEL_AXIS)).T
    # shard_batch of a pytree
    batch = {"anchor": torch.arange(8 * 4 * 4 * 3, dtype=torch.float32)
             .reshape(8, 4, 4, 3), "label": np.arange(8, dtype=np.int32)}
    out["sharded"] = shard_batch(batch, mesh)
    out["sharded2"] = shard_batch(batch, mesh2)
    # the collectives' gradients
    collectives.calls.update(all_gather=0, all_reduce=0)
    xr = torch.from_numpy(_x(30 + rank, (3, 4))).requires_grad_()
    _loss(rank, collectives.all_gather(xr)).backward()
    out["gather_grad"] = xr.grad
    for name, fn in (("sum", collectives.all_reduce_sum),
                     ("mean", collectives.all_reduce_mean)):
        xr = torch.from_numpy(_x(30 + rank, (3, 4))).requires_grad_()
        y = fn(xr)
        _loss(rank, y).backward()
        out[f"{name}_value"], out[f"{name}_grad"] = y.detach(), xr.grad
    out["global_mean"] = collectives.global_mean(
        torch.from_numpy(_x(30 + rank, (3, 4))))
    ts = [torch.from_numpy(_x(40 + rank, (3,))),
          torch.from_numpy(_x(50 + rank, (2, 2))),
          torch.arange(4, dtype=torch.float64) * (rank + 1)]
    collectives.all_reduce_mean_(ts)
    out["coalesced"] = ts
    out["calls"] = dict(collectives.calls)
    # BatchNorm over both ranks' rows
    bn = BatchNorm(5).train()
    x = _bn_input(rank).requires_grad_()
    y = bn(x)
    (y * torch.from_numpy(_x(60 + rank, (6, 5, 3, 3)))).sum().backward()
    out["bn"] = (y.detach(), bn.running_mean.clone(), bn.running_var.clone(),
                 x.grad)
    # the fused BatchNorm with a block's residual add and ReLU
    bn = _fused_bn()
    x = _bn_input(rank).requires_grad_()
    res = _bn_residual(rank).requires_grad_()
    collectives.calls.update(all_gather=0, all_reduce=0)
    y = bn(x, residual=res, relu=True)
    (y * torch.from_numpy(_x(60 + rank, (6, 5, 3, 3)))).sum().backward()
    out["bn_fused"] = (y.detach(), bn.running_mean.clone(),
                       bn.running_var.clone(), x.grad, bn.weight.grad,
                       bn.bias.grad, res.grad)
    out["bn_fused_calls"] = dict(collectives.calls)
    torch.save(out, os.path.join(out_dir, f"{rank}.pt"))
    collectives.shutdown()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("parallel")
    torch.multiprocessing.spawn(_worker, args=(_free_port(), str(out)),
                                nprocs=W)
    return [torch.load(str(out / f"{r}.pt"), weights_only=False)
            for r in range(W)]


# ---------------------------------------------------------------------------
# the counterparts of tests/test_mesh.py
# ---------------------------------------------------------------------------

def test_mesh_shapes(ranks):
    for r, out in enumerate(ranks):
        assert out["shapes"] == ({DATA_AXIS: 2, MODEL_AXIS: 1},
                                 {DATA_AXIS: 1, MODEL_AXIS: 2})
        assert out["coords"] == (r, r)
        assert out["main"] == (r == 0) and out["world"] == 2
        assert out["raises"][0] == "requested 4x1 mesh but only 2 devices"
        assert out["raises"][1] == "device count 2 not divisible by n_model=3"
        assert "must hold every process" in out["raises"][2]
    # without a process group the world is one device
    mesh = create_mesh()
    assert mesh.shape == {DATA_AXIS: 1, MODEL_AXIS: 1}
    assert local_mesh_size(mesh) == 1
    with pytest.raises(ValueError, match="only 1 devices"):
        create_mesh(n_data=2)


def test_sharded_batch_matmul(ranks):
    for out in ranks:
        np.testing.assert_allclose(out["matmul"].numpy(), _x(0, (16, 8))
                                   @ _x(1, (8, 4)), rtol=1e-5, atol=1e-5)


def test_model_sharded_classifier(ranks):
    """Class-sharded margin-head weight: each model rank holds 8 of the 16
    class rows, the batch is whole on the data axis of 1."""
    for out in ranks:
        assert out["tp_shapes"] == ((8, 8), (4, 8))
        np.testing.assert_allclose(out["logits"].numpy(), _x(1, (4, 8))
                                   @ _x(0, (16, 8)).T, rtol=1e-4, atol=1e-4)


def test_shard_batch_pytree(ranks):
    mesh = create_mesh()
    assert batch_sharding(mesh, 4).spec[0] == DATA_AXIS
    assert model_sharding(mesh, 1, 2).spec == (None, MODEL_AXIS)
    whole = torch.arange(8 * 4 * 4 * 3, dtype=torch.float32).reshape(
        8, 4, 4, 3)
    for r, out in enumerate(ranks):
        assert torch.equal(out["sharded"]["anchor"], whole[4 * r:4 * r + 4])
        np.testing.assert_array_equal(out["sharded"]["label"],
                                      np.arange(4 * r, 4 * r + 4))
        # the data axis of the (1, 2) mesh holds the whole batch
        assert torch.equal(out["sharded2"]["anchor"], whole)
    with pytest.raises(ValueError, match="does not split"):
        Sharding(Mesh(2, 1), (DATA_AXIS,)).local(np.zeros(3))


# ---------------------------------------------------------------------------
# the collectives
# ---------------------------------------------------------------------------

def _reference_grad(combine):
    """One-process autograd of the sum of both ranks' losses."""
    xs = [torch.from_numpy(_x(30 + r, (3, 4))).requires_grad_()
          for r in range(W)]
    y = combine(xs)
    sum(_loss(r, y) for r in range(W)).backward()
    return [x.grad for x in xs]


@pytest.mark.parametrize("name,combine", [
    ("gather", lambda xs: torch.cat(xs)),
    ("sum", lambda xs: xs[0] + xs[1]),
    ("mean", lambda xs: (xs[0] + xs[1]) / 2),
])
def test_collective_gradients(ranks, name, combine):
    want = _reference_grad(combine)
    for r, out in enumerate(ranks):
        np.testing.assert_allclose(out[f"{name}_grad"].numpy(),
                                   want[r].numpy(), rtol=1e-6, atol=1e-6)
        if name != "gather":
            xs = [torch.from_numpy(_x(30 + q, (3, 4))) for q in range(W)]
            np.testing.assert_allclose(out[f"{name}_value"].numpy(),
                                       combine(xs).numpy(), rtol=1e-6)


def test_global_mean_and_coalesced_mean(ranks):
    whole = np.concatenate([_x(30 + r, (3, 4)) for r in range(W)])
    want = [(_x(40, (3,)) + _x(41, (3,))) / 2,
            (_x(50, (2, 2)) + _x(51, (2, 2))) / 2,
            np.arange(4) * 1.5]
    for out in ranks:
        np.testing.assert_allclose(float(out["global_mean"]), whole.mean(),
                                   rtol=1e-6)
        for got, w in zip(out["coalesced"], want):
            np.testing.assert_allclose(got.numpy(), w, rtol=1e-6)
    # the same bits on both ranks, one all-reduce per dtype, and counted
    for a, b in zip(ranks[0]["coalesced"], ranks[1]["coalesced"]):
        assert torch.equal(a, b)
    # gather: 1 forward + 1 backward; sum and mean: 2 each; global_mean 1;
    # the coalesced mean: one f32 and one f64 buffer
    assert ranks[0]["calls"] == {"all_gather": 1, "all_reduce": 8}


def test_batchnorm_statistics_are_global(ranks):
    """Two ranks' BatchNorm equals one BatchNorm over both ranks' rows:
    output, running stats (the same on both ranks) and input gradient."""
    bn = BatchNorm(5).train()
    xs = [_bn_input(r).requires_grad_() for r in range(W)]
    y = bn(torch.cat(xs))
    (y * torch.cat([torch.from_numpy(_x(60 + r, (6, 5, 3, 3)))
                    for r in range(W)])).sum().backward()
    for r, out in enumerate(ranks):
        got_y, mean, var, grad = out["bn"]
        np.testing.assert_allclose(got_y.numpy(), y[6 * r:6 * r + 6]
                                   .detach().numpy(), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(mean.numpy(), bn.running_mean.numpy(),
                                   rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(var.numpy(), bn.running_var.numpy(),
                                   rtol=1e-5)
        np.testing.assert_allclose(grad.numpy(), xs[r].grad.numpy(),
                                   rtol=1e-5, atol=1e-5)
    assert torch.equal(ranks[0]["bn"][1], ranks[1]["bn"][1])
    assert torch.equal(ranks[0]["bn"][2], ranks[1]["bn"][2])


def test_fused_batchnorm_with_residual_and_relu_is_global(ranks):
    """Two ranks' fused BatchNorm with the residual add and the ReLU
    equals one over both ranks' rows: output, running stats, and the input,
    residual, weight and bias gradients (the ranks' parameter gradients
    summed, as the gradient mean after the step's backward takes them, W
    times over); one all-reduce in the forward and one in the backward."""
    bn = _fused_bn()
    xs = [_bn_input(r).requires_grad_() for r in range(W)]
    rs = [_bn_residual(r).requires_grad_() for r in range(W)]
    y = bn(torch.cat(xs), residual=torch.cat(rs), relu=True)
    (y * torch.cat([torch.from_numpy(_x(60 + r, (6, 5, 3, 3)))
                    for r in range(W)])).sum().backward()
    assert (y == 0).any() and (y > 0).any()
    for r, out in enumerate(ranks):
        got_y, mean, var, gx, _, _, gres = out["bn_fused"]
        np.testing.assert_allclose(got_y.numpy(), y[6 * r:6 * r + 6]
                                   .detach().numpy(), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(mean.numpy(), bn.running_mean.numpy(),
                                   rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(var.numpy(), bn.running_var.numpy(),
                                   rtol=1e-5)
        np.testing.assert_allclose(gx.numpy(), xs[r].grad.numpy(),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(gres.numpy(), rs[r].grad.numpy(),
                                   rtol=1e-5, atol=1e-5)
        assert out["bn_fused_calls"] == {"all_gather": 0, "all_reduce": 2}
    for i, p in ((4, bn.weight), (5, bn.bias)):
        np.testing.assert_allclose(
            sum(out["bn_fused"][i] for out in ranks).numpy(),
            p.grad.numpy(), rtol=1e-5, atol=1e-5)
    assert torch.equal(ranks[0]["bn_fused"][1], ranks[1]["bn_fused"][1])
    assert torch.equal(ranks[0]["bn_fused"][2], ranks[1]["bn_fused"][2])


def test_no_process_group_leaves_tensors_alone():
    x = torch.ones(3)
    collectives.calls.update(all_gather=0, all_reduce=0)
    assert collectives.all_gather(x) is x
    assert collectives.all_reduce_sum(x) is x
    assert collectives.init_distributed("localhost:1", 1, 0) is None
    assert collectives.is_main_process() and collectives.world() == 1
    assert collectives.calls == {"all_gather": 0, "all_reduce": 0}


# ---------------------------------------------------------------------------
# shard_for_host, the loader's shards and the draws' shards
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,pc", [(16, 2), (17, 2), (10, 4), (3, 8), (0, 2)])
def test_shard_for_host_matches_jax(n, pc):
    from hairci.parallel.collectives import shard_for_host as jax_shard

    for pi in range(pc):
        got = collectives.shard_for_host(n, pi, pc)
        want = jax_shard(n, pi, pc)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("pad_last", [True, False])
def test_loader_shards_are_rows_of_the_one_process_batches(tmp_path,
                                                           pad_last):
    """Each shard decodes rows [r B/n, (r+1) B/n) of every batch the
    one-process loader yields, in order, the padded last batch included."""
    from PIL import Image

    rng = np.random.default_rng(4)
    rows = ["id,class"]
    for i in range(13):
        Image.fromarray(rng.integers(0, 256, (20, 24, 3), dtype=np.uint8)
                        ).save(tmp_path / f"{i}.png")
        rows.append(f"{i}.png,{i % 3}")
    (tmp_path / "m.csv").write_text("\n".join(rows) + "\n")
    manifest = load_manifest(str(tmp_path / "m.csv"), str(tmp_path))
    kw = dict(batch_size=4, size=16, shuffle=True, seed=3, num_workers=0,
              drop_last=not pad_last, pad_last=pad_last, decoder="pil")
    whole = list(DataLoader(manifest, **kw))
    shards = [list(DataLoader(manifest, shard_index=r, shard_count=2, **kw))
              for r in range(2)]
    assert len(whole) == (4 if pad_last else 3)
    for b, (images, labels) in enumerate(whole):
        for r in range(2):
            np.testing.assert_array_equal(shards[r][b][0],
                                          images[2 * r:2 * r + 2])
            np.testing.assert_array_equal(shards[r][b][1],
                                          labels[2 * r:2 * r + 2])
    with pytest.raises(ValueError, match="must divide evenly"):
        DataLoader(manifest, batch_size=5, shard_count=2, pad_last=True)
    with pytest.raises(ValueError, match="dropped or padded"):
        DataLoader(manifest, batch_size=4, shard_count=2)


def test_shard_draws_give_the_global_views_rows():
    """A rank's views from its rows of the global draws are the rows of the
    one-process views (the colour jitter's op order shared)."""
    t = simclr_transform(16)
    gen = torch.Generator().manual_seed(0)
    images = torch.from_numpy(np.random.default_rng(1).integers(
        0, 256, (8, 24, 24, 3), dtype=np.uint8))
    draws = t.draw(gen, 8, 24, 24)
    whole = t.apply(images, draws)
    for lo in (0, 4):
        part = t.apply(images[lo:lo + 4],
                       [shard_draws(d, lo, lo + 4) for d in draws])
        for got, want in zip(part, whole):
            np.testing.assert_allclose(got.numpy(), want[lo:lo + 4].numpy(),
                                       rtol=1e-6, atol=1e-6)
