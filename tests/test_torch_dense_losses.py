"""The port's dense losses (``hairci_torch/losses/dense.py``) against the JAX
package's ``hairci/losses/dense.py``: every function's value and its
gradient within 1e-5 on seeded f32 inputs, the zero row of a fresh bank,
``update_memory_bank`` bitwise (a ring that wraps, and the pointer it
returns), ``select_most_similar``'s matches equal to JAX's (ties to the
first maximum), and ``ResNetFeatures`` in bf16 against JAX's: the pooled
features are the f32 mean of the f32 map, not rounded to bf16 as
``ResNet.forward``'s are."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hairci.losses.dense as jax_dense
import hairci.models.resnet as jax_resnet
import hairci_torch.losses.dense as dense
import hairci_torch.models.resnet as port_resnet
from hairci_torch.models.convert import resnet_state_dict_from_jax
from test_torch_resnet import random_variables

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


def _inputs(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


def _value_and_grads(jax_fn, port_fn, args, argnums, **kw):
    """Both packages' value and gradients wrt ``argnums`` (JAX's jitted:
    one compile, not one per op)."""
    want, jgrads = jax.jit(jax.value_and_grad(
        lambda *a: jax_fn(*a, **kw), argnums=argnums))(
            *(jnp.asarray(a) for a in args))
    targs = [_t(a, grad=i in argnums) for i, a in enumerate(args)]
    got = port_fn(*targs, **kw)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), **TOL)
    for i, g in zip(argnums, jgrads):
        np.testing.assert_allclose(targs[i].grad.numpy(), np.asarray(g),
                                   err_msg=f"grad {i}", **TOL)
    return got


@pytest.mark.parametrize("name,shapes,argnums,kw", [
    ("dense_loss", [(3, 4, 8), (3, 4, 8)], (0, 1), {"temperature": 0.3}),
    ("patch_contrastive_loss", [(3, 5, 8), (3, 5, 8)], (0, 1),
     {"temperature": 0.5}),
    ("memory_bank_infonce", [(6, 16), (6, 16), (10, 16)], (0,),
     {"temperature": 0.1}),
])
def test_loss_and_gradient_match_jax(name, shapes, argnums, kw):
    args = _inputs(len(name), *shapes)
    _value_and_grads(getattr(jax_dense, name), getattr(dense, name), args,
                     argnums, **kw)


def test_memory_bank_infonce_no_gradient_through_key_and_bank():
    q, k, bank = _inputs(1, (4, 8), (4, 8), (6, 8))
    tq, tk, tb = _t(q, True), _t(k, True), _t(bank, True)
    dense.memory_bank_infonce(tq, tk, tb).backward()
    assert tq.grad.abs().sum() > 0
    assert tk.grad is None and tb.grad is None


def test_fresh_bank_of_zeros():
    """A zero row normalises to zero, not NaN: against a fresh bank every
    negative logit is 0, and the loss is JAX's."""
    q, k = _inputs(2, (5, 8), (5, 8))
    bank = np.zeros((7, 8), np.float32)
    got = _value_and_grads(jax_dense.memory_bank_infonce,
                           dense.memory_bank_infonce, [q, k, bank], (0,),
                           temperature=0.2)
    assert torch.isfinite(got)
    zero = dense._normalize(torch.zeros(3, 8))
    assert torch.equal(zero, torch.zeros(3, 8))
    np.testing.assert_array_equal(
        np.asarray(jax_dense._normalize(jnp.zeros((3, 8)))), zero.numpy())


def test_normalize_matches_jax():
    (x,) = _inputs(3, (4, 6, 16))
    x[0, 0] = 1e-14      # a row below eps
    np.testing.assert_allclose(dense._normalize(_t(x)).numpy(),
                               np.asarray(jax_dense._normalize(x)), **TOL)


def test_update_memory_bank_ring_bitwise():
    """M = 6, B = 4: the second enqueue wraps (rows 4, 5, 0, 1); bank and
    pointer bitwise JAX's, with an int pointer and with a 0-d tensor."""
    rng = np.random.default_rng(4)
    jbank, jptr = jnp.zeros((6, 3), jnp.float32), jnp.zeros((), jnp.int32)
    bank, ptr = torch.zeros(6, 3), torch.zeros((), dtype=torch.long)
    ibank, iptr = torch.zeros(6, 3), 0
    for step in range(3):
        keys = rng.normal(size=(4, 3)).astype(np.float32)
        jbank, jptr = jax_dense.update_memory_bank(jbank, jptr,
                                                   jnp.asarray(keys))
        bank, ptr = dense.update_memory_bank(bank, ptr, _t(keys))
        ibank, iptr = dense.update_memory_bank(ibank, iptr, _t(keys))
        np.testing.assert_array_equal(bank.numpy(), np.asarray(jbank))
        np.testing.assert_array_equal(ibank.numpy(), np.asarray(jbank))
        assert int(ptr) == iptr == int(jptr) == (4 * (step + 1)) % 6
        assert isinstance(ptr, torch.Tensor) and ptr.dtype == torch.long
    # rows written last: 0..3 wrapped over the step before
    assert int(jptr) == 0


def test_update_memory_bank_leaves_its_input_and_refuses_overflow():
    bank = torch.zeros(4, 2)
    new, ptr = dense.update_memory_bank(bank, 3, torch.ones(2, 2))
    assert not bank.any() and int(ptr) == 1
    assert new[:, 0].tolist() == [1.0, 0.0, 0.0, 1.0]
    with pytest.raises(ValueError):
        dense.update_memory_bank(bank, 0, torch.ones(5, 2))


def test_select_most_similar_matches_jax_with_ties():
    """The matched local keys equal JAX's; a duplicated key position (an
    exact tie of the cosine) goes to the first of the two, as
    ``jnp.argmax``."""
    q, k, local = _inputs(5, (3, 9, 16), (3, 9, 16), (3, 9, 8))
    k[:, 7] = k[:, 2]            # ties: positions 2 and 7 match alike
    q[:, 4] = 2.5 * k[:, 2]      # and query 4 points exactly at them
    want = np.asarray(jax_dense.select_most_similar(q, k, local))
    got = dense.select_most_similar(_t(q), _t(k), _t(local))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got[:, 4].numpy(), local[:, 2])
    # the gradient flows to the gathered local keys only
    tl = _t(local, True)
    dense.select_most_similar(_t(q), _t(k), tl).sum().backward()
    jg = jax.grad(lambda l: jax_dense.select_most_similar(q, k, l).sum())(
        jnp.asarray(local))
    np.testing.assert_array_equal(tl.grad.numpy(), np.asarray(jg))


# ---------------------------------------------------------------------------
# the spatial trunk
# ---------------------------------------------------------------------------

def test_resnet_features_bf16_match_jax(monkeypatch):
    """ResNet-18 (one block per stage) at 64 px in bf16, eval mode: the
    spatial map (B, 2, 2, 512) and its pooled mean against JAX's
    ``ResNetFeatures``. The pooled features are not rounded to bf16 (JAX's
    ``ResNet`` rounds them, and so does the port's ``ResNet.forward``)."""
    monkeypatch.setitem(jax_resnet._STAGES, "resnet18",
                        ([1, 1, 1, 1], jax_resnet.BasicBlock))
    monkeypatch.setitem(port_resnet._STAGES, "resnet18",
                        ([1, 1, 1, 1], port_resnet.BasicBlock))
    rng = np.random.default_rng(6)
    x = rng.normal(size=(3, 64, 64, 3)).astype(np.float32)
    jfeat = jax_resnet.build_resnet("resnet18", dtype=jnp.bfloat16,
                                    with_spatial=True)
    params, stats = random_variables(jfeat, x, rng, train=False)
    variables = {"params": params, "batch_stats": stats}
    want_pooled, want_spatial = jax.jit(
        lambda v, x: jfeat.apply(v, x, train=False))(variables, x)
    want_plain = jax.jit(lambda v, x: jax_resnet.build_resnet(
        "resnet18", dtype=jnp.bfloat16).apply(v, x, train=False))(
            variables, x)

    sd = resnet_state_dict_from_jax(params, stats, (1, 1, 1, 1))
    feat = port_resnet.build_resnet("resnet18", dtype=torch.bfloat16,
                                    with_spatial=True)
    plain = port_resnet.build_resnet("resnet18", dtype=torch.bfloat16)
    assert isinstance(feat, port_resnet.ResNetFeatures)
    for m in (feat, plain):
        m.load_state_dict(sd, strict=True)
        m.eval()
    with torch.no_grad():
        pooled, spatial = feat(_t(x))
        rounded = plain(_t(x))
    assert spatial.shape == (3, 2, 2, 512) and spatial.dtype == torch.float32
    assert pooled.dtype == torch.float32
    # the grid DenseCL flattens: row-major (h, w), as JAX's reshape
    grid = spatial.reshape(3, 4, 512)
    assert torch.equal(grid[:, 1], spatial[:, 0, 1])
    assert torch.equal(pooled, spatial.mean(dim=(1, 2)))
    # the map within one bf16 ulp (on the CPU it is bitwise JAX's); the
    # f32 means within f32 summation order
    np.testing.assert_allclose(spatial.numpy(), np.asarray(want_spatial),
                               rtol=2.0 ** -7, atol=0)
    np.testing.assert_allclose(pooled.numpy(), np.asarray(want_pooled),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(rounded.numpy(), np.asarray(want_plain),
                               rtol=2.0 ** -7, atol=0)
    # the trap: only ResNet.forward rounds its pooled features to bf16
    assert torch.equal(rounded, rounded.bfloat16().float())
    assert not torch.equal(pooled, pooled.bfloat16().float())
    want_pooled = np.asarray(want_pooled)
    assert not np.array_equal(want_pooled, np.asarray(
        jnp.asarray(want_pooled).astype(jnp.bfloat16).astype(jnp.float32)))
