"""The port's top-k (hairci_torch/ops/topk.py) against the JAX Pallas kernel
(hairci/ops/topk_pallas.py) run in interpret mode on the CPU, and the CUDA
kernel against its plain twin on a card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hairci.ops.topk_pallas import topk_gallery_search as jax_topk
from hairci_torch.ops.topk import (
    plan,
    topk_gallery_search,
    topk_gallery_search_reference,
)

torch.set_num_threads(1)


def _unit(rng, n, d):
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _assert_same(ours, ref):
    np.testing.assert_allclose(ours[0].numpy(), np.asarray(ref[0]),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(ours[1].numpy(), np.asarray(ref[1]))


@pytest.mark.parametrize("Q,N,D,k,chunk", [
    (4, 100, 32, 5, 32),     # padding on every axis + multiple chunks
    (8, 256, 128, 10, 128),  # aligned
    (3, 50, 16, 60, 32),     # k > N -> clamped to N
])
def test_twin_matches_pallas_interpret(Q, N, D, k, chunk):
    rng = np.random.default_rng(Q * N)
    q, g = _unit(rng, Q, D), _unit(rng, N, D)
    ref = jax_topk(jnp.asarray(q), jnp.asarray(g), k=k, chunk=chunk,
                   interpret=True)
    ours = topk_gallery_search_reference(torch.from_numpy(q),
                                         torch.from_numpy(g), min(k, N))
    _assert_same(ours, ref)


def test_tie_order_matches_pallas_interpret():
    # duplicated gallery rows -> equal scores; the lower index must win
    rng = np.random.default_rng(1)
    base = _unit(rng, 10, 16)
    g = np.concatenate([base, base])
    ref = jax_topk(jnp.asarray(g[:4]), jnp.asarray(g), k=3, chunk=8,
                   interpret=True)
    ours = topk_gallery_search(torch.from_numpy(g[:4].copy()),
                               torch.from_numpy(g), 3)
    _assert_same(ours, ref)
    np.testing.assert_array_equal(ours[1][:, :2].numpy(),
                                  np.stack([np.arange(4), np.arange(4) + 10],
                                           1))


def test_bf16_storage_matches_pallas_interpret():
    # GalleryIndex passes a bf16 gallery without bf16=True: the kernel reads
    # bf16 rows and scores f32(q) . f32(g)
    rng = np.random.default_rng(2)
    q, g = _unit(rng, 4, 64), _unit(rng, 200, 64)
    g16 = jnp.asarray(g, jnp.bfloat16)
    ref = jax_topk(jnp.asarray(q), g16, k=5, chunk=64, interpret=True)
    g_t = torch.from_numpy(np.array(g16.astype(jnp.float32))).bfloat16()
    ours = topk_gallery_search(torch.from_numpy(q), g_t, 5)
    _assert_same(ours, ref)


def test_n_valid_matches_pallas_interpret():
    rng = np.random.default_rng(3)
    q, g = _unit(rng, 5, 32), _unit(rng, 160, 32)
    ref = jax_topk(jnp.asarray(q), jnp.asarray(g), k=8, chunk=32,
                   interpret=True, n_valid=100)
    ours = topk_gallery_search(torch.from_numpy(q), torch.from_numpy(g), 8,
                               n_valid=100)
    _assert_same(ours, ref)
    assert ours[1].max() < 100


def test_wrapper_checks_and_cpu_path():
    q = torch.zeros(2, 8)
    g = torch.zeros(20, 8)
    before = topk_gallery_search.launches
    s, i = topk_gallery_search(q, g, 4)
    assert s.shape == (2, 4) and i.dtype == torch.int64
    assert topk_gallery_search.launches == before  # the twin is no launch
    with pytest.raises(ValueError, match="k <= 16"):
        topk_gallery_search(q, g, 17)
    with pytest.raises(ValueError, match="dtypes"):
        topk_gallery_search(q.double(), g, 4)
    with pytest.raises(ValueError, match="contiguous"):
        topk_gallery_search(q, torch.zeros(8, 20).T, 4)
    with pytest.raises(ValueError, match="shapes"):
        topk_gallery_search(q, torch.zeros(20, 9), 4)
    with pytest.raises(ValueError, match="n_valid"):
        topk_gallery_search(q, g, 4, n_valid=21)


def test_plan_fills_the_card():
    # ViT-B serving shapes on a 132-SM card: Q=1 still gets hundreds of
    # blocks; shared memory always fits
    log_qt, kcap, splits = plan(1, 103945, 768, 5, 132)
    assert (log_qt, kcap) == (0, 8) and splits >= 132
    log_qt, kcap, splits = plan(256, 103945, 768, 16, 132)
    assert kcap == 16 and (2 ** log_qt) * 768 * 4 <= 232448
    assert -(-256 // 2 ** log_qt) * splits >= 132
    assert plan(3, 5, 4000, 1, 132)[0] == 3


@pytest.mark.cuda
def test_cuda_kernel_matches_twin():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the GPU)")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    for dtype in (torch.float32, torch.bfloat16):
        for Q, N, D, k in ((1, 5000, 768, 5), (37, 3001, 96, 16),
                           (256, 20000, 768, 8), (4, 3, 40, 8),
                           (5, 999, 45, 7)):  # D % 4 != 0: scalar loads
            q = torch.randn(Q, D, device="cuda", generator=gen)
            g = torch.randn(N, D, device="cuda", generator=gen)
            q = q / q.norm(dim=1, keepdim=True)
            g = (g / g.norm(dim=1, keepdim=True)).to(dtype)
            s, i = topk_gallery_search(q, g, k)
            rs, ri = topk_gallery_search_reference(q, g, min(k, N))
            torch.cuda.synchronize()
            torch.testing.assert_close(s, rs, rtol=0, atol=1e-5)
            assert torch.equal(i, ri)
