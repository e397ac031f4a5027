"""The port's CUDA kernels against their plain PyTorch versions, on the
card: bitwise for every output (the plain versions fix the kernels'
summation order).  Every test here is marked ``cuda`` and skips inside
the test where no CUDA device is available; this file imports no JAX,
so it runs on a machine with the card and torch alone:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import (bitpack, fused_unify, masked_agg,  # noqa
                                 ops, sign_sim)


def slot_stack(seed, b, k, d):
    rng = np.random.default_rng(seed)
    tv = rng.standard_normal((b, k, d)).astype(np.float32)
    ks = rng.integers(1, k + 1, b)
    valid = np.arange(k)[None, :] < ks[:, None]
    return tv, valid


def dense_round(seed, n, t, d):
    """Dense (N, T) round inputs: non-member rows carry zero words and
    zero gamma, as in the engine's dense layout."""
    rng = np.random.default_rng(seed)
    unified = rng.standard_normal((n, d)).astype(np.float32)
    unified[rng.random((n, d)) < 0.1] = 0.0
    members = rng.random((n, t)) < 0.5
    members[:, -1] = False
    masks = (rng.random((n, t, d)) < 0.7) & members[:, :, None]
    lams = np.where(members, rng.random((n, t)) + 0.5, 0).astype(np.float32)
    sizes = np.where(members, rng.integers(10, 200, (n, t)), 0)
    gam = (sizes / np.maximum(sizes.sum(0, keepdims=True), 1e-12)).astype(
        np.float32)
    words = bitpack.pack_bits(torch.from_numpy(masks))
    return unified, words, lams, gam, members


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,k,d", [(3, 4, 300), (2, 16, 4100), (5, 3, 33)])
def test_cuda_fused_unify_matches_plain(cuda, dtype, b, k, d):
    tv, valid = slot_stack(b * d, b, k, d)
    x = torch.from_numpy(tv).to(cuda, dtype)
    v = torch.from_numpy(valid).to(cuda)
    got = fused_unify.fused_unify_packed_cuda(x, v)
    want = fused_unify.plain(x, v)
    torch.cuda.synchronize()
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[0].view(torch.int16), want[0].view(torch.int16))
    assert torch.equal(got[2], want[2]) and torch.equal(got[3], want[3])


@pytest.mark.cuda
@pytest.mark.parametrize("seed,n,t,d", [(0, 5, 4, 300), (1, 40, 6, 4100)])
def test_cuda_masked_agg_matches_plain(cuda, seed, n, t, d):
    u, words, lams, gam, mem = dense_round(seed, n, t, d)
    args = (torch.from_numpy(u).to(cuda, torch.bfloat16),
            words.to(cuda), torch.from_numpy(lams).to(cuda),
            torch.from_numpy(gam).to(cuda), torch.from_numpy(mem).to(cuda),
            d, 0.4)
    got = masked_agg.masked_agg_batched_packed_cuda(*args)
    want = masked_agg.plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])


@pytest.mark.cuda
@pytest.mark.parametrize("t,d", [(3, 100), (30, 50000)])
def test_cuda_sign_sim_matches_plain(cuda, t, d):
    x = torch.randn((t, d), generator=torch.Generator().manual_seed(t))
    x[x.abs() < 0.2] = 0.0
    pos, nz = bitpack.sign_planes(x.to(cuda))
    got = sign_sim.sign_sim_packed_cuda(pos, nz)
    torch.cuda.synchronize()
    assert torch.equal(got, sign_sim.plain(pos, nz))


@pytest.mark.cuda
def test_cuda_round_matches_plain_round(cuda):
    """One whole round through the kernels equals the round through the
    plain versions, and every kernel counts its launch."""
    from repro_torch.core.engine import EngineConfig, RoundEngine, \
        pack_from_slots
    n, k, t, d = 12, 4, 6, 5000
    tv, valid = slot_stack(3, n, k, d)
    rng = np.random.default_rng(4)
    tasks = np.full((n, k), t, np.int32)
    for i in range(n):
        kk = int(valid[i].sum())
        tasks[i, :kk] = np.sort(rng.choice(t, kk, replace=False))
    sizes = np.where(valid, rng.integers(10, 200, (n, k)), 0)
    x = torch.from_numpy(tv * valid[:, :, None]).to(cuda)
    v = torch.from_numpy(valid).to(cuda)
    ops.reset_launch_counts()
    uni, words, lams = ops.fused_unify_packed(x, v)
    packed = pack_from_slots(list(range(n)),
                             [tasks[i, :valid[i].sum()].tolist()
                              for i in range(n)], uni, words, lams,
                             torch.from_numpy(tasks).to(cuda), v,
                             torch.from_numpy(sizes).to(cuda), t, d=d)
    eng = RoundEngine(EngineConfig(n_tasks=t), device=cuda)
    got = eng.run_packed(packed)
    counts = ops.launch_counts()
    want = eng.run_packed(packed, mode="ref")
    torch.cuda.synchronize()
    assert counts == {"fused_unify_packed": 2, "masked_agg_batched_packed": 1,
                      "sign_sim_packed": 1}
    for a, b in zip(got[:6] + (got.alpha_num, got.n_held),
                    want[:6] + (want.alpha_num, want.n_held)):
        assert torch.equal(a, b)
