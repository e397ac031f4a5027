"""Each kernel of the port against the JAX package, on the CPU: the plain
PyTorch versions (what the CPU path and the card check run) against the
JAX Pallas kernels in interpret mode and against the JAX reference.

Parity bar: mask words, sign votes (alpha_num) and Eq. 5 dots bitwise;
bf16 unified bitwise (the rounding of the same fp32 value); λ num/den
and fp32 vectors to rtol 1e-5 (another fp32 summation order).

The CUDA kernels themselves are held against these plain versions on
the card by tests/test_torch_cuda.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops, ref as jref  # noqa: E402
from repro.kernels.fused_unify import fused_unify_packed_pallas  # noqa: E402
from repro.kernels.masked_agg import (  # noqa: E402
    masked_agg_batched_packed_pallas)
from repro.kernels.sign_sim import sign_sim_packed_pallas  # noqa: E402
from repro_torch.kernels import (bitpack, build, fused_unify,  # noqa: E402
                                 masked_agg, ops, ref, sign_sim)

jax.config.update("jax_platform_name", "cpu")

RTOL = 1e-5


def u4(words):
    return bitpack.words_to_numpy(words)


def t_words(words):
    return bitpack.words_from_numpy(np.asarray(words))


def slot_stack(seed, b, k, d):
    rng = np.random.default_rng(seed)
    tv = rng.standard_normal((b, k, d)).astype(np.float32)
    ks = rng.integers(1, k + 1, b)
    valid = np.arange(k)[None, :] < ks[:, None]
    tv[~valid] = rng.standard_normal(tv[~valid].shape)   # garbage, ignored
    return tv, valid


# -- fused_unify_packed ------------------------------------------------------

@pytest.mark.parametrize("seed,b,k,d", [(0, 3, 4, 300), (1, 2, 2, 4100),
                                        (2, 4, 3, 33), (3, 1, 1, 512)])
def test_fused_unify_plain_vs_pallas_and_ref(seed, b, k, d):
    tv, valid = slot_stack(seed, b, k, d)
    uni, words, num, den = fused_unify.plain(torch.from_numpy(tv),
                                             torch.from_numpy(valid))
    for fn in (lambda x, v: fused_unify_packed_pallas(x, v, interpret=True),
               jref.fused_unify_packed_ref):
        ju, jw, jn, jd = fn(jnp.asarray(tv), jnp.asarray(valid))
        assert u4(words).tobytes() == np.asarray(jw).tobytes()
        assert np.array_equal(uni.view(torch.int16).numpy(),
                              np.asarray(ju).view(np.int16))
        np.testing.assert_allclose(num.numpy(), np.asarray(jn), rtol=RTOL)
        np.testing.assert_allclose(den.numpy(), np.asarray(jd), rtol=RTOL)
    # invalid slots: zero mask rows and zero λ num/den
    assert not u4(words)[~valid].any()
    assert not num.numpy()[~valid].any() and not den.numpy()[~valid].any()


def test_fused_unify_bf16_input_matches_reference():
    tv, valid = slot_stack(7, 3, 4, 700)
    tv_b = torch.from_numpy(tv).to(torch.bfloat16)
    uni, words, num, den = fused_unify.plain(tv_b, torch.from_numpy(valid))
    jx = jnp.asarray(tv_b.float().numpy()).astype(jnp.bfloat16)
    ju, jw, jn, jd = fused_unify_packed_pallas(jx, jnp.asarray(valid),
                                               interpret=True)
    assert u4(words).tobytes() == np.asarray(jw).tobytes()
    assert np.array_equal(uni.view(torch.int16).numpy(),
                          np.asarray(ju).view(np.int16))
    np.testing.assert_allclose(num.numpy(), np.asarray(jn), rtol=RTOL)
    np.testing.assert_allclose(den.numpy(), np.asarray(jd), rtol=RTOL)


def test_block_partials_and_tree_total():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.random((2, 3, 1024)).astype(np.float32))
    p = ref._block_partials(x)
    assert p.shape == (2, 3, 4)
    np.testing.assert_allclose(p.numpy(), x.reshape(2, 3, 4, 256).sum(-1)
                               .numpy(), rtol=1e-6)
    # the tree equals the JAX package's tree (same pairing, same padding)
    parts = rng.random((3, 1300)).astype(np.float32)
    assert np.array_equal(ref._tree_total(torch.from_numpy(parts)).numpy(),
                          np.asarray(jref._tree_total(jnp.asarray(parts))))


# -- masked_agg_batched_packed -----------------------------------------------

def dense_round(seed, n, t, d):
    """Dense (N, T) round inputs as the engine builds them: non-member
    rows carry zero words and zero gamma."""
    rng = np.random.default_rng(seed)
    unified = rng.standard_normal((n, d)).astype(np.float32)
    unified[rng.random((n, d)) < 0.1] = 0.0
    members = rng.random((n, t)) < 0.5
    members[:, -1] = False                           # an unheld task
    masks = (rng.random((n, t, d)) < 0.7) & members[:, :, None]
    lams = np.where(members, rng.random((n, t)) + 0.5, 0).astype(np.float32)
    sizes = np.where(members, rng.integers(10, 200, (n, t)), 0)
    gam = sizes / np.maximum(sizes.sum(0, keepdims=True), 1e-12)
    u_b = np.asarray(jnp.asarray(unified).astype(jnp.bfloat16))
    return (u_b, np.asarray(jops.pack_masks(jnp.asarray(masks))), lams,
            gam.astype(np.float32), members)


@pytest.mark.parametrize("seed,n,t,d", [(0, 5, 4, 300), (1, 8, 6, 4100),
                                        (2, 3, 2, 33)])
def test_masked_agg_plain_vs_pallas_and_ref(seed, n, t, d):
    u_b, words, lams, gam, mem = dense_round(seed, n, t, d)
    tau, a_num = masked_agg.plain(
        torch.from_numpy(u_b.astype(np.float32)).to(torch.bfloat16),
        t_words(words), torch.from_numpy(lams), torch.from_numpy(gam),
        torch.from_numpy(mem), d, 0.4)
    args = (jnp.asarray(u_b), jnp.asarray(words), jnp.asarray(lams),
            jnp.asarray(gam), jnp.asarray(mem))
    for j_tau, j_anum in (
            masked_agg_batched_packed_pallas(*args, rho=0.4, interpret=True),
            jops.masked_agg_batched_packed(*args, d, rho=0.4, mode="ref")):
        assert np.array_equal(a_num.numpy(), np.asarray(j_anum))
        np.testing.assert_allclose(tau.numpy(), np.asarray(j_tau), rtol=RTOL,
                                   atol=1e-6)
    # unheld task: τ̂ = 0 and a_num = 0
    assert not tau[-1].any() and not a_num[-1].any()


# -- sign_sim_packed ---------------------------------------------------------

@pytest.mark.parametrize("t,d", [(3, 100), (6, 20000)])
def test_sign_sim_plain_vs_pallas_and_ref(t, d):
    rng = np.random.default_rng(t)
    x = rng.standard_normal((t, d)).astype(np.float32)
    x[rng.random((t, d)) < 0.2] = 0.0
    pos, nz = bitpack.sign_planes(torch.from_numpy(x))
    dots = sign_sim.plain(pos, nz)
    jp, jn = jnp.asarray(u4(pos)), jnp.asarray(u4(nz))
    assert np.array_equal(dots.numpy(),
                          np.asarray(sign_sim_packed_pallas(jp, jn,
                                                            interpret=True)))
    np.testing.assert_array_equal(
        ops.sign_sim_packed(pos, nz, d).numpy(),
        np.asarray(jops.sign_sim_packed(jp, jn, d, mode="ref")))


# -- the (T, T) ops and dispatch ----------------------------------------------

def test_topk_and_cross_task_combine_match_reference():
    rng = np.random.default_rng(3)
    t, d = 7, 50
    sim = rng.random((t, t)).astype(np.float32)
    sim = (sim + sim.T) / 2
    sim[2, 3] = sim[3, 2] = sim[2, 4] = sim[4, 2] = 0.9     # a tie
    w = ops.topk_weights(torch.from_numpy(sim), eps=0.5, kappa=3)
    assert np.array_equal(w.numpy(), np.asarray(
        jops.topk_weights(jnp.asarray(sim), eps=0.5, kappa=3, mode="ref")))
    tau = rng.standard_normal((t, d)).astype(np.float32)
    m_hat = rng.random((t, d)).astype(np.float32)
    tv, tt = ops.cross_task_combine(torch.from_numpy(tau),
                                    torch.from_numpy(m_hat), w)
    jtv, jtt = jops.cross_task_combine(jnp.asarray(tau), jnp.asarray(m_hat),
                                       jnp.asarray(w.numpy()), mode="ref")
    np.testing.assert_allclose(tv.numpy(), np.asarray(jtv), rtol=RTOL,
                               atol=1e-6)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jtt), rtol=RTOL,
                               atol=1e-6)


def test_dispatch_by_device_and_explicit_ref():
    tv, valid = slot_stack(5, 2, 2, 100)
    x, v = torch.from_numpy(tv), torch.from_numpy(valid)
    a = ops.fused_unify_packed(x, v)
    b = ops.fused_unify_packed(x, v, mode="ref")
    for p, q in zip(a, b):
        assert torch.equal(p, q)
    with pytest.raises(ValueError, match="dispatch mode"):
        ops.fused_unify_packed(x, v, mode="cuda")


@pytest.mark.parametrize("call", [
    lambda x, v: fused_unify.fused_unify_packed_cuda(x, v),
    lambda x, v: masked_agg.masked_agg_batched_packed_cuda(
        x[:, 0], torch.zeros(2, 1, 4, dtype=torch.int32), torch.ones(2, 1),
        torch.ones(2, 1), torch.ones(2, 1), 100, 0.4),
    lambda x, v: sign_sim.sign_sim_packed_cuda(
        torch.zeros(2, 4, dtype=torch.int32),
        torch.zeros(2, 4, dtype=torch.int32)),
])
def test_kernel_paths_refuse_cpu_tensors(call):
    tv, valid = slot_stack(6, 2, 2, 100)
    with pytest.raises(ValueError, match="CUDA tensor"):
        call(torch.from_numpy(tv), torch.from_numpy(valid))


@pytest.mark.parametrize("call", [
    lambda x, v: fused_unify.fused_unify_cuda(x, v),
    lambda x, v: fused_unify.unify_cuda(x[0]),
    lambda x, v: masked_agg.masked_agg_batched_cuda(
        x[:, 0], torch.zeros(2, 1, 100, dtype=torch.bool), torch.ones(2, 1),
        torch.ones(2, 1), torch.ones(2, 1), 0.4),
    lambda x, v: sign_sim.sign_sim_cuda(x[:, 0]),
])
def test_bool_kernel_paths_refuse_cpu_tensors(call):
    tv, valid = slot_stack(6, 2, 2, 100)
    with pytest.raises(ValueError, match="CUDA tensor"):
        call(torch.from_numpy(tv), torch.from_numpy(valid))


def test_missing_nvcc_is_an_error(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.nvcc_path()


def test_launch_counts_reset_and_names():
    ops.reset_launch_counts()
    assert ops.launch_counts() == {"fused_unify_packed": 0,
                                   "masked_agg_batched_packed": 0,
                                   "sign_sim_packed": 0, "fused_unify": 0,
                                   "masked_agg_batched": 0, "sign_sim": 0,
                                   "unify": 0, "masked_agg": 0,
                                   "modulated_matmul": 0,
                                   "mlstm_chunkwise": 0}
    # the plain path never counts as a launch
    tv, valid = slot_stack(8, 2, 2, 64)
    ops.fused_unify_packed(torch.from_numpy(tv), torch.from_numpy(valid))
    assert sum(ops.launch_counts().values()) == 0
