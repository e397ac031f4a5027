"""The port's bool/fp32 A/B round layout against the JAX package, on the
CPU: each plain version against the JAX Pallas kernel in interpret mode
and the JAX reference, then the whole bool round through the port's
``RoundEngine`` against JAX's, and packed ≡ bool within the port.

Parity bar: masks, m̂, S, ``unify`` and the fp32 unified vectors
bitwise; λ num/den, τ̂ and task vectors to rtol 1e-5, atol 1e-6 (XLA
sums in another order); downlink masks of a whole round ≥ 99.999 %
equal (task vectors come out of fp32 sums, so a value at rounding
distance from zero may flip a bit).  Within the port, the bool round
equals the packed round bit for bit on bf16-valued inputs.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import aggregation as jagg  # noqa: E402
from repro.core import engine as jeng  # noqa: E402
from repro.core.client import ClientUpload as JUpload  # noqa: E402
from repro.core.unify import (  # noqa: E402
    unify_with_modulators as j_unify_with_modulators)
from repro.kernels import ops as jops, ref as jref  # noqa: E402
from repro.kernels.fused_unify import fused_unify_pallas  # noqa: E402
from repro.kernels.masked_agg import masked_agg_batched_pallas  # noqa: E402
from repro.kernels.sign_sim import sign_sim_pallas  # noqa: E402
from repro.kernels.unify import unify_pallas  # noqa: E402
from repro_torch.core import aggregation as tagg  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.core.client import ClientUpload as TUpload  # noqa: E402
from repro_torch.core.client import paper_link_bits  # noqa: E402
from repro_torch.core.server import MaTUServer, MaTUServerConfig  # noqa: E402
from repro_torch.kernels import (bitpack, fused_unify, masked_agg,  # noqa
                                 ops, sign_sim)

jax.config.update("jax_platform_name", "cpu")

RTOL, ATOL = 1e-5, 1e-6


def t(a):
    return torch.from_numpy(np.array(a))


def slot_stack(seed, b, k, d):
    rng = np.random.default_rng(seed)
    tv = rng.standard_normal((b, k, d)).astype(np.float32)
    ks = rng.integers(1, k + 1, b)
    valid = np.arange(k)[None, :] < ks[:, None]
    tv[~valid] = rng.standard_normal(tv[~valid].shape)   # garbage, ignored
    return tv, valid


# -- unify (kernel 7) -------------------------------------------------------

@pytest.mark.parametrize("k,d", [(1, 97), (3, 300), (20, 4100)])
def test_unify_plain_vs_pallas_and_ref(k, d):
    x = np.random.default_rng(k + d).standard_normal((k, d)).astype(
        np.float32)
    got = ops.unify(t(x))
    assert got.dtype == torch.float32
    for want in (unify_pallas(jnp.asarray(x), interpret=True),
                 jref.unify_ref(jnp.asarray(x))):
        assert np.array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(fused_unify.unify(t(x)), got)


# -- fused_unify, bool layout (kernel 4) -------------------------------------

@pytest.mark.parametrize("seed,b,k,d", [(0, 3, 4, 300), (1, 2, 1, 97),
                                        (2, 2, 3, 4100)])
def test_fused_unify_bool_plain_vs_pallas_and_ref(seed, b, k, d):
    tv, valid = slot_stack(seed, b, k, d)
    uni, masks, num, den = ops.fused_unify_raw(t(tv), t(valid), packed=False)
    assert uni.dtype == torch.float32 and masks.dtype == torch.bool
    ju, jm, jn, jd = fused_unify_pallas(jnp.asarray(tv), jnp.asarray(valid),
                                        interpret=True)
    ru, rm, rn, rd = jref.fused_unify_ref(jnp.asarray(tv), jnp.asarray(valid))
    for j_u, j_m, j_n, j_d in ((ju, np.asarray(jm) > 0.5, jn, jd),
                               (ru, rm, rn, rd)):
        assert np.array_equal(uni.numpy(), np.asarray(j_u))
        assert np.array_equal(masks.numpy(), np.asarray(j_m))
        np.testing.assert_allclose(num.numpy(), np.asarray(j_n), rtol=RTOL)
        np.testing.assert_allclose(den.numpy(), np.asarray(j_d), rtol=RTOL)
    assert not masks.numpy()[~valid].any()
    # the two layouts: the same mask bits and λ partials, bf16 = rounding
    pu, pw, pn, pd = ops.fused_unify_raw(t(tv), t(valid))
    assert torch.equal(bitpack.pack_bits(masks), pw)
    assert torch.equal(uni.to(torch.bfloat16).view(torch.int16),
                       pu.view(torch.int16))
    assert torch.equal(num, pn) and torch.equal(den, pd)


# -- masked_agg_batched, bool layout (kernel 5) ------------------------------

def dense_round(seed, n, t_, d):
    """Dense (N, T) round inputs as the engine builds them: non-member
    rows carry zero masks and zero gamma; task 0 has a member of zero
    data weight, the last task is unheld."""
    rng = np.random.default_rng(seed)
    unified = rng.standard_normal((n, d)).astype(np.float32)
    unified[rng.random((n, d)) < 0.1] = 0.0
    members = rng.random((n, t_)) < 0.5
    members[:2, 0] = True
    members[:, -1] = False
    masks = (rng.random((n, t_, d)) < 0.7) & members[:, :, None]
    lams = np.where(members, rng.random((n, t_)) + 0.5, 0).astype(np.float32)
    sizes = np.where(members, rng.integers(10, 200, (n, t_)), 0)
    sizes[0, 0] = 0                                  # zero-weight member
    gam = (sizes / np.maximum(sizes.sum(0, keepdims=True), 1e-12)).astype(
        np.float32)
    return unified, masks, lams, gam, members


@pytest.mark.parametrize("seed,n,t_,d", [(0, 5, 4, 300), (1, 8, 6, 4100),
                                         (2, 3, 2, 97)])
def test_masked_agg_bool_plain_vs_pallas_and_ref(seed, n, t_, d):
    u, masks, lams, gam, mem = dense_round(seed, n, t_, d)
    tau, m_hat = ops.masked_agg_batched(t(u), t(masks), t(lams), t(gam),
                                        t(mem), rho=0.4)
    args = tuple(map(jnp.asarray, (u, masks, lams, gam, mem)))
    for j_tau, j_m in (masked_agg_batched_pallas(*args, rho=0.4,
                                                 interpret=True),
                       jref.masked_agg_batched_ref(*args, 0.4)):
        assert np.array_equal(m_hat.numpy(), np.asarray(j_m))
        np.testing.assert_allclose(tau.numpy(), np.asarray(j_tau), rtol=RTOL,
                                   atol=ATOL)
    assert not tau[-1].any() and not m_hat[-1].any()      # unheld task
    # the zero-weight member still votes: N_t counts it
    n_t = mem[:, 0].sum()
    assert mem[0, 0] and gam[0, 0] == 0 and n_t >= 2
    assert set(np.unique(m_hat[0].numpy())) <= set(
        (np.arange(n_t + 1) / n_t).astype(np.float32)) | {1.0}
    # τ̂ is bitwise the packed twin's on the same bits
    tau_p, a_num = masked_agg.masked_agg_batched_packed(
        t(u), bitpack.pack_bits(t(masks)), t(lams), t(gam), t(mem), d, 0.4)
    assert torch.equal(tau, tau_p)


# -- sign_sim, dense (kernel 6) ---------------------------------------------

def xla_sim(dots: np.ndarray, d: int) -> np.ndarray:
    """S as XLA computes it inside ``jit``: ``0.5 * (dots / d + 1)`` is
    rewritten to fma(dots, fl(1/d), 1) * 0.5.  The product of an integer
    below 2^24 and an fp32 reciprocal, plus 1, is exact in float64, so
    one rounding to fp32 is the fma's."""
    r = np.float64(np.float32(1.0 / d))
    return np.float32(dots.astype(np.float64) * r + 1.0) * np.float32(0.5)


@pytest.mark.parametrize("t_,d", [(3, 97), (6, 4100)])
def test_sign_sim_dense_plain_vs_pallas_and_ref(t_, d):
    """S bitwise against the JAX reference (eager, a true division by d);
    against the jitted Pallas kernel the dots are bitwise equal and S is
    their normalisation by XLA's reciprocal-fma rewrite (at most 1 ulp
    from the true division)."""
    rng = np.random.default_rng(t_ * d)
    x = rng.standard_normal((t_, d)).astype(np.float32)
    x[rng.random((t_, d)) < 0.2] = 0.0
    x[-1] = 0.0                                       # an all-zero task row
    got = ops.sign_sim(t(x))
    assert np.array_equal(got.numpy(),
                          np.asarray(jref.sign_sim_ref(jnp.asarray(x))))
    dots = np.sign(x) @ np.sign(x).T
    assert np.array_equal(got.numpy(), (0.5 * (t(dots) / d + 1.0)).numpy())
    pallas = np.asarray(sign_sim_pallas(jnp.asarray(x), interpret=True))
    assert np.array_equal(xla_sim(dots, d), pallas)
    ulp = np.abs(got.numpy().view(np.int32) - pallas.view(np.int32))
    assert ulp.max() <= 1
    pos, nz = bitpack.sign_planes(t(x))
    assert torch.equal(got, ops.sign_sim_packed(pos, nz, d))
    assert torch.equal(sign_sim.sign_sim(t(x)), got)


# -- the whole bool round -----------------------------------------------------

def make_round(seed, n, k, t_, d, unheld=1):
    rng = np.random.default_rng(seed)
    tv = rng.standard_normal((n, k, d)).astype(np.float32)
    ks = rng.integers(1, k + 1, n)
    valid = np.arange(k)[None, :] < ks[:, None]
    tv *= valid[:, :, None]
    tasks = np.full((n, k), t_, np.int32)
    for i in range(n):
        tasks[i, :ks[i]] = np.sort(rng.choice(t_ - unheld, ks[i],
                                              replace=False))
    sizes = np.where(valid, rng.integers(10, 200, (n, k)), 0).astype(
        np.float32)
    return tv, valid, tasks, sizes, list(range(n)), [
        tasks[i, :ks[i]].tolist() for i in range(n)]


def jax_bool_round(tv, valid, tasks, sizes, cids, tids, t_, d):
    uni, masks, lams = jeng.batched_client_unify(
        jnp.asarray(tv), jnp.asarray(valid), mode="ref", packed=False)
    return jeng.pack_from_slots(cids, tids, uni, masks, lams,
                                jnp.asarray(tasks), jnp.asarray(valid),
                                jnp.asarray(sizes), t_, d=d)


def port_round_from(jp, d):
    return teng.pack_from_slots(jp.client_ids, jp.task_ids, t(jp.unified),
                                t(jp.slot_masks), t(jp.slot_lams),
                                t(jp.slot_tasks), t(jp.slot_valid),
                                t(jp.slot_sizes), jp.n_tasks, d=d)


def assert_bool_round_close(jo, to, valid):
    """The port's bool round against JAX's (whose client axis may be
    padded past the port's n rows)."""
    n = to.down_masks.shape[0]
    assert to.down_masks.dtype == torch.bool
    assert to.down_unified.dtype == torch.float32
    np.testing.assert_array_equal(to.m_hats.numpy(), np.asarray(jo.m_hats))
    for name in ("tau_hats", "task_vectors", "similarity", "down_unified",
                 "down_lams"):
        np.testing.assert_allclose(getattr(to, name).numpy(),
                                   np.asarray(getattr(jo, name))[:n]
                                   if name.startswith("down") else
                                   np.asarray(getattr(jo, name)), rtol=RTOL,
                                   atol=ATOL, err_msg=name)
    agree = to.down_masks.numpy() == np.asarray(jo.down_masks)[:n]
    assert agree[valid[:n]].mean() >= 0.99999


ROUNDS = [
    # seed, n, k, t, d, unheld
    (0, 6, 4, 7, 1000, 1),        # ragged d (1000 % 32 = 8), one unheld task
    (1, 4, 2, 5, 97, 2),          # d % 32 = 1, two unheld tasks
    (2, 9, 4, 4, 4100, 0),        # more clients than tasks, every task held
]


@pytest.mark.parametrize("mode", ["ref", "pallas_interpret"])
@pytest.mark.parametrize("seed,n,k,t_,d,unheld", ROUNDS)
def test_bool_run_packed_matches_jax(mode, seed, n, k, t_, d, unheld):
    tv, valid, tasks, sizes, cids, tids = make_round(seed, n, k, t_, d,
                                                     unheld)
    jp = jax_bool_round(tv, valid, tasks, sizes, cids, tids, t_, d)
    assert not jp.packed
    jo = jeng.RoundEngine(jeng.EngineConfig(n_tasks=t_)).run_packed(jp,
                                                                    mode=mode)
    tp = port_round_from(jp, d)
    assert not tp.packed
    to = teng.RoundEngine(teng.EngineConfig(n_tasks=t_),
                          device="cpu").run_packed(tp)
    assert to.alpha_num is None and to.m_hats_dense is not None
    assert_bool_round_close(jo, to, valid)
    if unheld:
        assert not to.tau_hats[-unheld:].any()
        assert not to.m_hats[-unheld:].any()
        assert not to.similarity[-unheld:].any()
        assert not to.similarity[:, -unheld:].any()
    # the dense per-task tensors are the JAX package's
    for a, b in zip(tp.dense_tensors(), jp.dense_tensors()):
        assert np.array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("cross_task,uniform_cross", [(False, False),
                                                      (True, True)])
def test_bool_run_packed_ablations_match_jax(cross_task, uniform_cross):
    t_, d = 6, 500
    tv, valid, tasks, sizes, cids, tids = make_round(9, 7, 4, t_, d)
    jp = jax_bool_round(tv, valid, tasks, sizes, cids, tids, t_, d)
    kw = dict(n_tasks=t_, cross_task=cross_task, uniform_cross=uniform_cross)
    jo = jeng.RoundEngine(jeng.EngineConfig(**kw)).run_packed(jp, mode="ref")
    to = teng.RoundEngine(teng.EngineConfig(**kw),
                          device="cpu").run_packed(port_round_from(jp, d))
    assert_bool_round_close(jo, to, valid)


def test_bool_batched_client_unify_matches_jax():
    tv, valid, *_ = make_round(4, 5, 4, 6, 1000)
    ju, jm, jl = jeng.batched_client_unify(jnp.asarray(tv),
                                           jnp.asarray(valid), mode="ref",
                                           packed=False)
    tu, tm, tl = teng.batched_client_unify(t(tv), t(valid), packed=False,
                                           device="cpu")
    assert tu.dtype == torch.float32 and tm.dtype == torch.bool
    assert np.array_equal(tu.numpy(), np.asarray(ju))
    assert np.array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=RTOL)
    # λ and mask bits are bitwise the packed layout's
    pu, pw, pl = teng.batched_client_unify(t(tv), t(valid), device="cpu")
    assert torch.equal(tl, pl) and torch.equal(bitpack.pack_bits(tm), pw)


def ragged_uploads(seed, n, t_, d, k_max=3, packed_every=0):
    """Per-client uploads with bf16-valued unified vectors, for both
    packages; every ``packed_every``-th port upload carries packed words
    (JAX's the same words as uint32)."""
    rng = np.random.default_rng(seed)
    jups, tups = [], []
    for cid in range(n):
        k = int(rng.integers(1, k_max + 1))
        ts = sorted(rng.choice(t_ - 1, size=k, replace=False).tolist())
        x = rng.standard_normal((k, d)).astype(np.float32)
        uni, masks, lams = j_unify_with_modulators(jnp.asarray(x))
        uni = np.asarray(uni.astype(jnp.bfloat16).astype(jnp.float32))
        masks = np.array(masks)
        sizes = rng.integers(10, 200, size=k).tolist()
        if packed_every and cid % packed_every == 0:
            jm = bitpack.pack_bits_np(masks)
            tm = bitpack.words_from_numpy(jm)
        else:
            jm, tm = masks, torch.from_numpy(masks)
        jups.append(JUpload(cid, ts, jnp.asarray(uni), jnp.asarray(jm),
                            lams, sizes))
        tups.append(TUpload(cid, ts, torch.from_numpy(uni.copy()), tm,
                            torch.from_numpy(np.array(lams)), sizes))
    return jups, tups


def test_bool_round_on_ragged_uploads_matches_jax():
    """RoundEngine.round(packed=False) on ragged uploads, some of them in
    packed words (unpacked at the boundary), against JAX's."""
    t_, d = 5, 300
    jups, tups = ragged_uploads(11, 6, t_, d, packed_every=2)
    jd, jo = jeng.RoundEngine(jeng.EngineConfig(n_tasks=t_)).round(
        jups, mode="ref", packed=False)
    eng = teng.RoundEngine(teng.EngineConfig(n_tasks=t_), device="cpu")
    td, to = eng.round(tups, packed=False)
    valid = np.asarray(jeng.pack_uploads(jups, t_, packed=False).slot_valid)
    assert_bool_round_close(jo, to, valid)
    for cid, jdl in jd.items():
        tdl = td[cid]
        assert not tdl.packed and tdl.masks.shape == jdl.masks.shape
        assert tdl.downlink_bits() == jdl.downlink_bits()
    batch = teng.pack_uploads(tups, t_, packed=False, device="cpu")
    jbatch = jeng.pack_uploads(jups, t_, packed=False)
    assert batch.slot_masks.dtype == torch.bool
    assert np.array_equal(batch.slot_masks.numpy(),
                          np.asarray(jbatch.slot_masks)[:len(tups)])
    assert np.array_equal(batch.unified.numpy(),
                          np.asarray(jbatch.unified)[:len(tups)])


def test_bool_wire_bits_are_the_paper_accounting():
    t_, d = 5, 300
    jups, tups = ragged_uploads(3, 5, t_, d)
    batch = teng.pack_uploads(tups, t_, packed=False, device="cpu")
    want = sum(paper_link_bits(d, len(u.task_ids)) for u in tups)
    assert batch.wire_bits() == want == sum(32 * d + len(u.task_ids)
                                            * (d + 32) for u in tups)
    assert want == jeng.pack_uploads(jups, t_, packed=False).wire_bits()
    assert teng.pack_uploads(tups, t_, device="cpu").wire_bits() < want


@pytest.mark.parametrize("seed,n,t_,d", [(0, 5, 4, 300), (1, 8, 6, 1000),
                                         (2, 3, 5, 97)])
def test_packed_round_bit_identical_to_bool_round(seed, n, t_, d):
    """The port's twin of the JAX package's wire parity guarantee: on
    bf16-valued uploads the packed round's masks, m̂, S, τ̂, task vectors
    and λ equal the bool round's bit for bit, and its bf16 downlink is
    the rounding of the bool round's fp32 one."""
    _, tups = ragged_uploads(seed, n, t_, d)
    eng = teng.RoundEngine(teng.EngineConfig(n_tasks=t_), device="cpu")
    downs_p, out_p = eng.round(tups)
    downs_b, out_b = eng.round(tups, packed=False)
    for name in ("task_vectors", "tau_hats", "similarity", "m_hats",
                 "down_lams"):
        assert torch.equal(getattr(out_b, name), getattr(out_p, name)), name
    assert torch.equal(bitpack.pack_bits(out_b.down_masks), out_p.down_masks)
    assert torch.equal(out_b.down_unified.to(torch.bfloat16).view(torch.int16),
                       out_p.down_unified.view(torch.int16))
    for cid in downs_p:
        assert torch.equal(downs_b[cid].masks, downs_p[cid].masks_dense())


def test_server_takes_a_bool_round_unchanged():
    t_, d = 5, 300
    tv, valid, tasks, sizes, cids, tids = make_round(5, 6, 4, t_, d)
    uni, masks, lams = teng.batched_client_unify(t(tv), t(valid),
                                                 packed=False, device="cpu")
    p = teng.pack_from_slots(cids, tids, uni, masks, lams, t(tasks),
                             t(valid), t(sizes), t_, d=d)
    server = MaTUServer(MaTUServerConfig(n_tasks=t_), device="cpu")
    downs = server.round_packed(p)
    out = teng.RoundEngine(teng.EngineConfig(n_tasks=t_),
                           device="cpu").run_packed(p)
    assert torch.equal(server.last_task_vectors, out.task_vectors)
    for i, cid in enumerate(cids):
        k = len(tids[i])
        assert downs[cid].masks.dtype == torch.bool
        assert torch.equal(downs[cid].masks, out.down_masks[i, :k])


# -- core/aggregation.py: the dense reference --------------------------------

@pytest.mark.parametrize("cross_task,uniform_cross", [(True, False),
                                                      (False, False),
                                                      (True, True)])
def test_aggregation_matu_round_matches_jax(cross_task, uniform_cross):
    t_, d = 6, 300
    u, masks, lams, gam, mem = dense_round(7, 8, t_, d)
    sizes = (gam * 1000).astype(np.float32)
    kw = dict(cross_task=cross_task, uniform_cross=uniform_cross)
    got = tagg.matu_round(t(u), t(masks), t(lams), t(mem), t(sizes), **kw)
    want = jagg.matu_round(*map(jnp.asarray, (u, masks, lams, mem, sizes)),
                           **kw)
    np.testing.assert_array_equal(got.m_hats.numpy(), np.asarray(want.m_hats))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                   atol=ATOL)
    words = bitpack.pack_bits(t(masks))
    got_p = tagg.matu_round_packed(t(u).to(torch.bfloat16), words, t(lams),
                                   t(mem), t(sizes), d, **kw)
    want_p = jagg.matu_round_packed(
        jnp.asarray(u).astype(jnp.bfloat16),
        jnp.asarray(bitpack.words_to_numpy(words)), *map(
            jnp.asarray, (lams, mem, sizes)), d, **kw)
    for a, b in zip(got_p, want_p):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                   atol=ATOL)


def test_engine_bool_round_matches_aggregation_reference():
    """The engine's bool round against the port's own dense oracle."""
    t_, d = 5, 300
    _, tups = ragged_uploads(8, 6, t_, d)
    eng = teng.RoundEngine(teng.EngineConfig(n_tasks=t_), device="cpu")
    batch = teng.pack_uploads(tups, t_, packed=False, device="cpu")
    out = eng.run_packed(batch)
    masks_d, lams_d, member_d, sizes_d = batch.dense_tensors()
    ref = tagg.matu_round(batch.unified, masks_d, lams_d, member_d, sizes_d)
    assert torch.equal(out.m_hats, ref.m_hats)
    assert torch.equal(out.similarity, ref.similarity)
    for a, b in ((out.tau_hats, ref.tau_hats),
                 (out.task_vectors, ref.task_vectors)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=RTOL,
                                   atol=ATOL)


def test_pack_unpack_masks_match_jax():
    rng = np.random.default_rng(2)
    m = rng.random((3, 4, 97)) < 0.5
    words = ops.pack_masks(t(m))
    assert bitpack.words_to_numpy(words).tobytes() == np.asarray(
        jops.pack_masks(jnp.asarray(m))).tobytes()
    assert np.array_equal(ops.unpack_masks(words, 97).numpy(), m)
