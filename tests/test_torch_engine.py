"""The port's round engine against the JAX package's, on the CPU: the
same wire-format uploads (numpy from a seed) go through
``repro.core.engine.RoundEngine.run_packed`` in "ref" and
"pallas_interpret" mode and through the port's ``RoundEngine``.

Parity bar: alpha_num, n_held bitwise; τ̂, task vectors, similarity and
λ to rtol 1e-5; downlink mask bits ≥ 99.999 % equal and bf16 within one
ulp (task vectors come out of fp32 sums, so a value at rounding distance
from zero may flip a bit) — and bitwise when the JAX round's own task
vectors are fed to the port's downlink unify.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import engine as jeng  # noqa: E402
from repro.core.unify import modulate as j_modulate  # noqa: E402
from repro.core.unify import unify_masked as j_unify_masked  # noqa: E402
from repro.core.unify import (  # noqa: E402
    unify_with_modulators as j_unify_with_modulators)
from repro.core.client import ClientUpload as JUpload  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.core import unify as tunify  # noqa: E402
from repro_torch.core.client import ClientUpload as TUpload  # noqa: E402
from repro_torch.core.server import MaTUServer, MaTUServerConfig  # noqa: E402
from repro_torch.kernels import bitpack, ops  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

RTOL, ATOL = 1e-5, 1e-6


def make_round(seed, n, k, t, d, unheld=1):
    """Ragged slot stacks: client i holds 1..k distinct tasks among the
    first t - unheld (the last ``unheld`` tasks nobody holds)."""
    rng = np.random.default_rng(seed)
    tv = rng.standard_normal((n, k, d)).astype(np.float32)
    ks = rng.integers(1, k + 1, n)
    valid = np.arange(k)[None, :] < ks[:, None]
    tv *= valid[:, :, None]
    tasks = np.full((n, k), t, np.int32)
    for i in range(n):
        tasks[i, :ks[i]] = np.sort(rng.choice(t - unheld, ks[i],
                                              replace=False))
    sizes = np.where(valid, rng.integers(10, 200, (n, k)), 0).astype(
        np.float32)
    cids = list(range(n))
    tids = [tasks[i, :ks[i]].tolist() for i in range(n)]
    return tv, valid, tasks, sizes, cids, tids


def jax_packed(tv, valid, tasks, sizes, cids, tids, t, d):
    uni, words, lams = jeng.batched_client_unify(
        jnp.asarray(tv), jnp.asarray(valid), mode="ref")
    return jeng.pack_from_slots(cids, tids, uni, words, lams,
                                jnp.asarray(tasks), jnp.asarray(valid),
                                jnp.asarray(sizes), t, d=d)


def port_packed_from(jp, d):
    """The JAX round's wire tensors, carried into the port as numpy."""
    f = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    return teng.pack_from_slots(
        jp.client_ids, jp.task_ids,
        f(np.asarray(jp.unified, np.float32)).to(torch.bfloat16),
        bitpack.words_from_numpy(np.asarray(jp.slot_masks)),
        f(jp.slot_lams), f(jp.slot_tasks), f(jp.slot_valid),
        f(jp.slot_sizes), jp.n_tasks, d=d)


def assert_round_close(jo, to, d, valid):
    np.testing.assert_array_equal(to.alpha_num.numpy(),
                                  np.asarray(jo.alpha_num))
    np.testing.assert_array_equal(to.n_held.numpy(), np.asarray(jo.n_held))
    np.testing.assert_array_equal(to.m_hats.numpy(), np.asarray(jo.m_hats))
    np.testing.assert_allclose(to.tau_hats.numpy(), np.asarray(jo.tau_hats),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(to.task_vectors.numpy(),
                               np.asarray(jo.task_vectors), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(to.similarity.numpy(),
                               np.asarray(jo.similarity), rtol=RTOL,
                               atol=ATOL)
    tb = bitpack.unpack_bits_np(bitpack.words_to_numpy(to.down_masks), d)
    jb = bitpack.unpack_bits_np(np.asarray(jo.down_masks), d)
    assert (tb == jb)[valid].mean() >= 0.99999
    ulp = np.abs(to.down_unified.view(torch.int16).numpy().astype(np.int32)
                 - np.asarray(jo.down_unified).view(np.int16).astype(np.int32))
    assert ulp.max() <= 1
    np.testing.assert_allclose(to.down_lams.numpy(),
                               np.asarray(jo.down_lams), rtol=RTOL,
                               atol=ATOL)


ROUNDS = [
    # seed, n, k, t, d, unheld
    (0, 6, 4, 7, 1000, 1),        # ragged d (1000 % 32 = 8), one unheld task
    (1, 4, 2, 5, 256, 2),         # whole words, two unheld tasks
    (2, 9, 4, 4, 4100, 0),        # more clients than tasks, every task held
    (3, 1, 2, 3, 33, 1),          # single client, one-bit tail word
]


@pytest.mark.parametrize("mode", ["ref", "pallas_interpret"])
@pytest.mark.parametrize("seed,n,k,t,d,unheld", ROUNDS)
def test_run_packed_matches_jax(mode, seed, n, k, t, d, unheld):
    tv, valid, tasks, sizes, cids, tids = make_round(seed, n, k, t, d, unheld)
    jp = jax_packed(tv, valid, tasks, sizes, cids, tids, t, d)
    jo = jeng.RoundEngine(jeng.EngineConfig(n_tasks=t)).run_packed(jp,
                                                                   mode=mode)
    to = teng.RoundEngine(teng.EngineConfig(n_tasks=t),
                          device="cpu").run_packed(port_packed_from(jp, d))
    assert_round_close(jo, to, d, valid)
    if unheld:
        assert not to.tau_hats[-unheld:].any()
        assert not to.similarity[-unheld:].any()
        assert not to.similarity[:, -unheld:].any()


@pytest.mark.parametrize("cross_task,uniform_cross", [(False, False),
                                                      (True, True)])
def test_run_packed_ablations_match_jax(cross_task, uniform_cross):
    t, d = 6, 500
    tv, valid, tasks, sizes, cids, tids = make_round(9, 7, 4, t, d)
    jp = jax_packed(tv, valid, tasks, sizes, cids, tids, t, d)
    kw = dict(n_tasks=t, cross_task=cross_task, uniform_cross=uniform_cross)
    jo = jeng.RoundEngine(jeng.EngineConfig(**kw)).run_packed(jp, mode="ref")
    to = teng.RoundEngine(teng.EngineConfig(**kw),
                          device="cpu").run_packed(port_packed_from(jp, d))
    assert_round_close(jo, to, d, valid)


@pytest.mark.parametrize("seed,n,k,t,d,unheld", ROUNDS[:3])
def test_downlink_unify_bitwise_on_jax_task_vectors(seed, n, k, t, d, unheld):
    """JAX's own round task vectors through the port's downlink unify give
    JAX's downlink words and bf16 vectors bit for bit."""
    tv, valid, tasks, sizes, cids, tids = make_round(seed, n, k, t, d, unheld)
    jp = jax_packed(tv, valid, tasks, sizes, cids, tids, t, d)
    jo = jeng.RoundEngine(jeng.EngineConfig(n_tasks=t)).run_packed(
        jp, mode="pallas_interpret")
    tvs = torch.from_numpy(np.array(jo.task_vectors))
    slots = tvs[torch.clamp(torch.from_numpy(tasks).long(), max=t - 1)]
    uni, words, lams = ops.fused_unify_packed(slots, torch.from_numpy(valid))
    assert bitpack.words_to_numpy(words).tobytes() == \
        np.asarray(jo.down_masks).tobytes()
    assert np.array_equal(uni.view(torch.int16).numpy(),
                          np.asarray(jo.down_unified).view(np.int16))
    np.testing.assert_allclose(lams.numpy(), np.asarray(jo.down_lams),
                               rtol=RTOL, atol=ATOL)


def test_batched_client_unify_matches_jax():
    tv, valid, *_ = make_round(4, 5, 4, 6, 1000)
    ju, jw, jl = jeng.batched_client_unify(jnp.asarray(tv),
                                           jnp.asarray(valid), mode="ref")
    tu, tw, tl = teng.batched_client_unify(torch.from_numpy(tv),
                                           torch.from_numpy(valid),
                                           device="cpu")
    assert bitpack.words_to_numpy(tw).tobytes() == np.asarray(jw).tobytes()
    assert np.array_equal(tu.view(torch.int16).numpy(),
                          np.asarray(ju).view(np.int16))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=RTOL)


def test_round_on_ragged_uploads_matches_jax():
    """RoundEngine.round on per-client uploads with dense bool masks
    (packed and rounded at the wire) against JAX's, through the server."""
    rng = np.random.default_rng(11)
    t, d = 5, 300
    jups, tups = [], []
    for cid in range(6):
        k = int(rng.integers(1, 4))
        ts = sorted(rng.choice(t - 1, size=k, replace=False).tolist())
        x = rng.standard_normal((k, d)).astype(np.float32)
        uni, masks, lams = j_unify_with_modulators(jnp.asarray(x))
        uni = np.asarray(uni.astype(jnp.bfloat16).astype(jnp.float32))
        sizes = rng.integers(10, 200, size=k).tolist()
        jups.append(JUpload(cid, ts, jnp.asarray(uni), masks, lams, sizes))
        tups.append(TUpload(cid, ts, torch.from_numpy(uni),
                            torch.from_numpy(np.asarray(masks)),
                            torch.from_numpy(np.asarray(lams)), sizes))
    jd, jo = jeng.RoundEngine(jeng.EngineConfig(n_tasks=t)).round(jups,
                                                                  mode="ref")
    server = MaTUServer(MaTUServerConfig(n_tasks=t), device="cpu")
    td = server.round(tups)
    np.testing.assert_allclose(server.last_task_vectors.numpy(),
                               np.asarray(jo.task_vectors), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(server.last_similarity.numpy(),
                               np.asarray(jo.similarity), rtol=RTOL,
                               atol=ATOL)
    for cid, jdl in jd.items():
        tdl = td[cid]
        assert tdl.packed and tdl.masks.shape == jdl.masks.shape
        assert tdl.downlink_bits() == jdl.downlink_bits()
        assert (tdl.masks_dense().numpy() == np.asarray(jdl.masks_dense())
                ).mean() >= 0.99999
    batch = teng.pack_uploads(tups, t, device="cpu")
    jbatch = jeng.pack_uploads(jups, t)
    assert batch.wire_bits() == jbatch.wire_bits()
    assert bitpack.words_to_numpy(batch.slot_masks).tobytes() == \
        np.asarray(jbatch.slot_masks)[:len(tups)].tobytes()


def test_unify_module_matches_jax():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((4, 300)).astype(np.float32)
    ju, jm, jl = j_unify_with_modulators(jnp.asarray(x))
    tu, tm, tl = tunify.unify_with_modulators(torch.from_numpy(x))
    assert np.array_equal(tu.numpy(), np.asarray(ju))
    assert np.array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=RTOL)
    valid = np.array([True, False, True, True])
    assert np.array_equal(
        tunify.unify_masked(torch.from_numpy(x), torch.from_numpy(valid))
        .numpy(), np.asarray(j_unify_masked(jnp.asarray(x),
                                                 jnp.asarray(valid))))
    # modulate from packed words == modulate from dense masks == JAX
    words = bitpack.pack_bits(tm[1])
    lam = tl[1]
    got = tunify.modulate(tu.to(torch.bfloat16), words, lam)
    want = j_modulate(jnp.asarray(tu.numpy()).astype(jnp.bfloat16),
                           jnp.asarray(bitpack.words_to_numpy(words)),
                           jnp.asarray(lam.numpy()))
    assert np.array_equal(got.numpy(), np.asarray(want))
