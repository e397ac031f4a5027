"""The port's host pipeline, on the CPU: ``RoundEngine.round_stream``
pipelined ≡ sequential bit for bit (packed and bool layouts, raw and
coded wires), each streamed round ≡ ``RoundEngine.round``, a reused
``SlotStage`` ≡ fresh buffers, and the port's stream against the JAX
package's ``round_stream`` on the same uploads (the engine's bar,
``tests/test_torch_engine.py``)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import engine as jeng  # noqa: E402
from repro.core.client import ClientUpload as JUpload  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.core.client import ClientUpload as TUpload  # noqa: E402
from repro_torch.core.unify import unify_with_modulators  # noqa: E402
from repro_torch.fed.compression import encode_mask_rows  # noqa: E402
from repro_torch.kernels import bitpack  # noqa: E402
from test_torch_engine import assert_round_close  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

N_TASKS, D = 5, 512
PHASES = {"pack", "decode", "device"}


def make_rounds(seed, n_rounds, *, coded=False, packed=True, n_clients=4,
                k_hi=4):
    """``n_rounds`` of ragged uploads (other tasks and masks each round)
    in the requested wire layout, host tensors."""
    rng = np.random.default_rng(seed)
    rounds = []
    for _ in range(n_rounds):
        ups = []
        for cid in range(n_clients):
            k = int(rng.integers(1, k_hi))
            tasks = sorted(rng.choice(N_TASKS, size=k, replace=False).tolist())
            tvs = torch.from_numpy(rng.standard_normal((k, D)).astype(
                np.float32))
            unified, masks, lams = unify_with_modulators(tvs)
            if coded:
                m = torch.from_numpy(encode_mask_rows(
                    bitpack.words_to_numpy(bitpack.pack_bits(masks)), D))
            else:
                m = bitpack.pack_bits(masks) if packed else masks
            vec = unified.to(torch.bfloat16) if packed else unified
            ups.append(TUpload(cid, tasks, vec, m, lams,
                               rng.integers(32, 256, size=k).tolist()))
        rounds.append(ups)
    return rounds


def assert_stream_equal(a, b):
    assert len(a) == len(b)
    for (downs_a, out_a, _), (downs_b, out_b, _) in zip(a, b):
        for name in ("task_vectors", "tau_hats", "similarity",
                     "down_unified", "down_masks", "down_lams", "alpha_num",
                     "n_held", "m_hats_dense"):
            x, y = getattr(out_a, name), getattr(out_b, name)
            assert (x is None) == (y is None), name
            assert x is None or torch.equal(x, y), name
        assert downs_a.keys() == downs_b.keys()
        for cid in downs_a:
            for f in ("unified", "masks", "lams"):
                assert torch.equal(getattr(downs_a[cid], f),
                                   getattr(downs_b[cid], f)), (cid, f)


def engine():
    return teng.RoundEngine(teng.EngineConfig(n_tasks=N_TASKS), device="cpu")


@pytest.mark.parametrize("layout", ["packed", "bool"])
@pytest.mark.parametrize("coded", [False, True])
def test_round_stream_pipelined_equals_sequential(layout, coded):
    packed = layout == "packed"
    rounds = make_rounds(0, 4, coded=coded, packed=packed)
    eng = engine()
    seq = list(eng.round_stream(rounds, packed=packed, code_masks=coded,
                                pipeline=False))
    pipe = list(eng.round_stream(rounds, packed=packed, code_masks=coded))
    assert_stream_equal(seq, pipe)
    for _, _, phase in seq + pipe:
        assert PHASES <= set(phase)
        assert ("encode" in phase) == coded
    assert all(dl.coded == coded for d, _, _ in pipe for dl in d.values())


def test_round_stream_equals_round():
    rounds = make_rounds(1, 3, coded=True)
    eng = engine()
    for ups, (downs, out, _) in zip(rounds, eng.round_stream(rounds)):
        want_downs, want = eng.round(ups)
        assert_stream_equal([(downs, out, None)], [(want_downs, want, None)])


def test_slot_stage_reuse_is_clean():
    """A stage refilled with a round of fewer tasks a client (stale slot
    rows underneath), then with other shapes, packs exactly what fresh
    buffers pack; the buffers are reused while the shapes hold."""
    stage = teng.SlotStage()
    big = make_rounds(2, 1, k_hi=5)[0]
    small = make_rounds(3, 1, k_hi=2)[0]
    other = make_rounds(4, 1, packed=False, n_clients=3)[0]
    first = teng.pack_uploads(big, N_TASKS, k_max=4, device="cpu",
                              stage=stage)
    ptr = first.slot_masks.data_ptr()
    for ups, packed in ((small, True), (other, False), (big, True)):
        fresh = teng.pack_uploads(ups, N_TASKS, k_max=4, packed=packed,
                                  device="cpu")
        got = teng.pack_uploads(ups, N_TASKS, k_max=4, packed=packed,
                                device="cpu", stage=stage)
        for f in ("unified", "slot_masks", "slot_lams", "slot_sizes",
                  "slot_tasks", "slot_valid"):
            assert torch.equal(getattr(got, f), getattr(fresh, f)), f
        if ups is small:      # same shapes: the stage's own buffer again
            assert got.slot_masks.data_ptr() == ptr


def to_jax(ups):
    out = []
    for u in ups:
        m = u.masks
        m = (jnp.asarray(m.numpy()) if m.dtype == torch.uint8 else
             jnp.asarray(bitpack.words_to_numpy(m)))
        out.append(JUpload(u.client_id, list(u.task_ids),
                           jnp.asarray(u.unified.float().numpy()).astype(
                               jnp.bfloat16), m,
                           jnp.asarray(u.lams.numpy()), list(u.data_sizes)))
    return out


@pytest.mark.parametrize("coded", [False, True])
def test_round_stream_matches_jax(coded):
    rounds = make_rounds(5, 3, coded=coded)
    ours = list(engine().round_stream(rounds, code_masks=coded))
    theirs = list(jeng.RoundEngine(jeng.EngineConfig(n_tasks=N_TASKS))
                  .round_stream([to_jax(u) for u in rounds],
                                code_masks=coded))
    for ups, (_, out, phase), (_, jout, jphase) in zip(rounds, ours, theirs):
        valid = teng.pack_uploads(ups, N_TASKS, device="cpu").slot_valid
        assert_round_close(jout, out, D, valid.numpy())
        assert set(phase) == set(jphase)
