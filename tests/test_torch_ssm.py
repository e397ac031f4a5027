"""The port's xLSTM math (``repro_torch.nn.ssm`` and the plain version of
the chunkwise-mLSTM kernel, ``repro_torch.kernels.ref``) against the JAX
package's (``repro.nn.ssm`` and ``mlstm_chunkwise_pallas`` in interpret
mode), on the CPU, on the same numpy inputs from seeds.

Tolerances:
* fp32: rtol 1e-4, atol 1e-5 (the bar of ``tests/test_kernels_mlstm.py``):
  the two packages sum the products, and the port sums the log-gate
  cumsum in fp64, in other orders;
* bf16 q / k / v: h to rtol = atol = 2^-5 (a few bf16 ulps at |h| <= 8):
  the port rounds the q·k scores, w and w @ v to bf16 where the JAX
  package's einsums do, but XLA on the CPU keeps excess precision through
  those roundings, and the Pallas kernel has none; the fp32 state (C, n,
  m) is held to the fp32 bar.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.mlstm_chunk import mlstm_chunkwise_pallas  # noqa: E402
from repro.nn import ssm as jssm  # noqa: E402
from repro_torch.kernels import mlstm_chunk, ref  # noqa: E402
from repro_torch.nn import ssm  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

RTOL, ATOL = 1e-4, 1e-5
BF16_TOL = 2.0 ** -5
DTYPES = {"fp32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


def mlstm_inputs(seed, b, h, s, dk, dv, state="zero"):
    """q, k (scaled by dk^-0.5), v, i, f (+2, a mostly open forget gate)
    and an initial state (zero, or random: C, n ~ 0.3 N(0, 1), m ~ N(0, 1))
    as fp32 numpy arrays."""
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((b, h, s, dk)) * dk ** -0.5).astype(np.float32)
    k = (rng.standard_normal((b, h, s, dk)) * dk ** -0.5).astype(np.float32)
    v = rng.standard_normal((b, h, s, dv)).astype(np.float32)
    i = rng.standard_normal((b, h, s)).astype(np.float32)
    f = (rng.standard_normal((b, h, s)) + 2.0).astype(np.float32)
    if state == "zero":
        st = (np.zeros((b, h, dk, dv), np.float32),
              np.zeros((b, h, dk), np.float32),
              np.full((b, h), -1e30, np.float32))
    else:
        st = ((0.3 * rng.standard_normal((b, h, dk, dv))).astype(np.float32),
              (0.3 * rng.standard_normal((b, h, dk))).astype(np.float32),
              rng.standard_normal((b, h)).astype(np.float32))
    return (q, k, v, i, f), st


def run_port(x, st, chunk, dtype=torch.float32):
    q, k, v, i, f = (torch.from_numpy(a) for a in x)
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    return mlstm_chunk.mlstm_chunkwise(
        q, k, v, i, f, tuple(torch.from_numpy(a) for a in st), chunk=chunk)


def run_jax(x, st, chunk, dtype=jnp.float32):
    q, k, v, i, f = (jnp.asarray(a) for a in x)
    q, k, v = q.astype(dtype), k.astype(dtype), v.astype(dtype)
    return jssm.mlstm_chunkwise(q, k, v, i, f,
                                tuple(jnp.asarray(a) for a in st),
                                chunk=chunk)


def assert_h_close(got, want, dtype_name):
    got = got.float().numpy()
    want = np.asarray(want.astype(jnp.float32))
    tol = (RTOL, ATOL) if dtype_name == "fp32" else (BF16_TOL, BF16_TOL)
    np.testing.assert_allclose(got, want, rtol=tol[0], atol=tol[1])


# ---------------------------------------------------------------------------
# the chunkwise mLSTM: plain version of kernel 10
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("state", ["zero", "random"])
@pytest.mark.parametrize("s,chunk", [(16, 4), (19, 4), (48, 16), (40, 16),
                                     (128, 64), (100, 64)])
def test_chunkwise_matches_jax(s, chunk, state, dtype):
    """h and the final (C, n, m), S a chunk multiple and ragged, against
    ``nn/ssm.py::mlstm_chunkwise``."""
    x, st = mlstm_inputs(s * 31 + chunk, 2, 3, s, 8, 12, state)
    th, (tC, tn, tm) = run_port(x, st, chunk, DTYPES[dtype][0])
    jh, (jC, jn, jm) = run_jax(x, st, chunk, DTYPES[dtype][1])
    assert th.dtype == DTYPES[dtype][0] and th.shape == (2, 3, s, 12)
    assert_h_close(th, jh, dtype)
    for got, want in ((tC, jC), (tn, jn), (tm, jm)):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("s,chunk", [(8, 4), (37, 16), (64, 16), (70, 64)])
def test_chunkwise_matches_pallas_interpret(s, chunk, dtype):
    """Zero state, h only: the Pallas kernel's own form (BH-flattened)."""
    b, h, dk, dv = 2, 2, 8, 16
    x, st = mlstm_inputs(s + 7 * chunk, b, h, s, dk, dv)
    th, _ = run_port(x, st, chunk, DTYPES[dtype][0])
    flat = [jnp.asarray(a.reshape((b * h,) + a.shape[2:])) for a in x]
    flat[:3] = [a.astype(DTYPES[dtype][1]) for a in flat[:3]]
    want = mlstm_chunkwise_pallas(*flat, chunk=chunk, interpret=True)
    assert_h_close(th.reshape(b * h, s, dv), want, dtype)


@pytest.mark.parametrize("chunk", [1, 3, 8])
@pytest.mark.parametrize("state", ["zero", "random"])
def test_chunkwise_matches_recurrent_steps(chunk, state):
    """The chunkwise form against the port's own per-step recurrence
    (the decode step), h and final state."""
    b, h, s, dk, dv = 2, 2, 13, 4, 6
    x, st = mlstm_inputs(chunk, b, h, s, dk, dv, state)
    th, (tC, tn, tm) = run_port(x, st, chunk)
    q, k, v, i, f = (torch.from_numpy(a) for a in x)
    cur = tuple(torch.from_numpy(a) for a in st)
    outs = []
    for t in range(s):
        cur, ht = ssm.mlstm_recurrent_step(cur, q[:, :, t], k[:, :, t],
                                           v[:, :, t], i[:, :, t], f[:, :, t])
        outs.append(ht)
    np.testing.assert_allclose(th.numpy(), torch.stack(outs, 2).numpy(),
                               rtol=RTOL, atol=ATOL)
    for got, want in zip((tC, tn, tm), cur):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL,
                                   atol=ATOL)


def test_recurrent_step_matches_jax():
    x, st = mlstm_inputs(3, 2, 3, 1, 8, 12, "random")
    q, k, v, i, f = (a[:, :, 0] for a in x)
    (tC, tn, tm), th = ssm.mlstm_recurrent_step(
        tuple(torch.from_numpy(a) for a in st),
        *(torch.from_numpy(a) for a in (q, k, v, i, f)))
    (jC, jn, jm), jh = jssm.mlstm_recurrent_step(
        tuple(jnp.asarray(a) for a in st),
        *(jnp.asarray(a) for a in (q, k, v, i, f)))
    for got, want in ((th, jh), (tC, jC), (tn, jn), (tm, jm)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                                   atol=ATOL)


def test_extreme_gates_stay_finite_and_match_jax():
    """Log-space stabilisation: gate pre-activations of +-50 (beyond
    torch softplus's threshold of 20) stay finite and agree with JAX."""
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal((1, 1, 12, 4)).astype(np.float32)
               for _ in range(3))
    i = np.asarray([[[-50, 50, 0, 30, -30, 10, 50, -50, 0, 5, -5, 20.0]]],
                   np.float32)
    f = np.asarray([[[50, -50, 0, 30, -30, 50, -50, 10, 0, -5, 5, -20.0]]],
                   np.float32)
    _, st = mlstm_inputs(0, 1, 1, 12, 4, 4)
    th, (tC, tn, tm) = run_port((q, k, v, i, f), st, 4)
    jh, (jC, jn, jm) = run_jax((q, k, v, i, f), st, 4)
    for got, want in ((th, jh), (tC, jC), (tn, jn), (tm, jm)):
        assert torch.isfinite(got).all()
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                                   atol=ATOL)


def test_logsigmoid_matches_jax_beyond_softplus_threshold():
    x = np.asarray([-80, -40, -20.5, -1, 0, 1, 20.5, 40, 80], np.float32)
    got = ref.logsigmoid(torch.from_numpy(x)).numpy()
    want = np.asarray(-jax.nn.softplus(-jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_wrapper_takes_the_plain_version_on_the_cpu():
    """On CPU tensors the dispatching wrapper is the plain version, bit
    for bit, with or without ``mode="ref"``; an unknown mode raises."""
    x, st = mlstm_inputs(5, 1, 2, 21, 8, 8, "random")
    args = [torch.from_numpy(a) for a in x]
    state = tuple(torch.from_numpy(a) for a in st)
    want = ref.mlstm_chunkwise_ref(*args, state, chunk=8)
    for mode in (None, "ref"):
        got = mlstm_chunk.mlstm_chunkwise(*args, state, chunk=8, mode=mode)
        assert torch.equal(got[0], want[0])
        for a, b in zip(got[1], want[1]):
            assert torch.equal(a, b)
    with pytest.raises(ValueError, match="dispatch mode"):
        mlstm_chunk.mlstm_chunkwise(*args, state, chunk=8, mode="fast")


def test_wrapper_writes_c_out_in_place_on_the_cpu():
    """A given ``C_out`` receives the final C and is returned as C, also
    when it is the state's own C (the model path's in-place cache)."""
    x, st = mlstm_inputs(6, 1, 2, 21, 8, 8, "random")
    args = [torch.from_numpy(a) for a in x]
    state = tuple(torch.from_numpy(a) for a in st)
    want = ref.mlstm_chunkwise_ref(*args, state, chunk=8)
    C = state[0].clone()
    got = mlstm_chunk.mlstm_chunkwise(*args, (C, state[1], state[2]),
                                      chunk=8, C_out=C)
    assert got[1][0] is C
    assert torch.equal(got[0], want[0])
    for a, b in zip(got[1], want[1]):
        assert torch.equal(a, b)


def test_kernel_path_refuses_cpu_tensors():
    """``mlstm_chunkwise_cuda`` takes CUDA tensors only: no fallback."""
    x, st = mlstm_inputs(5, 1, 1, 4, 4, 4)
    with pytest.raises(ValueError, match="CUDA tensor"):
        mlstm_chunk.mlstm_chunkwise_cuda(
            *(torch.from_numpy(a) for a in x),
            tuple(torch.from_numpy(a) for a in st), chunk=4)


def test_smem_bytes_at_full_width_fit_one_block():
    """xlstm-1.3b's prefill (Dk 256, chunk 256) fits one block's shared
    memory in fp32, and two blocks a SM in bf16 (the main kernel's stage
    buffers hold bf16); a chunk of 8192 in fp32 does not fit, and the
    kernel path refuses it before any launch."""
    assert mlstm_chunk.smem_bytes(256, 256, 4) <= mlstm_chunk.SMEM_LIMIT
    assert mlstm_chunk.smem_bytes(256, 256, 2) <= mlstm_chunk.SMEM_TWO_BLOCKS
    assert mlstm_chunk.smem_bytes(256, 256, 2) == 4 * (
        256 * 64 + 3 * 256 + 2 * 32 * (256 + 64) // 2)
    assert mlstm_chunk.smem_bytes(8192, 256, 4) > mlstm_chunk.SMEM_LIMIT


# ---------------------------------------------------------------------------
# causal conv and the two blocks
# ---------------------------------------------------------------------------

def test_causal_conv_state_carrying_matches_jax():
    """Splitting a sequence across two calls equals one call, and both
    equal the JAX package's."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 10, 5)).astype(np.float32)
    w = (0.3 * rng.standard_normal((4, 5))).astype(np.float32)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    y_full, st_full = ssm.causal_conv1d(tx, tw)
    y1, st = ssm.causal_conv1d(tx[:, :6], tw)
    y2, st2 = ssm.causal_conv1d(tx[:, 6:], tw, state=st)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(),
                               y_full.numpy(), rtol=1e-5, atol=1e-6)
    assert torch.equal(st2, st_full)
    jy, jst = jssm.causal_conv1d(jnp.asarray(x), jnp.asarray(w))
    np.testing.assert_allclose(y_full.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(st_full.numpy(), np.asarray(jst))


def to_torch(tree):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)),
                                  tree)


def block_pair(kind):
    """A JAX block, its parameters with LoRA (b ~ 0.05 N(0, 1)), and the
    port's twin holding the same numbers."""
    if kind == "mlstm":
        jb, tb = (jssm.MLSTMBlock(32, 2, chunk=4),
                  ssm.MLSTMBlock(32, 2, chunk=4))
    else:
        jb, tb = jssm.SLSTMBlock(32, 2), ssm.SLSTMBlock(32, 2)
    jp = jb.init(jax.random.PRNGKey(0))
    jl = jb.lora_init(jax.random.PRNGKey(1), 4)
    rng = np.random.default_rng(2)
    jl = jax.tree_util.tree_map_with_path(
        lambda p, x: (x + jnp.asarray(0.05 * rng.standard_normal(x.shape),
                                      x.dtype)
                      if str(p[-1].key) == "b" else x), jl)
    shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape),
                                    tb.init(None, "meta"))
    assert shapes == jax.tree_util.tree_map(lambda a: tuple(a.shape), jp)
    return jb, jp, jl, tb, to_torch(jp), to_torch(jl)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_block_forward_matches_jax(kind):
    jb, jp, jl, tb, tp, tl = block_pair(kind)
    x = (0.5 * np.random.default_rng(3).standard_normal((2, 11, 32))
         ).astype(np.float32)
    for lora in (False, True):
        jy, _ = jb.forward(jp, jnp.asarray(x), lora=jl if lora else None)
        ty = tb(tp, torch.from_numpy(x), lora=tl if lora else None)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_block_prefill_then_decode_matches_jax(kind):
    """Prefill (a ragged 10 steps over chunks of 4 for the mLSTM) fills
    the port's cache in place with exactly the state JAX returns; two
    decode steps from it agree with JAX and with the full forward."""
    jb, jp, jl, tb, tp, tl = block_pair(kind)
    x = (0.5 * np.random.default_rng(4).standard_normal((2, 12, 32))
         ).astype(np.float32)
    jst = jb.init_cache(2)
    jy, jst = jb.forward(jp, jnp.asarray(x[:, :10]), lora=jl, state=jst)
    cache = tb.init_cache(2)
    ty, same = tb.forward(tp, torch.from_numpy(x[:, :10]), lora=tl,
                          state=cache)
    assert same is cache
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=RTOL,
                               atol=ATOL)
    assert cache.keys() == jst.keys()
    for key in cache:
        np.testing.assert_allclose(cache[key].numpy(), np.asarray(jst[key]),
                                   rtol=RTOL, atol=ATOL, err_msg=key)
    full = tb(tp, torch.from_numpy(x), lora=tl)
    for t in (10, 11):
        jy, jst = jb.decode_step(jp, jnp.asarray(x[:, t:t + 1]), jst,
                                 lora=jl)
        ty, _ = tb.decode_step(tp, torch.from_numpy(x[:, t:t + 1]), cache,
                               lora=tl)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(ty[:, 0].numpy(), full[:, t].numpy(),
                                   rtol=RTOL, atol=ATOL)
    for key in cache:
        np.testing.assert_allclose(cache[key].numpy(), np.asarray(jst[key]),
                                   rtol=RTOL, atol=ATOL, err_msg=key)
