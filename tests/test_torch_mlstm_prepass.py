"""Kernel 10's split into a pre-pass and a main pass, in its plain form
(``repro_torch.kernels.ref.mlstm_chunk_prepass_ref`` and
``mlstm_chunk_main_ref``), on the CPU: composed, they must give what the
whole chunkwise mLSTM gives -- the port's plain version, the JAX
package's ``nn/ssm.py::mlstm_chunkwise`` (zero and random state) and
``mlstm_chunkwise_pallas`` in interpret mode (zero state) -- on the same
numpy inputs, with S ragged over three chunks or more.

Tolerances are those of ``tests/test_torch_ssm.py``: fp32 h and state
rtol 1e-4, atol 1e-5; bf16 h rtol = atol = 2^-5 against JAX (XLA keeps
excess precision through the bf16 rounding points), the state at the
fp32 bar.  Against the port's own plain version, which runs the same
ops, the composition is held to the fp32 bar in both dtypes.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels.mlstm_chunk import mlstm_chunkwise_pallas  # noqa: E402
from repro.nn import ssm as jssm  # noqa: E402
from repro_torch.kernels import mlstm_chunk, ref  # noqa: E402

RTOL, ATOL = 1e-4, 1e-5
BF16_TOL = 2.0 ** -5
DTYPES = {"fp32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}
# (S, chunk): S ragged, three chunks or more
SHAPES = [(13, 4), (40, 16), (70, 16), (100, 32)]


def inputs(seed, b, h, s, dk, dv, state):
    """q, k (scaled by dk^-0.5), v, i, f (+2) and a zero or random
    (C, n ~ 0.3 N(0, 1), m ~ N(0, 1)) initial state, fp32 numpy."""
    rng = np.random.default_rng(seed)
    x = ((rng.standard_normal((b, h, s, dk)) * dk ** -0.5),
         (rng.standard_normal((b, h, s, dk)) * dk ** -0.5),
         rng.standard_normal((b, h, s, dv)),
         rng.standard_normal((b, h, s)),
         rng.standard_normal((b, h, s)) + 2.0)
    if state == "zero":
        st = (np.zeros((b, h, dk, dv)), np.zeros((b, h, dk)),
              np.full((b, h), -1e30))
    else:
        st = (0.3 * rng.standard_normal((b, h, dk, dv)),
              0.3 * rng.standard_normal((b, h, dk)),
              rng.standard_normal((b, h)))
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return tuple(map(f32, x)), tuple(map(f32, st))


def torch_args(x, st, dtype):
    q, k, v, i, f = (torch.from_numpy(a) for a in x)
    return ((q.to(dtype), k.to(dtype), v.to(dtype), i, f),
            tuple(torch.from_numpy(a) for a in st))


def composed(args, st, chunk):
    """The plain pre-pass, then the plain main pass: (h, (C, n, m))."""
    q, k, v, i, f = args
    pre = ref.mlstm_chunk_prepass_ref(q, k, i, f, st[1], st[2], chunk=chunk)
    h, C = ref.mlstm_chunk_main_ref(q, k, v, st[0], pre, chunk=chunk)
    return h, (C, pre["n_final"], pre["m_final"]), pre


def close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol[0], atol=tol[1])


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("state", ["zero", "random"])
@pytest.mark.parametrize("s,chunk", SHAPES)
def test_composed_matches_plain_chunkwise(s, chunk, state, dtype):
    """Pre-pass + main pass = the port's plain chunkwise mLSTM."""
    x, st = inputs(s * 7 + chunk, 2, 2, s, 8, 12, state)
    args, tst = torch_args(x, st, DTYPES[dtype][0])
    h, (C, n, m), _ = composed(args, tst, chunk)
    wh, (wC, wn, wm) = ref.mlstm_chunkwise_ref(*args, tst, chunk=chunk)
    assert h.dtype == wh.dtype and h.shape == wh.shape
    close(h.float(), wh.float(), (RTOL, ATOL))
    for got, want in ((C, wC), (n, wn), (m, wm)):
        close(got, want, (RTOL, ATOL))


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("state", ["zero", "random"])
@pytest.mark.parametrize("s,chunk", SHAPES)
def test_composed_matches_jax(s, chunk, state, dtype):
    """Pre-pass + main pass against ``nn/ssm.py::mlstm_chunkwise``."""
    x, st = inputs(s * 11 + chunk, 2, 3, s, 8, 12, state)
    args, tst = torch_args(x, st, DTYPES[dtype][0])
    h, (C, n, m), _ = composed(args, tst, chunk)
    jd = DTYPES[dtype][1]
    jx = [jnp.asarray(a) for a in x]
    jx[:3] = [a.astype(jd) for a in jx[:3]]
    jh, (jC, jn, jm) = jssm.mlstm_chunkwise(
        *jx, tuple(jnp.asarray(a) for a in st), chunk=chunk)
    tol = (RTOL, ATOL) if dtype == "fp32" else (BF16_TOL, BF16_TOL)
    close(h.float().numpy(), jh.astype(jnp.float32), tol)
    for got, want in ((C, jC), (n, jn), (m, jm)):
        close(got.numpy(), want, (RTOL, ATOL))


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("s,chunk", [(13, 4), (70, 16)])
def test_composed_matches_pallas_interpret(s, chunk, dtype):
    """Zero state, h only: the Pallas kernel's own form (BH-flattened)."""
    b, h, dk, dv = 2, 2, 8, 16
    x, st = inputs(s + 5 * chunk, b, h, s, dk, dv, "zero")
    args, tst = torch_args(x, st, DTYPES[dtype][0])
    th = composed(args, tst, chunk)[0]
    flat = [jnp.asarray(a.reshape((b * h,) + a.shape[2:])) for a in x]
    flat[:3] = [a.astype(DTYPES[dtype][1]) for a in flat[:3]]
    want = mlstm_chunkwise_pallas(*flat, chunk=chunk, interpret=True)
    tol = (RTOL, ATOL) if dtype == "fp32" else (BF16_TOL, BF16_TOL)
    close(th.reshape(b * h, s, dv).float().numpy(), want.astype(jnp.float32),
          tol)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("state", ["zero", "random"])
def test_prepass_outputs_hold_their_definitions(state, dtype):
    """Each pre-pass output against what it stands for: w causal and in
    T, qn_intra the row sum of the unrounded w (w itself in fp32), the
    divisor at least exp(-m_t), the chain's first n and m the initial
    state's, its final n and m the whole mLSTM's, and bcum the same
    fp64-summed cumsum in every chunk."""
    s, chunk = 70, 16
    x, st = inputs(3, 1, 2, s, 8, 12, state)
    args, tst = torch_args(x, st, DTYPES[dtype][0])
    pre = ref.mlstm_chunk_prepass_ref(args[0], args[1], args[3], args[4],
                                      tst[1], tst[2], chunk=chunk)
    nc = -(-s // chunk)
    assert pre["w"].shape == (1, 2, nc, chunk, chunk)
    assert pre["w"].dtype == DTYPES[dtype][0]
    upper = ~torch.ones((chunk, chunk), dtype=torch.bool).tril()
    assert (pre["w"][..., upper] == 0).all()
    if dtype == "fp32":
        close(pre["qn_intra"], pre["w"].sum(-1), (RTOL, ATOL))
    assert (pre["den"] >= torch.exp(-pre["m_t"])).all()
    assert torch.equal(pre["n"][:, :, 0], tst[1])
    assert torch.equal(pre["m"][:, :, 0], tst[2])
    _, (_, wn, wm) = ref.mlstm_chunkwise_ref(*args, tst, chunk=chunk)
    assert torch.equal(pre["n_final"], wn)
    assert torch.equal(pre["m_final"], wm)
    f = torch.from_numpy(x[4])
    pad = nc * chunk - s
    fp = torch.nn.functional.pad(f, (0, pad), value=40.0)
    want = torch.cumsum(ref.logsigmoid(fp.reshape(1, 2, nc, chunk)).double(),
                        -1).float()
    assert torch.equal(pre["bcum"], want)


@pytest.mark.parametrize("s,chunk,dk,elt", [(512, 256, 256, 2),
                                            (500, 256, 256, 4),
                                            (70, 16, 8, 2)])
def test_workspace_shapes_and_bytes(s, chunk, dk, elt):
    """Two workspaces a call: fp32 rows a (b·h, chunk) and w rows padded
    to whole 32-key sub-tiles; at xlstm-1.3b's prefill (B·H 32, S 512)
    the w workspace is 8.4 MB in bf16."""
    bh = 32
    fs, ws = mlstm_chunk.workspace_shapes(bh, s, chunk, dk)
    nc = -(-s // chunk)
    assert fs == (bh, nc, 7 * chunk + dk + 2)
    assert ws[:3] == (bh, nc, chunk) and ws[3] % 32 == 0
    assert chunk <= ws[3] < chunk + 32
    n = mlstm_chunk.workspace_bytes(bh, s, chunk, dk, elt)
    assert n == 4 * np.prod(fs) + elt * np.prod(ws)
    if (s, chunk, elt) == (512, 256, 2):
        assert 2 * bh * nc * chunk * chunk == 8_388_608 < n < 9_000_000


def test_prepass_path_refuses_cpu_tensors():
    """``mlstm_chunk_prepass_cuda`` takes CUDA tensors only."""
    x, st = inputs(5, 1, 1, 8, 8, 8, "zero")
    args, tst = torch_args(x, st, torch.float32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        mlstm_chunk.mlstm_chunk_prepass_cuda(args[0], args[1], args[3],
                                             args[4], tst[1], tst[2],
                                             chunk=4)
