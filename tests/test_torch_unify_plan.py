"""Kernel 7's launch plan (``fused_unify.unify_plan``) and its walk, on
the CPU: the plan's load width divides every slot row's start, its tiles
cover [0, d) exactly once, and a torch emulation of the kernel over that
walk (vector by vector, ``elect`` in register order: the slot sum from
+0.0 in k order, then the max |x| over the aligned slots) equals the
plain version bit for bit and the JAX package's ``ops.unify`` in "ref"
and "pallas_interpret" modes at the bar of the existing unify tests
(``np.array_equal``).  Also the call path's device guard
(``build.on_device``), which enters nothing when the tensor's device is
current.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import build, fused_unify, ref  # noqa: E402

DS = [1, 3, 7, 8, 33, 4100, 65_540, 1_327_140]
KS = [1, 2, 3, 4, 5, 8, 16, 17, 40]
DTYPES = [torch.float32, torch.bfloat16]


def unify_stack(seed, k, d):
    """(K, d) fp32 slot rows (full fp32 precision), with special columns
    every 16: all +0.0, all -0.0, ±a alternating (ties in |x|; an
    exact-zero sum at even K), ties with a positive majority, +0.0 / -0.0
    mixed, and -0.0 in slot 0 only."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((k, d)).astype(np.float32)
    kind = np.arange(d) % 16
    a, slot = np.float32(0.75), np.arange(k)[:, None]
    x[:, kind == 0] = 0.0
    x[:, kind == 1] = -0.0
    x[:, kind == 2] = np.where(slot % 2 == 0, a, -a)
    x[:, kind == 3] = np.where(slot % 3 == 2, -a, a)
    x[:, kind == 4] = np.where(slot % 2 == 0, np.float32(-0.0),
                               np.float32(0.0))
    x[0, kind == 5] = -0.0
    return x


def walk(k, d, dtype, offset):
    """The coordinates of [0, d) in the kernel's order, (vectors, V): row
    i is the V coordinates thread i loads at once (block b takes the
    tile of ``UNIFY_BLOCK`` vectors b).  Checks the plan's shape on the
    way."""
    vec, blocks, per, route = fused_unify.unify_plan(k, d, dtype, offset)
    assert route == ("wide" if k > fused_unify.KMAX else "vec")
    assert per == fused_unify.UNIFY_BLOCK * vec
    assert blocks == -(-d // per)                 # one block a tile
    if route == "vec":
        assert (8 // dtype.itemsize) % vec == 0 and d % vec == 0
        for slot in range(k):                     # every row start
            assert (offset + slot * d) % vec == 0
    else:
        assert vec == 1
    threads = np.arange(blocks * fused_unify.UNIFY_BLOCK)
    vecs = threads[threads < d // vec]
    return vecs[:, None] * vec + np.arange(vec), vec


def emulate(x, k, d, offset):
    """The kernel's output from a torch emulation of its walk: each
    vector's K rows of V values, elected per coordinate in register
    order.  Unwritten coordinates stay NaN."""
    cols, _ = walk(k, d, x.dtype, offset)
    out = torch.full((d,), float("nan"))
    idx = torch.from_numpy(cols.reshape(-1))
    xv = x.float()[:, idx]                        # (K, vectors · V)
    s = torch.zeros(idx.shape)
    for slot in range(k):
        s = s + xv[slot]
    sigma = torch.where(s > 0, 1.0, torch.where(s < 0, -1.0, 0.0))
    mu = torch.zeros(idx.shape)
    for slot in range(k):
        mu = torch.where(xv[slot] * sigma > 0,
                         torch.maximum(mu, xv[slot].abs()), mu)
    out[idx] = sigma * mu
    return out


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", DS)
def test_unify_plan_covers_d_once(d, dtype, k):
    """Every coordinate exactly once, at every row alignment."""
    for offset in range(4):
        cols, vec = walk(k, d, dtype, offset)
        counts = np.bincount(cols.reshape(-1), minlength=d)
        assert counts.shape == (d,) and (counts == 1).all()
        if k <= fused_unify.KMAX and offset == 0:
            # aligned rows load 8 bytes where d allows
            assert vec == np.gcd(8 // dtype.itemsize, d)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("k,d", [(1, 7), (3, 33), (4, 4100), (5, 65_540),
                                 (4, 1_327_140), (16, 4100), (17, 33),
                                 (40, 4100)])
def test_unify_walk_bitwise_plain(k, d, dtype):
    """The emulated kernel equals ``ref.unify_ref`` in fp32 bit patterns
    (+0.0 and -0.0 apart), at every row alignment."""
    x = torch.from_numpy(unify_stack(k * d, k, d)).to(dtype)
    want = ref.unify_ref(x).view(torch.int32)
    for offset in range(4):
        got = emulate(x, k, d, offset)
        assert not got.isnan().any()
        assert torch.equal(got.view(torch.int32), want)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("k,d", [(1, 7), (3, 33), (4, 4100), (17, 33),
                                 (40, 2100)])
def test_unify_walk_matches_jax(k, d, dtype):
    """The emulated kernel against JAX's ``ops.unify`` in both of its
    modes on the same numpy input."""
    x = unify_stack(k + d, k, d)
    got = emulate(torch.from_numpy(x).to(dtype), k, d, 1).numpy()
    jx = jnp.asarray(x, dtype=jnp.bfloat16 if dtype == torch.bfloat16
                     else jnp.float32)
    for mode in ("ref", "pallas_interpret"):
        assert np.array_equal(got, np.asarray(jops.unify(jx, mode=mode)))


class _Tensor:
    def __init__(self, index):
        self.index = index

    def get_device(self):
        return self.index


@pytest.mark.parametrize("current,index", [(0, 0), (1, 1), (0, 1), (1, 0)])
def test_on_device_switches_only_off_device(monkeypatch, current, index):
    """The guard is the shared no-op context when the tensor's device is
    current, and ``torch.cuda.device(index)`` when it is not."""
    monkeypatch.setattr(torch.cuda, "current_device", lambda: current)
    monkeypatch.setattr(torch.cuda, "device", lambda i: ("switch to", i))
    ctx = build.on_device(_Tensor(index))
    if current == index:
        assert ctx is build._SAME_DEVICE
        with ctx:
            pass
    else:
        assert ctx == ("switch to", index)
