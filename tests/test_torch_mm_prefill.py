"""Kernel 9's prefill routes, on the CPU: the route a leaf's shape takes
(``modulated_matmul.prefill_route``) and the sum the narrow-K and
narrow-N kernels compute, each output one FMA chain over k = 0, 1, ...,
K - 1, written out in plain PyTorch, against the JAX package's Pallas
kernel (interpret mode) and its reference.

Parity bar: the written-out sums agree with JAX and with the plain
version within 1e-4·(|x|·|w|), the card's bar for kernel 9 (fp32 sums
of K products in other orders; worst case 2·K·2^-24); with one-hot rows
of x they return the effective weight bit for bit; zero columns of x
and zero rows of w past K (the kernels pad K to their stage) leave them
bit for bit.  The kernels themselves are held to the plain version on
the card by tests/test_torch_cuda.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import bitpack, ref  # noqa: E402
from repro_torch.kernels import modulated_matmul as mm  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

MM_RTOL = 1e-4
# every LoRA factor served at rank 16: qwen2-0.5b, xlstm-1.3b,
# granite-moe-3b, whisper-large-v3, hymba-1.5b, qwen2-vl-7b, deepseek-v2
LEAVES = sorted({
    (896, 16), (4864, 16), (16, 896),
    (2048, 16), (4096, 16), (2730, 16), (16, 2048), (16, 8192),
    (1536, 16), (16, 1536),
    (1280, 16), (5120, 16), (16, 1280),
    (1600, 16), (3200, 16), (5504, 16), (16, 1600), (16, 6400),
    (3584, 16), (18944, 16), (16, 3584),
    (16384, 16), (3072, 16), (16, 5120)})


@pytest.mark.parametrize("k,n", LEAVES + [(32, 64), (33, 32), (64, 64),
                                          (48, 48)])
def test_prefill_route_by_shape(k, n):
    want = ("narrow_k" if k <= mm.NARROW else
            "narrow_n" if n <= mm.NARROW else "tile")
    assert mm.prefill_route(k, n) == want
    if (k, n) in LEAVES:      # every b factor narrow K, every a narrow N
        assert want == ("narrow_k" if k == 16 else "narrow_n")


def prefill_sum(x, base, tau, words, lam):
    """The prefill routes' arithmetic in plain PyTorch.  The narrow-K
    and narrow-N kernels: each output sums k = 0, 1, ... in turn (the
    kernels fuse each step into one FMA; here it rounds twice, so the
    two agree to the bar, not bit for bit).  The general tile: one
    product."""
    w = ref.modulated_weight_ref(base, tau, words, lam)
    k = base.shape[0]
    if mm.prefill_route(*base.shape) == "tile":
        return torch.einsum("bsk,bkn->bsn", x, w)
    y = x[..., :1] * w[:, None, 0]
    for i in range(1, k):
        y = y + x[..., i:i + 1] * w[:, None, i]
    return y


def prefill_inputs(seed, b, s, k, n):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, k)).astype(np.float32)
    base = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    tau = (0.05 * rng.standard_normal((k, n))).astype(np.float32)
    words = bitpack.pack_bits_np(rng.random((b, k * n)) < 0.7)
    lam = (rng.random(b) + 0.5).astype(np.float32)
    return x, base, tau, words, lam


def to_port(x, base, tau, words, lam):
    return (torch.from_numpy(x), torch.from_numpy(base),
            torch.from_numpy(tau), bitpack.words_from_numpy(words),
            torch.from_numpy(lam))


@pytest.mark.parametrize("k,n,s", [(896, 16, 17), (2730, 16, 40),
                                   (4864, 16, 23), (16, 896, 17),
                                   (16, 2048, 40), (64, 64, 20)])
def test_prefill_sum_matches_jax(k, n, s):
    args = prefill_inputs(k + n + s, 2, s, k, n)
    want = jops.modulated_matmul(*map(jnp.asarray, args),
                                 mode="pallas_interpret")
    port = to_port(*args)
    got = prefill_sum(*port)
    w = ref.modulated_weight_ref(*port[1:])
    scale = torch.einsum("bsk,bkn->bsn", port[0].abs(), w.abs())
    assert got.shape == (2, s, n)
    for other in (torch.from_numpy(np.array(want)), mm.plain(*port)):
        assert ((got - other).abs() <= MM_RTOL * scale).all()


@pytest.mark.parametrize("k,n", [(16, 896), (16, 2048), (16, 6400)])
def test_prefill_sum_one_hot_rows_bitwise_narrow_k(k, n):
    """Rows s of x = e_(s mod K) at S = 64: each output is one exact
    product plus zeros, so row s is the effective weight's row s mod K."""
    _, base, tau, words, lam = to_port(*prefill_inputs(n, 2, 1, k, n))
    w = ref.modulated_weight_ref(base, tau, words, lam)
    s = 64
    x = torch.eye(k)[torch.arange(s) % k].expand(2, s, k).contiguous()
    assert torch.equal(prefill_sum(x, base, tau, words, lam),
                       w[:, torch.arange(s) % k])


@pytest.mark.parametrize("k,n", [(896, 16), (2730, 16), (4864, 16)])
def test_prefill_sum_one_hot_rows_bitwise_narrow_n(k, n):
    """One-hot rows x = I[k0:k0+20] (S 20, past the decode route) at the
    start of K, across the narrow-N kernel's first 64-row stage boundary
    and at the end of K return those rows of the effective weight bit
    for bit."""
    _, base, tau, words, lam = to_port(*prefill_inputs(k, 2, 1, k, n))
    w = ref.modulated_weight_ref(base, tau, words, lam)
    s = 20
    for k0 in (0, 64 - 10, k - s):
        x = torch.eye(k)[k0:k0 + s].expand(2, s, k).contiguous()
        assert torch.equal(prefill_sum(x, base, tau, words, lam),
                           w[:, k0:k0 + s]), k0


@pytest.mark.parametrize("pad", [4, 64])
@pytest.mark.parametrize("k,n", [(1, 32), (6, 16), (17, 96), (16, 896),
                                 (33, 32), (100, 16), (896, 16),
                                 (2730, 16)])
def test_prefill_sum_zero_padding_bitwise(k, n, pad):
    """K padded to a multiple of ``pad`` (4: the narrow-K kernel's
    stage; 64: the narrow-N kernel's) with zero columns of x and zero
    rows of w: each padded step adds 0 * 0 to a chain and leaves it bit
    for bit."""
    x, base, tau, words, lam = to_port(*prefill_inputs(k + n, 2, 19, k, n))
    w = ref.modulated_weight_ref(base, tau, words, lam)
    kp = -(-k // pad) * pad
    xp = torch.cat([x, torch.zeros(2, 19, kp - k)], dim=-1)
    wp = torch.cat([w, torch.zeros(2, kp - k, n)], dim=1)
    want = x[..., :1] * w[:, None, 0]
    for i in range(1, k):
        want = want + x[..., i:i + 1] * w[:, None, i]
    got = xp[..., :1] * wp[:, None, 0]
    for i in range(1, kp):
        got = got + xp[..., i:i + 1] * wp[:, None, i]
    assert torch.equal(got, want)
