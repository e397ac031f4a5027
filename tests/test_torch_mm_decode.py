"""Kernel 9's decode route, on the CPU: the split of K into chunks that
the wrapper hands the kernel (``modulated_matmul.decode_chunks``,
``decode_workspace_shape``), and the chunked sum that
the split-K kernel and its reduction compute, written out in plain
PyTorch, against the JAX package's Pallas kernel (interpret mode) and
its reference.

Parity bar: the chunks cover K exactly once, in ascending order; the
chunked sum agrees with JAX and with the plain version within
1e-4·(|x|·|w|), the card's bar for kernel 9 (fp32 sums of K products in
other orders; worst case 2·K·2^-24), and with one-hot rows of x it
returns the effective weight bit for bit.
The kernel itself is held to the plain version on the card by
tests/test_torch_cuda.py.
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
# every LoRA factor of qwen2-0.5b and xlstm-1.3b at rank 16
LEAVES = [(896, 16), (4864, 16), (16, 896), (2048, 16), (4096, 16),
          (2730, 16), (16, 2048), (16, 8192)]
# K that no chunk size of the plan divides, and edge sizes
ODD_K = [1, 15, 17, 33, 129, 1000, 4865, 100003]


def chunk_ranges(k):
    """The K rows [start, stop) of each decode chunk as the split-K
    kernel takes them (block c: rows c·kc to min(K, (c + 1)·kc)), in the
    order the reduction kernel sums their partials."""
    rows, n = mm.decode_chunks(k)
    return [(c * rows, min(k, (c + 1) * rows)) for c in range(n)]


@pytest.mark.parametrize("k", sorted({k for k, _ in LEAVES} | set(ODD_K)))
def test_decode_chunks_cover_k_once_in_order(k):
    rows, n = mm.decode_chunks(k)
    assert mm.CHUNK_MIN <= rows <= mm.CHUNK_MAX and rows % mm.ROW_STEP == 0
    spans = chunk_ranges(k)
    assert len(spans) == n
    covered = [r for start, stop in spans for r in range(start, stop)]
    assert covered == list(range(k))                  # once, ascending
    assert all(stop > start for start, stop in spans)
    assert all(stop - start == rows for start, stop in spans[:-1])


@pytest.mark.parametrize("k,n", LEAVES)
def test_decode_workspace_shape(k, n):
    chunks = mm.decode_chunks(k)[1]
    for b in (1, 8):
        for s in (1, 3, mm.DECODE_MAX_S):
            want = None if chunks == 1 else (b, chunks, s, n)
            assert mm.decode_workspace_shape(b, s, k, n) == want
        assert mm.decode_workspace_shape(b, mm.DECODE_MAX_S + 1, k, n) is None
    # the "b" factors (K = r = 16) fit one chunk and write y directly
    assert (chunks == 1) == (k <= mm.CHUNK_MIN)


def chunked_sum(x, base, tau, words, lam):
    """The decode route's arithmetic in plain PyTorch: one partial per
    chunk of :func:`chunk_ranges`, summed in ascending
    chunk order."""
    w = ref.modulated_weight_ref(base, tau, words, lam)
    parts = [torch.einsum("bsk,bkn->bsn", x[..., a:z], w[:, a:z])
             for a, z in chunk_ranges(x.shape[-1])]
    y = parts[0]
    for p in parts[1:]:
        y = y + p
    return y


def decode_inputs(seed, b, s, k, n):
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


@pytest.mark.parametrize("s", [1, 16])
@pytest.mark.parametrize("k,n", [(896, 16), (2730, 16), (16, 896)])
def test_chunked_sum_matches_jax(k, n, s):
    args = decode_inputs(k + s, 2, s, k, n)
    want = jops.modulated_matmul(*map(jnp.asarray, args),
                                 mode="pallas_interpret")
    port = to_port(*args)
    got = chunked_sum(*port)
    w = ref.modulated_weight_ref(*port[1:])
    scale = torch.einsum("bsk,bkn->bsn", port[0].abs(), w.abs())
    for other in (torch.from_numpy(np.asarray(want)), mm.plain(*port)):
        assert ((got - other).abs() <= MM_RTOL * scale).all()


@pytest.mark.parametrize("k,n", [(896, 16), (4864, 16), (16, 2048)])
def test_chunked_sum_one_hot_rows_bitwise(k, n):
    """One-hot rows x = I[k0:k0+S]: every output is one exact product
    plus zeros, so the chunked sum is the effective weight's rows."""
    _, base, tau, words, lam = to_port(*decode_inputs(k, 2, 1, k, n))
    w = ref.modulated_weight_ref(base, tau, words, lam)
    kc = mm.decode_chunks(k)[0]
    for k0, s in ((0, 16), (kc - 3, 5), (k - 16, 16), (k - 1, 1)):
        s = min(s, k - k0)
        x = torch.eye(k)[k0:k0 + s].expand(2, s, k).contiguous()
        assert torch.equal(chunked_sum(x, base, tau, words, lam),
                           w[:, k0:k0 + s])
