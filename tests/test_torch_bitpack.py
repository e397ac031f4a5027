"""The port's packed wire layout against the JAX package's: the same
mask gives byte-identical words (int32 bit patterns viewed as ``<u4``),
the same sign planes and the same Eq. 5 popcount dots; the bf16 wire
rounding is the same bit for bit."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import bitpack as jbp  # noqa: E402
from repro_torch.kernels import bitpack as tbp  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

DS = [1, 31, 33, 1000, 4100]


@pytest.mark.parametrize("d", DS)
def test_pack_bits_byte_identical(d):
    rng = np.random.default_rng(d)
    mask = rng.random((3, 2, d)) < rng.random()
    want = np.asarray(jbp.pack_bits(jnp.asarray(mask)))
    got = tbp.words_to_numpy(tbp.pack_bits(torch.from_numpy(mask)))
    assert got.dtype == np.dtype("<u4") and got.shape == want.shape
    assert got.tobytes() == want.tobytes()
    # tail bits past d stay zero
    assert tbp.packed_width(d) == want.shape[-1]


@pytest.mark.parametrize("d", DS)
def test_unpack_roundtrip_and_numpy_packers(d):
    rng = np.random.default_rng(100 + d)
    mask = rng.random((4, d)) < 0.5
    words = tbp.pack_bits(torch.from_numpy(mask))
    assert np.array_equal(tbp.unpack_bits(words, d).numpy(), mask)
    assert np.array_equal(tbp.pack_bits_np(mask), jbp.pack_bits_np(mask))
    assert np.array_equal(tbp.unpack_bits_np(tbp.pack_bits_np(mask), d), mask)
    # words cross the wire edge as numpy <u4 and back without change
    back = tbp.words_from_numpy(tbp.words_to_numpy(words))
    assert torch.equal(back, words)


def test_bit_31_and_high_words_survive_int32():
    mask = np.zeros((2, 64), bool)
    mask[0, 31] = mask[0, 63] = mask[1, :] = True
    words = tbp.pack_bits(torch.from_numpy(mask))
    u4 = tbp.words_to_numpy(words)
    assert u4[0, 0] == 1 << 31 and u4[0, 1] == 1 << 31
    assert (u4[1] == 0xFFFFFFFF).all()
    assert np.array_equal(tbp.unpack_bits(words, 64).numpy(), mask)


@pytest.mark.parametrize("t,d", [(1, 40), (5, 1000), (7, 4100)])
def test_sign_planes_and_packed_sign_dots(t, d):
    rng = np.random.default_rng(t * d)
    x = rng.standard_normal((t, d)).astype(np.float32)
    x[rng.random((t, d)) < 0.3] = 0.0              # sgn 0 entries
    pj, nj = jbp.sign_planes(jnp.asarray(x))
    pt, nt = tbp.sign_planes(torch.from_numpy(x))
    assert tbp.words_to_numpy(pt).tobytes() == np.asarray(pj).tobytes()
    assert tbp.words_to_numpy(nt).tobytes() == np.asarray(nj).tobytes()
    dots = tbp.packed_sign_dots(pt, nt)
    assert dots.dtype == torch.int32
    assert np.array_equal(dots.numpy(), np.asarray(jbp.packed_sign_dots(pj, nj)))
    s = np.sign(x)
    assert np.array_equal(dots.numpy(), (s @ s.T).astype(np.int32))


def test_wire_bits_matches_reference():
    for d, k in [(1, 1), (1000, 3), (1_327_140, 4)]:
        for vb in (2, 4):
            assert tbp.wire_bits(d, k, vec_bytes_per_elem=vb) == \
                jbp.wire_bits(d, k, vec_bytes_per_elem=vb)


def test_bf16_rounding_is_bitwise_the_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal(20000).astype(np.float32) * 10.0 ** rng.integers(
        -30, 30, 20000)
    # exact ties between two bf16 values (round to nearest even)
    ties = (np.arange(1, 2001, dtype=np.uint32) << 16) | 0x8000
    x = np.concatenate([x, ties.view(np.float32), -ties.view(np.float32),
                        np.array([0.0, -0.0, 1e-40, -1e-40], np.float32)])
    got = torch.from_numpy(x).to(torch.bfloat16).view(torch.int16).numpy()
    want = np.asarray(jnp.asarray(x).astype(jnp.bfloat16)).view(np.int16)
    assert np.array_equal(got, want)
