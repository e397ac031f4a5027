"""The redesigned kernels 3 (``sign_sim_packed``) and 5 (bool-layout
``masked_agg_batched``), on the CPU: the plans their wrappers hand the C
calls, kernel 5's mask bytes turned into bits as its threads do, and
kernel 3's int8 tensor-core form written out in plain
PyTorch — plane bits expanded to int8 signs, one Gram product a
k-step (one plane word of every row), the upper-triangle 16 x 8 tiles,
the blocks' partials summed — against the plain version and the JAX
Pallas kernel in interpret mode.

Parity bar: bitwise.  The dots are exact integers, so the emulation must
give them bit for bit; the kernels themselves are held to the plain
versions on the card by tests/test_torch_cuda.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.kernels.sign_sim import sign_sim_packed_pallas  # noqa: E402
from repro_torch.kernels import bitpack, masked_agg, sign_sim  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

SMEM_PER_SM = 233_472        # H100: 228 KB a SM, 1 KB of it reserved a block
SMEM_PER_BLOCK = 232_448     # 227 KB, with the dynamic opt-in


def planes(rng, t, w, subset=True):
    """(pos, nz) int32 (T, w) with every bit pattern; ``subset=False``
    leaves pos bits where nz is clear (the identity ignores them)."""
    nz = rng.integers(0, 2 ** 32, (t, w), dtype=np.uint64)
    pos = rng.integers(0, 2 ** 32, (t, w), dtype=np.uint64)
    if subset:
        pos &= nz
    as_i32 = lambda a: torch.from_numpy(a.astype(np.uint32).view(np.int32))
    return as_i32(pos), as_i32(nz)


# -- kernel 3's plan -------------------------------------------------------

@pytest.mark.parametrize("t", [1, 2, 16, 17, 30, 32, 33, 64, 65, 200])
@pytest.mark.parametrize("w", [1, 3, 7, 41_474, 376_827])
@pytest.mark.parametrize("sms", [132, 114])
def test_sign_sim_packed_plan_covers_every_word_once(t, w, sms):
    blocks, per, route = sign_sim.packed_plan(t, w, sms)
    assert route == ("mma" if t <= 64 else "popc")
    # the blocks' ranges [b * per, min((b + 1) * per, w)) tile [0, w)
    assert blocks * per >= w > (blocks - 1) * per
    if route == "mma":
        assert per % 4 == 0                 # ranges start 16 bytes apart
        assert blocks <= sign_sim.MMA_BLOCKS_PER_SM * sms
    else:
        assert per == sign_sim.words_per_block(t)
    ws = sign_sim.packed_workspace(t, blocks, route)
    assert ws == (blocks * t * (t + 1) // 2 if route == "mma" else t * t)


def test_sign_sim_packed_routes():
    assert sign_sim.packed_plan(30, 41_474) == (260, 160, "mma")
    assert sign_sim.packed_plan(30, 376_827) == (264, 1428, "mma")
    assert sign_sim.packed_plan(30, 41_474, route="popc")[2] == "popc"
    assert sign_sim.packed_plan(64, 100)[2] == "mma"
    assert sign_sim.packed_plan(65, 100)[2] == "popc"
    with pytest.raises(ValueError, match="T <= 64"):
        sign_sim.packed_plan(65, 100, route="mma")
    with pytest.raises(ValueError, match="unknown route"):
        sign_sim.packed_plan(30, 100, route="dense")


@pytest.mark.parametrize("t", [1, 16, 17, 32, 33, 64])
def test_sign_sim_packed_smem_budget(t):
    """The stage ring of both planes (rows of 68 words: the 16-byte-aligned
    window of 64 words at any 4-byte offset) fits two blocks a SM, and
    holds the 8 warps' int32 accumulator fragments afterwards."""
    rows = 16 * (1 if t <= 16 else 2 if t <= 32 else 4)
    smem = sign_sim.packed_smem(t)
    assert smem == sign_sim.MMA_STAGES * 2 * rows * 68 * 4 + 2 * rows * 12
    assert (sign_sim.MMA_CHUNK * 4 + 12 + 15) // 16 * 16 <= 68 * 4
    assert smem <= SMEM_PER_BLOCK
    assert sign_sim.MMA_BLOCKS_PER_SM * (smem + 1024) <= SMEM_PER_SM
    tiles = (rows // 16) * (rows // 16 + 1)
    assert 8 * tiles * 4 * 32 * 4 <= smem     # the 8 warps' fragments
    # the first design's tile for T > 64 stays within 48 KB
    assert 2 * 65 * (sign_sim.words_per_block(65) + 1) * 4 <= 48 * 1024


# -- kernel 3's int8 form, emulated ---------------------------------------

def u32(x):
    """int32 bit patterns -> int64 values in [0, 2**32)."""
    return x.long() & 0xFFFFFFFF


def signs4(p, z, q):
    """``signs4`` of csrc/sign_sim.cu: the signs of bits q, 8 + q, 16 + q,
    24 + q as bytes, scaled by 2^q."""
    m = 0x01010101 << q
    pb, nb = p & z & m, ~p & z & m
    return pb + nb * ((0x100 >> q) - 1)


def as_int8(reg):
    """(...,) int64 holding 4 bytes -> (..., 4) int8 values, byte 0 first."""
    out = torch.stack([(reg >> (8 * j)) & 0xFF for j in range(4)], -1)
    return torch.where(out >= 128, out - 256, out)


def mma_operands(pos, nz, o):
    """The int8 values that the mma of offset o (0..3) takes from each
    (T, w) plane word: a thread's word, bits 8 j + o (register h) and
    8 j + o + 4 (register h + 2), j = 0..3, as ``x >> (o & 2)`` masked at
    bit q = o & 1 of each byte: (T, w, 8), scaled by 2^q."""
    p, z = u32(pos), u32(nz)
    sh, q = o & 2, o & 1
    lo = signs4(p >> sh, z >> sh, q)
    hi = signs4(p >> (sh + 4), z >> (sh + 4), q)
    return torch.cat([as_int8(lo), as_int8(hi)], -1)


def bits_of(o):
    """The plane bits of a word that the mma of offset o takes."""
    return [8 * j + o + 4 * half for half in range(2) for j in range(4)]


def block_sums(pos, nz):
    """One block's sums over its words as its mmas give them: rows padded
    to 16 * MT with zeros, for each offset o the Gram product of its int8
    operands (int64), o odd into a second sum (4 times the dots), only the
    upper-triangle 16 x 8 tiles (column tile nt >= 2 * row tile mt) kept;
    the block's total takes the second sum divided by 4."""
    t = pos.shape[0]
    rows = 16 if t <= 16 else 32 if t <= 32 else 64
    acc = [torch.zeros((rows, rows), dtype=torch.int64) for _ in range(2)]
    for o in range(4):
        v = torch.zeros((rows, pos.shape[1] * 8), dtype=torch.int64)
        v[:t] = mma_operands(pos, nz, o).reshape(t, -1)
        acc[o & 1] += v @ v.T
    assert (acc[1] % 4 == 0).all()            # exact: a multiple of 4
    gram = acc[0] + acc[1] // 4
    kept = torch.zeros((rows, rows), dtype=torch.bool)
    for mt in range(rows // 16):
        kept[16 * mt:16 * mt + 16, 16 * mt:] = True       # nt >= 2 mt
    return torch.where(kept, gram, 0)


def emulate(pos, nz, sms=132):
    """Kernel 3's tensor-core route: each block's upper-triangle sums
    from its word range, then the sum kernel's int32 total a pair,
    mirrored, as fp32."""
    t, w = pos.shape
    blocks, per, route = sign_sim.packed_plan(t, w, sms)
    assert route == "mma"
    iu = torch.triu_indices(t, t)
    partials = torch.stack([
        block_sums(pos[:, b * per:(b + 1) * per],
                   nz[:, b * per:(b + 1) * per])[:t, :t][iu[0], iu[1]]
        for b in range(blocks)])
    total = partials.sum(0)
    assert total.abs().max() < 2 ** 31                    # int32 is exact
    dots = torch.zeros((t, t), dtype=torch.float32)
    dots[iu[0], iu[1]] = total.float()
    dots[iu[1], iu[0]] = total.float()
    return dots


@pytest.mark.parametrize("t", [1, 2, 15, 16, 17, 30, 32, 33, 63, 64])
def test_sign_sim_packed_epilogue_writes_every_pair_once(t):
    """The block epilogue's map from a warp's accumulator entry i (tile,
    register q, lane) to (row, col) of the Gram matrix: the entries with
    row <= col < T hit every pair of the upper triangle exactly once."""
    mt_n = 1 if t <= 16 else 2 if t <= 32 else 4
    nt_n, tiles = 2 * mt_n, mt_n * (mt_n + 1)
    seen = {}
    for i in range(tiles * 4 * 32):
        lane, q, tile, mt = i & 31, (i >> 5) & 3, i >> 7, 0
        while tile >= nt_n - 2 * mt:
            tile -= nt_n - 2 * mt
            mt += 1
        nt = 2 * mt + tile
        row = 16 * mt + (lane >> 2) + 8 * (q >> 1)
        col = 8 * nt + 2 * (lane & 3) + (q & 1)
        if row <= col < t:
            seen[(row, col)] = seen.get((row, col), 0) + 1
    assert seen == {(a, b): 1 for a in range(t) for b in range(a, t)}


@pytest.mark.parametrize("subset", [True, False])
def test_int8_operands_follow_the_plane_rule(subset):
    """+1 where nz and pos, -1 where nz and not pos, 0 where nz is clear
    (whatever pos holds), coordinate 32 k + j at bit j; the four offsets
    take every bit of a word once, offset o scaled by 2^(o mod 2)."""
    assert sorted(sum((bits_of(o) for o in range(4)), [])) == list(range(32))
    pos, nz = planes(np.random.default_rng(int(subset)), 5, 9, subset)
    p, z = bitpack.unpack_bits(pos, 9 * 32), bitpack.unpack_bits(nz, 9 * 32)
    want = torch.where(z, torch.where(p, 1, -1), 0).reshape(5, 9, 32)
    for o in range(4):
        got = mma_operands(pos, nz, o)
        assert torch.equal(got, want[..., bits_of(o)] * 2 ** (o & 1))


@pytest.mark.parametrize("subset", [True, False])
@pytest.mark.parametrize("t,w,sms", [(1, 1, 132), (2, 3, 132), (5, 7, 1),
                                     (16, 40, 3), (17, 33, 4), (30, 64, 2),
                                     (32, 129, 5), (33, 20, 2),
                                     (64, 41, 3)])
def test_int8_tile_form_equals_plain(t, w, sms, subset):
    pos, nz = planes(np.random.default_rng(t * w + sms), t, w, subset)
    got = emulate(pos, nz, sms)
    assert torch.equal(got, sign_sim.plain(pos, nz))


@pytest.mark.parametrize("t,w,sms,subset", [(3, 5, 132, True),
                                            (30, 41, 4, False),
                                            (33, 17, 2, False)])
def test_int8_tile_form_equals_jax_pallas(t, w, sms, subset):
    pos, nz = planes(np.random.default_rng(7 * t + w), t, w, subset)
    want = np.asarray(sign_sim_packed_pallas(
        pos.numpy().view(np.uint32), nz.numpy().view(np.uint32),
        interpret=True))
    got = emulate(pos, nz, sms)
    assert np.array_equal(got.numpy(), want)


# -- kernel 5's plan: the packed round's tile route on bool bytes ---------

BLOCK = 256             # threads of a tile block (csrc/masked_agg.cu)
STAGES, BLOCKS_PER_SM = 1, 3       # bool layout: one unified stage a block
PREFETCH_BYTES = 2 * 8 * BLOCK * 8   # 8 members' mask bytes, a task ahead


@pytest.mark.parametrize("elt,last", [(4, 47), (2, 93)])
def test_masked_agg_bool_route_boundary_and_smem(elt, last):
    """The tile route up to N = 47 (fp32 unified) / 93 (bf16), the first
    design beyond; a block's unified stage and mask prefetch fit one block
    a SM for every N of the route, three at the round's N = 32."""
    assert masked_agg.packed_tile(last, elt) > 0
    assert masked_agg.packed_tile(last + 1, elt) == 0

    def smem(n):
        tile = masked_agg.packed_tile(n, elt)
        return STAGES * (n * (tile * elt + 16) + 8) + PREFETCH_BYTES
    for n in (1, 7, 32, last):
        assert smem(n) <= SMEM_PER_BLOCK
        assert masked_agg.packed_tile(n, elt) // 8 >= 32   # whole warps
    assert BLOCKS_PER_SM * (smem(32) + 1024) <= SMEM_PER_SM


@pytest.mark.parametrize("n,elt,t,d", [(32, 4, 30, 1000), (32, 2, 30, 2100),
                                       (5, 4, 3, 33), (47, 4, 9, 700),
                                       (93, 2, 4, 300)])
def test_masked_agg_bool_tiles_cover_every_output_once(n, elt, t, d):
    """Each (task, coordinate) of the outputs is summed and written by
    exactly one thread of one tile: tile / 8 threads a task own 8
    coordinates each, 256 / that many tasks at once, tiles walked in
    turn."""
    tile = masked_agg.packed_tile(n, elt)
    per_task = tile // 8
    groups = BLOCK // per_task
    hits = torch.zeros((t, d), dtype=torch.int32)
    for j0 in range(0, d, tile):
        for tid in range(BLOCK):
            jt = 8 * (tid % per_task)
            for task in range(tid // per_task, t, groups):
                lo, hi = j0 + jt, min(j0 + jt + 8, j0 + tile, d)
                if lo < hi:
                    hits[task, lo:hi] += 1
    assert torch.equal(hits, torch.ones_like(hits))


def byte_bits(x):
    """``byte_bits`` of csrc/masked_agg.cu: bytes 0..3 (0 or 1) as bits."""
    return ((x * 0x01020408) & 0xFFFFFFFF) >> 24


def test_mask_bytes_to_bits():
    """Every pattern of 8 bool bytes, as two 4-byte loads, gives the mask
    bits of kernel 2's words: bit c for coordinate jt + c."""
    for v in range(256):
        bits = [(v >> c) & 1 for c in range(8)]
        lo = sum(b << (8 * c) for c, b in enumerate(bits[:4]))
        hi = sum(b << (8 * c) for c, b in enumerate(bits[4:]))
        assert byte_bits(lo) | (byte_bits(hi) << 4) == v
    rng = np.random.default_rng(0)
    mask = torch.from_numpy(rng.random((3, 64)) < 0.5)
    words = bitpack.pack_bits(mask)
    u8 = mask.view(torch.uint8).long()
    for jt in range(0, 64, 8):
        lo = sum(u8[:, jt + c] << (8 * c) for c in range(4))
        hi = sum(u8[:, jt + 4 + c] << (8 * c) for c in range(4))
        got = byte_bits(lo) | (byte_bits(hi) << 4)
        want = (u32(words[:, jt // 32]) >> (jt % 32)) & 0xFF
        assert torch.equal(got, want)
