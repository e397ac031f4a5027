"""The packed round's staged kernels (kernels 1 and 2), on the CPU: the
plans their wrappers hand the C calls (``fused_unify.lambda_blocks``,
``masked_agg.packed_tile``, ``masked_agg.packed_workspace``), and the λ
summation order of kernel 1 written out in plain PyTorch — each slice's
xor reduce-scatter butterfly, the halving tree over a λ block's 8
slices and the tree kernel's binary counter — against the plain
version's order (``ref._block_partials``, ``ref._tree_total``).

Parity bar: bitwise.  The kernels claim the same sums as the plain
version, so λ num/den, which the card tests hold bitwise, must come out
of this emulation bit for bit too.  The kernels themselves are held to
the plain versions on the card by tests/test_torch_cuda.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import fused_unify, masked_agg, ref  # noqa: E402

WIDTHS = [1, 33, 255, 256, 257, 300, 4100, 65540, 1_327_140]
LANES = torch.arange(32)


# -- plans ---------------------------------------------------------------

@pytest.mark.parametrize("d", WIDTHS)
def test_fused_unify_lambda_blocks(d):
    """One λ partial a 256-coordinate block of the λ grid, covering d
    once: the row length of the packed kernel's workspace."""
    n = fused_unify.lambda_blocks(d)
    assert (n - 1) * ref.LAMBDA_BLOCK < d <= n * ref.LAMBDA_BLOCK
    x = torch.zeros((1, 1, d))
    assert ref._block_partials(torch.nn.functional.pad(
        x, (0, n * ref.LAMBDA_BLOCK - d))).shape[-1] == n


def test_masked_agg_packed_tile_boundary():
    for elt, last in ((2, 93), (4, 47)):
        tiles = [masked_agg.packed_tile(n, elt) for n in range(1, 400)]
        assert tiles == sorted(tiles, reverse=True)          # widest first
        assert masked_agg.packed_tile(last, elt) == 256
        assert masked_agg.packed_tile(last + 1, elt) == 0
        for n, tile in enumerate(tiles, 1):
            if tile:
                assert tile in (1024, 512, 256)
                # every task's threads fill whole warps: tile / 8 >= 32
                assert tile // 8 >= 32
                assert n * (tile * elt + 16) <= masked_agg.STAGE_BYTES
                if tile < 1024:          # the next wider tile does not fit
                    assert n * (2 * tile * elt + 16) > masked_agg.STAGE_BYTES
    # the shapes of the card tests and of the full-width round
    assert masked_agg.packed_tile(32, 2) == 512
    assert masked_agg.packed_tile(32, 4) == 256
    assert masked_agg.packed_tile(5, 2) == 1024
    assert masked_agg.packed_tile(7, 2) == 1024
    assert masked_agg.packed_tile(100, 2) == 0


@pytest.mark.parametrize("n,t", [(1, 1), (3, 30), (32, 30), (93, 5),
                                 (94, 5), (4000, 2)])
def test_masked_agg_packed_workspace(n, t):
    tile = masked_agg.packed_tile(n, 2)
    words = masked_agg.packed_workspace(n, t, tile)
    if tile:                 # a 16-byte header and >= 4 entries a task
        assert words == t * 4 * (1 + max(n, 4))
    else:
        assert words == 2 * n * t


# -- kernel 1's λ order, emulated ----------------------------------------

def butterfly(v: torch.Tensor) -> torch.Tensor:
    """``warp_sums<Q>`` of csrc/fused_unify.cu on (32 lanes, Q) fp32
    values: returns each lane's v[0] afterwards."""
    v = v.clone()
    q = v.shape[1]
    for i in range(5):
        off = 16 >> i
        half = (q >> i) // 2
        partner = LANES ^ off
        up = ((LANES & off) != 0)[:, None]
        if half >= 1:
            lo, hi = v[:, :half], v[:, half:2 * half]
            send = torch.where(up, lo, hi)
            keep = torch.where(up, hi, lo)
            v[:, :half] = keep + send[partner]
        else:
            v[:, 0] = v[:, 0] + v[partner, 0]
    return v[:, 0]


def mixed(rng, shape, nonneg=False):
    """fp32 values of mixed magnitude (so that the order of a sum shows
    in its bits), a tenth of them zero."""
    x = rng.standard_normal(shape) * 10.0 ** rng.integers(-6, 6, shape)
    x[rng.random(shape) < 0.1] = 0.0
    return torch.from_numpy(np.abs(x) if nonneg else x).float()


@pytest.mark.parametrize("q", [2, 4, 8, 16, 32])
def test_butterfly_equals_shuffle_down_tree(q):
    rng = np.random.default_rng(q)
    for _ in range(20):
        v = mixed(rng, (32, q))
        tree = ref._halve(v, 0)               # the __shfl_down_sync tree
        got = butterfly(v)
        want = tree[LANES // (32 // q)]
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def tree_kernel(part: torch.Tensor) -> torch.Tensor:
    """``fused_unify_tree_kernel`` on one row of tile partials: eight
    warps, each an aligned segment of ``seg`` values, chunks of 32 summed
    by an xor tree and merged in order by a binary counter; then the
    eight segment sums by the pairing."""
    n = part.shape[0]
    seg = max(32, ref.next_pow2(n) // 8)
    padded = torch.zeros(8 * seg, dtype=torch.float32)
    padded[:n] = part
    sums = []
    for w in range(8):
        stack, occ = {}, 0
        for c0 in range(0, seg, 32):
            v = padded[w * seg + c0:w * seg + c0 + 32].clone()
            off = 1
            while off < 32:
                v = v + v[LANES ^ off]
                off <<= 1
            x, lvl = v[0], 0
            while (occ >> lvl) & 1:
                x = stack[lvl] + x
                occ &= ~(1 << lvl)
                lvl += 1
            stack[lvl] = x
            occ |= 1 << lvl
        sums.append(stack[occ.bit_length() - 1])
    s = sums
    return ((s[0] + s[1]) + (s[2] + s[3])) + ((s[4] + s[5]) + (s[6] + s[7]))


def kernel_lambda(x: torch.Tensor, q: int) -> torch.Tensor:
    """λ num of one slot row x (d,) as kernel 1 sums it: each slice of 32
    coordinates through the butterfly of ``q`` quantities (num the first,
    the rest zero), the 8 slices of a λ block by the halving tree, then
    the tree kernel over the blocks."""
    d = x.shape[0]
    n_blk = fused_unify.lambda_blocks(d)
    xp = torch.zeros(n_blk * ref.LAMBDA_BLOCK, dtype=torch.float32)
    xp[:d] = x.abs()
    per_block = []
    for blk in range(n_blk):
        lanes = xp[blk * 256:(blk + 1) * 256].reshape(8, 32)
        sl = []
        for i in range(8):
            v = torch.zeros((32, q))
            v[:, 0] = lanes[i]
            sl.append(butterfly(v)[0])        # lane 0 holds quantity 0
        per_block.append(((sl[0] + sl[4]) + (sl[2] + sl[6]))
                         + ((sl[1] + sl[5]) + (sl[3] + sl[7])))
    return tree_kernel(torch.stack(per_block))


@pytest.mark.parametrize("q", [2, 8, 32])
@pytest.mark.parametrize("d", [33, 300, 4100, 9000])
def test_kernel_lambda_order_equals_plain(q, d):
    rng = np.random.default_rng(d + q)
    x = mixed(rng, (d,))
    want = ref.fused_unify_ref(x[None, None], torch.ones((1, 1),
                                                         dtype=torch.bool))
    got = kernel_lambda(x, q)
    assert torch.equal(got.view(torch.int32), want[2][0, 0].view(torch.int32))


@pytest.mark.parametrize("n", [1, 2, 3, 7, 32, 33, 255, 256, 257, 1297,
                               5185, 47104])
def test_tree_kernel_equals_tree_total(n):
    """Zero padding past ref's power-of-two length changes no bit of a
    tree over values >= +0."""
    rng = np.random.default_rng(n)
    p = mixed(rng, (n,), nonneg=True)
    got = tree_kernel(p)
    want = ref._tree_total(p)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("seed,n,t", [(0, 5, 4), (1, 32, 30), (2, 40, 6)])
def test_unit_vote_counts_index_the_m_hat_table(seed, n, t):
    """Kernel 2 reads m̂ from a table of 32 lanes when the members are
    bool and a task has fewer than 32: with unit votes the agreement
    numerator is an integer no larger than the task's member count."""
    rng = np.random.default_rng(seed)
    d = 300
    unified = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
    members = torch.from_numpy(rng.random((n, t)) < 0.5)
    masks = torch.from_numpy(rng.random((n, t, d)) < 0.7) & members[:, :, None]
    lams = torch.where(members, 1.0, 0.0)
    gam = members.float() / members.float().sum(0).clamp(min=1.0)
    from repro_torch.kernels import bitpack
    _, a_num = masked_agg.plain(unified.to(torch.bfloat16),
                                bitpack.pack_bits(masks), lams, gam, members,
                                d, 0.4)
    count = members.sum(0).float()[:, None]
    assert torch.equal(a_num, a_num.round())
    assert (a_num <= count).all()
