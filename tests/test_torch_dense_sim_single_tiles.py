"""The redesigned kernels 6 (dense ``sign_sim``) and 8 (single-task
``masked_agg``), on the CPU: the plans their wrappers hand the C calls,
kernel 6's int8 tensor-core form written out in plain PyTorch -- four
fp32 values of a row as the four int8 sign bytes of one fragment
register, the A fragment's rows g / g + 8 and k columns 4 tig + 16 h,
the same registers as the B fragment, the upper-triangle 16 x 8 tiles,
each block's partials summed -- and its S epilogue; kernel 8's member
list from gamma, its per-thread sums over the member rows and its m_hat
table.  Each is held against the plain version and the JAX package
(the Pallas kernels in interpret mode).

Parity bar: the dots, the member lists, tau_hat and m_hat bitwise
against the plain versions; S within 1 ulp of JAX's eager division (the
card divides by a product with the fp32 reciprocal of d, as torch does
there); tau_hat against JAX's Pallas kernel at ``test_torch_serve.py``'s
bar (JAX weights gamma * (lambda * u), the port (gamma * lambda) * u).
The kernels themselves are held to the plain versions on the card by
tests/test_torch_cuda.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.masked_agg import masked_agg_pallas  # noqa: E402
from repro.kernels.sign_sim import sign_sim_pallas  # noqa: E402
from repro_torch.kernels import masked_agg, ref, sign_sim  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

SMEM_PER_SM = 233_472        # H100: 228 KB a SM, 1 KB of it reserved a block
SMEM_PER_BLOCK = 232_448     # 227 KB, with the dynamic opt-in
REGS_PER_SM = 65_536
THREADS = 256                # a block of either kernel
RTOL, ATOL = 1e-5, 1e-6      # test_torch_serve.py's tau_hat bar


# -- kernel 6's plan ---------------------------------------------------------

@pytest.mark.parametrize("t", [1, 16, 17, 30, 33, 64, 65, 200])
@pytest.mark.parametrize("d", [1, 31, 33, 4100, 1_327_140])
@pytest.mark.parametrize("sms", [132, 3])
def test_dense_plan_covers_every_coordinate_once(t, d, sms):
    blocks, per, route = sign_sim.dense_plan(t, d, sms)
    assert route == ("mma" if t <= 64 else "dp4a")
    # the blocks' ranges [b * per, min((b + 1) * per, d)) tile [0, d)
    assert blocks * per >= d > (blocks - 1) * per
    if route == "mma":
        assert per % sign_sim.DENSE_K == 0      # whole k-steps a block
        assert blocks <= sign_sim.dense_blocks_per_sm(t) * sms
    else:
        assert per == 4 * sign_sim.sign_words_per_block(t)
    ws = sign_sim.packed_workspace(t, blocks, route)
    assert ws == (blocks * t * (t + 1) // 2 if route == "mma" else t * t)


def test_dense_routes():
    assert sign_sim.dense_plan(30, 1_327_140) == (263, 5056, "mma")
    assert sign_sim.dense_plan(30, 1_327_140, route="dp4a")[2] == "dp4a"
    assert sign_sim.dense_plan(64, 100)[2] == "mma"
    assert sign_sim.dense_plan(65, 100)[2] == "dp4a"
    with pytest.raises(ValueError, match="T <= 64"):
        sign_sim.dense_plan(65, 100, route="mma")
    with pytest.raises(ValueError, match="unknown route"):
        sign_sim.dense_plan(30, 100, route="popc")


@pytest.mark.parametrize("t", range(1, 65))
def test_dense_smem_and_workspace_budgets(t):
    """The warps' fragments fit the blocks a SM (the dynamic opt-in above
    48 KB for T > 32); the accumulators of one block's threads fit its
    share of the registers; the workspace holds one partial a pair and
    block, the first design's the (T, T) sums."""
    mt = 1 if t <= 16 else 2 if t <= 32 else 4
    per_sm = sign_sim.dense_blocks_per_sm(t)
    smem = sign_sim.dense_smem(t)
    assert smem == 8 * mt * (mt + 1) * 128 * 4
    assert smem <= (48 * 1024 if t <= 32 else SMEM_PER_BLOCK)
    assert per_sm * (smem + 1024) <= SMEM_PER_SM
    # int32 accumulators (4 a tile) and the fragments (4 a row tile)
    assert mt * (mt + 1) * 4 + 4 * mt <= REGS_PER_SM // (per_sm * THREADS)
    blocks, _, route = sign_sim.dense_plan(t, 1_327_140)
    assert route == "mma"
    assert sign_sim.packed_workspace(t, blocks, route) * 4 < 2 ** 31
    assert 4 * t * (sign_sim.sign_words_per_block(t) + 1) <= 48 * 1024


# -- kernel 6's int8 form, emulated ------------------------------------------

LANE = torch.arange(32)
G, TIG = LANE >> 2, LANE & 3


def sign_register(v4):
    """``sign_bytes`` of csrc/sign_sim.cu: (..., 4) fp32 -> (...,) int64
    holding the 4 int8 signs (v > 0) - (v < 0), byte c from value c."""
    s = (v4 > 0).long() - (v4 < 0).long()
    return sum((s[..., c] & 0xFF) << (8 * c) for c in range(4))


def register_bytes(reg):
    """(...,) int64 holding 4 bytes -> (..., 4) int8 values, byte 0 first."""
    out = torch.stack([(reg >> (8 * c)) & 0xFF for c in range(4)], -1)
    return torch.where(out >= 128, out - 256, out)


def a_fragments(xb, mt_n):
    """The A-fragment registers of a block's coordinates ``xb`` (rows,
    K) fp32, K a multiple of 32, the task rows zero-padded to 16 * MT:
    (steps, MT, 32 lanes, 4).  Register h of task tile mt at lane (g,
    tig) holds row 16 mt + g + 8 (h & 1), k columns 32 s + 4 tig +
    16 (h >> 1) + 0..3 -- 4 consecutive fp32 values, one 16-byte load."""
    steps = xb.shape[1] // 32
    regs = torch.zeros((steps, mt_n, 32, 4), dtype=torch.int64)
    k = 32 * torch.arange(steps)[:, None, None]
    for mt in range(mt_n):
        for h in range(4):
            rows = (16 * mt + G + 8 * (h & 1))[None, :, None]
            cols = k + (4 * TIG + 16 * (h >> 1))[None, :, None] + \
                torch.arange(4)[None, None, :]
            regs[:, mt, :, h] = sign_register(xb[rows, cols])
    return regs


def mma_s8(a, b0, b1):
    """mma.sync.m16n8k32.row.col.s32.s8.s8.s32 over every k-step, summed:
    a (steps, 32, 4) A registers, b0 / b1 (steps, 32) B registers ->
    (32 lanes, 4) int64 accumulators, from the PTX fragment layouts
    (A[g + 8 (h & 1), 4 tig + 16 (h >> 1) + c] in a[h], byte c;
    B[4 tig + 16 h + c, g] in b_h, byte c; C[g + 8 (q >> 1),
    2 tig + (q & 1)] in register q)."""
    steps = a.shape[0]
    A = torch.zeros((steps, 16, 32), dtype=torch.int64)
    B = torch.zeros((steps, 32, 8), dtype=torch.int64)
    c4 = torch.arange(4)
    for h in range(4):
        rows = (G + 8 * (h & 1))[:, None].expand(32, 4)
        cols = (4 * TIG + 16 * (h >> 1))[:, None] + c4
        A[:, rows, cols] = register_bytes(a[:, :, h])
    for h, b in enumerate((b0, b1)):
        ks = (4 * TIG + 16 * h)[:, None] + c4
        B[:, ks, G[:, None].expand(32, 4)] = register_bytes(b)
    D = (A @ B).sum(0)
    return torch.stack([D[G + 8 * (q >> 1), 2 * TIG + (q & 1)]
                        for q in range(4)], -1)


def block_partials(xb, t):
    """One block's partial of every pair (a <= b < T) as its warps give
    it: the Gram product of the upper-triangle 16 x 8 tiles (column tile
    nt >= 2 * row tile mt), B fragment of columns 8 nt.. = registers
    nt % 2 and nt % 2 + 2 of task tile nt // 2, and the epilogue's map
    from (tile, register, lane) to (row, col)."""
    mt_n = 1 if t <= 16 else 2 if t <= 32 else 4
    rows = 16 * mt_n
    k = -(-xb.shape[1] // 32) * 32
    pad = torch.zeros((rows, k), dtype=torch.float32)
    pad[:t, :xb.shape[1]] = xb
    fa = a_fragments(pad, mt_n)
    out = torch.zeros((t, t), dtype=torch.int64)
    for mt in range(mt_n):
        for nt in range(2 * mt, 2 * mt_n):
            acc = mma_s8(fa[:, mt], fa[:, nt // 2, :, nt % 2],
                         fa[:, nt // 2, :, nt % 2 + 2])
            for q in range(4):
                r = 16 * mt + G + 8 * (q >> 1)
                c = 8 * nt + 2 * TIG + (q & 1)
                keep = (r <= c) & (c < t)
                out[r[keep], c[keep]] += acc[keep, q]
    return out


def emulate_dots(x, sms):
    """Kernel 6's tensor-core route: each block's partials over its
    coordinate range, summed over the blocks (int32 exact), mirrored."""
    t, d = x.shape
    blocks, per, route = sign_sim.dense_plan(t, d, sms)
    assert route == "mma"
    total = sum(block_partials(x[:, b * per:(b + 1) * per], t)
                for b in range(blocks))
    assert total.abs().max() < 2 ** 31
    return total + torch.triu(total, 1).T


def emulate_sim(dots, d):
    """The sum kernel's S epilogue: 0.5 * (dots * fl32(1/d) + 1), one fp32
    rounding a product and an add (the halving is exact)."""
    v = dots.numpy().astype(np.float32)
    r = np.float32(sign_sim.reciprocal(d))
    return np.float32(0.5) * (v * r + np.float32(1.0))


def xla_sim(dots, d):
    """S as XLA computes it inside ``jit`` (tests/test_torch_bool_round.py):
    fma(dots, fl(1/d), 1) * 0.5, one rounding."""
    r = np.float64(np.float32(1.0 / d))
    return np.float32(dots.astype(np.float64) * r + 1.0) * np.float32(0.5)


def dense_input(t, d):
    """(T, d) fp32 with zeros, negative zeros and (for T > 1) an all-zero
    row."""
    rng = np.random.default_rng(31 * t + d)
    x = rng.standard_normal((t, d)).astype(np.float32)
    x[np.abs(x) < 0.3] = 0.0
    x[rng.random((t, d)) < 0.1] = -0.0
    if t > 1:
        x[t // 2] = 0.0
    return x


@pytest.mark.parametrize("t", [1, 16, 17, 30, 64])
@pytest.mark.parametrize("d", [1, 31, 33, 4100])
def test_dense_int8_form_equals_plain_and_jax(t, d):
    """The emulated tensor-core dots are bitwise the plain version's
    ``sgn @ sgn.T`` (its S, normalised on the CPU, bitwise
    ``sign_sim_ref``'s) and the JAX Pallas kernel's (its S is XLA's
    normalisation of exactly these dots); the S epilogue stays within 1
    ulp of JAX's eager S."""
    x = dense_input(t, d)
    tx = torch.from_numpy(x)
    dots = emulate_dots(tx, sms=2)
    s = torch.sign(tx)
    assert torch.equal(dots, (s @ s.T).long())
    assert torch.equal(ref.sim_from_dots(dots, d), sign_sim.plain_dense(tx))
    pallas = np.asarray(sign_sim_pallas(jnp.asarray(x), interpret=True))
    assert np.array_equal(xla_sim(dots.numpy(), d), pallas)
    eager = np.asarray(jref.sign_sim_ref(jnp.asarray(x)))
    sim = emulate_sim(dots, d)
    ulp = np.abs(sim.view(np.int32).astype(np.int64)
                 - eager.view(np.int32).astype(np.int64))
    assert ulp.max() <= 1


def test_sign_register_takes_the_first_designs_signs():
    """+1, -1 and 0 (for +0.0 and -0.0) a byte, byte c from value c."""
    v = torch.tensor([[1.5, -2.0, 0.0, -0.0], [-1e-30, 3e38, -0.0, 1e-45]])
    got = register_bytes(sign_register(v))
    assert torch.equal(got, torch.tensor([[1, -1, 0, 0], [-1, 1, 0, 1]]))


@pytest.mark.parametrize("d", [1, 1_327_140, 3_588_168, 12_058_464])
def test_reciprocal_is_the_fp32_one(d):
    """fl32(1 / fl32(d)), the factor torch's division by a Python scalar
    takes on the card, exact in the float that ctypes passes."""
    r = sign_sim.reciprocal(d)
    assert r == float(np.float32(r))
    assert np.float32(r) == np.float32(1.0) / np.float32(d)


# -- kernel 8: member list, tiles, sums and the m_hat table -------------------

def member_list(gammas, lams):
    """``masked_agg_lists_kernel`` at T = 1 with membership from gamma:
    the workspace row of :func:`masked_agg.single_workspace` words --
    count, N_t = max(count, 1) as fp32 bits, then {n, 1.0, fl32(gamma *
    lambda), 0} a member in ascending n (a ballot over 32 rows at a
    time), zero entries after them."""
    n = len(gammas)
    ws = np.zeros(masked_agg.single_workspace(n), dtype=np.int32)
    count = 0
    for n0 in range(0, n, 32):
        for lane in range(32):
            i = n0 + lane
            if i < n and gammas[i] > 0:
                e = 4 + 4 * count
                ws[e] = i
                ws[e + 1] = np.float32(1.0).view(np.int32)
                ws[e + 2] = (np.float32(gammas[i]) * np.float32(lams[i])
                             ).view(np.int32)
                count += 1
    n_t = np.float32(0.0)
    for _ in range(count):
        n_t = np.float32(n_t + np.float32(1.0))
    ws[0] = count
    ws[1] = np.maximum(n_t, np.float32(1.0)).view(np.int32)
    return ws


def single_inputs(seed, n, d, n_mem=None, u_dtype=torch.float32):
    """One task: unified rows with zeros, masks 0.7 dense, lambda, and
    gamma > 0 on ``n_mem`` random rows (all when None), zero on the rest
    (which keep their masks)."""
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((n, d)).astype(np.float32)
    u[rng.random((n, d)) < 0.1] = 0.0
    masks = rng.random((n, d)) < 0.7
    lams = (rng.random(n) + 0.5).astype(np.float32)
    sizes = rng.integers(10, 200, n).astype(np.float32)
    if n_mem is not None:
        sizes[rng.permutation(n)[n_mem:]] = 0.0
    gam = (sizes / max(sizes.sum(), 1.0)).astype(np.float32)
    return (torch.from_numpy(u).to(u_dtype), torch.from_numpy(masks),
            torch.from_numpy(lams), torch.from_numpy(gam))


@pytest.mark.parametrize("n,n_mem", [(1, 1), (1, 0), (32, 9), (33, 33),
                                     (70, 5), (4000, 123), (5, 0)])
def test_single_member_list_from_gamma(n, n_mem):
    """Ascending rows with gamma > 0 (no gamma = 0 or negative row), each
    weight 1 and gamma * lambda rounded once; N_t = max(count, 1), no
    member at all included; zero entries after the members, within the
    workspace the wrapper allocates."""
    _, _, lams, gam = single_inputs(n + n_mem, n, 1, n_mem)
    gam = gam.numpy().copy()
    if n > 2 and n_mem < n:
        gam[np.flatnonzero(gam == 0)[0]] = -0.25    # a negative gamma too
    ws = member_list(gam, lams.numpy())
    count = int(ws[0])
    want = np.flatnonzero(gam > 0)
    assert count == len(want) == n_mem
    e = ws[4:4 + 4 * count].reshape(count, 4)
    assert np.array_equal(e[:, 0], want)
    assert (np.diff(e[:, 0]) > 0).all()
    assert (e[:, 1].view(np.float32) == 1.0).all()
    assert np.array_equal(e[:, 2].view(np.float32),
                          gam[want] * lams.numpy()[want])
    assert ws[1:2].view(np.float32)[0] == max(count, 1)
    assert not ws[4 + 4 * count:].any()
    assert ws.size == 4 + 4 * max(n, 4)


def raw_bf16_words(u):
    """bf16 values as the kernel's raw words: values 2i, 2i + 1 in the low
    and high halves of word i."""
    h = u.view(torch.int16).long() & 0xFFFF
    return h[..., 0::2] | (h[..., 1::2] << 16)


def test_single_raw_loads_decode():
    """``raw_f32`` of csrc/masked_agg.cu: a bf16 pair word gives value 2i
    as word << 16 and 2i + 1 as word & 0xffff0000, exactly the bf16
    values; ``raw_bits`` of fp32 / bf16 {0, 1} masks: bit c iff value c
    is not 0 (-0.0 included as 0)."""
    rng = np.random.default_rng(3)
    u = torch.from_numpy(rng.standard_normal((5, 8)).astype(np.float32)).to(
        torch.bfloat16)
    w = raw_bf16_words(u)
    lo = (w << 16) & 0xFFFFFFFF
    hi = w & 0xFFFF0000
    dec = torch.stack([lo, hi], -1).reshape(5, 8).to(torch.int64)
    dec = torch.from_numpy(dec.numpy().astype(np.uint32).view(np.float32))
    assert torch.equal(dec, u.float())
    m = torch.tensor([[1.0, 0.0, -0.0, 1.0, 0.0, 1.0, 1.0, 0.0]])
    for dt in (torch.float32, torch.bfloat16):
        bits = sum(int(m.to(dt).float()[0, c] != 0) << c for c in range(8))
        assert bits == 0b01101001


@pytest.mark.parametrize("d,sms", [(1, 132), (7, 1), (2048, 1), (2049, 1),
                                   (20_000, 2), (3_588_168, 132)])
def test_single_tiles_cover_every_coordinate_once(d, sms):
    """Persistent blocks walk tiles of 2048 coordinates, a thread 8
    consecutive ones: each coordinate is summed and written by exactly one
    thread of one block."""
    grid = masked_agg.single_grid(d, sms)
    tiles = -(-d // masked_agg.SINGLE_TILE)
    assert 1 <= grid <= min(tiles, masked_agg.SINGLE_BLOCKS_PER_SM * sms)
    assert masked_agg.SINGLE_TILE == 8 * THREADS
    hits = np.zeros(d, dtype=np.int32)
    for blk in range(grid):
        for tl in range(blk, tiles, grid):
            j = tl * masked_agg.SINGLE_TILE + 8 * np.arange(THREADS)
            for c in range(8):
                jc = j + c
                np.add.at(hits, jc[jc < d], 1)
    assert (hits == 1).all()


def emulate_single(u, masks, lams, gammas, rho):
    """Kernel 8's arithmetic: the member list, then for every coordinate
    the sums over the member rows in list order (votes += sp - sn, acc +=
    fl32(gamma * lambda) * (u * (sp + sn)), one fp32 rounding each), m_hat
    from the table of v / N_t over the vote counts v <= count, and
    tau_hat = acc * m_hat.  Returns (tau_hat, m_hat, the table)."""
    ws = member_list(gammas.numpy(), lams.numpy())
    count = int(ws[0])
    n_t = torch.tensor(ws[1:2].view(np.float32))
    alpha = torch.arange(count + 1, dtype=torch.float32) / n_t
    table = torch.where(alpha >= rho, 1.0, alpha)
    d = u.shape[1]
    votes = torch.zeros(d)
    acc = torch.zeros(d)
    for k in range(count):
        n = int(ws[4 + 4 * k])
        gl = torch.tensor(ws[6 + 4 * k:7 + 4 * k].view(np.float32))
        x = u[n].float()
        set_ = masks[n] != 0
        sp = (set_ & (x > 0)).float()
        sn = (set_ & (x < 0)).float()
        votes = votes + (sp - sn)
        acc = acc + gl * (x * (sp + sn))
    a_num = votes.abs()
    m_hat = table[a_num.long()]
    return acc * m_hat, m_hat, table


@pytest.mark.parametrize("mask_dtype", [torch.bool, torch.float32,
                                        torch.bfloat16])
@pytest.mark.parametrize("u_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,n_mem,d", [(1, 1, 7), (32, 9, 4100),
                                       (12, 0, 33), (40, 40, 300)])
def test_single_emulated_sums_equal_plain(n, n_mem, d, u_dtype, mask_dtype):
    """The emulated member-row sums and m_hat table are bitwise the plain
    version; the table is the per-value division it replaces."""
    u, masks, lams, gam = single_inputs(n * d + n_mem, n, d, n_mem, u_dtype)
    masks = masks.to(mask_dtype)
    tau, m_hat, table = emulate_single(u, masks, lams, gam, 0.4)
    want = masked_agg.plain_single(u, masks, lams, gam, 0.4)
    assert torch.equal(tau, want[0]) and torch.equal(m_hat, want[1])
    n_t = max(int((gam > 0).sum()), 1)
    alpha = torch.arange(len(table), dtype=torch.float32) / float(n_t)
    assert torch.equal(table, torch.where(alpha >= 0.4, 1.0, alpha))


@pytest.mark.parametrize("n,n_mem,d", [(9, 4, 300), (32, 9, 2100)])
def test_single_emulated_sums_match_jax_pallas(n, n_mem, d):
    """Against the JAX Pallas kernel in interpret mode: m_hat bitwise,
    tau_hat at the serving tests' bar."""
    u, masks, lams, gam = single_inputs(7 * n + d, n, d, n_mem)
    tau, m_hat, _ = emulate_single(u, masks, lams, gam, 0.4)
    jt, jm = masked_agg_pallas(jnp.asarray(u.numpy()),
                               jnp.asarray(masks.numpy()),
                               jnp.asarray(lams.numpy()),
                               jnp.asarray(gam.numpy()), rho=0.4,
                               interpret=True)
    np.testing.assert_array_equal(m_hat.numpy(), np.asarray(jm))
    np.testing.assert_allclose(tau.numpy(), np.asarray(jt), rtol=RTOL,
                               atol=ATOL)
