"""The port's last public names against the JAX package's, on the CPU:
``core.unify.unify_with_modulators_masked``,
``data.synthetic.Constellation.oracle_similarity`` and the tree helpers
``repro_torch.common`` exports (``tree_size``, ``tree_flatten_vector``,
``tree_unflatten_vector``, ``tree_zeros_like``, ``tree_add``,
``tree_sub``, ``tree_scale``, ``tree_dot``, ``tree_norm``,
``tree_cast``).  Inputs come from numpy seeds and go to both packages.

Bars: masks, τ, the oracle matrix, flat vectors and elementwise trees
bitwise; λ to rtol 1e-5 (JAX's own test's bar: sums in another order);
``tree_dot`` / ``tree_norm`` to rtol 1e-6 (fp32 sums in another order).
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

import repro.common as jcommon  # noqa: E402
from repro.common import tree as jtree  # noqa: E402
from repro.data.synthetic import make_constellation as j_constellation  # noqa
import repro_torch.common as tcommon  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro_torch.core import unify as tunify  # noqa: E402
from repro_torch.data.synthetic import make_constellation  # noqa: E402
from repro_torch.models.convert import tensor_from_numpy  # noqa: E402

jax.config.update("jax_platform_name", "cpu")
# the module, not the function ``repro.core`` exports under its name
junify = importlib.import_module("repro.core.unify")

LAM_RTOL = 1e-5
DOT_RTOL = 1e-6


# -- unify_with_modulators_masked ------------------------------------------

MASKED_CASES = [(4, 128, [True, True, False, True]),
                (5, 300, [True, False, True, True, False]),
                (3, 4100, [False, True, False]),
                (1, 64, [True]),
                (4, 33, [False, False, False, False])]


@pytest.mark.parametrize("k,d,valid", MASKED_CASES)
@pytest.mark.parametrize("seed", [0, 8])
def test_unify_with_modulators_masked_matches_jax(k, d, valid, seed):
    rng = np.random.default_rng(seed * 100 + k)
    x = rng.standard_normal((k, d)).astype(np.float32)
    x[:, :7] = 0.0                       # all-zero columns: τ and masks 0
    v = np.asarray(valid)
    ju, jm, jl = junify.unify_with_modulators_masked(jnp.asarray(x),
                                                     jnp.asarray(v))
    tu, tm, tl = tunify.unify_with_modulators_masked(torch.from_numpy(x),
                                                     torch.from_numpy(v))
    assert tu.numpy().tobytes() == np.asarray(ju).tobytes()
    assert np.array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=LAM_RTOL)
    assert tl.dtype == torch.float32 and tm.dtype == torch.bool


@pytest.mark.parametrize("k,d,valid", MASKED_CASES[:4])
def test_unify_with_modulators_masked_equals_ragged(k, d, valid):
    """As ``tests/test_core_unify.py`` holds JAX's: the valid rows equal
    ``unify_with_modulators`` of the valid rows alone, invalid slots get
    all-False masks and λ = 0."""
    rng = np.random.default_rng(k * 7 + d)
    x = torch.from_numpy(rng.standard_normal((k, d)).astype(np.float32))
    v = torch.tensor(valid)
    tau_m, masks_m, lams_m = tunify.unify_with_modulators_masked(x, v)
    tau_r, masks_r, lams_r = tunify.unify_with_modulators(x[v])
    assert torch.equal(tau_m, tau_r)
    assert torch.equal(masks_m[v], masks_r)
    np.testing.assert_allclose(lams_m[v].numpy(), lams_r.numpy(),
                               rtol=LAM_RTOL)
    assert not bool(masks_m[~v].any())
    assert bool((lams_m[~v] == 0).all())


def test_core_exports_the_unify_names_as_jax_does():
    """Every unify name JAX's ``repro.core`` exports but ``unify``, which
    stays the port's submodule."""
    import repro.core as jcore
    names = [n for n in jcore.__all__ if n in vars(junify) and n != "unify"]
    assert "unify_with_modulators_masked" in names
    for n in names:
        assert getattr(tcore, n) is getattr(tunify, n)
    assert tcore.unify is tunify and callable(tunify.unify)


# -- Constellation.oracle_similarity ---------------------------------------

CONSTELLATIONS = {
    # examples/quickstart.py's
    "quickstart": dict(n_tasks=6, n_groups=3, feat_dim=32, n_classes=8,
                       conflict_pairs=[(0, 1)], seed=0),
    # Table 2's (benchmarks/common.py::standard_setting) and its 8-task
    # correlation test (tests/test_fed.py)
    "table2": dict(n_tasks=8, n_groups=3, feat_dim=32, n_classes=8,
                   conflict_pairs=[(0, 1)], seed=0),
    "wide": dict(n_tasks=5, n_groups=2, feat_dim=48, n_classes=4,
                 conflict_pairs=None, seed=3),
}


@pytest.mark.parametrize("name", sorted(CONSTELLATIONS))
def test_oracle_similarity_bitwise_jax(name):
    kw = CONSTELLATIONS[name]
    got = make_constellation(**kw).oracle_similarity()
    want = j_constellation(**kw).oracle_similarity()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()
    assert np.allclose(got, got.T)
    if kw["conflict_pairs"]:
        # a conflicting pair's transforms point against each other
        assert got[0, 1] < 0 < got[0, kw["n_groups"]]


# -- the tree helpers -------------------------------------------------------

def np_tree(seed):
    """A nested tree of fp32 and bf16 leaves (dict keys out of sorted
    order, a list, a scalar leaf) as numpy arrays."""
    rng = np.random.default_rng(seed)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    bf = lambda *s: f32(*s).astype(ml_dtypes.bfloat16)  # noqa: E731
    return {"units": {"mixer": {"wq": {"b": f32(2, 4, 3), "a": bf(2, 5, 4),
                                       "alpha": f32(2)}},
                      "ffn": [f32(6), bf(3, 2)]},
            "head": f32(), "embed": bf(7, 3)}


def j_of(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def t_of(tree):
    if isinstance(tree, dict):
        return {k: t_of(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [t_of(v) for v in tree]
    if tree.ndim == 0:                 # np.ascontiguousarray makes it 1-D
        return torch.from_numpy(np.array(tree))
    return tensor_from_numpy(tree)


def same_tree(got, want):
    """Leaves in canonical order, bit for bit, dtypes and shapes equal."""
    g = tcommon.tree.tree_leaves(got)
    w = jax.tree_util.tree_leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        b = np.asarray(b)
        assert str(a.dtype).removeprefix("torch.") == b.dtype.name
        assert tuple(a.shape) == b.shape
        av = a.view(torch.int16) if a.dtype == torch.bfloat16 else a
        assert av.numpy().tobytes() == b.view(
            np.int16 if b.dtype.name == "bfloat16" else b.dtype).tobytes()


def test_common_exports_jax_names():
    for n in jcommon.__all__:
        assert hasattr(tcommon, n), n
    assert tcommon.tree_cast is tcommon.tree.tree_cast


def test_tree_size_matches_jax():
    t = np_tree(0)
    assert tcommon.tree_size(t_of(t)) == jtree.tree_size(j_of(t)) == 100


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tree_flatten_vector_matches_jax(dtype):
    t = np_tree(1)
    got = tcommon.tree_flatten_vector(t_of(t), dtype=getattr(torch, dtype))
    want = jtree.tree_flatten_vector(j_of(t), dtype=getattr(jnp, dtype))
    same_tree(got, want)


def test_tree_unflatten_vector_round_trip_and_matches_jax():
    t = np_tree(2)
    tt = t_of(t)
    vec = tcommon.tree_flatten_vector(tt)
    back = tcommon.tree_unflatten_vector(vec, tt)
    same_tree(back, j_of(t))
    assert list(back) == list(tt)             # the template's key order
    rng = np.random.default_rng(3)
    v = rng.standard_normal(vec.shape[0]).astype(np.float32)
    same_tree(tcommon.tree_unflatten_vector(torch.from_numpy(v), tt),
              jtree.tree_unflatten_vector(jnp.asarray(v), j_of(t)))
    assert tcommon.tree_flatten_vector({}).shape == (0,)


def test_tree_zeros_like_matches_jax():
    t = np_tree(4)
    same_tree(tcommon.tree_zeros_like(t_of(t)),
              jtree.tree_zeros_like(j_of(t)))


@pytest.mark.parametrize("name", ["tree_add", "tree_sub"])
def test_tree_binary_ops_match_jax(name):
    a, b = np_tree(5), np_tree(6)
    same_tree(getattr(tcommon, name)(t_of(a), t_of(b)),
              getattr(jtree, name)(j_of(a), j_of(b)))


@pytest.mark.parametrize("s", [0.5, -3.0])
def test_tree_scale_matches_jax(s):
    t = np_tree(7)
    same_tree(tcommon.tree_scale(t_of(t), s), jtree.tree_scale(j_of(t), s))


def test_tree_dot_and_norm_match_jax():
    a, b = np_tree(8), np_tree(9)
    got = tcommon.tree_dot(t_of(a), t_of(b))
    want = jtree.tree_dot(j_of(a), j_of(b))
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got), float(want), rtol=DOT_RTOL)
    got_n = tcommon.tree_norm(t_of(a))
    np.testing.assert_allclose(float(got_n), float(jtree.tree_norm(j_of(a))),
                               rtol=DOT_RTOL)
    assert float(tcommon.tree_dot({}, {})) == 0.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_tree_cast_matches_jax(dtype):
    t = np_tree(10)
    got = tcommon.tree_cast(t_of(t), getattr(torch, dtype))
    assert all(x.dtype == getattr(torch, dtype)
               for x in tcommon.tree.tree_leaves(got))
    same_tree(got, jtree.tree_cast(j_of(t), getattr(jnp, dtype)))
