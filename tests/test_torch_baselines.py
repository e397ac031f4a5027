"""The paper's baselines in the port against the JAX package, on the CPU:
the merge math of ``core/baselines.py`` (FedAvg's weighted average,
TIES with its kept set bitwise, cosine similarity, MaT-FL's greedy
groups), every strategy of ``STRATEGIES`` over three scripted rounds
(``task_init``, ``eval_vectors`` and the wire bits each round), the
linearised features and the local objective with FedProx's proximal
term and NTK-FedAvg's linearisation (MLP and reduced ViT-B/32 with the
JAX weights carried across), and each strategy through
``FedSimulator``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.common.tree import tree_dot, tree_sub  # noqa: E402
from repro.core import baselines as jb  # noqa: E402
from repro.fed import strategies as jstr  # noqa: E402
from repro.fed.testbed import ArchBackbone as JArch  # noqa: E402
from repro.fed.testbed import MLPBackbone as JMLP  # noqa: E402
from repro_torch.common.tree import tree_leaves, tree_map  # noqa: E402
from repro_torch.configs.base import ZOO_FAMILIES  # noqa: E402
from repro_torch.core import baselines as tb  # noqa: E402
from repro_torch.data.dirichlet import dirichlet_split  # noqa: E402
from repro_torch.data.synthetic import make_constellation  # noqa: E402
from repro_torch.fed import strategies as tstr  # noqa: E402
from repro_torch.fed.local import local_objective  # noqa: E402
from repro_torch.fed.simulator import FedConfig, FedSimulator  # noqa: E402
from repro_torch.fed.testbed import ArchBackbone, MLPBackbone  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

RTOL, ATOL = 1e-5, 1e-6
# a loss and its gradient through a jvp and an fp32 forward: both
# packages order their sums their own way
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
STRATEGY_NAMES = ["matu", "fedavg", "fedprox", "ntk-fedavg", "ties",
                  "fedper", "mat-fl"]


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ---------------------------------------------------------------------------
# merge math
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,d", [(1, 7), (5, 300), (16, 1001)])
def test_weighted_average_matches_jax(m, d):
    rng = np.random.default_rng(m + d)
    v = rng.standard_normal((m, d)).astype(np.float32)
    w = rng.integers(1, 300, m).astype(np.float32)
    want = np.asarray(jb.weighted_average(jnp.asarray(v), jnp.asarray(w)))
    got = tb.weighted_average(torch.from_numpy(v), torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("k", [1, 2, 3, 5, 8])
def test_mean_rows_matches_jnp_mean(k):
    v = np.random.default_rng(k).standard_normal((k, 999)).astype(np.float32)
    got = tb.mean_rows(torch.from_numpy(v)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jnp.mean(jnp.asarray(v),
                                                           axis=0)))


def _ties_inputs(kind, m, d, seed):
    rng = np.random.default_rng(seed)
    if kind == "ties":
        # few magnitude levels, zeros among them: many entries tie with
        # the k-th largest, and many column sums are exactly 0
        return (rng.integers(-3, 4, (m, d)) / 4).astype(np.float32)
    return rng.standard_normal((m, d)).astype(np.float32)


@pytest.mark.parametrize("keep_frac", [0.05, 0.2, 1.0])
@pytest.mark.parametrize("kind,m,d", [("normal", 6, 1001), ("ties", 6, 1001),
                                      ("ties", 3, 33), ("normal", 1, 97)])
def test_ties_merge_and_kept_set_match_jax(keep_frac, kind, m, d):
    v = _ties_inputs(kind, m, d, seed=m * d)
    jv = jnp.asarray(v)
    keep = max(1, int(d * keep_frac))
    mags = jnp.abs(jv)
    j_trim = np.asarray(jnp.where(
        mags >= jax.lax.top_k(mags, keep)[0][:, -1:], jv, 0.0))
    t_trim = tb.ties_trim(torch.from_numpy(v), keep_frac).numpy()
    np.testing.assert_array_equal(t_trim.view(np.int32),
                                  j_trim.view(np.int32))
    assert (t_trim != 0).sum() >= min(m * keep, int((v != 0).sum()))
    want = np.asarray(jb.ties_merge(jv, keep_frac=keep_frac))
    got = tb.ties_merge(torch.from_numpy(v), keep_frac=keep_frac).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    if kind == "ties":       # quarter steps sum exactly: equal bit for bit
        np.testing.assert_array_equal(got, want)


def test_ties_merge_sign_zero_drops_and_count_clamps():
    v = np.array([[1.0, -1.0, 2.0, 0.0], [-1.0, 1.0, 2.0, 0.0]], np.float32)
    got = tb.ties_merge(torch.from_numpy(v), keep_frac=1.0).numpy()
    np.testing.assert_array_equal(got, [0.0, 0.0, 2.0, 0.0])
    np.testing.assert_array_equal(
        got, np.asarray(jb.ties_merge(jnp.asarray(v), keep_frac=1.0)))


@pytest.mark.parametrize("n,d", [(2, 5), (9, 400)])
def test_cosine_similarity_and_greedy_groups_match_jax(n, d):
    rng = np.random.default_rng(n)
    v = rng.standard_normal((n, d)).astype(np.float32)
    v[n // 2] = 0.0                      # a zero vector: the eps floor
    j_sim = np.asarray(jb.cosine_similarity_matrix(jnp.asarray(v)))
    t_sim = tb.cosine_similarity_matrix(torch.from_numpy(v)).numpy()
    np.testing.assert_allclose(t_sim, j_sim, rtol=RTOL, atol=ATOL)
    for thr in (-0.5, 0.0, 0.05):
        assert tb.greedy_group(j_sim, thr) == jb.greedy_group(j_sim, thr)
        assert tb.greedy_group(t_sim, thr) == jb.greedy_group(j_sim, thr)


def test_greedy_group_on_planted_clusters():
    sim = np.full((6, 6), -0.2)
    for g in ([0, 2, 4], [1, 3], [5]):
        for i in g:
            for j in g:
                sim[i, j] = 0.9
    assert tb.greedy_group(sim) == jb.greedy_group(sim) == [[0, 2, 4],
                                                            [1, 3], [5]]


# ---------------------------------------------------------------------------
# strategies: three scripted rounds against JAX
# ---------------------------------------------------------------------------

N_TASKS, D = 5, 700


def _strategy_pair(name):
    kw = {"split_point": 300} if name == "fedper" else {}
    return (jstr.STRATEGIES[name](N_TASKS, D, **kw),
            tstr.STRATEGIES[name](N_TASKS, D, device="cpu", **kw))


def _clients(rng, n=6):
    out = []
    for c in range(n):
        k = int(rng.integers(1, 4))
        ts = sorted(rng.choice(N_TASKS, size=k, replace=False).tolist())
        out.append((c, ts, rng.integers(10, 300, size=k).tolist()))
    return out


def _assert_vectors(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL)


def test_strategies_table_has_the_jax_keys():
    assert set(tstr.STRATEGIES) == set(jstr.STRATEGIES) - {"matu-async"}
    for name in STRATEGY_NAMES:
        j, t = _strategy_pair(name)
        assert t.name == j.name == name
        assert (t.needs_prox, t.needs_linearize) == (j.needs_prox,
                                                     j.needs_linearize)


@pytest.mark.parametrize("name", STRATEGY_NAMES)
def test_strategy_three_scripted_rounds_match_jax(name):
    """Each round every client uploads, per task, JAX's ``task_init``
    plus seeded noise (the same numpy array on both sides); after each
    aggregation ``task_init`` of every (client, task), ``eval_vectors``
    of every task and the wire bits match JAX's."""
    js, ts = _strategy_pair(name)
    rng = np.random.default_rng(17)
    clients = _clients(rng)
    for r in range(3):
        j_ups, t_ups = [], []
        for c, tasks, sizes in clients:
            base = np.stack([np.asarray(js.task_init(c, t), np.float32)
                             for t in tasks])
            for i, t in enumerate(tasks):
                np.testing.assert_allclose(ts.task_init(c, t).numpy(),
                                           base[i], rtol=RTOL, atol=ATOL)
            tv = (base + 0.1 * rng.standard_normal(base.shape)).astype(
                np.float32)
            j_ups.append(jstr.Upload(c, tasks, jnp.asarray(tv), sizes))
            t_ups.append(tstr.Upload(c, tasks, torch.from_numpy(tv), sizes))
        js.aggregate_batch(jstr.RoundBatch.from_uploads(j_ups, N_TASKS))
        ts.aggregate_batch(tstr.RoundBatch.from_uploads(t_ups, N_TASKS))
        assert ts.uplink_bits(t_ups) == js.uplink_bits(j_ups), r
        assert ts.downlink_bits() == js.downlink_bits(), r
        for t in range(N_TASKS):
            _assert_vectors(ts.eval_vectors(t), js.eval_vectors(t))
        for c, tasks, _ in clients:
            for t in tasks:
                np.testing.assert_allclose(
                    ts.task_init(c, t).numpy(), np.asarray(js.task_init(c, t)),
                    rtol=RTOL, atol=ATOL)
    # a client never served starts where the strategy starts everyone
    fresh = tstr.STRATEGIES[name](N_TASKS, D, device="cpu",
                                  **({"split_point": 300}
                                     if name == "fedper" else {}))
    assert not fresh.task_init(99, 0).any()


# ---------------------------------------------------------------------------
# linearised features, FedProx and NTK objectives against JAX's formula
# ---------------------------------------------------------------------------

def _mlp_pair():
    jbb = JMLP(16, hidden=32, lora_rank=4, seed=3)
    tbb = MLPBackbone.from_numpy(np.asarray(jbb.w1), np.asarray(jbb.w2),
                                 to_np(jbb.lora0))
    return jbb, tbb, 16


def _vit_pair():
    jbb = JArch("vit_b32", seed=3)
    tbb = ArchBackbone.from_numpy("vit_b32", to_np(jbb.params),
                                  to_np(jbb.lora0), device="cpu")
    return jbb, tbb, tbb.cfg.patch_dim


PAIRS = {"mlp": _mlp_pair, "vit": _vit_pair}


@pytest.fixture(scope="module", params=sorted(PAIRS))
def pair(request):
    return PAIRS[request.param]()


def test_lin_features_match_jax_and_equal_features_at_zero(pair):
    jbb, tbb, feat = pair
    rng = np.random.default_rng(2)
    tv = (0.1 * rng.standard_normal(jbb.d)).astype(np.float32)
    x = rng.standard_normal((8, feat)).astype(np.float32)
    want = np.asarray(jbb.lin_features(jnp.asarray(tv), jnp.asarray(x)))
    got = tbb.lin_features(torch.from_numpy(tv), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=GRAD_RTOL,
                               atol=GRAD_ATOL)
    # f(0) + J(0)·0 is the features at the pretrained point
    zero = torch.zeros(tbb.d)
    assert torch.equal(tbb.lin_features(zero, torch.from_numpy(x)),
                       tbb.features(zero, torch.from_numpy(x)))
    # linear in τ: f(2τ) − f(0) = 2 (f(τ) − f(0))
    f0 = tbb.features(zero, torch.from_numpy(x))
    got2 = tbb.lin_features(2 * torch.from_numpy(tv), torch.from_numpy(x))
    np.testing.assert_allclose((got2 - f0).numpy(),
                               2 * (got - f0).numpy(), rtol=1e-4, atol=1e-5)


def _jax_objective(jbb, prox_mu, linearize):
    """The JAX trainer's tree-path loss, written out (its loss_fn is a
    closure of ``repro.fed.local._make_tree_trainer``)."""
    def feats(delta, xb):
        if linearize:
            zero = jax.tree_util.tree_map(jnp.zeros_like, delta)
            f0, out = jax.jvp(lambda dt: jbb.features_tree(dt, xb),
                              (zero,), (delta,))
            return f0 + out
        return jbb.features_tree(delta, xb)

    def loss(params, xb, yb, anchor):
        logits = feats(params[0], xb) @ params[1]
        lse = jax.nn.logsumexp(logits, axis=-1)
        gold = jnp.take_along_axis(logits, yb[:, None], axis=-1)[:, 0]
        ce = jnp.mean(lse - gold)
        if prox_mu > 0.0:
            diff = tree_sub(params[0], anchor)
            ce = ce + 0.5 * prox_mu * tree_dot(diff, diff)
        return ce
    return loss


@pytest.mark.parametrize("prox_mu,linearize", [(0.0, False), (0.1, False),
                                                (0.0, True), (0.5, True)])
def test_local_objective_loss_and_gradient_match_jax(pair, prox_mu,
                                                     linearize):
    jbb, tbb, feat = pair
    rng = np.random.default_rng(5)
    tv = (0.05 * rng.standard_normal(jbb.d)).astype(np.float32)
    tv0 = (0.05 * rng.standard_normal(jbb.d)).astype(np.float32)
    head = (0.1 * rng.standard_normal((tbb.feat_out, 5))).astype(np.float32)
    x = rng.standard_normal((12, feat)).astype(np.float32)
    y = rng.integers(0, 5, 12)

    jloss = _jax_objective(jbb, prox_mu, linearize)
    j_params = (jbb.space.unflatten(jnp.asarray(tv)), jnp.asarray(head))
    j_val, j_grads = jax.value_and_grad(jloss)(
        j_params, jnp.asarray(x), jnp.asarray(y),
        jbb.space.unflatten(jnp.asarray(tv0)))

    loss, to_model, _ = local_objective(tbb, prox_mu=prox_mu,
                                        linearize=linearize)
    t_params = (tree_map(lambda p: p.clone().requires_grad_(True),
                         to_model(torch.from_numpy(tv))),
                torch.from_numpy(head).requires_grad_(True))
    val = loss(t_params, torch.from_numpy(x), torch.from_numpy(y),
               to_model(torch.from_numpy(tv0)))
    grads = torch.autograd.grad(val, tree_leaves(t_params))
    np.testing.assert_allclose(float(val.detach()), float(j_val),
                               rtol=GRAD_RTOL)
    j_flat = jax.tree_util.tree_leaves(j_grads)
    assert len(j_flat) == len(grads)
    for g, w in zip(grads, j_flat):
        scale = float(np.abs(np.asarray(w)).max())
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=GRAD_RTOL,
                                   atol=GRAD_RTOL * scale + GRAD_ATOL)


# the zoo's lm-kind families run 2-4 fp32 layers (attention, MoE, xLSTM
# recurrences) whose sums both packages order their own way
DEEP_RTOL, DEEP_ATOL = 1e-4, 1e-5


@pytest.mark.parametrize("family", sorted(ZOO_FAMILIES))
def test_lin_features_and_gradients_through_every_zoo_family(family):
    """Every zoo family's ``lin_features`` against JAX's (weights carried
    across), and the linearised objective's gradient (reverse over
    forward) and the plain one's through its layers: finite, and the
    delta's leaves reached.  The xLSTM family's forward used to write its
    state in place, which autograd refused."""
    arch = ZOO_FAMILIES[family]
    feat = 32
    jbb = JArch(arch, feat_dim=None if family == "vit" else feat, seed=3)
    tbb = ArchBackbone.from_numpy(
        arch, to_np(jbb.params), to_np(jbb.lora0),
        None if jbb.kind == "vit" else np.asarray(jbb.in_proj),
        feat_dim=None if family == "vit" else feat, device="cpu")
    rng = np.random.default_rng(6)
    tv = (0.05 * rng.standard_normal(jbb.d)).astype(np.float32)
    x = rng.standard_normal((3, feat)).astype(np.float32)
    want = np.asarray(jbb.lin_features(jnp.asarray(tv), jnp.asarray(x)))
    got = tbb.lin_features(torch.from_numpy(tv), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=DEEP_RTOL,
                               atol=DEEP_ATOL)
    head = torch.from_numpy((0.1 * rng.standard_normal(
        (tbb.feat_out, 3))).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 3, 3))
    for linearize in (False, True):
        loss, to_model, _ = local_objective(tbb, prox_mu=0.1,
                                            linearize=linearize)
        params = (tree_map(lambda p: p.clone().requires_grad_(True),
                           to_model(torch.from_numpy(tv))),
                  head.clone().requires_grad_(True))
        grads = torch.autograd.grad(
            loss(params, torch.from_numpy(x), y,
                 to_model(torch.zeros(tbb.d))), tree_leaves(params))
        assert all(torch.isfinite(g).all() for g in grads)
        assert sum(float(g.abs().sum()) for g in grads[:-1]) > 0


def test_flat_objective_uses_lin_features():
    """A backbone without a layout manifest trains over the flat vector;
    with ``linearize`` through its ``lin_features``."""
    _, tbb, _ = _mlp_pair()

    class Flat:
        d, feat_out = tbb.d, tbb.feat_out
        features = tbb.features

    rng = np.random.default_rng(3)
    tv = torch.from_numpy((0.1 * rng.standard_normal(tbb.d))
                          .astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((6, 16)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 4, 6))
    head = torch.from_numpy((0.1 * rng.standard_normal((32, 4)))
                            .astype(np.float32))
    flat_loss, _, _ = local_objective(Flat, prox_mu=0.2, linearize=True)
    tree_loss, to_model, _ = local_objective(tbb, prox_mu=0.2,
                                             linearize=True)
    a = flat_loss((tv, head), x, y, torch.zeros_like(tv))
    b = tree_loss((to_model(tv), head), x, y, to_model(torch.zeros_like(tv)))
    np.testing.assert_allclose(float(a), float(b), rtol=1e-5)


# ---------------------------------------------------------------------------
# every strategy through FedSimulator
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def table2_small():
    con = make_constellation(n_tasks=4, n_groups=2, feat_dim=16,
                             n_classes=4, conflict_pairs=[(0, 1)], seed=0)
    split = dirichlet_split(n_clients=4, n_tasks=4, n_classes=4, zeta_t=0.5,
                            tasks_per_client=2, zeta_c=0.1, seed=0)
    return con, split


@pytest.mark.parametrize("name", STRATEGY_NAMES)
def test_each_strategy_runs_through_the_simulator(table2_small, name):
    con, split = table2_small
    bb = MLPBackbone(16, hidden=16, lora_rank=2)
    cfg = FedConfig(rounds=2, local_steps=2, batch_size=8, local_data=16,
                    eval_every=1, seed=0)
    kw = {"split_point": bb.split_point} if name == "fedper" else {}
    strat = tstr.STRATEGIES[name](con.n_tasks, bb.d, device="cpu", **kw)
    hist = FedSimulator(cfg, con, split, bb, strat, device="cpu").run()
    assert hist.rounds == [1, 2]
    assert all(0.0 <= a <= 1.0 for acc in hist.task_acc for a in acc.values())
    ks = [len(t) for t in split.tasks]
    if name == "fedper":
        assert hist.uplink_bits_per_round == [32 * bb.split_point * sum(ks)] * 2
    elif name != "matu":
        assert hist.uplink_bits_per_round == [32 * bb.d * sum(ks)] * 2
        assert hist.downlink_bits_per_round == [0, 0]
    for t in range(con.n_tasks):
        assert all(torch.isfinite(v).all() for v in strat.eval_vectors(t))


def test_simulator_builds_prox_and_linearised_trainers(monkeypatch,
                                                        table2_small):
    """FedProx's clients get ``prox_mu`` from the config and NTK-FedAvg's
    ``linearize``; the others train plainly."""
    import repro_torch.fed.simulator as sim_mod
    seen = []
    real = sim_mod.make_local_trainer

    def spy(bb, **kw):
        seen.append((kw["prox_mu"], kw["linearize"]))
        return real(bb, **kw)

    monkeypatch.setattr(sim_mod, "make_local_trainer", spy)
    con, split = table2_small
    bb = MLPBackbone(16, hidden=16, lora_rank=2)
    cfg = FedConfig(rounds=1, local_steps=1, batch_size=4, local_data=8,
                    prox_mu=0.25)
    for name in ("fedavg", "fedprox", "ntk-fedavg"):
        FedSimulator(cfg, con, split, bb,
                     tstr.STRATEGIES[name](con.n_tasks, bb.d, device="cpu"),
                     device="cpu")
    assert seen == [(0.0, False), (0.25, False), (0.0, True)]
    assert FedConfig().prox_mu == 0.1
