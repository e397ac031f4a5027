"""The port's federated side against the JAX package, on the CPU:
backbone features with the JAX backbone's weights carried across, the
loss, its gradient and one AdamW step, the layout manifest and its
fingerprint, the data splits, one ``MaTUStrategy.aggregate`` on the same
uploads, and an end-to-end quickstart run that separates related from
unrelated tasks (Eq. 5) as the JAX quickstart does."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.common.tree import TaskVectorSpace as JSpace  # noqa: E402
from repro.data.dirichlet import dirichlet_split as j_split  # noqa: E402
from repro.data.synthetic import make_constellation as j_con  # noqa: E402
from repro.fed import strategies as jstr  # noqa: E402
from repro.fed.testbed import MLPBackbone as JMLP  # noqa: E402
from repro.optim import adamw as j_adamw  # noqa: E402
from repro_torch.common.tree import TaskVectorSpace as TSpace  # noqa: E402
from repro_torch.common.tree import pad_vector, tree_map  # noqa: E402
from repro_torch.data.dirichlet import dirichlet_split  # noqa: E402
from repro_torch.data.synthetic import make_constellation  # noqa: E402
from repro_torch.fed import strategies as tstr  # noqa: E402
from repro_torch.fed.local import cross_entropy, make_local_trainer  # noqa
from repro_torch.fed.simulator import (FedConfig, FedSimulator,  # noqa: E402
                                       individual_baseline)
from repro_torch.fed.testbed import MLPBackbone, round_up_d  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

RTOL, ATOL = 1e-5, 1e-6


def to_np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def carried_backbone(feat=16, hidden=32, rank=4):
    jbb = JMLP(feat, hidden=hidden, lora_rank=rank, seed=3)
    tbb = MLPBackbone.from_numpy(np.asarray(jbb.w1), np.asarray(jbb.w2),
                                 to_np_tree(jbb.lora0))
    return jbb, tbb


def test_features_with_carried_weights_match():
    jbb, tbb = carried_backbone()
    assert tbb.d == jbb.d and tbb.fingerprint == jbb.fingerprint
    rng = np.random.default_rng(0)
    tv = (0.1 * rng.standard_normal(jbb.d)).astype(np.float32)
    x = rng.standard_normal((64, 16)).astype(np.float32)
    want = np.asarray(jbb.features(jnp.asarray(tv), jnp.asarray(x)))
    got = tbb.features(torch.from_numpy(tv), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_loss_gradient_and_one_adamw_step_match():
    jbb, tbb = carried_backbone()
    rng = np.random.default_rng(1)
    tv = (0.1 * rng.standard_normal(jbb.d)).astype(np.float32)
    head = (0.1 * rng.standard_normal((32, 5))).astype(np.float32)
    x = rng.standard_normal((48, 16)).astype(np.float32)
    y = rng.integers(0, 5, 48)

    def j_loss(params):
        logits = jbb.features_tree(params[0], jnp.asarray(x)) @ params[1]
        lse = jax.nn.logsumexp(logits, axis=-1)
        gold = jnp.take_along_axis(logits, jnp.asarray(y)[:, None], -1)[:, 0]
        return jnp.mean(lse - gold)

    j_params = (jbb.space.unflatten(jnp.asarray(tv)), jnp.asarray(head))
    j_val, j_grads = jax.value_and_grad(j_loss)(j_params)

    t_params = (tree_map(lambda p: p.clone().requires_grad_(True),
                         tbb.space.unflatten(torch.from_numpy(tv))),
                torch.from_numpy(head).requires_grad_(True))
    t_val = cross_entropy(tbb.features_tree(t_params[0], torch.from_numpy(x)),
                          t_params[1], torch.from_numpy(y))
    t_val.backward()
    np.testing.assert_allclose(t_val.item(), float(j_val), rtol=RTOL)
    np.testing.assert_allclose(
        tbb.space.flatten(tree_map(lambda p: p.grad, t_params[0])).numpy(),
        np.asarray(jbb.space.flatten(j_grads[0])), rtol=1e-4, atol=ATOL)
    np.testing.assert_allclose(t_params[1].grad.numpy(),
                               np.asarray(j_grads[1]), rtol=1e-4, atol=ATOL)

    # one AdamW step from the same gradients (the JAX ones, as numpy)
    jo = j_adamw(1e-2)
    j_new, _ = jo.update(j_grads, jo.init(j_params), j_params)
    to = adamw(1e-2)
    t_plain = (tree_map(lambda p: p.detach(), t_params[0]),
               t_params[1].detach())
    t_grads = (tbb.space.unflatten(torch.from_numpy(
        np.asarray(jbb.space.flatten(j_grads[0])))),
        torch.from_numpy(np.asarray(j_grads[1])))
    t_new, state = to.update(t_grads, to.init(t_plain), t_plain)
    assert state["step"] == 1
    np.testing.assert_allclose(tbb.space.flatten(t_new[0]).numpy(),
                               np.asarray(jbb.space.flatten(j_new[0])),
                               rtol=RTOL, atol=1e-7)
    np.testing.assert_allclose(t_new[1].numpy(), np.asarray(j_new[1]),
                               rtol=RTOL, atol=1e-7)


def test_manifest_order_and_fingerprint_match():
    rng = np.random.default_rng(2)
    tree = {"blk": [{"wq": {"b": rng.random((4, 3)), "a": rng.random((2, 4))}},
                    {"wo": {"a": rng.random((5,))}}],
            "alpha": rng.random(()), "Zed": rng.random((3, 1))}
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)
    js = JSpace.from_tree(jax.tree_util.tree_map(jnp.asarray, tree))
    ts = TSpace.from_tree(tree_map(torch.from_numpy, tree))
    assert ts.manifest_text() == js.manifest_text()
    assert ts.fingerprint == js.fingerprint and ts.d == js.d
    flat = ts.flatten(tree_map(torch.from_numpy, tree))
    assert np.array_equal(flat.numpy(), np.asarray(js.flatten(
        jax.tree_util.tree_map(jnp.asarray, tree))))
    back = ts.unflatten(pad_vector(flat, ts.d + 7))
    assert torch.equal(ts.flatten(back), flat)
    assert round_up_d(1000) == 1024 and round_up_d(1024) == 1024


def test_splits_and_constellation_match():
    kw = dict(n_clients=9, n_tasks=6, n_classes=8, zeta_t=0.5,
              tasks_per_client=2, seed=0)
    a, b = dirichlet_split(**kw), j_split(**kw)
    assert a.tasks == b.tasks and a.data_sizes == b.data_sizes
    for key in b.class_probs:
        assert np.array_equal(a.class_probs[key], b.class_probs[key])
    ck = dict(n_tasks=6, n_groups=3, feat_dim=16, n_classes=8,
              conflict_pairs=[(0, 1)], seed=0)
    for ta, tb in zip(make_constellation(**ck).tasks, j_con(**ck).tasks):
        assert ta.group == tb.group
        assert np.array_equal(ta.r, tb.r) and np.array_equal(ta.w, tb.w)


@pytest.mark.parametrize("feat_dim", [16, 64])
def test_constellation_on_a_torch_device_matches_numpy(feat_dim):
    """``make_constellation(device=)``: the QRs and products in fp64
    torch (here on the CPU) on numpy's draws.  W and the groups are
    bitwise numpy's; each R entry within 1e-6 (fp64 rounding may move
    an fp32 entry by an ulp, < 1.2e-7 for |R| < 1)."""
    ck = dict(n_tasks=6, n_groups=3, feat_dim=feat_dim, n_classes=8,
              conflict_pairs=[(0, 1)], seed=0)
    for ta, tb in zip(make_constellation(**ck, device="cpu").tasks,
                      make_constellation(**ck).tasks):
        assert ta.group == tb.group and ta.r.dtype == np.float32
        assert np.array_equal(ta.w, tb.w)
        np.testing.assert_allclose(ta.r, tb.r, rtol=0, atol=1e-6)


def test_matu_aggregate_gives_the_same_task_init():
    rng = np.random.default_rng(4)
    n_tasks, d = 5, 700
    j_ups, t_ups = [], []
    for c in range(7):
        k = int(rng.integers(1, 4))
        ts = sorted(rng.choice(n_tasks - 1, size=k, replace=False).tolist())
        tv = rng.standard_normal((k, d)).astype(np.float32)
        sizes = rng.integers(10, 300, size=k).tolist()
        j_ups.append(jstr.Upload(c, ts, jnp.asarray(tv), sizes))
        t_ups.append(tstr.Upload(c, ts, torch.from_numpy(tv), sizes))
    js = jstr.MaTUStrategy(n_tasks, d)
    tsg = tstr.MaTUStrategy(n_tasks, d, device="cpu")
    js.aggregate(j_ups)
    tsg.aggregate(t_ups)
    assert tsg.uplink_bits(t_ups) == js.uplink_bits(j_ups)
    assert tsg.downlink_bits() == js.downlink_bits()
    np.testing.assert_allclose(tsg.server.last_similarity.numpy(),
                               np.asarray(js.server.last_similarity),
                               rtol=RTOL, atol=ATOL)
    for u in t_ups:
        for t in u.task_ids:
            np.testing.assert_allclose(
                tsg.task_init(u.client_id, t).numpy(),
                np.asarray(js.task_init(u.client_id, t)), rtol=RTOL,
                atol=ATOL)
    # a client never served starts from zero
    assert not tsg.task_init(99, 0).any()


def test_fedavg_aggregate_matches():
    rng = np.random.default_rng(6)
    d = 50
    vecs = [rng.standard_normal((2, d)).astype(np.float32) for _ in range(3)]
    sizes = [[10, 20], [30, 5], [7, 7]]
    js, ts = jstr.FedAvgStrategy(3, d), tstr.FedAvgStrategy(3, d,
                                                            device="cpu")
    js.aggregate([jstr.Upload(i, [0, 1], jnp.asarray(v), s)
                  for i, (v, s) in enumerate(zip(vecs, sizes))])
    ts.aggregate([tstr.Upload(i, [0, 1], torch.from_numpy(v), s)
                  for i, (v, s) in enumerate(zip(vecs, sizes))])
    np.testing.assert_allclose(ts.eval_vectors(0)[0].numpy(),
                               np.asarray(js.eval_vectors(0)[0]), rtol=RTOL,
                               atol=ATOL)


def test_quickstart_separates_related_tasks_on_cpu():
    """The quickstart's constellation (6 tasks in 3 groups, 9 clients) for
    3 rounds of 25 local steps: the JAX quickstart shows within-group
    S 0.806 vs cross-group S 0.742 at this size; the port must separate
    them too, and learn."""
    n_tasks = 6
    con = make_constellation(n_tasks=n_tasks, n_groups=3, feat_dim=32,
                             n_classes=8, conflict_pairs=[(0, 1)], seed=0)
    split = dirichlet_split(n_clients=9, n_tasks=n_tasks, n_classes=8,
                            zeta_t=0.5, tasks_per_client=2, seed=0)
    bb = MLPBackbone(32, hidden=64, lora_rank=8)
    cfg = FedConfig(rounds=3, local_steps=25, lr=1e-2, eval_every=1, seed=0)
    strat = tstr.MaTUStrategy(n_tasks, bb.d, device="cpu")
    hist = FedSimulator(cfg, con, split, bb, strat, device="cpu").run()
    assert hist.rounds == [1, 2, 3]
    assert hist.mean_acc[-1] > hist.mean_acc[0] > 1.0 / 8
    s = strat.server.last_similarity.numpy()
    pairs = [(a, b) for a in range(n_tasks) for b in range(a + 1, n_tasks)]
    same = np.mean([s[a, b] for a, b in pairs
                    if con.group_of(a) == con.group_of(b)])
    cross = np.mean([s[a, b] for a, b in pairs
                     if con.group_of(a) != con.group_of(b)])
    assert same > cross + 0.02
    # measured wire bits: bf16 vector + packed words + λ per client
    ks = [len(ts) for ts in split.tasks]
    from repro_torch.kernels.bitpack import wire_bits
    assert hist.uplink_bits_per_round[-1] == sum(wire_bits(bb.d, k)
                                                 for k in ks)
    assert hist.downlink_bits_per_round[-1] == hist.uplink_bits_per_round[-1]


def test_individual_baseline_and_flat_trainer_run():
    con = make_constellation(n_tasks=2, n_groups=1, feat_dim=8, n_classes=3)
    bb = MLPBackbone(8, hidden=16, lora_rank=2)
    acc = individual_baseline(FedConfig(local_steps=2, local_data=32), con,
                              bb, steps_multiplier=1, device="cpu")
    assert set(acc) == {0, 1} and all(0.0 <= a <= 1.0 for a in acc.values())

    class Flat:            # a backbone without a layout manifest
        d, feat_out = bb.d, bb.feat_out
        features = bb.features
    train = make_local_trainer(Flat, steps=3, batch_size=4, lr=1e-2)
    x = torch.randn(16, 8)
    y = torch.randint(0, 3, (16,))
    tv, head, loss = train(torch.zeros(bb.d), torch.zeros(16, 3), x, y,
                           torch.Generator().manual_seed(0))
    assert tv.shape == (bb.d,) and head.shape == (16, 3)
    assert torch.isfinite(loss) and tv.abs().sum() > 0
