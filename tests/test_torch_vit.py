"""The port's ViT family and its federated path against the JAX package,
on the CPU: ``ViT.features`` with carried weights, the ViT-B/32 layout
manifest and fingerprint (reduced and at full width), ``ArchBackbone``
features for every zoo family, the loss, gradient and one AdamW step of
``ViTBackbone``, the local trainer over several steps, and a mixed
{lm, vit} ``FedSimulator`` round (per-client backbones)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.common.tree import TaskVectorSpace as JSpace  # noqa: E402
from repro.configs import vit_b32 as j_vit  # noqa: E402
from repro.fed.local import make_local_trainer as j_trainer  # noqa: E402
from repro.fed.testbed import ArchBackbone as JArch  # noqa: E402
from repro.optim import adamw as j_adamw  # noqa: E402
from repro_torch.common.tree import (TaskVectorLayoutError,  # noqa: E402
                                     TaskVectorSpace, tree_map)
from repro_torch.configs import vit_b32  # noqa: E402
from repro_torch.configs.base import (ZOO_FAMILIES,  # noqa: E402
                                      check_lora_targets, lora_targets_for)
from repro_torch.data.dirichlet import FedSplit  # noqa: E402
from repro_torch.data.synthetic import make_constellation  # noqa: E402
from repro_torch.fed.local import cross_entropy, make_local_trainer  # noqa
from repro_torch.fed.simulator import FedConfig, FedSimulator  # noqa: E402
from repro_torch.fed.strategies import (MaTUStrategy, RoundBatch,  # noqa
                                        Upload)
from repro_torch.fed.testbed import (D_BOUNDARY, ArchBackbone,  # noqa: E402
                                     ViTBackbone, make_zoo_backbones,
                                     round_up_d)
from repro_torch.optim import adamw  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

RTOL, ATOL = 1e-5, 1e-6          # one fp32 forward
# the lm-kind families run 2-4 fp32 layers (attention, MoE, xLSTM
# recurrences) whose sums both packages order their own way
DEEP_RTOL, DEEP_ATOL = 1e-4, 1e-5
FEAT = 32                        # == reduced vit patch_dim
FULL_D, FULL_FP = 1_327_140, "8193ac2a083e3e4f"
REDUCED_D, REDUCED_FP = 3_590, "bc4eab9e1f6b052d"


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def carried(arch, feat_dim=None, seed=3):
    """(JAX backbone, port backbone with its weights carried across)."""
    jbb = JArch(arch, feat_dim=feat_dim, seed=seed)
    tbb = ArchBackbone.from_numpy(
        arch, to_np(jbb.params), to_np(jbb.lora0),
        None if jbb.kind == "vit" else np.asarray(jbb.in_proj),
        feat_dim=feat_dim, device="cpu")
    return jbb, tbb


@pytest.fixture(scope="module")
def vit_pair():
    return carried("vit_b32")


def _delta(bb, seed, scale=0.1):
    rng = np.random.default_rng(seed)
    return (scale * rng.standard_normal(bb.d)).astype(np.float32)


# -- the model ---------------------------------------------------------------

@pytest.mark.parametrize("with_lora", [False, True])
def test_vit_features_match_jax(vit_pair, with_lora):
    jbb, tbb = vit_pair
    cfg = j_vit.reduced_vit()
    rng = np.random.default_rng(1)
    patches = rng.standard_normal((5, cfg.n_patches, cfg.patch_dim)
                                  ).astype(np.float32)
    tv = _delta(jbb, 2)
    jl = jax.tree_util.tree_map(jnp.add, jbb.lora0,
                                jbb.space.unflatten(jnp.asarray(tv))) \
        if with_lora else None
    tl = tree_map(torch.add, tbb.lora0,
                  tbb.space.unflatten(torch.from_numpy(tv))) \
        if with_lora else None
    want = np.asarray(jbb.model.features(jbb.params, jnp.asarray(patches),
                                         lora=jl))
    got = tbb.model.features(tbb.params, torch.from_numpy(patches),
                             lora=tl).numpy()
    assert got.shape == (5, cfg.d_model)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("form", ["patch", "flat"])
def test_vit_backbone_input_forms_match_jax(vit_pair, form):
    """x patch-sized (B, patch_dim), tiled across the patches, or flat
    (B, n_patches * patch_dim)."""
    jbb, tbb = vit_pair
    cfg = tbb.cfg
    width = cfg.patch_dim if form == "patch" else cfg.patch_dim * \
        cfg.n_patches
    x = np.random.default_rng(3).standard_normal((6, width)).astype(
        np.float32)
    tv = _delta(jbb, 4)
    want = np.asarray(jbb.features(jnp.asarray(tv), jnp.asarray(x)))
    got = tbb.features(torch.from_numpy(tv), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("full", [False, True])
def test_vit_manifest_and_fingerprint_match_jax(full):
    """Leaf order, d and fingerprint of the LoRA tree, reduced and at
    full width (the LoRA tree alone: the 87 M base is never built)."""
    jcfg = j_vit.CONFIG if full else j_vit.reduced_vit()
    tcfg = vit_b32.CONFIG if full else vit_b32.reduced_vit()
    assert tcfg == vit_b32.ViTConfig(**jcfg.__dict__)
    jl = j_vit.build(jcfg).lora_init(jax.random.PRNGKey(1), jcfg.lora_rank)
    js = JSpace.from_tree(jl)
    tl = vit_b32.build(tcfg, device="cpu").lora_init(None, tcfg.lora_rank,
                                                     device="meta")
    ts = TaskVectorSpace.from_tree(tl)
    assert ts.manifest_text() == js.manifest_text()
    want = (FULL_D, FULL_FP) if full else (REDUCED_D, REDUCED_FP)
    assert (ts.d, ts.fingerprint) == (js.d, js.fingerprint) == want
    assert [l.path for l in ts.leaves][:3] == [
        "blocks/attn/wo/a", "blocks/attn/wo/alpha", "blocks/attn/wo/b"]
    check_lora_targets(lora_targets_for(tcfg),
                       [l.path for l in ts.leaves])
    assert vit_b32.build(tcfg, device="cpu").init(
        device="meta")["blocks"]["attn"]["wq"]["w"].shape == (
            tcfg.n_layers, tcfg.d_model, tcfg.d_model)


def test_vit_backbone_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ViTBackbone()


# -- every zoo family ----------------------------------------------------------

@pytest.mark.parametrize("family", sorted(ZOO_FAMILIES))
def test_arch_backbone_features_match_jax(family):
    arch = ZOO_FAMILIES[family]
    jbb, tbb = carried(arch, None if family == "vit" else FEAT)
    assert (tbb.d, tbb.fingerprint, tbb.split_point, tbb.feat_out) == (
        jbb.d, jbb.fingerprint, jbb.split_point, jbb.feat_out)
    assert tbb.kind == jbb.kind
    x = np.random.default_rng(5).standard_normal((4, FEAT)).astype(
        np.float32)
    tv = _delta(jbb, 6)
    want = np.asarray(jbb.features(jnp.asarray(tv), jnp.asarray(x)))
    got = tbb.features(torch.from_numpy(tv), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=DEEP_RTOL, atol=DEEP_ATOL)


def test_zoo_backbones_build_and_refuse_a_wrong_patch_width():
    zoo = make_zoo_backbones(FEAT, ["lm", "vit"], device="cpu")
    assert set(zoo) == {"lm", "vit"}
    assert len({b.fingerprint for b in zoo.values()}) == 2
    again = ArchBackbone(ZOO_FAMILIES["lm"], FEAT, seed=7, device="cpu")
    assert again.fingerprint == zoo["lm"].fingerprint   # seed-independent
    with pytest.raises(ValueError, match="patch_dim"):
        make_zoo_backbones(FEAT + 1, ["vit"], device="cpu")
    with pytest.raises(ValueError, match="feat_dim is required"):
        ArchBackbone(ZOO_FAMILIES["lm"], device="cpu")


# -- training ------------------------------------------------------------------

def test_vit_loss_gradient_and_one_adamw_step_match(vit_pair):
    jbb, tbb = vit_pair
    rng = np.random.default_rng(7)
    tv = _delta(jbb, 8)
    head = (0.1 * rng.standard_normal((tbb.feat_out, 5))).astype(np.float32)
    x = rng.standard_normal((12, FEAT)).astype(np.float32)
    y = rng.integers(0, 5, 12)

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
    t_flat = tbb.space.flatten(tree_map(lambda p: p.grad, t_params[0]))
    j_flat = np.asarray(jbb.space.flatten(j_grads[0]))
    assert np.count_nonzero(j_flat) > 0.9 * j_flat.size
    # gradients: rel L2 over the whole vector, and elementwise
    np.testing.assert_allclose(
        np.linalg.norm(t_flat.numpy() - j_flat) / np.linalg.norm(j_flat), 0,
        atol=1e-5)
    np.testing.assert_allclose(t_flat.numpy(), j_flat, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(t_params[1].grad.numpy(),
                               np.asarray(j_grads[1]), rtol=1e-4, atol=ATOL)

    jo = j_adamw(1e-2)
    j_new, _ = jo.update(j_grads, jo.init(j_params), j_params)
    to = adamw(1e-2)
    t_plain = (tree_map(lambda p: p.detach(), t_params[0]),
               t_params[1].detach())
    t_grads = (tbb.space.unflatten(torch.from_numpy(j_flat.copy())),
               torch.from_numpy(np.array(j_grads[1])))
    t_new, _ = to.update(t_grads, to.init(t_plain), t_plain)
    np.testing.assert_allclose(tbb.space.flatten(t_new[0]).numpy(),
                               np.asarray(jbb.space.flatten(j_new[0])),
                               rtol=RTOL, atol=1e-7)
    np.testing.assert_allclose(t_new[1].numpy(), np.asarray(j_new[1]),
                               rtol=RTOL, atol=1e-7)


def test_vit_local_trainer_matches_jax_on_one_row(vit_pair):
    """Five AdamW steps of ``make_local_trainer`` on a dataset of one row:
    every minibatch index is 0 on both sides (the packages draw their
    indices from different generators).  The row is flat (distinct
    patches): tiled patches make some gradient coordinates cancel to
    ~1e-9, where AdamW's normalised step turns fp32 rounding into a
    percent of lr."""
    jbb, tbb = vit_pair
    rng = np.random.default_rng(9)
    cfg = tbb.cfg
    x = rng.standard_normal((1, cfg.n_patches * cfg.patch_dim)).astype(
        np.float32)
    y = np.array([2])
    head = (0.01 * rng.standard_normal((tbb.feat_out, 4))).astype(np.float32)
    tv0 = _delta(jbb, 10, scale=0.01)
    kw = dict(steps=5, batch_size=4, lr=1e-2)
    j_tv, j_head, j_loss = j_trainer(jbb, **kw)(
        jnp.asarray(tv0), jnp.asarray(head), jnp.asarray(x), jnp.asarray(y),
        jax.random.PRNGKey(0))
    t_tv, t_head, t_loss = make_local_trainer(tbb, **kw)(
        torch.from_numpy(tv0), torch.from_numpy(head), torch.from_numpy(x),
        torch.from_numpy(y), torch.Generator().manual_seed(0))
    j_tv, j_head = np.asarray(j_tv), np.asarray(j_head)
    assert (np.abs(j_tv - tv0) > 0).mean() > 0.9       # training moved it
    np.testing.assert_allclose(float(t_loss), float(j_loss), rtol=1e-5)
    # each coordinate within 1e-3 · lr, the vectors within rel L2 1e-5
    for got, want in ((t_tv.numpy(), j_tv), (t_head.numpy(), j_head)):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        assert np.linalg.norm(got - want) / np.linalg.norm(want) < 1e-5


# -- a mixed {lm, vit} round ------------------------------------------------

@pytest.fixture(scope="module")
def lm_vit():
    return make_zoo_backbones(FEAT, ["lm", "vit"], device="cpu")


def test_mixed_simulator_pads_to_the_common_d(lm_vit):
    n_tasks = 4
    con = make_constellation(n_tasks=n_tasks, n_groups=2, feat_dim=FEAT,
                             n_classes=4, seed=5)
    split = FedSplit([[t] for t in range(n_tasks)],
                     {(c, c): None for c in range(n_tasks)},
                     {(c, c): 16 for c in range(n_tasks)})
    fams = ["lm", "vit"]
    bbs = [lm_vit[fams[c % 2]] for c in range(n_tasks)]
    d = round_up_d(max(b.d for b in bbs))
    assert d == round_up_d(lm_vit["lm"].d) and d % D_BOUNDARY == 0
    strat = MaTUStrategy(n_tasks, d, device="cpu")
    cfg = FedConfig(rounds=1, local_steps=2, batch_size=8, local_data=16,
                    eval_every=1, seed=0)
    sim = FedSimulator(cfg, con, split, bbs, strat, device="cpu")
    assert sim.d == d
    assert strat.expected_layouts == {t: bbs[t].fingerprint
                                      for t in range(n_tasks)}
    batches = []
    inner = strat.aggregate_batch
    strat.aggregate_batch = lambda b: (batches.append(b), inner(b))
    hist = sim.run()
    (batch,) = batches
    for u in batch.uploads:
        bb = bbs[u.client_id]
        assert u.fingerprint == bb.fingerprint
        assert u.task_vectors.shape == (1, d)
        assert torch.count_nonzero(u.task_vectors[0, :bb.d]) > 0
        assert not torch.any(u.task_vectors[0, bb.d:])
    assert len(hist.task_acc[0]) == n_tasks
    # each task evaluates through its own backbone, on the prefix of the
    # common-d vector that its manifest covers
    for t in range(n_tasks):
        bb = bbs[t]
        assert sim._backbone_for_task(t) is bb
        assert sim.heads[t].shape == (bb.feat_out, con.n_classes)
        tv = strat.eval_vectors(t)[0]
        x, y = sim._eval_sets[t]
        with torch.no_grad():
            want = float(torch.mean((torch.argmax(
                bb.features(tv[:bb.d], x) @ sim.heads[t], -1) == y).float()))
        assert hist.task_acc[0][t] == want


def test_mixed_layouts_refused(lm_vit):
    con = make_constellation(n_tasks=2, n_groups=2, feat_dim=FEAT,
                             n_classes=4, seed=0)
    split = FedSplit([[0], [0]], {(0, 0): None, (1, 0): None},
                     {(0, 0): 16, (1, 0): 16})
    d = round_up_d(max(b.d for b in lm_vit.values()))
    with pytest.raises(TaskVectorLayoutError, match="different"):
        FedSimulator(FedConfig(rounds=1), con, split,
                     {0: lm_vit["lm"], 1: lm_vit["vit"]},
                     MaTUStrategy(2, d, device="cpu"), device="cpu")
    with pytest.raises(ValueError, match="missing clients"):
        FedSimulator(FedConfig(rounds=1), con, split, {0: lm_vit["lm"]},
                     MaTUStrategy(2, d, device="cpu"), device="cpu")
    # the strategy's own gate: an upload flattened through another
    # manifest than the task's is refused before aggregation
    strat = MaTUStrategy(2, d, device="cpu")
    strat.use_layouts({0: lm_vit["lm"].fingerprint})
    bad = Upload(0, [0], torch.ones((1, d)), [16],
                 fingerprint=lm_vit["vit"].fingerprint)
    with pytest.raises(TaskVectorLayoutError, match="refusing"):
        strat.aggregate_batch(RoundBatch.from_uploads([bad], 2))
    assert strat.downlinks == {}
