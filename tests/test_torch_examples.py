"""The port's three example twins against the JAX package's examples,
on the CPU (the JAX examples are loaded by path, as scripts):

* ``examples/fed_finetune_lm_torch.py``: its ``make_task_sampler`` draws
  the JAX example's tokens byte for byte; ``main`` at the reduced
  qwen2-0.5b for two rounds of one local step, with the JAX model's
  parameters and ``lora0`` carried across (``models/convert.py``), takes
  the same local steps in both rounds (loss within rtol 1e-5; after one
  AdamW step at most a 1e-3 share of each LoRA leaf off by more than
  lr / 2, the fp32 gate of the sharded-step checks: AdamW's first step
  moves an element ~lr·sign(g), so an element whose gradient rounds
  across 0 moves the other way), round 2 starting from each client's
  modulated downlink, uploads the same bits, and saves a checkpoint
  that JAX's ``load`` reads bit for bit; ``unify_with_modulators`` and
  ``MaTUServer.round`` on JAX's deltas meet JAX at the round engine's
  bar (masks bitwise, λ rtol 1e-5, task vectors rtol 1e-5 / atol 1e-6).
* ``examples/serve_decode_torch.py``: ``federated_round`` against JAX's
  on the same carried weights (task vectors at the engine's bar, masks
  bitwise); ``main`` on JAX's serving downlink carried across (the storage report equal; for each of the three
  mixes, dense-routed and fused greedy tokens equal to JAX's
  ``MultiTenantDecoder``'s; one routed-tree signature across mixes).
* ``examples/quickstart_torch.py``: ``run`` at 2 rounds of 5 steps
  (uplink bits a round equal JAX's wire accounting; S of Eq. 5); and
  the port's MaTU at ``tests/test_fed.py``'s correlation setting, whose
  sign similarity must track the constellation's oracle relatedness
  (Pearson r > 0.5, the JAX test's bar).  Training draws differ by
  design (``src/repro_torch/fed/simulator.py``), so no accuracy is
  compared number for number.
"""

import dataclasses
import functools
import importlib.util
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.ckpt import checkpoint as j_ckpt  # noqa: E402
from repro.common.tree import TaskVectorSpace as JSpace  # noqa: E402
from repro.configs.base import SHAPES as J_SHAPES  # noqa: E402
from repro.configs.base import load_arch as j_load_arch  # noqa: E402
from repro.core.client import ClientUpload as JUpload  # noqa: E402
from repro.core.server import MaTUServer as JServer  # noqa: E402
from repro.core.server import MaTUServerConfig as JServerCfg  # noqa: E402
from repro.core.unify import modulate as j_modulate  # noqa: E402
from repro.core.unify import (  # noqa: E402
    unify_with_modulators as j_unify_with_modulators)
from repro.data.dirichlet import dirichlet_split as j_split  # noqa: E402
from repro.kernels.bitpack import wire_bits as j_wire_bits  # noqa: E402
from repro.optim import adamw as j_adamw  # noqa: E402
from repro.serve import GenerationConfig as JGenCfg  # noqa: E402
from repro.serve import ModulatorStore as JStore  # noqa: E402
from repro.serve import MultiTenantDecoder as JDecoder  # noqa: E402
from repro.train.trainer import make_train_step as j_train_step  # noqa: E402
from repro_torch.configs.base import SHAPES, load_arch  # noqa: E402
from repro_torch.core.client import ClientDownlink, ClientUpload  # noqa: E402
from repro_torch.core.server import MaTUServer, MaTUServerConfig  # noqa: E402
from repro_torch.core.unify import unify_with_modulators  # noqa: E402
from repro_torch.kernels import bitpack  # noqa: E402
from repro_torch.models.convert import (lora_from_numpy,  # noqa: E402
                                        params_from_numpy)

jax.config.update("jax_platform_name", "cpu")

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples")
# the JAX serve example imports its sibling as ``fed_finetune_lm``, and
# the twins theirs as ``fed_finetune_lm_torch``
if EXAMPLES not in sys.path:
    sys.path.insert(0, EXAMPLES)

import fed_finetune_lm_torch as fed_lm  # noqa: E402
import quickstart_torch  # noqa: E402
import serve_decode_torch  # noqa: E402

LR = 5e-3                      # both fed examples' AdamW rate
LOSS_RTOL = 1e-5
FLIP_SHARE = 1e-3              # share of a leaf off by more than LR / 2
RTOL, ATOL = 1e-5, 1e-6        # the round engine's bar (fp32 sums)
N_TASKS_LM, CLIENT_TASKS = 3, [[0], [1], [2], [0, 2]]
B, S = 4, 48                   # fed_finetune_lm's --batch / --seq
FED_ROUNDS = 2


def load_jax_example(name):
    """A JAX example as a module, by path (scripts, not a package)."""
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", os.path.join(EXAMPLES, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def carried_cfg(arch_cfg, shape, jparams, jlora0):
    """A port config of ``arch_cfg``'s model whose ``build`` gives the
    port model with ``init`` / ``lora_init`` returning the JAX trees
    carried across (the twins build their model from ``cfg``)."""
    cfg = dataclasses.replace(arch_cfg)
    model = arch_cfg.build(shape, device="cpu")
    params = params_from_numpy(model, to_np(jparams))
    lora0 = lora_from_numpy(model, to_np(jlora0))
    model.init = lambda *a, **k: params
    model.lora_init = lambda *a, **k: lora0
    cfg.build = lambda *a, **k: model
    return cfg, params, lora0


# -- make_task_sampler ---------------------------------------------------------

@pytest.mark.parametrize("task", [0, 1, 2])
def test_task_sampler_matches_jax_byte_for_byte(task):
    jfed = load_jax_example("fed_finetune_lm")
    vocab = 512
    j_sample = jfed.make_task_sampler(task, vocab)
    t_sample = fed_lm.make_task_sampler(task, vocab, device="cpu")
    for call in range(3):
        jb = j_sample(jax.random.PRNGKey(call), B, S)
        tb = t_sample(B, S)
        for k in ("tokens", "labels"):
            assert tb[k].dtype == torch.int32 and tb[k].device.type == "cpu"
            assert tb[k].numpy().tobytes() == np.asarray(jb[k]).tobytes()
        assert bool((tb["labels"][:, -1] == -100).all())


# -- fed_finetune_lm: two rounds at the reduced qwen2 -------------------------

def jax_local_round(jfed_pieces, downs):
    """One round of the JAX example's clients at one local step each, by
    its pieces: a client held in ``downs`` starts each task from its
    modulated downlink.  Returns (losses, deltas, uploads)."""
    jspace, jparams, jlora0, samplers, step, opt = jfed_pieces
    losses, deltas, jups = [], [], []
    for cid, tasks in enumerate(CLIENT_TASKS):
        tvs = []
        for i, t in enumerate(tasks):
            lora = jlora0
            if cid in downs:
                dl = downs[cid]
                lora = jax.tree_util.tree_map(jnp.add, jlora0, jspace.unflatten(
                    j_modulate(dl.unified, dl.masks[i], dl.lams[i])))
            lora, state, m = step(jparams, lora, opt.init(lora),
                                  samplers[t](jax.random.PRNGKey(0), B, S))
            losses.append(float(m["loss"]))
            tvs.append(jspace.flatten(jax.tree_util.tree_map(
                jnp.subtract, lora, jlora0)))
        deltas.append(np.stack([np.asarray(v) for v in tvs]))
        uni, masks, lams = j_unify_with_modulators(jnp.stack(tvs))
        jups.append(JUpload(cid, tasks, uni, masks, lams, [B * S] * len(tasks),
                            fingerprint=jspace.fingerprint))
    return losses, deltas, jups


@functools.lru_cache(maxsize=1)
def fed_rig(workdir):
    """The JAX example's two rounds at one local step, by its pieces
    (round 2 from JAX's round-1 downlinks), and the twin's ``main`` on
    the same (carried) weights, each round's uploads recorded: the
    twin's checkpoint lands under ``workdir``."""
    jfed = load_jax_example("fed_finetune_lm")
    jcfg = j_load_arch("qwen2-0.5b").reduced()
    jm = jcfg.build(J_SHAPES["train_4k"])
    jparams = jm.init(jax.random.PRNGKey(0))
    jlora0 = jm.lora_init(jax.random.PRNGKey(1))
    jspace = JSpace.from_tree(jlora0)
    samplers = {t: jfed.make_task_sampler(t, jcfg.vocab)
                for t in range(N_TASKS_LM)}
    step, opt = j_train_step(jm, j_adamw(LR))
    step = jax.jit(step)       # the example's step, compiled once
    pieces = (jspace, jparams, jlora0, samplers, step, opt)
    jserver = JServer(JServerCfg(n_tasks=N_TASKS_LM))
    rounds, jdowns = [], {}
    for _ in range(FED_ROUNDS):
        losses, deltas, jups = jax_local_round(pieces, jdowns)
        jdowns = jserver.round(jups)
        rounds.append(dict(
            losses=losses, deltas=deltas, jups=jups, jdowns=jdowns,
            tv=np.asarray(jserver.last_task_vectors),
            sim=np.asarray(jserver.last_similarity)))

    pcfg, _params, _lora0 = carried_cfg(
        load_arch("qwen2-0.5b").reduced(), SHAPES["train_4k"], jparams,
        jlora0)
    uploads, downlinks, orig = [], [], MaTUServer.round

    def recorded(self, ups, **kw):
        uploads.append(ups)
        downlinks.append(orig(self, ups, **kw))
        return downlinks[-1]

    cwd = os.getcwd()
    os.chdir(workdir)
    MaTUServer.round = recorded
    try:
        out = fed_lm.main(["--rounds", str(FED_ROUNDS), "--local-steps", "1"],
                          cfg=pcfg, device="cpu")
    finally:
        MaTUServer.round = orig
        os.chdir(cwd)
    # round 1's JAX pieces under the names the one-round tests read
    return dict(rounds[0], jspace=jspace, rounds=rounds, out=out,
                uploads=uploads, downlinks=downlinks, workdir=workdir)


@pytest.fixture(scope="module")
def fed(tmp_path_factory):
    return fed_rig(str(tmp_path_factory.mktemp("fed_lm")))


def test_fed_lm_space_and_first_step_losses_match_jax(fed):
    out = fed["out"]
    assert out["space"].fingerprint == fed["jspace"].fingerprint
    np.testing.assert_allclose(out["task_losses"][0], fed["losses"],
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(out["losses"][0], np.mean(fed["losses"]),
                               rtol=LOSS_RTOL)
    assert len(out["step_s"]) == 5 * FED_ROUNDS
    assert len(out["round_s"]) == FED_ROUNDS


@pytest.mark.parametrize("cid", [0, 1, 2])
def test_fed_lm_one_adamw_step_matches_jax(fed, cid):
    """A single-task client's unified upload is its delta itself; each
    LoRA leaf of it against JAX's delta."""
    assert_delta_close(fed, fed["uploads"][0][cid].unified.numpy(),
                       fed["deltas"][cid][0])


def assert_delta_close(fed, got, want):
    assert got.shape == want.shape
    for leaf in fed["out"]["space"].leaves:
        sl = slice(leaf.offset, leaf.offset + leaf.size)
        off = np.abs(got[sl] - want[sl]) > LR / 2
        assert off.mean() <= FLIP_SHARE, (leaf.path, int(off.sum()))
    # the same elements move (b starts at 0, so a first step moves no
    # ``a``)
    assert np.count_nonzero(want) > 0
    assert ((got != 0) != (want != 0)).mean() <= FLIP_SHARE


def test_fed_lm_uplink_bits_match_jax(fed):
    want = [sum(u.uplink_bits() for u in r["jups"]) for r in fed["rounds"]]
    assert fed["out"]["uplink_bits"] == want


def test_fed_lm_round_two_starts_from_the_downlinks(fed):
    """Round 2: every client starts each task from its modulated
    downlink (the twin's from its own round 1, JAX's from JAX's); the
    first step's losses within rtol 1e-5 of JAX's, and each single-task
    client's upload one AdamW step (at most lr an element) from its
    downlink's modulated vector.  The two starts differ where round 1's
    steps did, so the uploads are not held to the one-step gate: a
    different ``b`` turns ``a``'s near-zero gradients."""
    from repro_torch.core.unify import modulate
    out, want = fed["out"], fed["rounds"][1]
    assert len(fed["uploads"]) == FED_ROUNDS
    np.testing.assert_allclose(out["task_losses"][1], want["losses"],
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(out["losses"][1], np.mean(want["losses"]),
                               rtol=LOSS_RTOL)
    # the downlink moved the start: round 2's losses are not round 1's
    assert not np.allclose(out["task_losses"][1], out["task_losses"][0],
                           rtol=LOSS_RTOL)
    for cid in range(3):
        dl = fed["downlinks"][0][cid]
        start = modulate(dl.unified, dl.masks[0], dl.lams[0]).numpy()
        got = fed["uploads"][1][cid].unified.numpy()
        assert np.count_nonzero(start) > 0
        assert np.abs(got - start).max() <= LR * (1 + 1e-4), cid


def test_fed_lm_round_from_jax_deltas_matches_jax(fed):
    """JAX's deltas as the port's inputs: client unify, the uploads'
    bits and one ``MaTUServer.round`` against JAX's."""
    fp = fed["jspace"].fingerprint
    ups = []
    for cid, (tasks, x, jup) in enumerate(zip(CLIENT_TASKS, fed["deltas"],
                                              fed["jups"])):
        uni, masks, lams = unify_with_modulators(torch.from_numpy(x))
        assert uni.numpy().tobytes() == np.asarray(jup.unified).tobytes()
        assert np.array_equal(masks.numpy(), np.asarray(jup.masks))
        np.testing.assert_allclose(lams.numpy(), np.asarray(jup.lams),
                                   rtol=RTOL)
        ups.append(ClientUpload(cid, tasks, uni, masks, lams,
                                [B * S] * len(tasks), fingerprint=fp))
        assert ups[-1].uplink_bits() == jup.uplink_bits()
    server = MaTUServer(MaTUServerConfig(n_tasks=N_TASKS_LM), device="cpu")
    downs = server.round(ups)
    np.testing.assert_allclose(server.last_task_vectors.numpy(), fed["tv"],
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(server.last_similarity.numpy(), fed["sim"],
                               rtol=RTOL, atol=ATOL)
    for cid, jdl in fed["jdowns"].items():
        tdl = downs[cid]
        assert tdl.packed and tdl.downlink_bits() == jdl.downlink_bits()
        assert np.array_equal(tdl.masks_dense().numpy(),
                              np.asarray(jdl.masks_dense()))
        np.testing.assert_allclose(tdl.lams.numpy(), np.asarray(jdl.lams),
                                   rtol=RTOL)


def test_fed_lm_checkpoint_loads_in_jax_bitwise(fed):
    tv = fed["out"]["server"].last_task_vectors
    path = os.path.join(fed["workdir"], fed_lm.CKPT)
    tree, meta = j_ckpt.load(path, {"task_vectors": jnp.zeros(tuple(tv.shape),
                                                              jnp.float32)})
    assert meta == {"rounds": FED_ROUNDS}
    assert np.asarray(tree["task_vectors"]).tobytes() == tv.numpy().tobytes()


# -- serve_decode: the store and the three mixes at the reduced qwen2 ---------

class CarriedServer:
    """Stands in for the twin's round: its serving downlink is JAX's,
    carried across."""

    def __init__(self, jdl):
        self.jdl = jdl

    def serving_downlink(self, *, fingerprint=None):
        assert fingerprint == self.jdl.fingerprint
        return ClientDownlink(
            torch.from_numpy(np.array(self.jdl.unified, np.float32))
            .to(torch.bfloat16),
            bitpack.words_from_numpy(np.asarray(self.jdl.masks)),
            torch.from_numpy(np.array(self.jdl.lams)), fingerprint=fingerprint)


@functools.lru_cache(maxsize=1)
def serve_weights():
    """The serving example's reduced qwen2 in JAX and the port's config
    carrying its weights across."""
    jcfg = j_load_arch("qwen2-0.5b").reduced()
    jm = jcfg.build(J_SHAPES["decode_32k"])
    jparams = jm.init(jax.random.PRNGKey(0))
    jlora0 = jm.lora_init(jax.random.PRNGKey(1))
    pcfg, params, lora0 = carried_cfg(
        load_arch("qwen2-0.5b").reduced(), SHAPES["decode_32k"], jparams,
        jlora0)
    return jm, jparams, jlora0, JSpace.from_tree(jlora0), pcfg, params, lora0


def test_serve_federated_round_matches_jax():
    """``federated_round`` at 2 tasks and one local step against JAX's,
    whose step runs under ``jax.jit``: the server's task vectors at the
    round engine's bar, the serving downlink's mask words bitwise and
    its λ within rtol 1e-5; the uploads' bits JAX's accounting."""
    from repro_torch.common.tree import TaskVectorSpace
    jm, jparams, jlora0, jspace, pcfg, params, lora0 = serve_weights()
    jserve = load_jax_example("serve_decode")

    def jitted_step(model, opt):
        step, opt = j_train_step(model, opt)
        return jax.jit(step), opt

    jserve.make_train_step = jitted_step    # this loaded copy only
    kw = dict(local_steps=1, batch=4, seq=32, vocab=pcfg.vocab)
    jserver = jserve.federated_round(
        jm, jparams, jlora0, jspace,
        {t: jserve.make_task_sampler(t, pcfg.vocab) for t in range(2)}, **kw)
    model = pcfg.build(SHAPES["decode_32k"], device="cpu")
    space = TaskVectorSpace.from_tree(lora0)
    assert space.fingerprint == jspace.fingerprint
    server, uploads = serve_decode_torch.federated_round(
        model, params, lora0, space,
        {t: fed_lm.make_task_sampler(t, pcfg.vocab, device="cpu")
         for t in range(2)}, **kw)
    assert [u.task_ids for u in uploads] == [[0], [1]]
    # dense bool uploads: the paper's 32 d + k (d + 32), k = 1
    assert all(u.uplink_bits() == 32 * space.d + space.d + 32
               for u in uploads)
    np.testing.assert_allclose(server.last_task_vectors.numpy(),
                               np.asarray(jserver.last_task_vectors),
                               rtol=RTOL, atol=ATOL)
    sdl = server.serving_downlink(fingerprint=space.fingerprint)
    jdl = jserver.serving_downlink(fingerprint=jspace.fingerprint)
    assert torch.equal(sdl.masks,
                       bitpack.words_from_numpy(np.asarray(jdl.masks)))
    np.testing.assert_allclose(sdl.lams.numpy(), np.asarray(jdl.lams),
                               rtol=RTOL)


@functools.lru_cache(maxsize=1)
def serve_rig():
    """JAX's serving downlink of one round (4 single-task clients on
    seeded task vectors) into the twin's ``main`` and into JAX's store;
    JAX's dense-routed and fused decoders, one compiled program each."""
    jm, jparams, jlora0, jspace, pcfg, _params, _lora0 = serve_weights()
    rng = np.random.default_rng(7)
    vecs = (0.05 * rng.standard_normal((4, jspace.d))).astype(np.float32)
    jserver = JServer(JServerCfg(n_tasks=4))
    jserver.round([JUpload(t, [t], jnp.asarray(vecs[t]),
                           jnp.ones((1, jspace.d), bool), jnp.ones((1,)),
                           [128], fingerprint=jspace.fingerprint)
                   for t in range(4)])
    jdl = jserver.serving_downlink(fingerprint=jspace.fingerprint)
    saved = serve_decode_torch.federated_round
    serve_decode_torch.federated_round = lambda *a, **k: (CarriedServer(jdl),
                                                          [])
    try:
        out = serve_decode_torch.main(["--quick"], cfg=pcfg, device="cpu")
    finally:
        serve_decode_torch.federated_round = saved
    jstore = JStore(jspace, jlora0, capacity=4)
    jstore.ingest(jdl)
    gen = JGenCfg(max_new_tokens=8, temperature=0.0)
    decoders = {fused: JDecoder(jm, jparams, jstore, fused=fused, cfg=gen)
                for fused in (False, True)}
    return dict(jstore=jstore, decoders=decoders, out=out)


def test_serve_storage_report_matches_jax():
    r = serve_rig()
    assert r["out"]["report"] == r["jstore"].storage_report()


@pytest.mark.parametrize("which", [0, 1, 2])
def test_serve_mix_tokens_match_jax(which):
    """Dense-routed and fused greedy tokens of one mix against JAX's
    ``MultiTenantDecoder``'s on the same prompts (fp32)."""
    r = serve_rig()
    out = r["out"]
    mix = out["mixes"][which]
    prompts = jnp.asarray(out["prompts"].numpy())
    for fused, got in ((False, out["mix_tokens"][which]),
                       (True, out["fused"].generate(out["prompts"], mix))):
        want = r["decoders"][fused].generate(prompts, mix)
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), np.asarray(want)), fused
    if which == 0:
        assert torch.equal(out["dense_tokens"], out["mix_tokens"][0])
        assert torch.equal(out["fused_tokens"], out["dense_tokens"])


def test_serve_one_routed_tree_across_mixes():
    out = serve_rig()["out"]
    assert out["one_route"] == {"dense": True, "fused": True}
    sig = serve_decode_torch.route_signature
    assert sig(out["fused"], [0, 1, 2, 3]) != sig(out["dense"], [0, 1, 2, 3])
    assert sig(out["dense"], [0, 1, 2, 3]) == sig(out["dense"], [3, 3, 1, 0])


# -- quickstart ------------------------------------------------------------------

def jax_bits_a_round(d):
    """JAX's wire accounting over the quickstart's split: MaTU's measured
    packed uplink (bf16 vector, packed mask words, fp32 λ a task) and
    FedAvg's fp32 adapter a task, every client each round."""
    split = j_split(n_clients=9, n_tasks=6, n_classes=8, zeta_t=0.5,
                    tasks_per_client=2, seed=0)
    matu = sum(j_wire_bits(d, len(t), vec_bytes_per_elem=2, float_bits=32)
               for t in split.tasks)
    fedavg = sum(32 * d * len(t) for t in split.tasks)
    return matu, fedavg


def test_quickstart_run_bits_and_similarity():
    from repro_torch.fed.simulator import FedConfig
    res = quickstart_torch.run(
        FedConfig(rounds=2, local_steps=5, lr=1e-2, eval_every=1, seed=0),
        device="cpu")
    h_matu, strat = res["matu"]
    h_avg, _ = res["fedavg"]
    matu, fedavg = jax_bits_a_round(strat.d)
    assert (matu, fedavg) == (292_704, 1_089_536)
    assert h_matu.uplink_bits_per_round == [matu, matu]
    assert h_avg.uplink_bits_per_round == [fedavg, fedavg]
    assert h_matu.rounds == h_avg.rounds == [1, 2]
    assert all(0.0 <= a <= 1.0 for a in h_matu.mean_acc + h_avg.mean_acc)
    assert sorted(res["individual"]) == list(range(6))
    s = res["similarity"]
    assert s.shape == (6, 6) and np.array_equal(s, s.T)
    assert np.all((0.0 <= s) & (s <= 1.0))
    # Eq. 5's diagonal is ½(1 + the share of τ̂'s nonzero signs), no
    # entry of a row above it
    assert np.all(s <= np.diag(s)[:, None] + 1e-7)
    np.testing.assert_allclose(res["within"], np.mean(
        [s[a, b] for a, b in ((0, 3), (1, 4), (2, 5))]), rtol=1e-6)


def test_quickstart_matu_similarity_tracks_oracle():
    """The port's twin of ``tests/test_fed.py``'s correlation test, at its
    exact setting: 8 tasks, 16 clients, 15 rounds of 30 steps."""
    from repro_torch.data.dirichlet import dirichlet_split
    from repro_torch.data.synthetic import make_constellation
    from repro_torch.fed.simulator import FedConfig, FedSimulator
    from repro_torch.fed.strategies import MaTUStrategy
    from repro_torch.fed.testbed import MLPBackbone
    n = 8
    con = make_constellation(n_tasks=n, n_groups=3, feat_dim=32, n_classes=8,
                             conflict_pairs=[(0, 1)], seed=0)
    split = dirichlet_split(n_clients=16, n_tasks=n, n_classes=8,
                            zeta_t=0.0, seed=0)
    bb = MLPBackbone(32, hidden=64, lora_rank=8)
    cfg = FedConfig(rounds=15, local_steps=30, lr=1e-2, eval_every=15, seed=0)
    strat = MaTUStrategy(n, bb.d, device="cpu")
    FedSimulator(cfg, con, split, bb, strat, device="cpu").run()
    sim = strat.server.last_similarity.numpy()
    oracle = con.oracle_similarity()
    iu = np.triu_indices(n, k=1)
    r = np.corrcoef(sim[iu], oracle[iu])[0, 1]
    assert r > 0.5, f"sign-sim/oracle correlation too weak: {r:.3f}"


# -- package rules -----------------------------------------------------------------

TWINS = ["quickstart_torch", "fed_finetune_lm_torch", "serve_decode_torch"]


@pytest.mark.parametrize("name", TWINS)
def test_twin_imports_neither_jax_nor_repro(name):
    import ast
    with open(os.path.join(EXAMPLES, f"{name}.py")) as f:
        tree = ast.parse(f.read())
    mods = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
            for a in n.names]
    mods += [n.module for n in ast.walk(tree)
             if isinstance(n, ast.ImportFrom) and n.module]
    bad = [m for m in mods if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad and any(m.startswith("repro_torch") for m in mods), bad


@pytest.mark.parametrize("name", TWINS)
def test_twin_runs_on_the_card_by_default(name, monkeypatch, tmp_path):
    """No card: the default device raises, never a CPU fallback."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    mod = sys.modules[name]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        if name == "quickstart_torch":
            mod.main()
        else:
            mod.main([], cfg=load_arch("qwen2-0.5b").reduced())
