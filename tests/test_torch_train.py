"""The port's training path against the JAX package, on the CPU: the
fp32 cross-entropy and its chunked form, ``LM.loss`` (dense, MoE with
its load-balance aux, the vlm's text tail) and ``EncDecLM.loss`` with
their LoRA gradients, the checkpoint twin of the layer loop,
``make_train_step`` / ``make_full_train_step``, the optimizers, clipping,
chaining and schedules, and checkpoints that cross between the
packages."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import optim as jopt  # noqa: E402
from repro.ckpt import checkpoint as j_ckpt  # noqa: E402
from repro.common.tree import TaskVectorSpace as JSpace  # noqa: E402
from repro.configs.base import load_arch as j_load_arch  # noqa: E402
from repro.models import lm as j_lm  # noqa: E402
from repro.train.trainer import make_full_train_step as j_full  # noqa: E402
from repro.train.trainer import make_train_step as j_train  # noqa: E402
from repro_torch import optim as topt  # noqa: E402
from repro_torch.ckpt import checkpoint as t_ckpt  # noqa: E402
from repro_torch.common.tree import (TaskVectorSpace, tree_leaves,  # noqa
                                     tree_map)
from repro_torch.configs.base import load_arch  # noqa: E402
from repro_torch.models import lm as t_lm  # noqa: E402
from repro_torch.models.convert import (lora_from_numpy,  # noqa: E402
                                        params_from_numpy)
from repro_torch.train.trainer import (make_full_train_step,  # noqa: E402
                                       make_train_step)

jax.config.update("jax_platform_name", "cpu")

# fp32 losses through 2-4 layers, summed in each package's own order
RTOL = 1e-5
GRAD_REL_L2 = 1e-4


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def rel_l2(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


# -- cross-entropy -----------------------------------------------------------

def ce_inputs(seed=0, b=2, s=13, d=16, v=37):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    w = (rng.standard_normal((d, v)) / 4).astype(np.float32)
    labels = rng.integers(0, v, (b, s)).astype(np.int32)
    labels[0, 3] = labels[1, 0] = labels[1, -1] = -100
    return x, w, labels


@pytest.mark.parametrize("chunk", [4, 5, 13, 16])
def test_chunked_cross_entropy_matches_jax(chunk):
    """A chunk that divides S, ones that do not (the tail padded with
    ignored labels) and one past S; value and gradients of x and the
    head."""
    x, w, labels = ce_inputs()

    def j_fn(x, w):
        return j_lm.chunked_cross_entropy(x, lambda xc: xc @ w,
                                          jnp.asarray(labels), chunk=chunk)

    j_val, (jgx, jgw) = jax.value_and_grad(j_fn, argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(w))
    tx = torch.from_numpy(x).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    t_val = t_lm.chunked_cross_entropy(tx, lambda xc: xc @ tw,
                                       torch.from_numpy(labels).long(),
                                       chunk=chunk)
    t_val.backward()
    np.testing.assert_allclose(t_val.item(), float(j_val), rtol=RTOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), rtol=1e-4,
                               atol=1e-7)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jgw), rtol=1e-4,
                               atol=1e-7)
    # the unchunked form on the same hidden states, both packages
    logits = torch.from_numpy(x) @ torch.from_numpy(w)
    full = t_lm.cross_entropy(logits, torch.from_numpy(labels).long())
    np.testing.assert_allclose(full.item(), t_val.item(), rtol=RTOL)
    np.testing.assert_allclose(full.item(), float(j_lm.cross_entropy(
        jnp.asarray(x) @ jnp.asarray(w), jnp.asarray(labels))), rtol=RTOL)


def test_cross_entropy_all_ignored_is_zero():
    x, w, labels = ce_inputs(1)
    labels[:] = -100
    val = t_lm.chunked_cross_entropy(torch.from_numpy(x),
                                     lambda xc: xc @ torch.from_numpy(w),
                                     torch.from_numpy(labels).long(), chunk=5)
    assert val.item() == 0.0


# -- model losses ------------------------------------------------------------

LOSS_ARCHS = ["qwen2-0.5b", "granite-moe-3b-a800m", "qwen2-vl-7b",
              "whisper-large-v3"]


def rig(arch, seed=0):
    """JAX and port models of ``arch``'s reduced config with the JAX
    weights carried across, and a LoRA tree whose b factors are nonzero
    (so every LoRA leaf has a gradient)."""
    jm = j_load_arch(arch).reduced().build()
    tm = load_arch(arch).reduced().build(device="cpu")
    jp = jm.init(jax.random.PRNGKey(seed))
    jl = jm.lora_init(jax.random.PRNGKey(seed + 1))
    space = JSpace.from_tree(jl)
    rng = np.random.default_rng(seed + 2)
    jl = jax.tree_util.tree_map(jnp.add, jl, space.unflatten(jnp.asarray(
        (0.05 * rng.standard_normal(space.d)).astype(np.float32))))
    return (jm, jp, jl), (tm, params_from_numpy(tm, to_np(jp)),
                          lora_from_numpy(tm, to_np(jl)))


def make_batch(cfg, seed, b=2, s=11, img=3):
    """Seeded tokens with next-token labels (the last ignored); a vlm
    also gets ``img`` prepended image embeddings, whisper its frames."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(1, cfg.vocab, (b, s)).astype(np.int32)
    lab = np.concatenate([tok[:, 1:], np.full((b, 1), -100, np.int32)], 1)
    batch = {"tokens": tok, "labels": lab}
    if cfg.family == "vlm":
        batch["extra_embeds"] = rng.standard_normal(
            (b, img, cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        batch["audio_embeds"] = rng.standard_normal(
            (b, cfg.enc_frames, cfg.d_model)).astype(np.float32)
    return batch


def as_j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def as_t(batch):
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32
            else torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("arch", LOSS_ARCHS)
def test_loss_and_lora_gradient_match_jax(arch):
    (jm, jp, jl), (tm, tp, tl) = rig(arch)
    batch = make_batch(load_arch(arch).reduced(), 3)
    j_val, j_g = jax.value_and_grad(lambda l: jm.loss(jp, l, as_j(batch)))(jl)
    tl = tree_map(lambda t: t.clone().requires_grad_(True), tl)
    t_val = tm.loss(tp, tl, as_t(batch))
    t_val.backward()
    np.testing.assert_allclose(t_val.item(), float(j_val), rtol=RTOL)
    space = TaskVectorSpace.from_tree(tl)
    got = space.flatten(tree_map(lambda t: t.grad, tl)).numpy()
    want = np.asarray(JSpace.from_tree(j_g).flatten(j_g))
    assert np.count_nonzero(want) > 0.9 * want.size
    assert rel_l2(got, want) < GRAD_REL_L2
    np.testing.assert_allclose(got, want, rtol=1e-3,
                               atol=1e-4 * np.abs(want).max())


def test_moe_aux_enters_the_loss():
    """granite's reduced MoE: the aux summed over the layers equals the
    JAX forward's, is nonzero, and the loss is CE + 0.01 · aux."""
    (jm, jp, jl), (tm, tp, tl) = rig("granite-moe-3b-a800m")
    batch = make_batch(load_arch("granite-moe-3b-a800m").reduced(), 4)
    _, j_aux = jm.model.forward(jp, jnp.asarray(batch["tokens"]), lora=jl)
    logits, t_aux = tm.model.forward(tp, as_t(batch)["tokens"], lora=tl,
                                     return_aux=True)
    assert logits.shape[-1] == tm.cfg.vocab and t_aux.item() > 0
    np.testing.assert_allclose(t_aux.item(), float(j_aux), rtol=RTOL)
    hidden = tm.model.forward(tp, as_t(batch)["tokens"], lora=tl,
                              return_hidden=True)
    ce = t_lm.chunked_cross_entropy(
        hidden, lambda xc: tm.model._head(tp, xc), as_t(batch)["labels"])
    np.testing.assert_allclose(tm.loss(tp, tl, as_t(batch)).item(),
                               (ce + 0.01 * t_aux).item(), rtol=1e-6)
    # a dense model's aux is 0
    (_, _, _), (dm, dp, dl) = rig("qwen2-0.5b")
    assert dm.model.forward(dp, as_t(batch)["tokens"][:, :4] % 7, lora=dl,
                            return_aux=True)[1].item() == 0.0


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "granite-moe-3b-a800m",
                                  "whisper-large-v3"])
def test_checkpointed_layers_change_no_number(arch):
    """The layer loop under ``torch.utils.checkpoint`` (``remat``) and
    without it: the same loss and LoRA gradients, bit for bit."""
    _, (tm, tp, tl) = rig(arch)
    batch = as_t(make_batch(load_arch(arch).reduced(), 5))
    out = []
    for remat in (False, True):
        tm.model.remat = remat
        lo = tree_map(lambda t: t.clone().requires_grad_(True), tl)
        val = tm.loss(tp, lo, batch)
        grads = torch.autograd.grad(val, tree_leaves(lo))
        out.append((val, grads))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)


# -- train steps -------------------------------------------------------------

def test_train_step_three_steps_match_jax():
    """``make_train_step(model, adamw(5e-3))`` (clip 1.0) from the LoRA
    init over three batches, against the JAX step on the same batches:
    losses, and the LoRA trees after each step."""
    arch = "qwen2-0.5b"
    jm = j_load_arch(arch).reduced().build()
    tm = load_arch(arch).reduced().build(device="cpu")
    jp = jm.init(jax.random.PRNGKey(0))
    jl = jm.lora_init(jax.random.PRNGKey(1))
    tp, tl = params_from_numpy(tm, to_np(jp)), lora_from_numpy(tm, to_np(jl))
    j_step, j_opt = j_train(jm, jopt.adamw(5e-3))
    t_step, t_opt = make_train_step(tm, topt.adamw(5e-3))
    js, ts = j_opt.init(jl), t_opt.init(tl)
    space = TaskVectorSpace.from_tree(tl)
    jspace = JSpace.from_tree(jl)
    start = np.asarray(jspace.flatten(jl))
    lr = 5e-3
    for i in range(3):
        batch = make_batch(tm.cfg, 10 + i, b=2, s=16)
        jl, js, jmet = j_step(jp, jl, js, as_j(batch))
        tl, ts, tmet = t_step(tp, tl, ts, as_t(batch))
        np.testing.assert_allclose(tmet["loss"].item(), float(jmet["loss"]),
                                   rtol=RTOL)
        got = space.flatten(tl).numpy()
        want = np.asarray(jspace.flatten(jl))
        # AdamW's step is about lr whatever a gradient's size, so a
        # coordinate whose gradient is near 0 turns the fp32 sums'
        # rounding into a fraction of lr: each coordinate within 1e-2 ·
        # lr, and the moved part within the gradients' rel L2
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-2 * lr)
        assert rel_l2(got - start, want - start) < GRAD_REL_L2
    assert ts["step"] == 3


def test_full_train_step_matches_jax():
    """``make_full_train_step`` with SGD: one step differentiates every
    base parameter (no LoRA)."""
    arch = "qwen2-0.5b"
    jm = j_load_arch(arch).reduced().build()
    tm = load_arch(arch).reduced().build(device="cpu")
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_numpy(tm, to_np(jp))
    batch = make_batch(tm.cfg, 20, b=2, s=8)
    j_step, j_opt = j_full(jm, jopt.sgd(0.5), grad_clip=0.25)
    t_step, t_opt = make_full_train_step(tm, topt.sgd(0.5), grad_clip=0.25)
    jp2, _, jmet = j_step(jp, j_opt.init(jp), as_j(batch))
    tp2, _, tmet = t_step(tp, t_opt.init(tp), as_t(batch))
    np.testing.assert_allclose(tmet["loss"].item(), float(jmet["loss"]),
                               rtol=RTOL)
    jflat = jax.tree_util.tree_leaves(jp)
    for (a, b), (c, d) in zip(zip(tree_leaves(tp2), tree_leaves(tp)),
                              zip(jax.tree_util.tree_leaves(jp2), jflat)):
        moved_t = (a - b).numpy()
        moved_j = np.asarray(c) - np.asarray(d)
        np.testing.assert_allclose(moved_t, moved_j, rtol=1e-3,
                                   atol=1e-4 * max(np.abs(moved_j).max(),
                                                   1e-12))


# -- optimizers, clipping, chaining, schedules ----------------------------------

def opt_tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"w": (scale * rng.standard_normal((5, 3))).astype(np.float32),
            "b": {"x": (scale * rng.standard_normal(4)).astype(np.float32)}}


def run_opts(j_o, t_o, steps=3):
    jp, tp = jax.tree_util.tree_map(jnp.asarray, opt_tree(0)), tree_map(
        torch.from_numpy, opt_tree(0))
    js, ts = j_o.init(jp), t_o.init(tp)
    for i in range(steps):
        g = opt_tree(100 + i, 0.3)
        jp, js = j_o.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        tp, ts = t_o.update(tree_map(torch.from_numpy, g), ts, tp)
    return tp, jp


OPTS = {
    "sgd": lambda m: m.sgd(0.1),
    "sgd_momentum": lambda m: m.sgd(0.1, momentum=0.9),
    "sgd_cosine": lambda m: m.sgd(m.cosine_decay(0.1, 3)),
    "adamw_warmup_decay": lambda m: m.adamw(
        m.linear_warmup_cosine(0.05, 1, 3), weight_decay=0.1),
    "chain_clip_adamw": lambda m: m.chain(m.clip_by_global_norm(0.5),
                                          m.adamw(0.05)),
    "chain_no_clip": lambda m: m.chain(None, m.sgd(0.1, momentum=0.5)),
}


@pytest.mark.parametrize("name", sorted(OPTS))
def test_optimizers_match_jax(name):
    tp, jp = run_opts(OPTS[name](jopt), OPTS[name](topt))
    for a, b in zip(tree_leaves(tp), jax.tree_util.tree_leaves(jp)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)


@pytest.mark.parametrize("max_norm", [0.1, 100.0])
def test_clip_by_global_norm_matches_jax(max_norm):
    g = opt_tree(7)
    want = jopt.clip_by_global_norm(max_norm)(
        jax.tree_util.tree_map(jnp.asarray, g))
    got = topt.clip_by_global_norm(max_norm)(tree_map(torch.from_numpy, g))
    for a, b in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    norm = np.sqrt(sum(float((a.double() ** 2).sum())
                       for a in tree_leaves(got)))
    assert norm == pytest.approx(min(max_norm, norm), rel=1e-5)


SCHEDULES = {
    "constant": lambda m: m.constant(3e-4),
    "cosine_decay": lambda m: m.cosine_decay(1e-2, 10, final_frac=0.2),
    "linear_warmup_cosine": lambda m: m.linear_warmup_cosine(1e-2, 3, 12),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedules_match_jax(name):
    j_fn, t_fn = SCHEDULES[name](jopt), SCHEDULES[name](topt)
    for step in range(0, 15):
        want = float(j_fn(jnp.asarray(step, jnp.int32)))
        assert t_fn(step) == pytest.approx(want, rel=1e-6, abs=1e-12), step


# -- checkpoints ---------------------------------------------------------------

def test_checkpoints_cross_between_packages(tmp_path):
    tree = {"task_vectors": opt_tree(3)["w"], "lora": opt_tree(4),
            "seq": [np.arange(3, dtype=np.int32),
                    (np.ones((2, 2), np.float32),)]}
    meta = {"round": 4, "strategy": "matu"}
    j_tree = jax.tree_util.tree_map(jnp.asarray, tree)
    t_tree = tree_map(torch.from_numpy, tree)
    j_ckpt.save(str(tmp_path / "j"), j_tree, meta)
    t_ckpt.save(str(tmp_path / "t"), t_tree, meta)
    # the same manifest file, key for key
    with open(tmp_path / "j.json") as f, open(tmp_path / "t.json") as g:
        assert json.load(f) == json.load(g)
    got, got_meta = t_ckpt.load(str(tmp_path / "j"), t_tree)
    assert got_meta == meta
    for a, b in zip(tree_leaves(got), tree_leaves(t_tree)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    want, want_meta = j_ckpt.load(str(tmp_path / "t"), j_tree)
    assert want_meta == meta
    for a, b in zip(jax.tree_util.tree_leaves(want),
                    jax.tree_util.tree_leaves(j_tree)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # a bf16 leaf is stored as its fp32 values and loads back exactly
    bf = {"x": torch.randn(7).to(torch.bfloat16)}
    t_ckpt.save(str(tmp_path / "bf"), bf)
    back, _ = t_ckpt.load(str(tmp_path / "bf"), bf)
    assert back["x"].dtype == torch.bfloat16 and torch.equal(back["x"],
                                                             bf["x"])
    jb, _ = j_ckpt.load(str(tmp_path / "bf"),
                        {"x": jnp.zeros(7, jnp.bfloat16)})
    assert torch.equal(torch.from_numpy(np.asarray(jb["x"], np.float32)),
                       bf["x"].float())
    # and a bf16 leaf the JAX package wrote (its bfloat16 bits) loads
    # into the port bit for bit
    j_ckpt.save(str(tmp_path / "jbf"), {"x": jnp.asarray(bf["x"].float(),
                                                         jnp.bfloat16)})
    tb, _ = t_ckpt.load(str(tmp_path / "jbf"), bf)
    assert tb["x"].dtype == torch.bfloat16 and torch.equal(tb["x"], bf["x"])
    with pytest.raises(ValueError, match="shape mismatch"):
        t_ckpt.load(str(tmp_path / "t"), {**t_tree, "task_vectors":
                                          torch.zeros(2)})
    with pytest.raises(ValueError, match="missing keys"):
        t_ckpt.load(str(tmp_path / "t"), {**t_tree, "extra": torch.zeros(1)})
