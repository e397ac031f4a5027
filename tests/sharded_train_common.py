"""The shared harness of the sharded train-step tests
(``tests/test_torch_sharded_train*.py``): the inputs, the JAX package's
reference steps (a subprocess on 4 host devices) and the port's ranks
(``tests/torch_model_ranks.py``, on the (2, 2) and (1, 3) meshes), all
three subprocesses started at once.  See
``tests/test_torch_sharded_train.py`` for the setting and the bars."""

import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
LOSS_RTOL, LORA_REL_L2, GRAD_REL_L2 = 1e-5, 1e-4, 1e-4
MESHES = ((2, 2), (1, 3))
B, S, Q_CHUNK, LR = 4, 12, 6, 1e-3

# the JAX side: the reference steps from train.pkl's inputs, and their
# LoRA gradients before the clip; writes jax_train.pkl.  argv: work,
# sharded (0 / 1).
_JAX = textwrap.dedent("""
    import os, sys, pickle
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import Mesh
    from repro.configs.base import SHAPES, load_arch
    from repro.launch.dryrun import batch_shardings, opt_state_shardings
    from repro.launch.mesh import arch_rules
    from repro.nn.sharding import logical_to_sharding, mesh_context
    from repro.optim import adamw
    from repro.train.trainer import make_train_step

    work, sharded = sys.argv[1], sys.argv[2] == "1"
    inputs = pickle.load(open(os.path.join(work, "train.pkl"), "rb"))
    Q_CHUNK, LR = {Q_CHUNK}, {LR}
    MESHES = {MESHES}

    def np_tree(t):
        return jax.tree_util.tree_map(np.asarray, t)

    def set_q_chunk(model):
        for _, blk in model.model.unit_blocks:
            m = getattr(blk, "mixer", None)
            m = getattr(m, "attn", m)
            if hasattr(m, "q_chunk"):
                m.q_chunk = Q_CHUNK

    def step_of(model):
        step, opt = make_train_step(model, adamw(LR))
        return step, opt

    def grad_of(model):
        # the step's LoRA gradients, before the clip and the optimizer
        return lambda p, l, b: jax.grad(lambda l_: model.loss(p, l_, b))(l)

    def fill(struct, tree, path=()):
        # the reference's tree shape filled from the port's numpy tree (an
        # MoE without a shared expert has an empty "ffn" LoRA dict there)
        if isinstance(struct, dict):
            return {{k: fill(v, tree, path + (k,)) for k, v in struct.items()}}
        node = tree
        for k in path:
            node = node[k]
        return jnp.asarray(node)

    refs = {{}}
    for arch, case in inputs.items():
        cfg = load_arch(arch).reduced()
        model = cfg.build(SHAPES["train_4k"])
        set_q_chunk(model)
        key = jax.random.PRNGKey(0)
        params = fill(jax.eval_shape(model.init, key), case["params"])
        lora = fill(jax.eval_shape(model.lora_init, key), case["lora"])
        jbatch = jax.tree_util.tree_map(jnp.asarray, case["batch"])
        if not sharded:
            step, opt = step_of(model)
            new, _, m = jax.jit(step)(params, lora, opt.init(lora), jbatch)
            grads = jax.jit(grad_of(model))(params, lora, jbatch)
            refs[arch] = {{"": (float(m["loss"]), np_tree(new),
                               np_tree(grads))}}
            continue
        refs[arch] = {{}}
        for shape in MESHES:
            n = shape[0] * shape[1]
            mesh = Mesh(np.array(jax.devices()[:n]).reshape(shape),
                        ("data", "model"))
            with mesh_context(mesh, arch_rules(cfg, mesh)):
                model = cfg.build(SHAPES["train_4k"])
                set_q_chunk(model)
                p_sh = logical_to_sharding(model.axes(), params, mesh=mesh)
                l_sh = logical_to_sharding(model.lora_axes(), lora, mesh=mesh)
                step, opt = step_of(model)
                state = opt.init(lora)
                o_sh = opt_state_shardings(state, l_sh, mesh)
                b_sh = batch_shardings(jbatch, mesh)
                fn = jax.jit(step, in_shardings=(p_sh, l_sh, o_sh, b_sh))
                gfn = jax.jit(grad_of(model), in_shardings=(p_sh, l_sh, b_sh))
                with mesh:
                    new, _, m = fn(params, lora, state, jbatch)
                    grads = gfn(params, lora, jbatch)
            refs[arch]["%dx%d" % shape] = (float(m["loss"]), np_tree(new),
                                           np_tree(grads))
    pickle.dump(refs, open(os.path.join(work, "jax_train.pkl"), "wb"))
""").format(Q_CHUNK=Q_CHUNK, LR=LR, MESHES=MESHES)


def make_inputs(archs):
    """Each arch's reduced parameters and LoRA from the port's own init
    (torch generators, seeded), the LoRA ``b`` factors plus 0.05 N(0, 1),
    and a batch of B × S random tokens, all numpy."""
    from repro_torch.configs.base import SHAPES, load_arch

    def np_tree(t):
        if isinstance(t, dict):
            return {k: np_tree(v) for k, v in t.items()}
        return t.detach().numpy()
    out = {}
    for i, arch in enumerate(archs):
        cfg = load_arch(arch).reduced()
        model = cfg.build(SHAPES["train_4k"], device="cpu")
        params = np_tree(model.init(10 + i))
        lora = np_tree(model.lora_init(20 + i))
        rng = np.random.default_rng(30 + i)

        def nudge(t):
            if isinstance(t, dict):
                return {k: (v + 0.05 * rng.standard_normal(v.shape).astype(
                    v.dtype) if k == "b" else nudge(v)) for k, v in t.items()}
            return t
        tokens = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
        out[arch] = dict(arch=arch, params=params, lora=nudge(lora),
                         batch={"tokens": tokens,
                                "labels": np.roll(tokens, -1, axis=1)},
                         q_chunk=Q_CHUNK, lr=LR)
    return out


def run_pair(work, archs, sharded):
    """The JAX subprocess and the port's ranks on both meshes, all at
    once from the same inputs; returns (the ranks' reports by mesh tag,
    JAX's references)."""
    with open(os.path.join(work, "train.pkl"), "wb") as f:
        pickle.dump(make_inputs(archs), f)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    env.pop("XLA_FLAGS", None)
    jax_proc = subprocess.Popen([sys.executable, "-c", _JAX, work,
                                 "1" if sharded else "0"], env=env,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
    procs = {f"{d}x{m}": subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_model_ranks.py"), work,
         "train", f"{d}x{m}"], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for d, m in MESHES}
    reports = {}
    for tag, proc in procs.items():
        _, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, err[-3000:]
        n = int(tag[0]) * int(tag[2])
        reports[tag] = []
        for r in range(n):
            with open(os.path.join(work, f"train_{tag}_{r}.pkl"), "rb") as f:
                reports[tag].append(pickle.load(f))
    _, err = jax_proc.communicate(timeout=300)
    assert jax_proc.returncode == 0, err[-3000:]
    with open(os.path.join(work, "jax_train.pkl"), "rb") as f:
        refs = pickle.load(f)
    return reports, refs


def flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, prefix + (k,)))
        return out
    return {"/".join(prefix): np.asarray(tree, np.float32)}


def check_step(rep, want_loss, want_lora):
    np.testing.assert_allclose(rep["loss"], want_loss, rtol=LOSS_RTOL)
    want = flat(want_lora)
    assert set(rep["lora"]) == set(want)
    got = np.concatenate([rep["lora"][k].ravel() for k in sorted(want)])
    ref = np.concatenate([want[k].ravel() for k in sorted(want)])
    rel = float(np.linalg.norm(got - ref) / np.linalg.norm(ref))
    assert rel < LORA_REL_L2, rel


def check_grads(rep, want_grads):
    """Each LoRA leaf's gradient of the step, before the clip and the
    optimizer, within rel L2 :data:`GRAD_REL_L2` of the reference's (a
    leaf the loss does not reach is zero on both sides).  AdamW's first
    step keeps little more than each element's sign, so this is what
    holds the size of the sharded gradients."""
    want = flat(want_grads)
    assert set(rep["grads"]) == set(want)
    for k in sorted(want):
        got, ref = rep["grads"][k], want[k]
        den = float(np.linalg.norm(ref))
        num = float(np.linalg.norm(got - ref))
        if den == 0.0:
            assert num == 0.0, (k, num)
        else:
            assert num / den < GRAD_REL_L2, (k, num / den)


