"""The port's sharded MoE forms against the JAX package's sharded MoE.

Under a ``(data, model)`` mesh ``repro.nn.moe.MoE`` runs one of three
``shard_map`` forms -- expert-parallel, token-parallel, replicated --
and the expert-parallel one scans its tokens in chunks
(``_chunked_local_moe``).  Capacity is per shard (and per chunk) and the
aux is the mean of every shard's, so the port's sharded call must equal
JAX's sharded call, not the unsharded one.  Each case runs on a (2, 2)
mesh: the port's on 4 gloo CPU ranks (``tests/torch_model_ranks.py``),
JAX's on 4 host devices (a subprocess with
``--xla_force_host_platform_device_count=4``); both subprocesses start
once for the file, from the same numpy inputs.

Bar: every local routing call's expert ids, capacity positions and kept
flags equal JAX's formula on the same local tokens, exactly (a dropping
variant at capacity factor 1.0 drops tokens in each form); outputs and
aux within fp32 rtol 1e-5; the gradients of a weighted sum of the
output plus the aux in x, every parameter and the shared expert's
LoRA, against ``jax.grad`` of JAX's sharded call, within rel L2 1e-5
a leaf.  The
counted psums: one over ``model`` in the
expert-parallel form, plus the aux's mean in every form.
"""

import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest

pytest.importorskip("torch")

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
RTOL, ATOL = 1e-5, 1e-6
D, F = 16, 8
DATA, MODEL = 2, 2
LORA_R = 2              # the shared expert's LoRA rank
AUX_COEF = 0.5          # the aux's weight in the gradients' loss

# name: (experts, top_k, capacity factor, B, S, token chunk, shared, form)
CASES = {
    "ep": (4, 2, 8.0, 4, 8, None, 0, "expert_parallel"),
    "ep_drop": (4, 2, 1.0, 4, 8, None, 0, "expert_parallel"),
    "ep_chunked": (4, 2, 1.0, 4, 32, 16, 0, "expert_parallel"),
    "ep_shared": (4, 2, 1.25, 4, 8, None, 1, "expert_parallel"),
    "ep_b_unsplit": (4, 2, 1.0, 3, 8, None, 0, "expert_parallel"),
    "tp": (3, 2, 8.0, 4, 8, None, 0, "token_parallel"),
    "tp_drop": (3, 2, 1.0, 4, 48, None, 0, "token_parallel"),
    "rep_decode": (3, 2, 1.0, 4, 1, None, 0, "replicated"),
    "rep_drop": (3, 2, 1.0, 4, 33, None, 1, "replicated"),
}
DROPPING = ("ep_drop", "ep_chunked", "ep_b_unsplit", "tp_drop", "rep_drop")


def make_cases():
    out = {}
    for i, (name, (e, k, cf, b, s, chunk, shared, form)) in enumerate(
            sorted(CASES.items())):
        rng = np.random.default_rng(100 + i)

        def w(*shape, fan):
            return (rng.standard_normal(shape) / np.sqrt(fan)).astype(
                np.float32)
        params = {"router": {"w": w(D, e, fan=D)},
                  "experts": {"gate": w(e, D, F, fan=D),
                              "up": w(e, D, F, fan=D),
                              "down": w(e, F, D, fan=F)}}
        if shared:
            params["shared"] = {"gate": {"w": w(D, 8, fan=D)},
                                "up": {"w": w(D, 8, fan=D)},
                                "down": {"w": w(8, D, fan=8)}}
        x = rng.standard_normal((b, s, D)).astype(np.float32)
        # drawn after x, so the forward cases keep their inputs
        lora = {}
        if shared:
            lora["shared"] = {"down": {
                "a": w(8, LORA_R, fan=8), "b": 0.1 * w(LORA_R, D, fan=1),
                "alpha": np.asarray(LORA_R, np.float32)}}
        out[name] = dict(e=e, k=k, cf=cf, d_ff=F, token_chunk=chunk,
                         n_shared=shared, shared_d_ff=8 if shared else None,
                         form=form, params=params, lora=lora, x=x,
                         w=rng.standard_normal((b, s, D)).astype(np.float32),
                         aux_coef=AUX_COEF)
    return out


_JAX = textwrap.dedent("""
    import os, sys, pickle, functools
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import numpy as np
    import jax, jax.numpy as jnp
    from repro.launch.mesh import make_debug_mesh
    from repro.nn.moe import MoE
    from repro.nn.sharding import mesh_context

    work = sys.argv[1]
    cases = pickle.load(open(os.path.join(work, "moe.pkl"), "rb"))
    mesh = make_debug_mesh((2, 2))
    n_data, n_model = 2, 2

    @functools.partial(jax.jit, static_argnums=(2, 3))
    def _route(router_w, xt, k, e):
        logits = jnp.einsum("td,de->te", xt, router_w).astype(jnp.float32)
        _, idx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), k)
        flat = idx.reshape(-1)
        onehot = jax.nn.one_hot(flat, e, dtype=jnp.int32)
        pos = jnp.sum((jnp.cumsum(onehot, axis=0) - onehot) * onehot, -1)
        return idx, pos.reshape(idx.shape)

    def route(moe, router_w, xt, cap):
        idx, pos = _route(router_w, xt, moe.top_k, moe.n_experts)
        return {"ids": np.asarray(idx), "pos": np.asarray(pos),
                "keep": np.asarray(pos < cap), "cap": cap}

    out = {}
    for name, c in cases.items():
        d = c["x"].shape[-1]
        moe = MoE(d, c["d_ff"], c["e"], c["k"], n_shared=c["n_shared"],
                  shared_d_ff=c["shared_d_ff"], capacity_factor=c["cf"])
        chunk = c["token_chunk"] or 8192
        if c["token_chunk"]:
            moe._chunked_local_moe = functools.partial(
                MoE._chunked_local_moe, moe, token_chunk=chunk)
        params = jax.tree_util.tree_map(jnp.asarray, c["params"])
        x = jnp.asarray(c["x"])
        def call(p, x):
            with mesh_context(mesh):
                return moe(p, x), moe.last_aux
        y, aux = jax.jit(call)(params, x)
        lora = jax.tree_util.tree_map(jnp.asarray, c["lora"])
        wt = jnp.asarray(c["w"])
        def loss(p, l, x):
            with mesh_context(mesh):
                return (jnp.sum(moe(p, x, l) * wt)
                        + c["aux_coef"] * moe.last_aux)
        g_p, g_l, g_x = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(
            params, lora, x)
        grads = {"x": np.asarray(g_x), "params": jax.tree_util.tree_map(
            np.asarray, g_p), "lora": jax.tree_util.tree_map(np.asarray, g_l)}
        b, s, _ = x.shape
        b_shard = b % n_data == 0
        b_loc = b // n_data if b_shard else b
        calls = {}
        for di in range(n_data):
            for mj in range(n_model):
                xs = x[di * b_loc:(di + 1) * b_loc] if b_shard else x
                if c["form"] == "token_parallel":
                    s_loc = s // n_model
                    xs = xs[:, mj * s_loc:(mj + 1) * s_loc]
                xt = xs.reshape(-1, d)
                t = xt.shape[0]
                rw = params["router"]["w"]
                if c["form"] == "expert_parallel" and t > chunk and t % chunk == 0:
                    calls[(di, mj)] = [route(moe, rw, xt[i:i + chunk],
                                             moe.capacity(chunk))
                                       for i in range(0, t, chunk)]
                else:
                    calls[(di, mj)] = [route(moe, rw, xt, moe.capacity(t))]
        out[name] = {"y": np.asarray(y), "aux": float(aux),
                     "calls": calls, "grads": grads}
    pickle.dump(out, open(os.path.join(work, "jax_moe.pkl"), "wb"))
""")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("sharded_moe"))
    with open(os.path.join(work, "moe.pkl"), "wb") as f:
        pickle.dump(make_cases(), f)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    env.pop("XLA_FLAGS", None)
    jax_proc = subprocess.Popen([sys.executable, "-c", _JAX, work], env=env,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
    port = subprocess.run([sys.executable,
                           os.path.join(HERE, "torch_model_ranks.py"), work,
                           "moe", f"{DATA}x{MODEL}"], env=env,
                          capture_output=True, text=True, timeout=300)
    _, jax_err = jax_proc.communicate(timeout=300)
    assert jax_proc.returncode == 0, jax_err[-3000:]
    assert port.returncode == 0, port.stderr[-3000:]
    ranks = []
    for r in range(DATA * MODEL):
        with open(os.path.join(work, f"moe_{DATA}x{MODEL}_{r}.pkl"),
                  "rb") as f:
            ranks.append(pickle.load(f))
    with open(os.path.join(work, "jax_moe.pkl"), "rb") as f:
        jax_out = pickle.load(f)
    return ranks, jax_out


@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_moe_matches_jax_sharded(runs, name):
    ranks, jax_out = runs
    want = jax_out[name]
    for rep in ranks:
        got = rep[name]
        assert got["form"] == CASES[name][-1]
        np.testing.assert_allclose(got["y"], want["y"], rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got["aux"], want["aux"], rtol=RTOL)


@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_moe_routing_exact(runs, name):
    """Every local routing call of every rank: ids, positions, kept
    flags and the capacity equal JAX's on the same local tokens."""
    ranks, jax_out = runs
    for rep in ranks:
        got = rep[name]
        want = jax_out[name]["calls"][got["coord"]]
        assert len(got["calls"]) == len(want)
        for g, w in zip(got["calls"], want):
            assert g["cap"] == w["cap"]
            for key in ("ids", "pos", "keep"):
                np.testing.assert_array_equal(g[key], w[key], err_msg=key)


def _flat(tree, prefix):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + "/" + k))
        return out
    return {prefix: np.asarray(tree, np.float32)}


@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_moe_grads_match_jax_sharded(runs, name):
    """The gradients of ``sum(y * w) + 0.5 aux`` in x, the router, the
    experts, the shared expert and its LoRA, against ``jax.grad`` of
    JAX's sharded call, each leaf within rel L2 1e-5 (a sum over tokens
    in another order moves an element near zero by more than its own
    rtol): the sizes each form's declared gradients, its
    combine over ``model`` and the aux's mean give the backward."""
    ranks, jax_out = runs
    g = jax_out[name]["grads"]
    want = {"x": g["x"], **_flat(g["params"], "params"),
            **_flat(g["lora"], "lora")}
    for rep in ranks:
        got = rep[name]["grads"]
        assert set(got) == set(want)
        for k in sorted(want):
            rel = float(np.linalg.norm(got[k] - want[k])
                        / np.linalg.norm(want[k]))
            assert rel < RTOL, (k, rel)


def test_dropping_cases_drop(runs):
    """The capacity-1.0 cases do drop (else they would test nothing)."""
    ranks, _ = runs
    for name in DROPPING:
        assert any(not c["keep"].all() for rep in ranks
                   for c in rep[name]["calls"]), name


@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_moe_psums(runs, name):
    ranks, _ = runs
    want = 2 if CASES[name][-1] == "expert_parallel" else 1
    assert all(rep[name]["psums"] == want for rep in ranks)
