"""The ranks of the model-parallel tests (``tests/test_torch_sharded_moe.py``
and ``tests/test_torch_sharded_train.py``): the port's sharded MoE forms
and sharded LoRA train steps on gloo CPU ranks.

    python tests/torch_model_ranks.py WORKDIR MODE DATAxMODEL

reads ``WORKDIR/<MODE>.pkl`` (numpy only, written by the test), spawns
DATA·MODEL ranks that rendezvous through a file store in WORKDIR on a
``(data, model)`` debug mesh, and has each rank write
``WORKDIR/<MODE>_<DATA>x<MODEL>_<rank>.pkl``.  MODE "moe": every case's
sharded MoE output and aux (whole, as numpy), the routing each of
this rank's local MoE calls used, and the gradients of a weighted sum
of the output plus the aux.  MODE "train": every arch's loss,
LoRA gradients (before the clip) and updated LoRA of one sharded AdamW
step, the collectives the step
issued by kind (DTensor's, from ``CommDebugMode``, and the counted
psums), and every parameter's local and whole shapes.  MODE "attn":
``nn.attention.sharded_sdpa`` against the plain core on whole tensors,
with DTensor's all-gathers routed as on a card
(``launch.mesh.route_all_gather``).
A rank that raises makes the script exit nonzero.  Nothing here imports
JAX.
"""

from __future__ import annotations

import functools
import os
import pickle
import sys

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(os.path.dirname(HERE), "src"))


def full(x):
    """A DTensor's whole value (a plain tensor as it is), as numpy."""
    from torch.distributed.tensor import DTensor
    if isinstance(x, DTensor):
        x = x.full_tensor()
    return x.detach().float().numpy()


def to_torch(tree):
    from repro_torch.models.convert import tensor_from_numpy
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    return tensor_from_numpy(tree)


def moe_case(case, mesh):
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.models.convert import tensor_from_numpy
    from repro_torch.nn import sharding
    from repro_torch.nn.moe import MoE
    d = case["x"].shape[-1]
    moe = MoE(d, case["d_ff"], case["e"], case["k"],
              n_shared=case["n_shared"], shared_d_ff=case["shared_d_ff"],
              capacity_factor=case["cf"])
    if case.get("token_chunk"):
        moe._chunked_local_moe = functools.partial(
            MoE._chunked_local_moe, moe, token_chunk=case["token_chunk"])
    calls = []
    route = moe.route

    def recording_route(router_w, xt, cap):
        out = route(router_w, xt, cap)
        calls.append({"ids": out[2].numpy(), "pos": out[3].numpy(),
                      "keep": out[4].numpy(), "cap": cap})
        return out
    moe.route = recording_route
    params = to_torch(case["params"])
    with sharding.mesh_context(mesh):
        shard = sharding.logical_to_sharding(moe.axes(), params, mesh=mesh)
        pd = sharding.distribute_tree(params, shard, mesh)
        x = tensor_from_numpy(case["x"])
        xd = distribute_tensor(x, mesh, sharding.spec_placements(
            sharding.resolve_spec(("batch", None, None), x.shape), mesh, 3))
        sharding.reset_collective_counts()
        y = moe(pd, xd)
        form = moe.forms(x.shape[0], x.shape[1], mesh)
        rep = {"y": full(y), "aux": float(full(moe.last_aux)),
               "calls": calls, "form": form["form"],
               "coord": tuple(mesh.get_coordinate()),
               "psums": sharding.collective_counts()["psum"]}
        moe.route = route
        rep["grads"] = moe_grads(moe, case, mesh, pd, xd,
                                 distribute_tensor(to_torch(case["w"]), mesh,
                                                   y.placements))
        return rep


def moe_grads(moe, case, mesh, pd, xd, wd):
    """The gradients of ``sum(y * w) + aux_coef * aux`` of the sharded
    call in x, every parameter and the shared expert's LoRA, whole, by
    "/"-joined path."""
    from repro_torch.common.tree import tree_leaves_with_path, tree_map
    from repro_torch.nn import sharding
    lora = to_torch(case["lora"])
    ld = sharding.distribute_tree(
        lora, sharding.logical_to_sharding(moe.lora_axes(), lora, mesh=mesh),
        mesh)
    pg, lg = (tree_map(lambda t: t.detach().requires_grad_(True), t)
              for t in (pd, ld))
    xg = xd.detach().requires_grad_(True)
    loss = ((moe(pg, xg, lg) * wd).sum()
            + case["aux_coef"] * moe.last_aux)
    named = ([("x", xg)]
             + [("params/" + "/".join(p), t)
                for p, t in tree_leaves_with_path(pg)]
             + [("lora/" + "/".join(p), t)
                for p, t in tree_leaves_with_path(lg)])
    grads = torch.autograd.grad(loss, [t for _, t in named],
                                allow_unused=True, materialize_grads=True)
    return {k: full(g) for (k, _), g in zip(named, grads)}


def train_case(case, mesh):
    from torch.distributed.tensor.debug import CommDebugMode
    from repro_torch.configs.base import SHAPES, load_arch
    from repro_torch.launch.mesh import (arch_rules, batch_shardings,
                                         opt_state_shardings)
    from repro_torch.models.convert import (lora_from_numpy,
                                            params_from_numpy,
                                            tensor_from_numpy)
    from repro_torch.nn import sharding
    from repro_torch.optim import (Optimizer, adamw, chain,
                                   clip_by_global_norm)
    from repro_torch.common.tree import tree_leaves_with_path
    from repro_torch.train.trainer import make_train_step
    cfg = load_arch(case["arch"]).reduced()
    with sharding.mesh_context(mesh, arch_rules(cfg, mesh)):
        model = cfg.build(SHAPES["train_4k"], device="cpu")
        for blk in mixers(model):
            blk.q_chunk = case["q_chunk"]
        params = params_from_numpy(model, case["params"])
        lora = lora_from_numpy(model, case["lora"])
        batch = {k: tensor_from_numpy(v) for k, v in case["batch"].items()}
        params_sh = sharding.logical_to_sharding(model.axes(), params)
        lora_sh = sharding.logical_to_sharding(model.lora_axes(), lora)
        # the trainer's default step (clip 1.0, then AdamW), with the
        # gradients recorded before the clip
        inner, seen = chain(clip_by_global_norm(1.0), adamw(case["lr"])), []

        def update(grads, state, lora):
            seen.append(grads)
            return inner.update(grads, state, lora)
        step, opt = make_train_step(model, Optimizer(inner.init, update),
                                    grad_clip=None)
        pd = sharding.distribute_tree(params, params_sh, mesh)
        ld = sharding.distribute_tree(lora, lora_sh, mesh)
        state = opt.init(lora)
        sd = sharding.distribute_tree(
            state, opt_state_shardings(state, lora_sh, mesh), mesh)
        bd = sharding.distribute_tree(batch, batch_shardings(batch, mesh),
                                      mesh)
        sharding.reset_collective_counts()
        comm = CommDebugMode()
        with comm:
            new_lora, _, m = step(pd, ld, sd, bd)
        comms = {str(k).split(".")[-1]: v
                 for k, v in comm.get_comm_counts().items()}
        psums = sharding.collective_counts()["psum"]
        shapes = {"/".join(p): (tuple(t.to_local().shape), tuple(t.shape))
                  for p, t in tree_leaves_with_path(pd)}
        return {"loss": float(full(m["loss"])),
                "lora": {"/".join(p): full(t)
                         for p, t in tree_leaves_with_path(new_lora)},
                "grads": {"/".join(p): full(t)
                          for p, t in tree_leaves_with_path(seen[0])},
                "comms": comms, "psums": psums, "param_shapes": shapes}


def attn_case(case, mesh):
    """``sharded_sdpa`` on DTensor q / k / v (batch over ``data``, whole
    on ``model``) against the plain core on whole tensors: the output
    and the gradients of q, k and v of a fixed weighting of it."""
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.launch.mesh import route_all_gather
    from repro_torch.nn import sharding
    from repro_torch.nn.attention import Attention
    # DTensor's all-gathers through launch.mesh's routing, as gloo ranks
    # on a card run them
    route_all_gather("CPU")
    h, kvh, hd = case["h"], case["kv"], case["hd"]
    attn = Attention(h * hd, h, kvh, head_dim=hd)
    q, k, v, w = (to_torch(case[n]) for n in ("q", "k", "v", "w"))
    mask = to_torch(case["mask"]) if case["mask"] is not None else None
    want = []
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = attn._sdpa_block(*leaves, mask)
    want = [out.detach()] + list(torch.autograd.grad((out * w).sum(),
                                                     leaves))
    with sharding.mesh_context(mesh):
        pl = sharding.spec_placements(sharding.resolve_spec(
            ("batch", None, None, None), q.shape), mesh, 4)
        ds = [distribute_tensor(t, mesh, pl).requires_grad_(True)
              for t in (q, k, v)]
        out = attn._sdpa(*ds, mask)
        got = [out.full_tensor().detach()] + [
            g.full_tensor() for g in torch.autograd.grad(
                (out * distribute_tensor(w, mesh, out.placements)).sum(),
                ds)]
    return {"err": [float((a - b).abs().max()) for a, b in zip(got, want)],
            "scale": [float(b.abs().max()) for b in want],
            "placements": [str(p) for p in out.placements]}


def mixers(model):
    """Every attention module of an LM's unit blocks (the ones that read
    ``q_chunk``)."""
    out = []
    for _, blk in model.model.unit_blocks:
        mixer = getattr(blk, "mixer", None)
        if mixer is None:
            continue
        out.append(getattr(mixer, "attn", mixer))
    return [m for m in out if hasattr(m, "q_chunk")]


def store_path(work: str, mode: str, shape) -> str:
    """The file store of one spawn: one a mode and mesh, so two spawns in
    one directory never meet."""
    return os.path.join(work, f"store_{mode}_{shape[0]}x{shape[1]}")


def rank_main(rank: int, work: str, mode: str, shape) -> None:
    torch.set_num_threads(1)
    world = shape[0] * shape[1]
    dist.init_process_group(
        "gloo", init_method="file://" + store_path(work, mode, shape),
        rank=rank, world_size=world)
    try:
        from repro_torch.launch.mesh import make_debug_mesh
        mesh = make_debug_mesh(shape, device_type="cpu")
        with open(os.path.join(work, f"{mode}.pkl"), "rb") as f:
            cases = pickle.load(f)
        run = {"moe": moe_case, "train": train_case,
               "attn": attn_case}[mode]
        rep = {name: run(case, mesh) for name, case in cases.items()
               if tuple(case.get("mesh", shape)) == tuple(shape)}
        tag = f"{shape[0]}x{shape[1]}"
        with open(os.path.join(work, f"{mode}_{tag}_{rank}.pkl"), "wb") as f:
            pickle.dump(rep, f)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    work, mode, mesh = sys.argv[1], sys.argv[2], sys.argv[3]
    shape = tuple(int(v) for v in mesh.split("x"))
    store = store_path(work, mode, shape)
    if os.path.exists(store):    # a stale store would hang the rendezvous
        os.remove(store)
    mp.spawn(rank_main, args=(work, mode, shape), nprocs=shape[0] * shape[1])
