"""End-to-end example on the PyTorch/CUDA port: many-task federated LoRA
fine-tuning of a REAL language model from the assigned zoo (reduced
qwen2 family by default), with MaTU aggregation over the flat LoRA
space — the paper's pipeline applied to an actual transformer.

Three synthetic "tasks" = three next-token languages (distinct Markov
transition structures over the token space).  Each of 4 clients holds
1-2 tasks; per round every client fine-tunes LoRA per task, unifies,
uploads; the stateless server runs Eq. 3-6 and downlinks modulators.

It runs on a CUDA device (``main(device="cpu")`` runs it on the CPU,
each kernel through its plain PyTorch version):

    PYTHONPATH=src python examples/fed_finetune_lm_torch.py [--rounds 5]
"""

import argparse
import time

import numpy as np
import torch

from repro_torch.ckpt.checkpoint import save
from repro_torch.common.tree import TaskVectorSpace, tree_map
from repro_torch.configs.base import SHAPES, load_arch
from repro_torch.core.client import ClientUpload
from repro_torch.core.server import MaTUServer, MaTUServerConfig
from repro_torch.core.unify import modulate, unify_with_modulators
from repro_torch.optim import adamw
from repro_torch.train.trainer import make_train_step

CKPT = "results/ckpt/fed_lm_torch"


def make_task_sampler(task_id: int, vocab: int, seed: int = 0, *,
                      device="cuda"):
    """Markov-chain 'language' over the token space, one per task.

    numpy draws in the JAX example's order, so the same calls give the
    same tokens there and here; ``sample(batch, seq)`` returns int32
    ``tokens`` and ``labels`` (the next token, -100 at the last
    position) on ``device``."""
    rng = np.random.default_rng(seed + 101 * task_id)
    base = rng.dirichlet([0.05] * 64, size=64)  # sparse 64-state chain

    def sample(batch, seq):
        toks = np.zeros((batch, seq), np.int32)
        states = rng.integers(0, 64, batch)
        for s in range(seq):
            probs = base[states]
            states = np.array([rng.choice(64, p=p) for p in probs])
            toks[:, s] = states + task_id * 64  # distinct token regions
        t = torch.from_numpy(toks % vocab).to(device)
        return {"tokens": t, "labels": torch.cat(
            [t[:, 1:], torch.full((batch, 1), -100, dtype=torch.int32,
                                  device=t.device)], dim=1)}

    return sample


def main(argv=None, *, cfg=None, device="cuda"):
    """Runs the example; ``cfg`` (default the reduced qwen2-0.5b) is the
    model's config.  Returns a dict: each round's mean local loss
    (``losses``), every (client, task)'s last local loss (``task_losses``),
    uplink bits (``uplink_bits``) and S(0, 2) (``s02``); every local
    step's wall in s (``step_s``, each ends on the loss read, which
    waits for the device) and each round's server wall (``round_s``, to
    the S read); the ``server``, the ``space`` and the last round's
    ``uploads``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--local-steps", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=48)
    args = ap.parse_args(argv)

    label = "reduced qwen2 family" if cfg is None else cfg.name
    cfg = cfg or load_arch("qwen2-0.5b").reduced()
    model = cfg.build(SHAPES["train_4k"], device=device)
    params = model.init(0)
    lora0 = model.lora_init(1)
    dev = model.device
    # the flat d-axis is DEFINED by the layout manifest; its fingerprint
    # is what client and server compare before a round
    space = TaskVectorSpace.from_tree(lora0)
    d = space.d
    print(f"model: {label}, LoRA d = {d}, layout {space.fingerprint}")

    n_tasks = 3
    client_tasks = [[0], [1], [2], [0, 2]]
    samplers = {t: make_task_sampler(t, cfg.vocab, device=dev)
                for t in range(n_tasks)}

    train_step, opt = make_train_step(model, adamw(5e-3))
    server = MaTUServer(MaTUServerConfig(n_tasks=n_tasks), device=dev)
    downlinks = {}
    step_s = []

    def local_finetune(tv_flat, task):
        """θ_p ⊕ τ -> E local steps -> new τ (flat).  The flat vector
        crosses the wire edge through the layout manifest: unflatten
        once on entry, flatten once on return."""
        lora = tree_map(torch.add, lora0, space.unflatten(tv_flat))
        state = opt.init(lora)
        loss = None
        for s in range(args.local_steps):
            batch = samplers[task](args.batch, args.seq)
            t0 = time.perf_counter()
            lora, state, m = train_step(params, lora, state, batch)
            loss = float(m["loss"])
            step_s.append(time.perf_counter() - t0)
        delta = tree_map(torch.sub, lora, lora0)
        return space.flatten(delta), loss

    out = {"losses": [], "task_losses": [], "uplink_bits": [], "s02": [],
           "step_s": step_s, "round_s": []}
    for r in range(args.rounds):
        uploads, losses = [], []
        for cid, tasks in enumerate(client_tasks):
            tvs = []
            for i, t in enumerate(tasks):
                if cid in downlinks:
                    dl = downlinks[cid]
                    tv0 = modulate(dl.unified, dl.masks[i], dl.lams[i])
                else:
                    tv0 = torch.zeros((d,), dtype=torch.float32, device=dev)
                tv, loss = local_finetune(tv0, t)
                tvs.append(tv)
                losses.append(loss)
            unified, masks, lams = unify_with_modulators(torch.stack(tvs))
            uploads.append(ClientUpload(
                cid, tasks, unified, masks, lams,
                [args.batch * args.seq] * len(tasks),
                fingerprint=space.fingerprint))
        t0 = time.perf_counter()
        downlinks.update(server.round(uploads))
        s02 = float(server.last_similarity[0, 2])
        out["round_s"].append(time.perf_counter() - t0)
        bits = sum(u.uplink_bits() for u in uploads)
        print(f"round {r+1}: mean local loss {np.mean(losses):.4f}  "
              f"uplink {bits/8/2**20:.2f} MiB  "
              f"S(0,2)={s02:.2f}")
        out["losses"].append(float(np.mean(losses)))
        out["task_losses"].append(losses)
        out["uplink_bits"].append(bits)
        out["s02"].append(s02)

    # results/ckpt/ is git-ignored: run artifacts never land in the tree
    save(CKPT, {"task_vectors": server.last_task_vectors},
         {"rounds": args.rounds})
    print(f"saved server task vectors -> {CKPT}.npz")
    return dict(out, server=server, space=space, uploads=uploads)


if __name__ == "__main__":
    main()
