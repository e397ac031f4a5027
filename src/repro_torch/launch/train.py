"""Training launcher (the twin of ``repro.launch.train``, with its flags
and defaults).

Two modes:

* ``fed`` (default): the paper's pipeline, many-task federated LoRA
  fine-tuning with a selectable aggregation strategy on the synthetic
  constellation, with checkpointing and the communication ledger.  The
  MaTU round runs through the card's kernels.

    PYTHONPATH=src python -m repro_torch.launch.train fed --strategy matu \
        --tasks 8 --clients 16 --rounds 40

* ``lm``: supervised LoRA fine-tuning steps of one assigned architecture
  (its reduced variant unless ``--reduced`` is turned off in code; the
  flag, as in the reference, defaults to true).

    PYTHONPATH=src python -m repro_torch.launch.train lm --arch qwen2-0.5b --steps 50

Both run on the card; :func:`run_fed` and :func:`run_lm` take
``device="cpu"`` from a caller that asks for the CPU.  Training draws
(the lm mode's tokens) come from a ``torch.Generator`` seeded as the
reference seeds its keys, so they are other numbers than the
reference's.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.common.device import DeviceLike, resolve_device


def run_fed(args, device: DeviceLike = "cuda"):
    """The ``fed`` mode; returns the run's ``History``."""
    from repro_torch.ckpt.checkpoint import save
    from repro_torch.data.dirichlet import dirichlet_split
    from repro_torch.data.synthetic import make_constellation
    from repro_torch.fed.simulator import (FedConfig, FedSimulator,
                                           individual_baseline)
    from repro_torch.fed.strategies import STRATEGIES
    from repro_torch.fed.testbed import MLPBackbone, ViTBackbone

    dev = resolve_device(device)
    con = make_constellation(n_tasks=args.tasks, n_groups=3, feat_dim=32,
                             n_classes=8, conflict_pairs=[(0, 1)],
                             seed=args.seed)
    split = dirichlet_split(n_clients=args.clients, n_tasks=args.tasks,
                            n_classes=8, zeta_t=args.zeta_t,
                            tasks_per_client=args.tasks_per_client or None,
                            seed=args.seed)
    bb = (ViTBackbone(seed=args.seed, device=dev) if args.backbone == "vit"
          else MLPBackbone(32, hidden=64, lora_rank=8, seed=args.seed))
    cfg = FedConfig(rounds=args.rounds, local_steps=args.local_steps,
                    lr=args.lr, participation=args.participation,
                    eval_every=max(args.rounds // 4, 1), seed=args.seed)

    cls = STRATEGIES[args.strategy]
    kw = {"split_point": bb.split_point} if args.strategy == "fedper" else {}
    strat = cls(args.tasks, bb.d, device=dev, **kw)
    sim = FedSimulator(cfg, con, split, bb, strat, device=dev)
    hist = sim.run(verbose=True)

    print(f"\nfinal mean acc: {hist.final_mean_acc:.3f}  "
          f"uplink/round: {hist.mean_uplink_bits/8/2**20:.2f} MiB")
    if args.compare_individual:
        ind = individual_baseline(cfg, con, bb, device=dev)
        print(f"individual upper bound: {np.mean(list(ind.values())):.3f}")
    if args.ckpt and strat.name == "matu":
        save(args.ckpt, {"task_vectors": strat.server.last_task_vectors},
             {"rounds": args.rounds, "strategy": strat.name})
        print(f"saved server task vectors -> {args.ckpt}.npz")
    return hist


def run_lm(args, device: DeviceLike = "cuda"):
    """The ``lm`` mode; returns each step's loss."""
    from repro_torch.configs.base import SHAPES, input_specs, load_arch
    from repro_torch.optim import adamw, linear_warmup_cosine
    from repro_torch.train.trainer import make_train_step

    dev = resolve_device(device)
    cfg = load_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = cfg.build(SHAPES["train_4k"], device=dev)
    params = model.init(args.seed)
    lora = model.lora_init(args.seed + 1)
    step, opt = make_train_step(
        model, adamw(linear_warmup_cosine(args.lr, 10, args.steps)))
    state = opt.init(lora)

    gen = torch.Generator(device=dev).manual_seed(7)
    losses = []
    for i in range(args.steps):
        batch = input_specs(cfg, SHAPES["train_4k"], concrete=True,
                            batch_override=args.batch, seq_override=args.seq,
                            device=dev)
        batch["tokens"] = torch.randint(
            0, cfg.vocab, tuple(batch["tokens"].shape), generator=gen,
            device=dev, dtype=torch.int32)
        batch["labels"] = torch.roll(batch["tokens"], -1, dims=1)
        t0 = time.perf_counter()
        lora, state, m = step(params, lora, state, batch)
        losses.append(float(m["loss"]))
        if i % max(args.steps // 10, 1) == 0 or i == args.steps - 1:
            print(f"step {i:4d}  loss {losses[-1]:.4f}  "
                  f"{(time.perf_counter()-t0)*1e3:.0f} ms")
    return losses


def parser() -> argparse.ArgumentParser:
    """The reference's flags and defaults, unchanged."""
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="mode")

    f = sub.add_parser("fed")
    f.add_argument("--strategy", default="matu")
    f.add_argument("--tasks", type=int, default=8)
    f.add_argument("--clients", type=int, default=16)
    f.add_argument("--rounds", type=int, default=40)
    f.add_argument("--local-steps", type=int, default=30)
    f.add_argument("--lr", type=float, default=1e-2)
    f.add_argument("--zeta-t", type=float, default=0.0)
    f.add_argument("--tasks-per-client", type=int, default=0)
    f.add_argument("--participation", type=float, default=1.0)
    f.add_argument("--backbone", choices=["mlp", "vit"], default="mlp")
    f.add_argument("--compare-individual", action="store_true")
    f.add_argument("--ckpt", default="")
    f.add_argument("--seed", type=int, default=0)

    l = sub.add_parser("lm")  # noqa: E741
    l.add_argument("--arch", default="qwen2-0.5b")
    l.add_argument("--steps", type=int, default=50)
    l.add_argument("--batch", type=int, default=4)
    l.add_argument("--seq", type=int, default=64)
    l.add_argument("--lr", type=float, default=5e-3)
    l.add_argument("--reduced", action="store_true", default=True)
    l.add_argument("--seed", type=int, default=0)
    return ap


def main(argv=None, device: DeviceLike = "cuda"):
    args = parser().parse_args(argv)
    if args.mode == "lm":
        return run_lm(args, device)
    if args.mode is None:   # the reference's default mode, fed's defaults
        args = parser().parse_args(["fed"])
    return run_fed(args, device)


if __name__ == "__main__":
    main()
