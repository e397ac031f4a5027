"""Quickstart on the PyTorch/CUDA port: MaTU in 80 lines.

1. builds a synthetic 6-task constellation with a known conflict,
2. runs federated LoRA fine-tuning with the MaTU strategy,
3. prints per-round accuracy, the sign-similarity matrix Eq. 5 learned
   by the server, and the communication ledger vs FedAvg.

It runs on a CUDA device (``run(cfg, device="cpu")`` runs it on the
CPU, each kernel through its plain PyTorch version):

    PYTHONPATH=src python examples/quickstart_torch.py
"""

import numpy as np

from repro_torch.data.dirichlet import dirichlet_split
from repro_torch.data.synthetic import make_constellation
from repro_torch.fed.simulator import FedConfig, FedSimulator, individual_baseline
from repro_torch.fed.strategies import FedAvgStrategy, MaTUStrategy
from repro_torch.fed.testbed import MLPBackbone


def run(cfg: FedConfig, *, device):
    """The quickstart's body at ``cfg`` on ``device``.  Returns the
    individual baseline's accuracies, each strategy's (History,
    strategy), the server's S and the within- and cross-group means."""
    n_tasks = 6
    con = make_constellation(n_tasks=n_tasks, n_groups=3, feat_dim=32,
                             n_classes=8, conflict_pairs=[(0, 1)], seed=0)
    split = dirichlet_split(n_clients=9, n_tasks=n_tasks, n_classes=8,
                            zeta_t=0.5, tasks_per_client=2, seed=0)
    bb = MLPBackbone(32, hidden=64, lora_rank=8)

    print(f"== constellation: {n_tasks} tasks in 3 groups "
          f"(groups 0 and 1 conflict), d = {bb.d} LoRA params ==")

    ind = individual_baseline(cfg, con, bb, device=device)
    print(f"individual fine-tuning (upper bound): "
          f"{np.mean(list(ind.values())):.3f}\n")

    results = {}
    for name, cls in [("matu", MaTUStrategy), ("fedavg", FedAvgStrategy)]:
        strat = cls(n_tasks, bb.d, device=device)
        sim = FedSimulator(cfg, con, split, bb, strat, device=device)
        hist = sim.run(verbose=True)
        results[name] = (hist, strat)
        print()

    h_matu, strat = results["matu"]
    h_avg, _ = results["fedavg"]
    print("== final mean accuracy ==")
    print(f"  MaTU    {h_matu.final_mean_acc:.3f}  "
          f"({h_matu.mean_uplink_bits/8/2**20:.2f} MiB/round uplink)")
    print(f"  FedAvg  {h_avg.final_mean_acc:.3f}  "
          f"({h_avg.mean_uplink_bits/8/2**20:.2f} MiB/round uplink)")

    print("\n== server sign-similarity S(t,t') (Eq. 5) ==")
    s = strat.server.last_similarity.cpu().numpy()
    groups = [con.group_of(t) for t in range(n_tasks)]
    print("groups:", groups)
    for row in s:
        print("  " + " ".join(f"{v:.2f}" for v in row))
    same = [s[a, b] for a in range(n_tasks) for b in range(a + 1, n_tasks)
            if groups[a] == groups[b]]
    diff = [s[a, b] for a in range(n_tasks) for b in range(a + 1, n_tasks)
            if groups[a] != groups[b]]
    print(f"mean within-group S = {np.mean(same):.3f}, "
          f"cross-group S = {np.mean(diff):.3f}")
    return {"individual": ind, **results, "similarity": s,
            "within": float(np.mean(same)), "cross": float(np.mean(diff))}


def main(*, device="cuda"):
    run(FedConfig(rounds=20, local_steps=25, lr=1e-2, eval_every=5, seed=0),
        device=device)


if __name__ == "__main__":
    main()
