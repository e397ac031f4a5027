"""Dirichlet task/class allocation for federated simulations.

Mirrors the paper's FL settings (§4): task concentration ζ_t and class
concentration ζ_c, both via Dir(α) following Li et al. 2021.  Lower α
→ more heterogeneous clients.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np


@dataclass
class FedSplit:
    # tasks[c] = list of task ids held by client c
    tasks: List[List[int]]
    # class_probs[(c, t)] = per-class sampling distribution for client c, task t
    class_probs: Dict[tuple, np.ndarray]
    # data_sizes[(c, t)] = |D_c^t|
    data_sizes: Dict[tuple, int]


def dirichlet_split(
    *,
    n_clients: int,
    n_tasks: int,
    n_classes: int,
    tasks_per_client: Optional[int] = None,
    zeta_t: float = 0.5,
    zeta_c: float = 0.1,
    base_samples: int = 256,
    seed: int = 0,
) -> FedSplit:
    """Allocate tasks and class distributions to clients.

    ``zeta_t == 0`` reproduces the paper's *single-task, no-overlap*
    setting (each client gets exactly one task, round-robin).  Otherwise
    each client draws ``tasks_per_client`` tasks (default: sampled 1–5)
    from a Dir(ζ_t)-skewed task popularity distribution.
    """
    rng = np.random.default_rng(seed)
    tasks: List[List[int]] = []
    if zeta_t == 0.0:
        for c in range(n_clients):
            tasks.append([c % n_tasks])
    else:
        popularity = rng.dirichlet([zeta_t] * n_tasks)
        for c in range(n_clients):
            k = tasks_per_client or int(rng.integers(1, min(n_tasks, 5) + 1))
            k = min(k, n_tasks)
            chosen = rng.choice(n_tasks, size=k, replace=False,
                                p=popularity / popularity.sum())
            tasks.append(sorted(int(t) for t in chosen))
        # coverage: every task must have at least one holder (as in the
        # paper's benchmarks, where every dataset is evaluated)
        held = {t for ts in tasks for t in ts}
        for t in range(n_tasks):
            if t not in held:
                c = int(rng.integers(0, n_clients))
                tasks[c] = sorted(set(tasks[c]) | {t})

    class_probs, data_sizes = {}, {}
    for c in range(n_clients):
        for t in tasks[c]:
            p = rng.dirichlet([max(zeta_c, 1e-3)] * n_classes)
            class_probs[(c, t)] = p.astype(np.float64) / p.sum()
            data_sizes[(c, t)] = int(base_samples * (0.5 + rng.random()))
    return FedSplit(tasks, class_probs, data_sizes)


# stream tags keeping the lazy population draws independent: every
# derived rng seeds a fresh SeedSequence from (seed, TAG, ...), so the
# per-client assignment, per-(client, task) local stats, and per-round
# sampling streams never interleave — asking for client c's tasks can
# never perturb client c+1's, no matter the order (or how often) the
# questions are asked.
_POP_CLIENT, _POP_LOCAL, _POP_ROUND = 0x11, 0x22, 0x33


@dataclass
class PopulationSplit:
    """Lazy Dirichlet task assignment over an arbitrarily large client
    population (the 10^5–10^6 scale-out setting).

    Holds O(T) state only: the Dir(ζ_t) task-popularity vector, drawn
    once from ``seed``.  Everything per-client is DERIVED on demand
    from an order-invariant rng seeded by ``(seed, tag, client_id)``,
    so a population of N clients costs nothing until a client is
    actually sampled, and the same client id always resolves to the
    same tasks/sizes regardless of when or how often it is asked for
    (the round engine's two-pass streaming contract relies on exactly
    this).  Distributions match :func:`dirichlet_split` — minus the
    coverage fix-up, which is both O(N) and unnecessary at population
    scale, where every task is held w.h.p.
    """
    n_clients: int
    n_tasks: int
    n_classes: int = 10
    tasks_per_client: Optional[int] = None
    zeta_t: float = 0.5
    zeta_c: float = 0.1
    base_samples: int = 256
    seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        self.popularity: Optional[np.ndarray] = (
            rng.dirichlet([self.zeta_t] * self.n_tasks)
            if self.zeta_t > 0.0 else None)

    def tasks_for(self, client_id: int) -> List[int]:
        """Client ``client_id``'s task ids (sorted), derived lazily.
        ``zeta_t == 0`` reproduces the single-task round-robin
        setting, like :func:`dirichlet_split`."""
        if self.popularity is None:
            return [int(client_id) % self.n_tasks]
        rng = np.random.default_rng((self.seed, _POP_CLIENT, int(client_id)))
        k = self.tasks_per_client or int(
            rng.integers(1, min(self.n_tasks, 5) + 1))
        k = min(k, self.n_tasks)
        chosen = rng.choice(self.n_tasks, size=k, replace=False,
                            p=self.popularity / self.popularity.sum())
        return sorted(int(t) for t in chosen)

    def local_stats(self, client_id: int, task_id: int
                    ) -> tuple:
        """(class_probs, data_size) for one (client, task) pair —
        same Dir(ζ_c) class skew and size law as the eager split."""
        rng = np.random.default_rng(
            (self.seed, _POP_LOCAL, int(client_id), int(task_id)))
        p = rng.dirichlet([max(self.zeta_c, 1e-3)] * self.n_classes)
        size = int(self.base_samples * (0.5 + rng.random()))
        return p.astype(np.float64) / p.sum(), size

    def data_sizes_for(self, client_id: int) -> List[int]:
        """Data sizes aligned with ``tasks_for(client_id)``."""
        return [self.local_stats(client_id, t)[1]
                for t in self.tasks_for(client_id)]

    def sample_round(self, round_idx: int, n_sampled: int) -> np.ndarray:
        """Deterministic without-replacement client sample for a round
        — O(n_sampled) rejection draws when the sample is a small
        fraction of the population, O(N) permutation otherwise (never
        hit at population scale)."""
        rng = np.random.default_rng((self.seed, _POP_ROUND, int(round_idx)))
        n, k = self.n_clients, min(int(n_sampled), self.n_clients)
        if k * 8 >= n:
            return rng.permutation(n)[:k].astype(np.int64)
        seen: set = set()
        out: List[int] = []
        while len(out) < k:
            for c in rng.integers(0, n, size=k - len(out)):
                c = int(c)
                if c not in seen:
                    seen.add(c)
                    out.append(c)
        return np.asarray(out, np.int64)


def assign_fixed_groups(n_clients: int, task_groups: List[List[int]]) -> FedSplit:
    """Fixed task-group assignment (Fig. 6a conflict experiments):
    client c gets task_groups[c % len(task_groups)] with uniform classes."""
    tasks = [list(task_groups[c % len(task_groups)]) for c in range(n_clients)]
    class_probs, data_sizes = {}, {}
    for c in range(n_clients):
        for t in tasks[c]:
            class_probs[(c, t)] = None  # uniform
            data_sizes[(c, t)] = 256
    return FedSplit(tasks, class_probs, data_sizes)
