"""Synthetic many-task constellations with controllable relatedness.

  latent  z ~ N(0, I_F);   label  y = argmax(W_g z)
  input   x = R_t z + ε

Each task t applies its own input rotation R_t; the backbone must learn
(in LoRA space) to undo R_t before the head can read out W_g.  Tasks of
a group share R_g up to a small rotation (high sign agreement);
conflicting group pairs use R_b = −R_a (systematic sign conflicts).

The constellation itself is drawn with numpy from ``seed`` and is the
JAX package's, number for number.  With ``device=`` its QRs and
products run there in fp64 (``torch.linalg.qr``, matmul) on the same
draws: equal to numpy's within fp64 rounding, and at a wide
``feat_dim`` far quicker on the card than on the host.  Samples are
drawn with a ``torch.Generator`` in place of ``jax.random``, so they
follow the same law but not the same numbers.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.common.device import DeviceLike, resolve_device


@dataclass
class TaskSpec:
    task_id: int
    group: int
    r: np.ndarray               # (F, F) task input rotation
    w: np.ndarray               # (C, F) latent class map (group-level)
    noise: float = 0.05


@dataclass
class Constellation:
    tasks: List[TaskSpec]
    feat_dim: int
    n_classes: int

    @property
    def n_tasks(self) -> int:
        return len(self.tasks)

    def group_of(self, t: int) -> int:
        return self.tasks[t].group

    def oracle_similarity(self) -> np.ndarray:
        """Ground-truth task relatedness: cosine similarity of the input
        transforms the backbone must learn to undo (numpy, the JAX
        package's computation)."""
        flats = np.stack([t.r.reshape(-1) for t in self.tasks])
        flats = flats / (np.linalg.norm(flats, axis=1, keepdims=True) + 1e-12)
        return flats @ flats.T


class _Linalg:
    """Where the constellation's QRs and products run: numpy on the host
    (``device`` None), or fp64 torch on ``device``."""

    def __init__(self, device: Optional[DeviceLike]):
        self.dev = None if device is None else resolve_device(device)

    def array(self, a: np.ndarray):
        return a if self.dev is None else torch.from_numpy(a).to(self.dev)

    def eye(self, f: int):
        return self.array(np.eye(f))

    def q(self, a):
        """Q of the (Householder) QR of ``a``."""
        return (np.linalg.qr(a) if self.dev is None else torch.linalg.qr(a))[0]

    def host32(self, a) -> np.ndarray:
        return (a.astype(np.float32) if self.dev is None
                else a.to(torch.float32).cpu().numpy())


def _small_rotation(rng, f: int, angle: float, la: _Linalg):
    a = la.array(rng.standard_normal((f, f)))
    skew = (a - a.T) / 2
    # first-order rotation exp(angle*skew) ≈ I + angle*skew (renormalised)
    return la.q(la.eye(f) + angle * skew)


def make_constellation(
    *,
    n_tasks: int,
    n_groups: int,
    feat_dim: int = 32,
    n_classes: int = 8,
    within_group_angle: float = 0.05,
    conflict_pairs: Optional[List[Tuple[int, int]]] = None,
    noise: float = 0.05,
    seed: int = 0,
    device: Optional[DeviceLike] = None,
) -> Constellation:
    """Build ``n_tasks`` tasks in ``n_groups`` groups (round-robin);
    ``conflict_pairs`` lists (a, b) group pairs with R_b = −R_a.
    ``device``: None for numpy's QRs and products on the host (the JAX
    package's numbers), or where to run them in fp64 instead."""
    rng = np.random.default_rng(seed)
    la = _Linalg(device)
    group_r, group_w = [], []
    for _g in range(n_groups):
        group_r.append(la.q(la.array(rng.standard_normal((feat_dim,
                                                          feat_dim)))))
        group_w.append(rng.standard_normal((n_classes, feat_dim)))
    for (a, b) in conflict_pairs or []:
        group_r[b] = -group_r[a]  # sign-flipped input transform
    tasks = []
    for t in range(n_tasks):
        g = t % n_groups
        r = group_r[g] @ _small_rotation(rng, feat_dim, within_group_angle, la)
        w = group_w[g] + 0.1 * rng.standard_normal((n_classes, feat_dim))
        tasks.append(TaskSpec(t, g, la.host32(r), w.astype(np.float32),
                              noise))
    return Constellation(tasks, feat_dim, n_classes)


def sample_task_batch(task: TaskSpec, generator: torch.Generator, n: int,
                      class_probs: Optional[np.ndarray] = None):
    """Draw n (x, y) on the CPU: z latent-normal (optionally shifted
    toward sampled class prototypes), y = argmax(W z), x = R z + ε."""
    f = task.r.shape[0]
    w = torch.from_numpy(task.w)
    z = torch.randn((n, f), generator=generator)
    if class_probs is not None:
        cls = torch.multinomial(torch.as_tensor(class_probs, dtype=torch.float64),
                                n, replacement=True, generator=generator)
        protos = w[cls] / (torch.linalg.norm(w[cls], dim=-1, keepdim=True)
                           + 1e-9)
        z = z + 1.5 * protos
    y = torch.argmax(z @ w.T, dim=-1)
    x = z @ torch.from_numpy(task.r).T \
        + task.noise * torch.randn((n, f), generator=generator)
    return x.float(), y


def eval_batch(task: TaskSpec, seed: int = 1234, n: int = 512):
    """Deterministic held-out test set for a task (IID classes)."""
    g = torch.Generator().manual_seed(seed + 7919 * task.task_id)
    return sample_task_batch(task, g, n)
