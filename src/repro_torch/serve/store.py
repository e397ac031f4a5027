"""ModulatorStore: the multi-tenant serving state — one unified vector,
T one-bit modulators, no per-task checkpoint.

After federation the server ships ONE unified task vector τ plus per
task a binary mask m^t and a scaler λ^t (paper §3.2); a task's adapter
is ``lora0 + unflatten(λ^t · m^t ⊙ τ)``.  The store holds that state on
the device:

* the unified vector ONCE, in its wire dtype (bf16 off a packed
  downlink), upcast to fp32 only where a delta is built;
* per task id a packed int32 mask row (bool downlink rows are packed on
  ingest) and one fp32 λ;
* materialised adapters in a bounded LRU, rebuilt from the packed state
  on a miss.

Ingest checks the downlink's ``TaskVectorSpace`` fingerprint against
the store's manifest and refuses an unstamped downlink unless the
caller passes ``unchecked=True``.  ``storage_report`` sets the resident
bytes against per-task-checkpoint serving (T full fp32 adapters).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict, Iterable, List, Optional

import torch

from repro_torch.common.device import DeviceLike, resolve_device
from repro_torch.common.tree import (TaskVectorLayoutError, TaskVectorSpace,
                                     tree_add, tree_leaves)
from repro_torch.core.client import ClientDownlink
from repro_torch.core.unify import modulate
from repro_torch.kernels import bitpack

Tree = Any


class ModulatorStore:
    """Task-id-keyed modulator cache behind the multi-tenant decoder.

    ``space`` is the serving model's manifest (over the LoRA template),
    ``lora0`` the base adapter tree the deltas apply to, ``capacity``
    the bound of the LRU of materialised adapters.  Everything the store
    holds lives on ``device`` (default CUDA; raises without a card).
    """

    def __init__(self, space: TaskVectorSpace, lora0: Tree, *,
                 capacity: int = 8, device: DeviceLike = "cuda"):
        if capacity < 1:
            raise ValueError(f"LRU capacity must be >= 1, got {capacity}")
        self.device = resolve_device(device)
        self.space = space
        self.lora0 = lora0
        self.capacity = capacity
        self.unified: Optional[torch.Tensor] = None     # (d,) wire dtype
        self._words: Dict[int, torch.Tensor] = {}       # t -> (W,) int32
        self._lams: Dict[int, torch.Tensor] = {}        # t -> fp32 scalar
        self._lru: "OrderedDict[int, Tree]" = OrderedDict()
        self._tau_tree: Optional[Tree] = None
        self.hits = 0
        self.misses = 0
        self.materializations = 0

    # -- ingest ---------------------------------------------------------
    def ingest(self, downlink: ClientDownlink,
               task_ids: Optional[Iterable[int]] = None, *,
               unchecked: bool = False) -> List[int]:
        """Install a round's unified vector and modulators; row i of the
        downlink is task ``task_ids[i]`` (default ``0..k-1``).  Masks
        become resident as packed words whatever layout they arrive in,
        and stale LRU entries of the refreshed tasks are dropped.
        Returns the installed task ids."""
        if downlink.fingerprint is None:
            if not unchecked:
                raise TaskVectorLayoutError(
                    "refusing to serve an unstamped downlink (no layout "
                    "fingerprint); pass unchecked=True to override")
        else:
            self.space.require_compatible(downlink.fingerprint,
                                          context="serving store ingest")
        d = int(downlink.unified.shape[-1])
        if d < self.space.d:
            raise TaskVectorLayoutError(
                f"downlink vector has {d} coords, serving manifest needs "
                f"d={self.space.d}")
        k = int(downlink.lams.shape[0])
        ids = list(range(k)) if task_ids is None else [int(t) for t in task_ids]
        if len(ids) != k:
            raise ValueError(f"{len(ids)} task ids for {k} modulator rows")
        masks = downlink.masks.to(self.device)
        words = masks if downlink.packed else bitpack.pack_bits(masks)
        lams = downlink.lams.to(self.device, torch.float32)
        self.unified = downlink.unified.to(self.device)
        self._tau_tree = None
        for i, t in enumerate(ids):
            self._words[t] = words[i]
            self._lams[t] = lams[i]
            self._lru.pop(t, None)
        return ids

    # -- lookup ---------------------------------------------------------
    @property
    def task_ids(self) -> List[int]:
        return sorted(self._words)

    def __contains__(self, task_id: int) -> bool:
        return int(task_id) in self._words

    def _require(self, task_id: int) -> int:
        t = int(task_id)
        if t not in self._words:
            raise KeyError(f"task {t} has no resident modulator "
                           f"(known: {self.task_ids})")
        return t

    def mask_words(self, task_id: int) -> torch.Tensor:
        """Packed (ceil(d/32),) int32 modulator row."""
        return self._words[self._require(task_id)]

    def lam(self, task_id: int) -> torch.Tensor:
        return self._lams[self._require(task_id)]

    def delta(self, task_id: int) -> torch.Tensor:
        """Flat fp32 modulated delta λ^t · m^t ⊙ τ (the row is unpacked
        here, at the point of use)."""
        t = self._require(task_id)
        return modulate(self.unified, self._words[t], self._lams[t])

    def tau_tree(self) -> Tree:
        """The unified vector as a model-space tree in the leaf dtypes
        (the fused router's per-leaf τ), built once per ingest."""
        if self.unified is None:
            raise ValueError("store has no unified vector (ingest first)")
        if self._tau_tree is None:
            self._tau_tree = self.space.unflatten(self.unified.float())
        return self._tau_tree

    def adapter(self, task_id: int) -> Tree:
        """The task's adapter ``lora0 + unflatten(delta)`` through the
        LRU (a hit computes nothing; a miss rebuilds from the packed
        state and may evict the least recently used task)."""
        t = self._require(task_id)
        if t in self._lru:
            self.hits += 1
            self._lru.move_to_end(t)
            return self._lru[t]
        self.misses += 1
        self.materializations += 1
        adapter = tree_add(self.lora0, self.space.unflatten(self.delta(t)))
        self._lru[t] = adapter
        while len(self._lru) > self.capacity:
            self._lru.popitem(last=False)
        return adapter

    def cached_task_ids(self) -> List[int]:
        """LRU contents, least to most recently used."""
        return list(self._lru)

    # -- storage accounting ---------------------------------------------
    def resident_bytes(self) -> int:
        """Base adapter + unified vector (wire dtype) + per task one
        packed mask row and one fp32 λ.  The LRU is a bounded working
        set, not serving state, and is left out."""
        base = sum(x.numel() * x.element_size() for x in tree_leaves(self.lora0))
        uni = (self.unified.numel() * self.unified.element_size()
               if self.unified is not None else 0)
        mods = sum(w.numel() * 4 + 4 for w in self._words.values())
        return base + uni + mods

    def checkpoint_bytes(self) -> int:
        """What per-task-checkpoint serving holds instead: one fp32
        adapter (4 bytes per coordinate) per task."""
        return len(self._words) * 4 * self.space.d

    def storage_report(self) -> Dict[str, float]:
        resident = self.resident_bytes()
        ckpt = self.checkpoint_bytes()
        return {
            "tasks": len(self._words),
            "d": self.space.d,
            "resident_bytes": resident,
            "checkpoint_bytes": ckpt,
            "ratio": (ckpt / resident) if resident else float("inf"),
            "lru_capacity": self.capacity,
            "lru_hits": self.hits,
            "lru_misses": self.misses,
            "materializations": self.materializations,
        }
