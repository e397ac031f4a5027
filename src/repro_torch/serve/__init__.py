"""Multi-tenant MaTU serving: one backbone, one unified vector, T
one-bit modulators.

1. **Store handoff.**  After a federated round,
   ``MaTUServer.serving_downlink(fingerprint=space.fingerprint)``
   re-unifies the full task-vector set into one all-tasks downlink
   (row t is task id t) and :meth:`ModulatorStore.ingest` makes it
   resident on the device: the unified vector once, per task a packed
   mask row and an fp32 λ, behind the layout-fingerprint handshake.
2. **Routing.**  :func:`route_batch` resolves a batch's task ids into a
   routed LoRA tree, dense-routed (per-request adapters from the store's
   LRU) or fused (packed per-leaf mask bits + λ; the modulated weight is
   built inside the ``ops.modulated_matmul`` kernel).
3. **Generation.**  :class:`MultiTenantDecoder` runs :func:`generate`
   (prefill, then a Python loop of decode steps) over the routed tree.
"""

from repro_torch.serve.generate import GenerationConfig, generate
from repro_torch.serve.router import MultiTenantDecoder, route_batch
from repro_torch.serve.store import ModulatorStore

__all__ = ["GenerationConfig", "generate", "ModulatorStore",
           "MultiTenantDecoder", "route_batch"]
