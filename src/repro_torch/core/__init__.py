"""MaTU core: client math (``unify``), wire types (``client``), the dense
per-task reference round (``aggregation``), the round engine in the
packed and the bool/fp32 layouts (``engine``), the stateless server
(``server``) and the baselines' merge math (``baselines``).  The
package exports the client-side types and the client math, as the JAX
package's ``repro.core`` does, but for ``unify`` itself: here that name
stays the submodule's (``from repro_torch.core import unify`` is the
module), so Eq. 2 is ``repro_torch.core.unify.unify``.
"""

from repro_torch.core.client import ClientDownlink, ClientUpload, MaTUClient
from repro_torch.core.unify import (modulate, modulators, task_mask,
                                    task_scaler, unify_masked,
                                    unify_with_modulators,
                                    unify_with_modulators_masked)

__all__ = [
    "ClientDownlink", "ClientUpload", "MaTUClient",
    "modulate", "modulators", "task_mask", "task_scaler",
    "unify_masked", "unify_with_modulators",
    "unify_with_modulators_masked",
]
