"""MaTU core: client math (``unify``), wire types (``client``), the dense
per-task reference round (``aggregation``), the round engine in the
packed and the bool/fp32 layouts (``engine``), the stateless server
(``server``) and the baselines' merge math (``baselines``).  The
package exports the client-side types.
"""

from repro_torch.core.client import ClientDownlink, ClientUpload, MaTUClient

__all__ = ["ClientDownlink", "ClientUpload", "MaTUClient"]
