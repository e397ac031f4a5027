"""MaTU core: client math (``unify``), wire types (``client``), the dense
per-task reference round (``aggregation``), the round engine in the
packed and the bool/fp32 layouts (``engine``) and the stateless server
(``server``).
"""
