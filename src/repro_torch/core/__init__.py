"""MaTU core: client math (``unify``), wire types (``client``), the
packed round engine (``engine``) and the stateless server (``server``).
"""
