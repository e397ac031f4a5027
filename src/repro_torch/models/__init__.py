"""Models of the port: the pre-norm ``Block`` (``blocks``), the
decoder-only ``LM`` (``lm``), ``build_model`` / ``ArchModel``
(``builders``) and the carrying of JAX parameter trees (``convert``)."""
