"""Models of the port: the pre-norm ``Block`` (``blocks``), the
decoder-only ``LM`` (``lm``), the encoder-decoder ``EncDecLM``
(``encdec``), the ``ViT`` (``vit``), ``build_model`` / ``ArchModel``
(``builders``) and the carrying of JAX parameter trees (``convert``)."""
