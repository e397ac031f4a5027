"""Architecture configs of the port (``base``: ``ArchConfig``, input
shapes, LoRA targeting rules; one module per ported architecture)."""
