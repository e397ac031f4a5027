"""Checkpoints of parameter trees (``checkpoint``)."""
