"""Shared helpers: device choice and the task-vector layout manifest."""
