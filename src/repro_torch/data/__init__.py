"""Federated data: Dirichlet task/class splits and synthetic
constellations."""
