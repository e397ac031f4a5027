"""Federated layer: local training, strategies, simulator, testbed
backbones."""
