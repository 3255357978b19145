"""Synthetic training data of the port, as ``repro.data``."""
