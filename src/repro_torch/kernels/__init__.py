"""Kernels of the port: hand-written CUDA for the card, plain torch for
the host.  ``ops`` dispatches on the tensor's device; ``flexa_prox``
holds the CUDA bindings; ``ref`` the plain versions."""
