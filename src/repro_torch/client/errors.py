"""Typed error taxonomy of the client front door (as ``repro.client``).

* :class:`SpecError` — the workload description is malformed; raised at
  ``submit`` time, before any device work.
* :class:`UnsupportedWorkloadError` — the spec is valid but the selected
  backend cannot execute it.
* :class:`UnknownBackendError` — ``ClientConfig.backend`` names nothing.
* :class:`NotPortedError` — the reference has it, this port not yet
  (the ``mesh`` backend).
"""
from __future__ import annotations


class ClientError(Exception):
    """Base class of every deliberate ``repro_torch.client`` failure."""


class SpecError(ClientError, ValueError):
    """A workload spec is malformed (caught before any execution)."""


class UnsupportedWorkloadError(ClientError):
    """The chosen backend cannot run this (valid) workload."""


class UnknownBackendError(ClientError, KeyError):
    """``backend=`` names no registered execution backend."""


class NotPortedError(ClientError, NotImplementedError):
    """A part of the reference's client that this port does not have yet."""
