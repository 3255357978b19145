"""``repro_torch.client`` — the front door of the port.

    from repro_torch.client import FlexaClient, PathSpec, SoloSpec

    client = FlexaClient()                  # inline backend, on the card
    r = client.run(SoloSpec(problem))
    path = client.run(PathSpec(problem, compact=True))

Ported: :class:`FlexaClient` with the ``inline`` backend, running
:class:`SoloSpec` and :class:`PathSpec`.  ``BatchSpec``, ``CVSpec``, the
serving backends and ``SolveRequest`` raise :class:`NotPortedError`.
"""
from repro_torch.client.backends import (Backend, InlineBackend,
                                         available_backends, make_backend,
                                         register_backend)
from repro_torch.client.errors import (ClientError, NotPortedError,
                                       SpecError, UnknownBackendError,
                                       UnsupportedWorkloadError)
from repro_torch.client.session import FlexaClient
from repro_torch.client.specs import (BatchSpec, CVSpec, PathSpec,
                                      SoloResult, SoloSpec,
                                      TicketDiagnostics, WorkItem,
                                      normalize, solve_request_of)
from repro_torch.config.base import ClientConfig
from repro_torch.path.driver import PathResult

__all__ = [
    "FlexaClient", "ClientConfig",
    "SoloSpec", "PathSpec", "BatchSpec", "CVSpec",
    "SoloResult", "PathResult", "TicketDiagnostics", "WorkItem",
    "normalize", "solve_request_of",
    "Backend", "InlineBackend",
    "available_backends", "register_backend", "make_backend",
    "ClientError", "SpecError", "UnknownBackendError",
    "UnsupportedWorkloadError", "NotPortedError",
]
