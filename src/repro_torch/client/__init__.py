"""``repro_torch.client`` — the front door of the port.

    from repro_torch.client import FlexaClient, PathSpec, SoloSpec

    client = FlexaClient()                  # inline backend, on the card
    r = client.run(SoloSpec(problem))
    path = client.run(PathSpec(problem, compact=True))
    batch = client.run(BatchSpec(problems))
    cv = client.run(CVSpec(folds, validation=pairs))

    serve = FlexaClient(backend="continuous")   # or "wave"
    tickets = [serve.submit(SoloSpec(p)) for p in problems]
    results = serve.drain()

Ported: :class:`FlexaClient` with the ``inline``, ``wave``,
``continuous`` and ``remote`` backends, running :class:`SoloSpec`,
:class:`BatchSpec`, :class:`PathSpec` and :class:`CVSpec`, and
:func:`solve_request_of`.  The ``mesh`` backend raises
:class:`NotPortedError`.
"""
from repro_torch.client.backends import (Backend, ContinuousBackend,
                                         InlineBackend, WaveBackend,
                                         available_backends, make_backend,
                                         register_backend)
from repro_torch.client.errors import (ClientError, NotPortedError,
                                       SpecError, UnknownBackendError,
                                       UnsupportedWorkloadError)
from repro_torch.client.session import FlexaClient
from repro_torch.client.specs import (SERVE_PATH_FAMILIES, BatchResult,
                                      BatchSpec, CVResult,
                                      CVSpec, PathSpec, SoloResult,
                                      SoloSpec, TicketDiagnostics, WorkItem,
                                      mse_score, normalize,
                                      solve_request_of)
from repro_torch.config.base import ClientConfig, ServeConfig
from repro_torch.path.driver import PathResult

__all__ = [
    "FlexaClient", "ClientConfig", "ServeConfig",
    "SoloSpec", "PathSpec", "BatchSpec", "CVSpec",
    "SoloResult", "BatchResult", "PathResult", "CVResult",
    "TicketDiagnostics", "WorkItem", "normalize", "mse_score",
    "solve_request_of", "SERVE_PATH_FAMILIES",
    "Backend", "InlineBackend", "WaveBackend", "ContinuousBackend",
    "available_backends", "register_backend", "make_backend",
    "ClientError", "SpecError", "UnknownBackendError",
    "UnsupportedWorkloadError", "NotPortedError",
]
