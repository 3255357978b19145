"""Serving layer of the port: LM generation and two solver runtimes.

The solver engines are the backends behind the client front door
(``repro_torch.client.FlexaClient`` with ``backend="wave"`` /
``"continuous"``); constructing them directly works but emits a one-shot
``FutureWarning``.

* :class:`ServeEngine` — LM prefill/decode on one device.
* :class:`SolverServeEngine` — wave-batched solver serving (padded
  power-of-two buckets run to convergence).
* :class:`ContinuousSolverEngine` — continuous batching: slot slabs,
  chunked steps, eviction/backfill from a policy-ordered admission queue
  (:class:`AdmissionQueue`, :class:`QueueEntry`).
* :class:`PathRequest` / :class:`PathState` — the point-by-point λ-path
  protocol, driven natively by the continuous engine and by the client's
  wave backend.
* :class:`ServeTelemetry` / :class:`RequestTrace` — latency, occupancy
  and waste telemetry (``repro_torch.serve.metrics``).

The mesh engine and its per-device telemetry wait for ROADMAP Queue 1
step 12.
"""
from repro_torch.serve.continuous import (AdmissionQueue,
                                          ContinuousSolverEngine, QueueEntry)
from repro_torch.serve.engine import (GenerationResult, ServeEngine,
                                      SolveRequest, SolveResponse,
                                      SolverServeEngine)
from repro_torch.serve.metrics import RequestTrace, ServeTelemetry
from repro_torch.serve.pathstate import PathRequest, PathState

__all__ = [
    "GenerationResult", "ServeEngine",
    "SolveRequest", "SolveResponse", "SolverServeEngine",
    "ContinuousSolverEngine", "AdmissionQueue", "QueueEntry",
    "PathRequest", "PathState",
    "RequestTrace", "ServeTelemetry",
]
