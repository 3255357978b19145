"""Solver substrate of the port: the FLEXA registry, the batched
multi-instance engine (``batched.py``) and active-set compaction
(``compaction.py``)."""
from repro_torch.solvers.batched import BatchedProblemSpec, make_batched_solver
from repro_torch.solvers.registry import available_methods, get_solver, register
from repro_torch.solvers.result import SolverResult

__all__ = [
    "make_batched_solver", "BatchedProblemSpec", "SolverResult",
    "register", "get_solver", "available_methods",
]
