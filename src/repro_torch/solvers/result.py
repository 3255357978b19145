"""Re-export of the shared result contract (lives in ``core.result``)."""
from repro_torch.core.result import SolverResult

__all__ = ["SolverResult"]
