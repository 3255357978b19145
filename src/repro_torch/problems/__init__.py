from repro_torch.problems.base import Problem
from repro_torch.problems.lasso import make_lasso, nesterov_instance

__all__ = ["Problem", "make_lasso", "nesterov_instance"]
