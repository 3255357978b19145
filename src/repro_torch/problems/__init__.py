from repro_torch.problems.base import Problem
from repro_torch.problems.lasso import make_lasso, nesterov_instance
from repro_torch.problems.group_lasso import make_group_lasso, nesterov_group_instance
from repro_torch.problems.logreg import make_logreg, random_logreg_instance
from repro_torch.problems.svm import make_svm, random_svm_instance

__all__ = [
    "Problem", "make_lasso", "nesterov_instance", "make_group_lasso",
    "nesterov_group_instance", "make_logreg", "random_logreg_instance",
    "make_svm", "random_svm_instance",
]
