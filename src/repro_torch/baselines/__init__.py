from repro_torch.baselines import admm, fista, gauss_seidel, grock
from repro_torch.baselines.fista import BaselineResult

__all__ = ["admm", "fista", "gauss_seidel", "grock", "BaselineResult"]
