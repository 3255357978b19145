"""Step-size rule of Algorithm 1, Eq. (4):  γᵏ = γᵏ⁻¹ (1 − θ γᵏ⁻¹)."""
from __future__ import annotations


def gamma_next(gamma, theta):
    """Eq. (4): one update of the diminishing step size."""
    return gamma * (1.0 - theta * gamma)
