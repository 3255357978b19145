"""Method registry: one name per algorithm, one adapter per entry point.

Every adapter has the call convention
``adapter(problem, x0, cfg: SolverConfig, **options) -> SolverResult``.
The port registers the FLEXA family (``flexa``, ``flexa_compiled``,
``jacobi``); the reference's baselines and ``pflexa`` are not ported yet
and raise :class:`NotImplementedError` by name.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.config.base import SolverConfig
from repro_torch.core import flexa as _flexa
from repro_torch.problems.base import Problem
from repro_torch.solvers.result import SolverResult

_REGISTRY: dict[str, Callable] = {}

#: Methods of the reference registry that this port does not have yet.
NOT_YET_PORTED = ("admm", "fista", "gauss_seidel", "grock", "pflexa")


def register(name: str, fn: Callable | None = None):
    """Register ``fn`` as solver ``name`` (usable as a decorator)."""
    def _do(f):
        if name in _REGISTRY:
            raise ValueError(f"solver {name!r} already registered")
        _REGISTRY[name] = f
        return f
    return _do if fn is None else _do(fn)


def get_solver(name: str) -> Callable:
    if name in NOT_YET_PORTED:
        raise NotImplementedError(
            f"solver {name!r} is not yet ported to repro_torch; "
            f"available: {available_methods()}")
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown solver {name!r}; available: {available_methods()}"
        ) from None


def available_methods() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def _reject_unknown(options: dict, allowed: tuple = ()):
    unknown = set(options) - set(allowed)
    if unknown:
        raise TypeError(f"unknown solver options {sorted(unknown)}; "
                        f"this method accepts {sorted(allowed) or 'none'}")


@register("flexa")
def _solve_flexa(problem: Problem, x0, cfg: SolverConfig,
                 **options) -> SolverResult:
    """Algorithm 1, greedy ρ-selection (the paper's FPA configuration)."""
    _reject_unknown(options, ("callback", "active"))
    return _flexa.solve(problem, x0=x0, cfg=cfg,
                        callback=options.get("callback"),
                        active=options.get("active"))


@register("flexa_compiled")
def _solve_flexa_compiled(problem: Problem, x0, cfg: SolverConfig,
                          **options) -> SolverResult:
    """Algorithm 1 with the state kept on the device (no history)."""
    _reject_unknown(options)
    return _flexa.solve_compiled(problem, x0=x0, cfg=cfg)


@register("jacobi")
def _solve_jacobi(problem: Problem, x0, cfg: SolverConfig,
                  **options) -> SolverResult:
    """Fully parallel Jacobi: Sᵏ = 𝒩 (ρ → 0 limit of the greedy rule)."""
    _reject_unknown(options)
    r = _flexa.solve(problem, x0=x0,
                     cfg=dataclasses.replace(cfg, jacobi=True))
    r.method = "jacobi"
    return r
