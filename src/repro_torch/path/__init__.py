"""``repro_torch.path`` — the warm-started, screened λ-path (a port of
``repro.path``): λ_max and grids, strong rules with the KKT recheck, and
the homotopy driver the client's inline backend runs for ``PathSpec``."""
from repro_torch.path.driver import MAX_KKT_ROUNDS, PathResult
from repro_torch.path.grid import geometric_grid, lambda_max, validate_grid
from repro_torch.path.screening import (DEFAULT_KKT_SLACK, ScreenReport,
                                        block_scores, kkt_violations,
                                        strong_rule_active)

__all__ = [
    "PathResult", "MAX_KKT_ROUNDS",
    "geometric_grid", "lambda_max", "validate_grid",
    "ScreenReport", "block_scores", "kkt_violations",
    "strong_rule_active", "DEFAULT_KKT_SLACK",
]
