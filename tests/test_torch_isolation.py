"""The port stands alone: no import of ``jax`` or of the JAX package.

* An AST scan of ``src/repro_torch/**.py`` and ``chip_smoke.py`` finds
  no ``import jax`` / ``import repro`` (``repro_torch`` is the port).
* A fresh interpreter with ``jax`` and ``repro`` blocked in
  ``sys.modules`` imports the port and runs a compacted path solve on
  the CPU.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_import_of_jax_or_reference(path):
    assert path.exists()
    assert not _imported_roots(path) & {"jax", "jaxlib", "repro"}


def test_port_runs_with_jax_and_reference_blocked():
    code = """
import sys
for name in ("jax", "jaxlib", "repro"):
    sys.modules[name] = None          # any import of them now fails
from repro_torch.client import FlexaClient, PathSpec, SoloSpec
from repro_torch.config.base import SolverConfig
from repro_torch.problems.lasso import nesterov_instance
p = nesterov_instance(20, 64, 0.1, device="cpu")
client = FlexaClient(device="cpu", solver=SolverConfig(tol=1e-6,
                                                       tau_adapt=False))
r = client.run(PathSpec(problem=p, n_points=5, lam_min_ratio=0.2,
                        compact=True))
assert r.converged.all() and r.support[-1] > 0
s = client.run(SoloSpec(problem=p))
assert s.converged
loaded = [m for m in sys.modules if m.split(".")[0] in ("jax", "repro")
          and sys.modules[m] is not None]
assert not loaded, loaded
print("ok")
"""
    env = {**os.environ,
           "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")
