"""The solver service across packages: one wire, two implementations.

* A ``repro_torch`` server (``python -m repro_torch.remote.server
  --device cpu``) answers the JAX package's
  ``repro.client.FlexaClient(backend="remote")``.
* A ``repro.remote.server`` subprocess (``JAX_PLATFORMS=cpu``) answers
  the port's ``FlexaClient(backend="remote")``.

Both servers run the calibrated equivalence config (``--tol 1e-7
--max-iters 4000 --no-tau-adapt``), and each answer is held within 1e-5
of the *other* package's inline solve, for a Lasso solo and a group-Lasso
path (equal λ grids and supports), and comes back as the asking
package's own result class.
"""
import os
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro.client import (FlexaClient as JClient, PathSpec as JPathSpec,
                          SoloSpec as JSoloSpec)
from repro.config.base import ClientConfig as JClientConfig
from repro.config.base import SolverConfig as JSolverConfig
from repro.problems.group_lasso import nesterov_group_instance as jgroup
from repro.problems.lasso import nesterov_instance as jnesterov
from repro_torch.client import FlexaClient, PathSpec, SoloSpec
from repro_torch.config.base import ClientConfig, SolverConfig
from repro_torch.problems.families import problem_from_arrays

ROOT = Path(__file__).resolve().parents[1]
CFG = dict(tol=1e-7, max_iters=4000, tau_adapt=False)
SERVER_ARGS = ["--tol", "1e-7", "--max-iters", "4000", "--no-tau-adapt"]
GRID = dict(n_points=4, lam_min_ratio=0.2)


def _spawn(module, extra=()):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1"}
    return subprocess.Popen(
        [sys.executable, "-m", module, "--port", "0", *SERVER_ARGS, *extra],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env, text=True)


def _ready(proc):
    """The URL of a server once it printed its READY line."""
    for line in proc.stdout:
        if line.startswith("READY port="):
            return proc, f"http://127.0.0.1:{int(line.split('=')[1])}"
    err = proc.stderr.read()
    proc.kill()
    raise RuntimeError(f"{proc.args} failed to start:\n{err}")


def _stop(proc):
    proc.send_signal(signal.SIGTERM)
    out, _ = proc.communicate(timeout=60)
    assert proc.returncode == 0 and "DRAINED" in out


@pytest.fixture(scope="module")
def servers():
    """(port server URL, reference server URL), both drained at the end
    with exit 0."""
    started = {"port": _spawn("repro_torch.remote.server",
                              ["--device", "cpu"]),
               "ref": _spawn("repro.remote.server")}    # boot together
    procs = {k: _ready(proc) for k, proc in started.items()}
    yield {k: url for k, (_, url) in procs.items()}
    for proc, _ in procs.values():
        _stop(proc)


@pytest.fixture(scope="module")
def pair():
    """Each case's instance in both packages (same numpy data)."""
    out = {}
    for case, pj in (("solo", jnesterov(m=24, n=64, nnz_frac=0.1, c=1.0,
                                        seed=0)),
                     ("path", jgroup(m=24, n_blocks=16, block_size=4,
                                     nnz_frac=0.25, c=1.0, seed=0))):
        pt = problem_from_arrays(
            pj.family, {k: np.asarray(v) for k, v in pj.data.items()},
            pj.g_weight, block_size=pj.block_size, device="cpu")
        out[case] = (pj, pt)
    return out


def _check(case, got, ref, backend="remote"):
    np.testing.assert_allclose(np.asarray(got.x), np.asarray(ref.x),
                               atol=1e-5)
    if case == "solo":
        assert got.backend == backend and got.converged and ref.converged
    else:
        np.testing.assert_allclose(got.lambdas, ref.lambdas, rtol=1e-12)
        np.testing.assert_array_equal(got.support, ref.support)
        assert got.meta["backend"] == backend
        assert np.asarray(got.converged).all()


@pytest.mark.parametrize("case", ["solo", "path"])
def test_port_server_answers_the_reference_client(servers, pair, case):
    pj, pt = pair[case]
    client = JClient(config=JClientConfig(
        backend="remote", remote_url=servers["port"],
        solver=JSolverConfig(**CFG)))
    inline = FlexaClient(device="cpu", solver=SolverConfig(**CFG))
    if case == "solo":
        got, ref = (client.run(JSoloSpec(problem=pj)),
                    inline.run(SoloSpec(problem=pt)))
    else:
        got, ref = (client.run(JPathSpec(problem=pj, **GRID)),
                    inline.run(PathSpec(problem=pt, **GRID)))
    assert type(got).__module__.split(".")[0] == "repro"
    _check(case, got, ref)


@pytest.mark.parametrize("case", ["solo", "path"])
def test_reference_server_answers_the_port_client(servers, pair, case):
    pj, pt = pair[case]
    client = FlexaClient(config=ClientConfig(
        backend="remote", remote_url=servers["ref"],
        solver=SolverConfig(**CFG)), device="cpu")
    inline = JClient(solver=JSolverConfig(**CFG))
    if case == "solo":
        got, ref = (client.run(SoloSpec(problem=pt)),
                    inline.run(JSoloSpec(problem=pj)))
    else:
        got, ref = (client.run(PathSpec(problem=pt, **GRID)),
                    inline.run(JPathSpec(problem=pj, **GRID)))
    assert type(got).__module__.split(".")[0] == "repro_torch"
    assert isinstance(got.x, np.ndarray)
    _check(case, got, ref)
    if got.ledger is not None:
        assert got.ledger.conserved()
