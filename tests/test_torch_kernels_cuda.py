"""The CUDA kernels of the port against their plain versions, on the card.

Every test here is marked ``cuda`` and skips where CUDA is unavailable
(the kernels have no CPU mode).  The module imports neither ``jax`` nor
the JAX package, so it runs on a machine with only PyTorch:

    python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

Both kernels only move data, so they must equal their plain versions
bit for bit.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flexa_prox
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

#: (n_rows, k_active, capacity, C, dtype): K=1, all −1, C ∈ {1, 37, 128,
#: 300, 4999, 5000}, N ≠ K, bf16/fp16.
CASES = [
    (16, 5, None, 1, "float32"),
    (16, 5, None, 37, "float32"),
    (12, 1, 1, 128, "float32"),
    (8, 0, 4, 96, "float32"),
    (40, 23, None, 300, "float32"),
    (300, 200, None, 4999, "float32"),
    (300, 200, None, 5000, "float32"),
    (16, 5, None, 300, "bfloat16"),
    (16, 5, None, 128, "float16"),
    (64, 30, None, 1, "bfloat16"),
]


def _plan_arrays(n_rows, k_active, seed, cap=None):
    rng = np.random.default_rng(seed)
    act = np.sort(rng.choice(n_rows, size=k_active, replace=False))
    if cap is None:
        cap = max(1, 1 << (max(k_active, 1) - 1).bit_length())
    idx = np.full(cap, -1, np.int32)
    idx[:k_active] = act
    inv = np.full(n_rows, -1, np.int32)
    inv[act] = np.arange(k_active, dtype=np.int32)
    return idx, inv


def _src(n_rows, C, dtype, seed):
    a = np.random.default_rng(seed).standard_normal((n_rows, C)).astype(
        np.float32)
    return torch.from_numpy(a).to(getattr(torch, dtype))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false); the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n_rows,k,cap,C,dtype", CASES)
def test_cuda_kernels_equal_plain_versions(cuda, n_rows, k, cap, C, dtype):
    idx, inv = _plan_arrays(n_rows, k, seed=n_rows + k + C, cap=cap)
    src = _src(n_rows, C, dtype, seed=C).to(cuda)
    g0 = flexa_prox.gather_rows.launches
    got = tops.gather_blocks(src, idx)
    torch.cuda.synchronize()
    assert flexa_prox.gather_rows.launches == g0 + 1
    want = tref.gather_rows_ref(src, torch.from_numpy(idx).to(cuda))
    assert torch.equal(got, want)
    base = src.flip(0).contiguous()
    s0 = flexa_prox.scatter_rows.launches
    got = tops.scatter_blocks(want, inv, base)
    torch.cuda.synchronize()
    assert flexa_prox.scatter_rows.launches == s0 + 1
    assert torch.equal(got, tref.scatter_rows_ref(
        want, torch.from_numpy(inv).to(cuda), base))


@pytest.mark.cuda
def test_cuda_call_with_failed_build_raises(cuda, monkeypatch, tmp_path):
    """No fallback: when the kernel cannot be built a CUDA call raises."""
    monkeypatch.setattr(flexa_prox, "_lib", None)
    monkeypatch.setattr(flexa_prox, "BUILD_DIR", tmp_path)

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(flexa_prox, "find_nvcc", no_nvcc)
    with pytest.raises(RuntimeError):
        tops.gather_blocks(torch.ones((4, 2), device=cuda),
                           np.zeros(2, np.int32))


@pytest.mark.cuda
def test_compacted_path_on_the_card_launches_the_kernels(cuda):
    """The client's compacted λ-path on the card goes through both
    kernels and agrees with the same path on the CPU (≤1e-5: cuBLAS sums
    in another order)."""
    from repro_torch.client import FlexaClient, PathSpec
    from repro_torch.config.base import SolverConfig
    from repro_torch.problems.lasso import nesterov_instance

    cfg = SolverConfig(tol=1e-7, max_iters=4000, tau_adapt=False)
    spec = dict(n_points=10, lam_min_ratio=0.05, compact=True)
    runs = {}
    for dev in ("cpu", "cuda"):
        p = nesterov_instance(m=30, n=96, nnz_frac=0.1, seed=0, device=dev)
        g0, s0 = (flexa_prox.gather_rows.launches,
                  flexa_prox.scatter_rows.launches)
        runs[dev] = FlexaClient(device=dev, solver=cfg).run(
            PathSpec(problem=p, **spec))
        launched = (flexa_prox.gather_rows.launches - g0,
                    flexa_prox.scatter_rows.launches - s0)
        assert (min(launched) > 0) == (dev == "cuda"), (dev, launched)
    np.testing.assert_allclose(runs["cuda"].x, runs["cpu"].x, atol=1e-5)
    np.testing.assert_array_equal(runs["cuda"].support, runs["cpu"].support)


@pytest.mark.cuda
def test_problem_on_the_card_is_not_moved_again(cuda):
    """A problem built for ``"cuda"`` already lies on the client's card:
    the client runs it as it is."""
    from repro_torch.problems.families import problem_on
    from repro_torch.problems.lasso import nesterov_instance

    p = nesterov_instance(m=20, n=50, nnz_frac=0.1, device="cuda")
    assert problem_on(p, "cuda") is p
