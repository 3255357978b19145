"""The SSD scan's backward on the CPU: the plain ``ssd_scan_bwd``
(``repro_torch.kernels.ref``, autograd of ``ssd_scan_ragged``) against
``jax.vjp`` of the JAX package's oracle ``repro.kernels.ref.
ssd_scan_ref``, and the dispatch of ``ops.ssd_scan`` under autograd.

The oracle multiplies exp(s_t − s_u) by the triangle after the exp, so
it is compared at chunks of at most 16, where nothing overflows, and at
the training chunk 256 with a decay small enough that exp(s_t − s_u)
stays finite; fp32, each gradient within 1e-5 of its largest entry
(sums in another order).
At chunk 256 with A = −16 the plain backward is finite, as the forward
masks before the exp.  The CUDA kernel is held to the plain version on
the card (``tests/test_torch_kernels_cuda.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as JREF
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import ssd_scan as tssd

#: (Bt, S, H, P, N, chunk), S a multiple of the chunk (the oracle's rule).
CASES = [(1, 32, 2, 8, 8, 8), (2, 48, 3, 4, 6, 16), (1, 64, 2, 16, 16, 16),
         (2, 16, 1, 5, 3, 4)]


def _inputs(Bt, S, H, P, N, seed, A=None):
    rng = np.random.default_rng(seed)
    f = np.float32
    return (rng.standard_normal((Bt, S, H, P)).astype(f),
            (rng.random((Bt, S, H)) * 0.3 + 1e-3).astype(f),
            (-np.linspace(1.0, 16.0, H)).astype(f) if A is None
            else np.full(H, A, f),
            rng.standard_normal((Bt, S, N)).astype(f),
            rng.standard_normal((Bt, S, N)).astype(f),
            rng.standard_normal((Bt, S, H, P)).astype(f),
            rng.standard_normal((Bt, H, N, P)).astype(f))


@pytest.mark.parametrize("case", CASES, ids=str)
@pytest.mark.parametrize("dh", [False, True])
def test_plain_bwd_matches_jax_vjp_of_the_oracle(case, dh):
    Bt, S, H, P, N, chunk = case
    x, dt, A, B, C, dy, dhf = _inputs(Bt, S, H, P, N, seed=S + H)
    (_, h), vjp = jax.vjp(
        lambda *a: JREF.ssd_scan_ref(*a, chunk=chunk),
        *(jnp.asarray(v) for v in (x, dt, A, B, C)))
    want = vjp((jnp.asarray(dy), jnp.asarray(dhf) if dh
                else jnp.zeros_like(h)))
    got = tref.ssd_scan_bwd(*(torch.from_numpy(v) for v in (x, dt, A, B, C,
                                                             dy)),
                            torch.from_numpy(dhf) if dh else None,
                            chunk=chunk)
    for name, g, w in zip(("dx", "ddt", "dA", "dB", "dC"), got, want):
        w = np.asarray(w)
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        assert np.abs(g.numpy() - w).max() <= 1e-5 * np.abs(w).max(), name


def test_plain_bwd_matches_jax_vjp_at_full_width():
    """The plain backward against ``jax.vjp`` of the oracle at the
    training chunk and mamba2-1.3b's widths (P 64, N 128, chunk 256; 8
    independent heads of its 64, two chunks, a dh_final): the CUDA kernel
    is held to the plain version at chunk 256 on the card, so this closes
    the chain at the training shape.  A in [−0.25, −0.05] and dt ≤ 0.3
    keep |s| ≤ 19.2 within a chunk, where the oracle's unmasked
    exp(s_t − s_u) stays finite."""
    Bt, S, H, P, N, chunk = 1, 512, 8, 64, 128, 256
    x, _, _, B, C, dy, dhf = _inputs(Bt, S, H, P, N, seed=7)
    rng = np.random.default_rng(8)
    dt = (rng.random((Bt, S, H)) * 0.299 + 1e-3).astype(np.float32)
    A = np.linspace(-0.25, -0.05, H).astype(np.float32)
    (_, _), vjp = jax.vjp(
        lambda *a: JREF.ssd_scan_ref(*a, chunk=chunk),
        *(jnp.asarray(v) for v in (x, dt, A, B, C)))
    want = vjp((jnp.asarray(dy), jnp.asarray(dhf)))
    got = tref.ssd_scan_bwd(*(torch.from_numpy(v) for v in (x, dt, A, B, C,
                                                             dy, dhf)),
                            chunk=chunk)
    for name, g, w in zip(("dx", "ddt", "dA", "dB", "dC"), got, want):
        w = np.asarray(w)
        assert np.isfinite(w).all(), name
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        assert np.abs(g.numpy() - w).max() <= 1e-5 * np.abs(w).max(), name


def test_plain_bwd_is_finite_where_the_decay_overflows():
    """A = −16, dt = 0.1 at chunk 256 and a ragged S: exp(s_t − s_u) for
    u > t would be inf, and the oracle's product with the triangle NaN."""
    x, _, A, B, C, dy, dhf = _inputs(1, 300, 2, 8, 8, seed=1, A=-16.0)
    dt = np.full((1, 300, 2), 0.1, np.float32)
    got = tref.ssd_scan_bwd(*(torch.from_numpy(v) for v in (x, dt, A, B, C,
                                                            dy, dhf)),
                            chunk=256)
    assert all(bool(torch.isfinite(g).all()) for g in got)
    assert float(got[2].abs().max()) > 0


def test_ssd_scan_on_the_cpu_differentiates_the_plain_version(monkeypatch):
    """``ops.ssd_scan`` on CPU tensors that require grad never reaches the
    kernels' wrappers or libraries; its gradients are the plain
    backward's, bit for bit, and a ragged S keeps them finite."""
    def refuse(*a, **k):
        raise AssertionError("a CUDA wrapper was called for CPU tensors")
    for name in ("ssd_scan", "ssd_scan_bwd", "library", "bwd_library"):
        monkeypatch.setattr(tssd, name, refuse)
    x, dt, A, B, C, dy, dhf = (torch.from_numpy(v) for v in _inputs(
        2, 37, 3, 8, 8, seed=2))
    ins = [t.clone().requires_grad_(True) for t in (x, dt, A, B, C)]
    y, h = tops.ssd_scan(*ins, chunk=16)
    torch.autograd.backward([y, h], [dy, dhf])
    want = tref.ssd_scan_bwd(x, dt, A, B, C, dy, dhf, chunk=16)
    assert all(torch.equal(t.grad, w) for t, w in zip(ins, want))


def test_bwd_wrapper_refuses_cpu_tensors():
    x, dt, A, B, C, dy, _ = (torch.from_numpy(v) for v in _inputs(
        1, 16, 1, 4, 4, seed=3))
    with pytest.raises(ValueError, match="CUDA"):
        tssd.ssd_scan_bwd(x, dt, A, B, C, dy, chunk=8,
                          scratch=torch.zeros(1))
    assert tssd.ssd_scan_bwd.launches == 0
    assert tssd.ssd_scan_bwd.plain is tref.ssd_scan_bwd
