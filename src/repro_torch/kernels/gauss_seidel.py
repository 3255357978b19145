"""CUDA Gauss-Seidel sweep of the Lasso (``csrc/gauss_seidel.cu``).

:func:`gauss_seidel_sweep` replaces no Pallas kernel.  The reference runs
each Gauss-Seidel sweep as one device program (a ``lax.fori_loop`` over
the n coordinates, ``src/repro/baselines/gauss_seidel.py:37-50``), and
this kernel is the port's form of that program: one launch per sweep,
where eager torch would make a few launches per coordinate.  A cluster
of thread blocks walks the coordinates 32 at a time, Gram-corrected,
each thread block holding a slice of the residual in shared memory; the
source says why.

The plain version is :func:`repro_torch.kernels.ref.gauss_seidel_sweep_ref`
(also ``gauss_seidel_sweep.plain``); the dispatch
(:func:`repro_torch.kernels.ops.gauss_seidel_sweep`) runs it for tensors on
the CPU only.  The kernel is built at first use by
:mod:`repro_torch.kernels.build` (nothing at import) and loaded with
``ctypes``; a failed build or launch raises.  ``gauss_seidel_sweep.launches``
counts launches, incremented only where the kernel is launched.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

#: Largest m (rows of A) the kernel takes (kMaxRows in the source, the
#: first kernel's limit): r is split across the cluster's shared memory.
MAX_ROWS = 57344

#: Substrings of the device-kernel names as ``torch.profiler`` records them.
KERNEL_NAMES = {"gauss_seidel_sweep": ("gauss_seidel_sweep_kernel",)}

_lib = None


def library() -> ctypes.CDLL:
    """The loaded Gauss-Seidel library (built on first call)."""
    global _lib
    if _lib is None:
        lib = build.load("gauss_seidel")
        vp = ctypes.c_void_p
        lib.gauss_seidel_sweep_launch.argtypes = [
            vp, vp, vp, vp, ctypes.c_float, vp, ctypes.c_longlong,
            ctypes.c_int, vp]
        lib.gauss_seidel_sweep_launch.restype = ctypes.c_int
        lib.gauss_seidel_kernel_info.argtypes = [ctypes.c_int, vp]
        lib.gauss_seidel_kernel_info.restype = ctypes.c_int
        _lib = lib
    return _lib


def kernel_info(m: int) -> dict:
    """What the compiler and the card (the current CUDA device) made of the
    sweep at m rows: registers and local (spill) bytes per thread, static
    and dynamic shared memory per CTA, CTAs per cluster, clusters the card
    can hold at once, threads per CTA, rows of r per CTA, rows per staged
    tile and tiles in the ring."""
    out = (ctypes.c_longlong * 10)()
    rc = library().gauss_seidel_kernel_info(m, out)
    if rc != 0:
        raise RuntimeError(f"gauss_seidel_kernel_info failed: CUDA error "
                           f"{rc}")
    keys = ("registers", "local_bytes", "static_smem", "dynamic_smem",
            "cluster_ctas", "max_active_clusters", "threads", "slice_rows",
            "chunk_rows", "ring_slots")
    return dict(zip(keys, out))


def gauss_seidel_sweep(At: torch.Tensor, colsq: torch.Tensor,
                       x: torch.Tensor, r: torch.Tensor,
                       c: float) -> torch.Tensor:
    """One CUDA sweep over the n coordinates, x and r updated in place →
    max |δ| (a 0-d fp32 tensor on the card; nothing is read back).

    ``At`` is Aᵀ, (n, m) (row i is column aᵢ of A); ``colsq`` the floored
    column norms ‖aᵢ‖² (n,); ``x`` (n,); ``r`` = Ax − b (m,); all fp32,
    contiguous, on one CUDA device, m ≤ :data:`MAX_ROWS`.  ``c`` is the
    ℓ1 weight, a host float.
    """
    dev = x.device
    named = (("At", At, 2), ("colsq", colsq, 1), ("x", x, 1), ("r", r, 1))
    for name, t, ndim in named:
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{name} must be a CUDA tensor on {dev}, got "
                             f"{t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} dtype {t.dtype} is not torch.float32")
        if t.dim() != ndim or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {ndim}-D tensor, "
                             f"got shape {tuple(t.shape)}")
    n, m = At.shape
    if colsq.shape != (n,) or x.shape != (n,) or r.shape != (m,):
        raise ValueError(f"shape mismatch: At {tuple(At.shape)}, colsq "
                         f"{tuple(colsq.shape)}, x {tuple(x.shape)}, r "
                         f"{tuple(r.shape)}")
    if m > MAX_ROWS:
        raise ValueError(f"m = {m} rows exceed the {MAX_ROWS} whose residual "
                         "fits the kernel's shared memory")
    max_delta = torch.zeros((), dtype=torch.float32, device=dev)
    if n == 0:
        return max_delta
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = library().gauss_seidel_sweep_launch(
            At.data_ptr(), colsq.data_ptr(), x.data_ptr(), r.data_ptr(),
            float(c), max_delta.data_ptr(), n, m, stream)
    if rc != 0:
        raise RuntimeError(f"gauss_seidel_sweep launch failed: CUDA error "
                           f"{rc}")
    gauss_seidel_sweep.launches += 1
    return max_delta


gauss_seidel_sweep.launches = 0
gauss_seidel_sweep.plain = ref.gauss_seidel_sweep_ref
