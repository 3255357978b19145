"""CUDA kernels of ``src/repro/kernels/flexa_prox.py``: the FLEXA best
response (``best_response``) and the compaction gather/scatter
(``gather_rows`` / ``scatter_rows``).

They replace the Pallas TPU kernels of that file:

* :func:`best_response` — ``best_response`` at flexa_prox.py:55
  (``pallas_call`` :69): z = sign(w)·max(|w| − c/d, 0) with
  w = x − g/d in fp32, and e2 = Σ(z − x)², for one parameter tensor of
  any shape; d a 0-d fp32 device tensor or dense fp32 of x's shape, c a
  host float.  Source ``csrc/flexa_prox.cu``.
* :func:`gather_rows`  — ``gather_rows`` at flexa_prox.py:278
  (``pallas_call`` :294): out[k] = src[idx[k]] in fp32, zero rows for
  idx −1.  ``src`` may be fp32, bf16 or fp16.
* :func:`scatter_rows` — ``scatter_rows`` at flexa_prox.py:308
  (``pallas_call`` :329): out[i] = vals[inv[i]] where inv[i] ≥ 0, else
  base[i], as a new tensor in base's dtype.

All three only stream bytes, so HBM bandwidth bounds them; the sources
(``csrc/flexa_prox.cu``, ``csrc/compact_rows.cu``) say how each kernel
is laid out for that.  The plain versions are
:func:`repro_torch.kernels.ref.flexa_best_response_ref`,
:func:`~repro_torch.kernels.ref.gather_rows_ref` and
:func:`~repro_torch.kernels.ref.scatter_rows_ref`, also reachable as
``best_response.plain`` / ``gather_rows.plain`` / ``scatter_rows.plain``.

Build: each source into its own shared library, through
:mod:`repro_torch.kernels.build` at first use (nothing is built or
imported at module import), loaded with ``ctypes``.  A failed build or
launch raises; there is no fallback.

Each wrapper counts its launches in a plain integer attribute,
``best_response.launches`` / ``gather_rows.launches`` /
``scatter_rows.launches``, incremented only where the kernel is
launched.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

#: dtype codes of the C interfaces (enum DType in compact_rows.cu and
#: flexa_prox.cu).
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

#: x/g dtypes the best-response kernel is built for (fp32 master weights
#: on the training path, bf16 beside them).
BR_DTYPES = (torch.float32, torch.bfloat16)

#: Threads per block of the best-response kernel (kThreads in the source)
#: and the elements one block takes per grid-stride step, at least.
BR_THREADS, BR_ELEMS_PER_THREAD = 256, 8
#: Resident blocks per SM the best-response grid is capped at.
BR_BLOCKS_PER_SM = 8

_lib = None
_br_lib = None


def br_library() -> ctypes.CDLL:
    """The loaded best-response library (built on first call)."""
    global _br_lib
    if _br_lib is None:
        lib = build.load("flexa_prox")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.best_response_launch.argtypes = [vp, vp, ci, vp, ci,
                                             ctypes.c_float, vp, vp,
                                             ctypes.c_longlong, ci, vp]
        lib.best_response_launch.restype = ci
        _br_lib = lib
    return _br_lib


def best_response_blocks(numel: int, sm_count: int) -> int:
    """Grid size of the best-response kernel: a function of numel and the
    card's SM count only, so e2's summation order (per-block partials
    summed in index order) is the same on every launch."""
    per_block = BR_THREADS * BR_ELEMS_PER_THREAD
    return max(1, min(-(-numel // per_block), BR_BLOCKS_PER_SM * sm_count))


def best_response(x: torch.Tensor, g: torch.Tensor, d: torch.Tensor,
                  c: float) -> tuple[torch.Tensor, torch.Tensor]:
    """CUDA best response → (z fp32 of x's shape, e2 0-d fp32).

    ``x`` and ``g`` contiguous, of one shape and dtype (fp32 or bf16);
    ``d`` a 0-d fp32 tensor (read by the kernel through its
    pointer) or a contiguous fp32 tensor of x's shape; all on one CUDA
    device.  ``c`` is a host float ≥ 0.
    """
    dev = x.device
    for name, t, dtypes in (("x", x, BR_DTYPES),
                            ("g", g, (x.dtype,)),
                            ("d", d, (torch.float32,))):
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{name} must be a CUDA tensor on {dev}, got "
                             f"{t.device}")
        if t.dtype not in dtypes:
            raise TypeError(f"{name} dtype {t.dtype} not in {dtypes}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    dense = d.dim() > 0
    if g.shape != x.shape or (dense and d.shape != x.shape):
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, g "
                         f"{tuple(g.shape)}, d {tuple(d.shape)}")
    z = torch.empty(x.shape, dtype=torch.float32, device=dev)
    n = x.numel()
    if n == 0:
        return z, torch.zeros((), dtype=torch.float32, device=dev)
    blocks = best_response_blocks(
        n, torch.cuda.get_device_properties(dev).multi_processor_count)
    # per-block partials, the ticket counter, e2
    work = torch.empty(blocks + 2, dtype=torch.float32, device=dev)
    lib = br_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.best_response_launch(x.data_ptr(), g.data_ptr(),
                                      DTYPE_CODES[x.dtype], d.data_ptr(),
                                      int(dense), float(c), z.data_ptr(),
                                      work.data_ptr(), n, blocks, stream)
    _raise_on(rc, "best_response")
    best_response.launches += 1
    return z, work[blocks + 1]


def library() -> ctypes.CDLL:
    """The loaded gather/scatter library (built on first call)."""
    global _lib
    if _lib is None:
        lib = build.load("compact_rows")
        vp, ll = ctypes.c_void_p, ctypes.c_longlong
        lib.gather_rows_launch.argtypes = [vp, ctypes.c_int, vp, vp, ll, ll,
                                           vp]
        lib.gather_rows_launch.restype = ctypes.c_int
        lib.scatter_rows_launch.argtypes = [vp, ctypes.c_int, vp, vp, vp,
                                            ctypes.c_int, ll, ll, vp]
        lib.scatter_rows_launch.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(name: str, t: torch.Tensor, ndim: int, dtypes, device) -> None:
    if not t.is_cuda or t.device != device:
        raise ValueError(f"{name} must be a CUDA tensor on {device}, got "
                         f"{t.device}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got shape "
                         f"{tuple(t.shape)}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} dtype {t.dtype} not in {dtypes}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


def gather_rows(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """CUDA ``out[k] = src[idx[k]]`` (−1 ⇒ zero row) → (K, C) fp32.

    ``src`` (N, C) fp32/bf16/fp16 and ``idx`` (K,) int32, both contiguous
    on one CUDA device; every idx entry must lie in [−1, N) (the dispatch
    in :mod:`repro_torch.kernels.ops` checks).
    """
    dev = src.device
    _check("src", src, 2, tuple(DTYPE_CODES), dev)
    _check("idx", idx, 1, (torch.int32,), dev)
    K, C = idx.shape[0], src.shape[1]
    out = torch.empty((K, C), dtype=torch.float32, device=dev)
    if K == 0 or C == 0:
        return out
    lib = library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.gather_rows_launch(src.data_ptr(), DTYPE_CODES[src.dtype],
                                    idx.data_ptr(), out.data_ptr(), K, C,
                                    stream)
    _raise_on(rc, "gather_rows")
    gather_rows.launches += 1
    return out


def scatter_rows(vals: torch.Tensor, inv: torch.Tensor,
                 base: torch.Tensor) -> torch.Tensor:
    """CUDA ``out[i] = vals[inv[i]]`` if inv[i] ≥ 0 else ``base[i]`` →
    a new (N, C) tensor in base's dtype.

    ``vals`` (K, C), ``inv`` (N,) int32 with entries in [−1, K), ``base``
    (N, C); fp32/bf16/fp16, contiguous, on one CUDA device.
    """
    dev = base.device
    _check("base", base, 2, tuple(DTYPE_CODES), dev)
    _check("vals", vals, 2, tuple(DTYPE_CODES), dev)
    _check("inv", inv, 1, (torch.int32,), dev)
    N, C = base.shape
    if inv.shape[0] != N or vals.shape[1] != C:
        raise ValueError(f"shape mismatch: vals {tuple(vals.shape)}, inv "
                         f"{tuple(inv.shape)}, base {tuple(base.shape)}")
    out = torch.empty_like(base)
    if N == 0 or C == 0:
        return out
    lib = library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.scatter_rows_launch(vals.data_ptr(), DTYPE_CODES[vals.dtype],
                                     inv.data_ptr(), base.data_ptr(),
                                     out.data_ptr(), DTYPE_CODES[base.dtype],
                                     N, C, stream)
    _raise_on(rc, "scatter_rows")
    scatter_rows.launches += 1
    return out


best_response.launches = 0
best_response.plain = ref.flexa_best_response_ref
gather_rows.launches = 0
gather_rows.plain = ref.gather_rows_ref
scatter_rows.launches = 0
scatter_rows.plain = ref.scatter_rows_ref
