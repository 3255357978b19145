"""CUDA kernels of the compaction path: ``gather_rows`` / ``scatter_rows``.

They replace the Pallas TPU kernels of ``src/repro/kernels/flexa_prox.py``:

* :func:`gather_rows`  — ``gather_rows`` at flexa_prox.py:278
  (``pallas_call`` :294): out[k] = src[idx[k]] in fp32, zero rows for
  idx −1.  ``src`` may be fp32, bf16 or fp16.
* :func:`scatter_rows` — ``scatter_rows`` at flexa_prox.py:308
  (``pallas_call`` :329): out[i] = vals[inv[i]] where inv[i] ≥ 0, else
  base[i], as a new tensor in base's dtype.

Both only move bytes, so HBM bandwidth bounds them; the source
(``csrc/compact_rows.cu``) says how each kernel is laid out for that.
The plain versions are :func:`repro_torch.kernels.ref.gather_rows_ref`
and :func:`~repro_torch.kernels.ref.scatter_rows_ref`, also reachable as
``gather_rows.plain`` / ``scatter_rows.plain``.

Build: ``nvcc -gencode arch=compute_90a,code=sm_90a -O3`` into a shared
library with a plain C interface under ``build/repro_torch/`` at the root
of the checkout, at first use (the file name carries a hash of the
source, so an edited source is rebuilt), and loaded with ``ctypes``.
Nothing is built or imported at module import.  A failed build or
launch raises; there is no fallback.

Each wrapper counts its launches in a plain integer attribute,
``gather_rows.launches`` / ``scatter_rows.launches``, incremented only
where the kernel is launched.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

from repro_torch.kernels import ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "compact_rows.cu"
#: Build directory (listed in .gitignore): <checkout>/build/repro_torch.
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

#: dtype codes of the C interface (enum DType in compact_rows.cu).
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

_lib = None
#: Seconds the last nvcc build in this process took (0.0: none ran).
build_seconds = 0.0


def find_nvcc() -> str:
    """Path of ``nvcc`` (PATH, then the toolkit's default prefix)."""
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch "
                       "are built from source at first use")


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libcompact_rows-{digest[:16]}.so"


def build(verbose: bool = False) -> Path:
    """Compile ``csrc/compact_rows.cu`` unless its library is on disk."""
    global build_seconds
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    if verbose:
        cmd[1:1] = ["-Xptxas", "-v"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    if verbose:
        print(proc.stdout + proc.stderr)
    os.replace(tmp, path)
    return path


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
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


gather_rows.launches = 0
gather_rows.plain = ref.gather_rows_ref
scatter_rows.launches = 0
scatter_rows.plain = ref.scatter_rows_ref
