"""CUDA kernel of the Mamba2 SSD chunked scan: :func:`ssd_scan`.

It replaces the Pallas TPU kernel ``ssd_scan`` of
``src/repro/kernels/ssd_scan.py:83`` (``pallas_call`` :97): per (batch
row, head), chunks of ``chunk`` rows with the (N, P) fp32 state carried
across them, y in x's dtype and the final state in fp32.  One call
launches three kernels on the current stream: the chunks' own states
and the cumsum of dt·A, over (chunk, head, batch row); the state passed
across chunks, one thread per state element; the chunks' outputs, over
(chunk, head, batch row).  bf16 inputs run every product on the tensor
cores (the fp32 factors as three exact bf16 terms); fp32 and fp16 on
the CUDA cores.  The wrapper allocates the scratch that carries the
per-chunk states and the cumsum between them.  The source
(``csrc/ssd_scan.cu``) says what bounds it and how it is laid out.  The
plain version is
:func:`repro_torch.kernels.ref.ssd_scan_ragged`, also reachable as
``ssd_scan.plain``: it pads a ragged S with dt = 0, while the kernel
masks the ragged last chunk itself, which gives the same result.

:func:`ssd_scan_bwd` is its gradient, a kernel that replaces no TPU
kernel (the Pallas ``ssd_scan`` has no VJP; the JAX package
differentiates its jnp oracle): given dy and the gradient of the final
state, dx, ddt, dA, dB and dC in six launches (``csrc/ssd_scan_bwd.cu``
says what each does), reading the per-chunk entering states and the
cumsum that the forward left in its scratch (``ssd_scan(...,
keep_scratch=True)``).  As the forward, bf16 inputs run every product on
the tensor cores (the fp32 factors as three exact bf16 terms) and sum dB
and dC over groups of 8 heads inside the kernel; fp32 and fp16 on the
CUDA cores.  Its plain version is
:func:`repro_torch.kernels.ref.ssd_scan_bwd` (``ssd_scan_bwd.plain``),
autograd of ``ssd_scan_ragged``.

Build: ``csrc/ssd_scan.cu`` and ``csrc/ssd_scan_bwd.cu`` each into its
own shared library through :mod:`repro_torch.kernels.build` at first
use, loaded with ``ctypes``.  A failed build or launch raises; there is
no fallback.  Each wrapper counts its launches (``ssd_scan.launches``,
``ssd_scan_bwd.launches``), one per call, incremented only where the
kernels are launched; :data:`KERNEL_NAMES` names the device kernels of a
call for the profiler.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

#: dtype codes of the C interface (enum DType in ssd_scan.cu).
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
#: Largest head dim and state size the kernel's register tiles hold.
MAX_P, MAX_N = 64, 128
#: The device kernels one call launches (substrings of their names), in
#: order: chunk states, state pass, chunk outputs.
KERNEL_NAMES = {"ssd_scan": ("ssd_chunk_state", "ssd_state_pass",
                             "ssd_chunk_out"),
                "ssd_scan_bwd": ("ssd_bwd_dstate", "ssd_bwd_state_pass",
                                 "ssd_bwd_rows_u", "ssd_bwd_rows_t",
                                 "ssd_bwd_dlog", "ssd_bwd_head_sum")}
#: Passes as ``kernel_info`` numbers them.
PASSES = {"chunk_state": 0, "state_pass": 1, "chunk_out": 2}
#: The backward's passes as ``bwd_kernel_info`` numbers them.
BWD_PASSES = {"dstate": 0, "state_pass": 1, "rows_u": 2, "rows_t": 3,
              "dlog": 4, "head_sum": 5}

_lib = None
_bwd_lib = None


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        lib = build.load("ssd_scan")
        vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.ssd_scan_launch.argtypes = [vp, vp, vp, vp, vp, ci, vp, vp, vp,
                                        ll, ll, ci, ci, ci, ci, vp, vp]
        lib.ssd_scan_launch.restype = ci
        lib.ssd_scan_scratch_floats.argtypes = [ll, ll, ci, ci, ci, ci]
        lib.ssd_scan_scratch_floats.restype = ll
        lib.ssd_scan_smem_bytes.argtypes = [ci, ci, ci, ci]
        lib.ssd_scan_smem_bytes.restype = ctypes.c_size_t
        lib.ssd_scan_kernel_info.argtypes = [ci, ci, ci, ci, ci, vp]
        lib.ssd_scan_kernel_info.restype = ci
        _lib = lib
    return _lib


def bwd_library() -> ctypes.CDLL:
    """The loaded backward library (built on first call)."""
    global _bwd_lib
    if _bwd_lib is None:
        lib = build.load("ssd_scan_bwd")
        vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.ssd_scan_bwd_launch.argtypes = [vp] * 8 + [ci] + [vp] * 6 + [
            ll, ll, ci, ci, ci, ci, vp, vp]
        lib.ssd_scan_bwd_launch.restype = ci
        lib.ssd_scan_bwd_scratch_floats.argtypes = [ll, ll, ci, ci, ci, ci,
                                                    ci]
        lib.ssd_scan_bwd_scratch_floats.restype = ll
        lib.ssd_scan_bwd_kernel_info.argtypes = [ci, ci, ci, ci, ci, vp]
        lib.ssd_scan_bwd_kernel_info.restype = ci
        _bwd_lib = lib
    return _bwd_lib


_INFO_KEYS = ("registers", "local_bytes", "static_smem", "dynamic_smem",
              "blocks_per_sm", "threads")


def kernel_info(dtype: torch.dtype, pass_: str, N: int, P: int,
                chunk: int) -> dict:
    """What the compiler made of one pass (a key of :data:`PASSES`) for
    ``dtype`` at (N, P, chunk), on the current CUDA device: registers and
    local (spill) bytes per thread, static and dynamic shared memory,
    resident blocks per SM, threads per block."""
    out = (ctypes.c_longlong * 6)()
    rc = library().ssd_scan_kernel_info(DTYPE_CODES[dtype], PASSES[pass_], N,
                                        P, chunk, out)
    if rc != 0:
        raise RuntimeError(f"ssd_scan_kernel_info failed: CUDA error {rc}")
    return dict(zip(_INFO_KEYS, out))


def bwd_kernel_info(dtype: torch.dtype, pass_: str, N: int, P: int,
                    chunk: int) -> dict:
    """:func:`kernel_info` of one of the backward's passes (a key of
    :data:`BWD_PASSES`)."""
    out = (ctypes.c_longlong * 6)()
    rc = bwd_library().ssd_scan_bwd_kernel_info(
        DTYPE_CODES[dtype], BWD_PASSES[pass_], N, P, chunk, out)
    if rc != 0:
        raise RuntimeError(f"ssd_scan_bwd_kernel_info failed: CUDA error "
                           f"{rc}")
    return dict(zip(_INFO_KEYS, out))


def _on_card(name: str, t: torch.Tensor, ndim: int, dtypes, device) -> None:
    if not t.is_cuda or t.device != device:
        raise ValueError(f"{name} must be a CUDA tensor on {device}, got "
                         f"{t.device}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got shape "
                         f"{tuple(t.shape)}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} dtype {t.dtype} not in {dtypes}")


def _check(x, dt, A, B, C, chunk):
    """Device, dtype and shape checks of the scan's inputs → (Bt, S, H, P,
    N)."""
    dev = x.device
    _on_card("x", x, 4, tuple(DTYPE_CODES), dev)
    _on_card("B", B, 3, (x.dtype,), dev)
    _on_card("C", C, 3, (x.dtype,), dev)
    _on_card("dt", dt, 3, (torch.float32,), dev)
    _on_card("A", A, 1, (torch.float32,), dev)
    Bt, S, H, P = x.shape
    N = B.shape[-1]
    if (B.shape != (Bt, S, N) or C.shape != (Bt, S, N)
            or dt.shape != (Bt, S, H) or A.shape != (H,)):
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, B "
                         f"{tuple(B.shape)}, C {tuple(C.shape)}")
    if not (1 <= P <= MAX_P and 1 <= N <= MAX_N and chunk >= 1):
        raise ValueError(f"the kernel takes P ≤ {MAX_P}, N ≤ {MAX_N} and "
                         f"chunk ≥ 1; got P={P}, N={N}, chunk={chunk}")
    return Bt, S, H, P, N


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, *, chunk: int,
             keep_scratch: bool = False):
    """CUDA SSD scan → (y (Bt, S, H, P) in x's dtype, h (Bt, H, N, P) fp32),
    and with ``keep_scratch`` also the scratch that :func:`ssd_scan_bwd`
    reads (the state entering every chunk, then the chunks' cumsums).

    ``x`` (Bt, S, H, P) and ``B``, ``C`` (Bt, S, N) in one dtype (fp32,
    bf16 or fp16), any strides; ``dt`` (Bt, S, H) fp32, any strides;
    ``A`` (H,) fp32.  All on one CUDA device.  S may be ragged against
    ``chunk``; P ≤ 64 and N ≤ 128.
    """
    dev = x.device
    Bt, S, H, P, N = _check(x, dt, A, B, C, chunk)
    y = torch.empty((Bt, S, H, P), dtype=x.dtype, device=dev)
    h = torch.empty((Bt, H, N, P), dtype=torch.float32, device=dev)
    if Bt == 0 or H == 0 or S == 0:
        scratch = torch.empty(0, dtype=torch.float32, device=dev)
        h.zero_()
        return (y, h, scratch) if keep_scratch else (y, h)
    lib = library()
    A = A.contiguous()
    strides = (ctypes.c_longlong * 13)(*x.stride(), *dt.stride(),
                                       *B.stride(), *C.stride())
    # per-chunk states, then the cumsum of every chunk (csrc/ssd_scan.cu)
    scratch = torch.empty(lib.ssd_scan_scratch_floats(Bt, S, H, P, N, chunk),
                          dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.ssd_scan_launch(x.data_ptr(), dt.data_ptr(), A.data_ptr(),
                                 B.data_ptr(), C.data_ptr(),
                                 DTYPE_CODES[x.dtype], y.data_ptr(),
                                 h.data_ptr(), scratch.data_ptr(), Bt, S, H,
                                 P, N, chunk, strides, stream)
    if rc != 0:
        smem = lib.ssd_scan_smem_bytes(DTYPE_CODES[x.dtype], N, P, chunk)
        raise RuntimeError(f"ssd_scan launch failed: CUDA error {rc} "
                           f"(shared memory {smem} bytes, chunk {chunk})")
    ssd_scan.launches += 1
    return (y, h, scratch) if keep_scratch else (y, h)


ssd_scan.launches = 0
ssd_scan.plain = ref.ssd_scan_ragged


def ssd_scan_bwd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 B: torch.Tensor, C: torch.Tensor, dy: torch.Tensor,
                 dh_final: torch.Tensor | None = None, *, chunk: int,
                 scratch: torch.Tensor):
    """CUDA backward of :func:`ssd_scan` → (dx (Bt, S, H, P), ddt (Bt, S,
    H), dA (H,), dB, dC (Bt, S, N)): dx, dB, dC in x's dtype, ddt and dA
    fp32, all contiguous.

    Inputs as :func:`ssd_scan` takes them; ``dy`` (Bt, S, H, P) in x's
    dtype, any strides; ``dh_final`` (Bt, H, N, P) fp32 or None (zero).
    ``scratch`` is what ``ssd_scan(..., keep_scratch=True)`` returned for
    these inputs.
    """
    dev = x.device
    Bt, S, H, P, N = _check(x, dt, A, B, C, chunk)
    _on_card("dy", dy, 4, (x.dtype,), dev)
    if dy.shape != x.shape:
        raise ValueError(f"dy {tuple(dy.shape)}, x {tuple(x.shape)}")
    if dh_final is not None:
        _on_card("dh_final", dh_final, 4, (torch.float32,), dev)
        if dh_final.shape != (Bt, H, N, P):
            raise ValueError(f"dh_final {tuple(dh_final.shape)}, want "
                             f"{(Bt, H, N, P)}")
        dh_final = dh_final.contiguous()
    dx = torch.empty((Bt, S, H, P), dtype=x.dtype, device=dev)
    ddt = torch.empty((Bt, S, H), dtype=torch.float32, device=dev)
    dA = torch.empty((H,), dtype=torch.float32, device=dev)
    dB = torch.empty((Bt, S, N), dtype=x.dtype, device=dev)
    dC = torch.empty((Bt, S, N), dtype=x.dtype, device=dev)
    if Bt == 0 or H == 0 or S == 0:
        return dx, ddt, dA.zero_(), dB, dC
    want = library().ssd_scan_scratch_floats(Bt, S, H, P, N, chunk)
    if (not scratch.is_cuda or scratch.device != dev
            or scratch.dtype != torch.float32 or scratch.numel() != want
            or not scratch.is_contiguous()):
        raise ValueError(f"scratch must be the forward's: {want} contiguous "
                         f"fp32 on {dev}")
    lib = bwd_library()
    A = A.contiguous()
    strides = (ctypes.c_longlong * 17)(*x.stride(), *dt.stride(),
                                       *B.stride(), *C.stride(), *dy.stride())
    work = torch.empty(lib.ssd_scan_bwd_scratch_floats(
        Bt, S, H, P, N, chunk, DTYPE_CODES[x.dtype]), dtype=torch.float32,
        device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.ssd_scan_bwd_launch(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), dy.data_ptr(),
            None if dh_final is None else dh_final.data_ptr(),
            scratch.data_ptr(), DTYPE_CODES[x.dtype], dx.data_ptr(),
            ddt.data_ptr(), dA.data_ptr(), dB.data_ptr(), dC.data_ptr(),
            work.data_ptr(), Bt, S, H, P, N, chunk, strides, stream)
    if rc != 0:
        raise RuntimeError(f"ssd_scan_bwd launch failed: CUDA error {rc} "
                           f"(N {N}, P {P}, chunk {chunk})")
    ssd_scan_bwd.launches += 1
    return dx, ddt, dA, dB, dC


ssd_scan_bwd.launches = 0
ssd_scan_bwd.plain = ref.ssd_scan_bwd
