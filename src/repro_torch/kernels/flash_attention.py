"""CUDA kernel of causal GQA flash attention: :func:`flash_attention`.

It replaces the Pallas TPU kernel ``flash_attention`` of
``src/repro/kernels/flash_attention.py:86`` (``pallas_call`` :103): q
(B, Hq, Sq, D) against k, v (B, Hkv, Skv, D), query head h reading kv
head h // (Hq / Hkv), queries aligned to the end of the keys, an online
softmax with an fp32 (m, ℓ, acc) carry, the output in q's dtype.  bf16
inputs run both products on the tensor cores (P·V as three exact bf16
terms of the fp32 p); fp32 inputs on the CUDA cores.  The source
(``csrc/flash_attention.cu``) says what bounds it and how it is laid
out.  The plain version is
:func:`repro_torch.kernels.ref.flash_attention_ref`, also reachable as
``flash_attention.plain``.  The TPU's ``block_q`` / ``block_k`` are not
part of this interface: the kernel chooses its own tiles.

Build: ``csrc/flash_attention.cu`` into its own shared library through
:mod:`repro_torch.kernels.build` at first use, loaded with ``ctypes``.
A failed build or launch raises; there is no fallback.  The wrapper
counts its launches in ``flash_attention.launches``, incremented only
where the kernel is launched.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

#: dtype codes of the C interface (enum DType in flash_attention.cu).
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: Head dims the kernel takes: multiples of 8 up to 128.
D_MULTIPLE, MAX_D = 8, 128

_lib = None


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        lib = build.load("flash_attention")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.flash_attention_launch.argtypes = [vp, vp, vp, vp, ci, ci, ci,
                                               ci, ci, ci, ci, ci,
                                               ctypes.c_float, vp, vp]
        lib.flash_attention_launch.restype = ci
        lib.flash_attention_smem_bytes.argtypes = [ci]
        lib.flash_attention_smem_bytes.restype = ctypes.c_size_t
        lib.flash_attention_kernel_info.argtypes = [ci, ci, vp]
        lib.flash_attention_kernel_info.restype = ci
        _lib = lib
    return _lib


def kernel_info(dtype: torch.dtype, D: int) -> dict:
    """What the compiler made of the kernel that takes ``dtype`` at head
    dim ``D`` (on the current CUDA device): registers and local (spill)
    bytes per thread, static and dynamic shared memory, resident blocks
    per SM, threads per block."""
    out = (ctypes.c_longlong * 6)()
    rc = library().flash_attention_kernel_info(DTYPE_CODES[dtype], D, out)
    if rc != 0:
        raise RuntimeError(f"flash_attention_kernel_info failed: CUDA error "
                           f"{rc}")
    keys = ("registers", "local_bytes", "static_smem", "dynamic_smem",
            "blocks_per_sm", "threads")
    return dict(zip(keys, out))


def check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 causal: bool) -> None:
    """Raise for q, k, v that no attention call takes: other than 4-D,
    mismatched k/v, Hq not a multiple of Hkv, an empty key axis, or a
    causal call with more queries than keys (the oracle's rows are then
    all masked)."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dim() != 4:
            raise ValueError(f"{name} must be 4-D (B, H, S, D), got shape "
                             f"{tuple(t.shape)}")
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    if tuple(k.shape) != (B, Hkv, Skv, D) or v.shape != k.shape:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"Hq = {Hq} is not a multiple of Hkv = {Hkv}")
    if Skv == 0:
        raise ValueError("attention over an empty key axis")
    if causal and Sq > Skv:
        raise ValueError(f"causal attention with Sq = {Sq} > Skv = {Skv}: "
                         "queries are aligned to the end of the keys, so "
                         "the first rows would see no key")


def _kernel_ready(t: torch.Tensor) -> torch.Tensor:
    """``t`` if the kernel can read it as it is (D axis contiguous, other
    strides multiples of 4 elements, 16-byte aligned), else a contiguous
    copy."""
    ok = (t.stride(3) == 1 and all(s % 4 == 0 for s in t.stride()[:3])
          and t.data_ptr() % 16 == 0)
    return t if ok else t.contiguous()


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: float | None = None
                    ) -> torch.Tensor:
    """CUDA attention → (B, Hq, Sq, D) in q's dtype.

    ``q`` (B, Hq, Sq, D), ``k`` and ``v`` (B, Hkv, Skv, D), one dtype
    (fp32 or bf16), on one CUDA device, any strides (a view whose D axis
    is not contiguous is copied first).  D a multiple of 8 up to 128;
    ``scale`` defaults to D^-½ as the oracle forms it
    (:func:`~repro_torch.kernels.ref.attention_scale`).  The result is a
    view with the memory layout (B, Sq, Hq, D), which is what the model's
    head merge reads.
    """
    dev = q.device
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{name} must be a CUDA tensor on {dev}, got "
                             f"{t.device}")
        if t.dtype not in DTYPE_CODES or t.dtype != q.dtype:
            raise TypeError(f"{name} dtype {t.dtype}: the kernel takes one "
                            f"of {tuple(DTYPE_CODES)} for q, k and v alike")
    check_shapes(q, k, v, causal)
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    if D % D_MULTIPLE or not 0 < D <= MAX_D:
        raise ValueError(f"the kernel takes D a multiple of {D_MULTIPLE} up "
                         f"to {MAX_D}, got D = {D}")
    if scale is None:
        scale = ref.attention_scale(D)
    out = torch.empty((B, Sq, Hq, D), dtype=q.dtype,
                      device=dev).transpose(1, 2)
    if B == 0 or Hq == 0 or Sq == 0:
        return out
    q, k, v = (_kernel_ready(t) for t in (q, k, v))
    lib = library()
    strides = (ctypes.c_longlong * 12)(*q.stride()[:3], *k.stride()[:3],
                                       *v.stride()[:3], *out.stride()[:3])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            DTYPE_CODES[q.dtype], B, Hq, Hkv, Sq, Skv, D, int(causal),
            float(scale), strides, stream)
    if rc != 0:
        smem = lib.flash_attention_smem_bytes(D)
        raise RuntimeError(f"flash_attention launch failed: CUDA error {rc} "
                           f"(shared memory {smem} bytes, D {D})")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
flash_attention.plain = ref.flash_attention_ref
