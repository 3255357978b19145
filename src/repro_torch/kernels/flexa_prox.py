"""CUDA kernels of ``src/repro/kernels/flexa_prox.py``: the FLEXA best
response (``best_response``), its fused update (``apply_update``), their
batched forms (``batched_best_response``, ``batched_apply_update``), the
compaction gather/scatter (``gather_rows`` / ``scatter_rows``) and the
gather fused with the best response (``compact_best_response``).

They replace the Pallas TPU kernels of that file:

* :func:`best_response` — ``best_response`` at flexa_prox.py:55
  (``pallas_call`` :69): z = sign(w)·max(|w| − c/d, 0) with
  w = x − g/d in fp32, and e2 = Σ(z − x)², for one parameter tensor of
  any shape; d a 0-d fp32 device tensor or dense fp32 of x's shape, c a
  host float.  Source ``csrc/flexa_prox.cu``.
* :func:`apply_update` — ``apply_update`` at flexa_prox.py:104
  (``pallas_call`` :117): x + γ·m·(z − x) in x's dtype, z as
  :func:`best_response` computes it but never written, γ·m a 0-d fp32
  device tensor; written into ``out`` (x itself for the optimizer's
  in-place update).
* :func:`batched_best_response` / :func:`batched_apply_update` —
  flexa_prox.py:174 / :223 (``pallas_call`` :188 / :239): the same over a
  (B, n) bucket with d (), (B,) or dense, c a host float, 0-d or (B,), γ·m
  a 0-d or (B,) device tensor; e2 (B,).  Their threshold is the solver chain's
  (1/d)·c, not c/d (``csrc/flexa_prox.cu`` says why).  The best response
  is one launch of one thread-block cluster per instance up to
  :data:`BATCHED_CTA_ELEMS` × the card's largest cluster elements per
  instance (:func:`batched_blocks`), its e2 summed across the cluster
  without global scratch; :func:`batched_kernel_info` says what the
  compiler and the card made of it.
* :func:`gather_rows`  — ``gather_rows`` at flexa_prox.py:278
  (``pallas_call`` :294): out[k] = src[idx[k]] in fp32, zero rows for
  idx −1.  ``src`` may be fp32, bf16 or fp16.  One block per output row
  (16-byte loads) for wide rows, one thread per row for narrow ones.
* :func:`scatter_rows` — ``scatter_rows`` at flexa_prox.py:308
  (``pallas_call`` :329): out[i] = vals[inv[i]] where inv[i] ≥ 0, else
  base[i], as a new tensor in base's dtype; one launch, one writer per
  row, no atomics.  The path's (n, 1) fp32 vectors, 16-byte aligned,
  take the fast form: each thread 4 rows, an int4 of inv and a float4 of
  base loaded back to back, then the vals loads of those rows together,
  then one float4 store; ⌈n / 1024⌉ blocks of 256.  Every other call one
  row per thread.  The C launcher picks the form and sizes the grid.
* :func:`compact_best_response` — ``compact_best_response`` at
  flexa_prox.py:351 (``pallas_call`` :385): the gather of the K rows idx
  picks from x, g (and a dense d) fused with :func:`best_response` on
  them; z (K, C) fp32 with pad rows 0, e2 over the gathered rows.  Up to
  the card's largest cluster × :data:`COMPACT_CTA_ELEMS` gathered
  elements (every (n, 1) bucket up to K = 131072) it is one launch of
  one thread-block cluster (:func:`compact_blocks`) in which each thread
  issues all its idx loads, then all its gathered loads, before any
  arithmetic, and e2 is summed across the cluster with no memset,
  ticket, fence or atomic, only z and e2 allocated; above that, the grid
  form with per-block partials and a ticket reset by a memset.
  :func:`compact_kernel_info` says what the compiler and the card made
  of the one-cluster kernel.  No path of the reference calls it: it
  stands at its entry point, ``ops.compact_best_response``.

Most of them only stream bytes, so HBM bandwidth bounds them; on the
solver path's (n, 1) vectors the bytes take less than a launch, and
the fixed cost of a call (its device operations, its chain of dependent
loads) bounds them.  The sources (``csrc/flexa_prox.cu``,
``csrc/compact_rows.cu``) say how each kernel is laid out for that.
The plain versions are
the ``*_ref`` functions of :mod:`repro_torch.kernels.ref`
(``flexa_best_response_ref``, ``flexa_apply_ref``,
``flexa_best_response_batched_ref``, ``flexa_apply_batched_ref``,
``gather_rows_ref``, ``scatter_rows_ref``,
``compact_best_response_ref``), also reachable as each wrapper's
``.plain``.

Build: each source into its own shared library, through
:mod:`repro_torch.kernels.build` at first use (nothing is built or
imported at module import), loaded with ``ctypes``.  A failed build or
launch raises; there is no fallback.

Each wrapper counts its launches in a plain integer attribute,
``best_response.launches``, ``apply_update.launches`` and so on,
incremented only where the kernel is launched; :data:`KERNEL_NAMES`
names each wrapper's device kernels as the profiler records them.  The
wrappers read no value back to the host and launch on the current
stream, so a solver iteration that calls them can be captured in a CUDA
graph.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

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

#: The one-launch batched best response: at most this many elements per
#: CTA (512 threads × 16; kCtaElems in the source), at least this many per
#: CTA before another joins the cluster, and at most this many CTAs in a
#: cluster (8 on a card that cannot place 16).
BATCHED_CTA_ELEMS, BATCHED_SPLIT, BATCHED_MAX_CLUSTER = 8192, 2048, 16
#: The one-cluster compact best response: at most this many gathered
#: elements per CTA (512 threads × 16; kCbrCtaElems in compact_rows.cu),
#: and at least this many per CTA before another joins the cluster.  A
#: gather of scattered rows is bounded by what each SM's loads can have
#: in flight, so it spreads over the cluster's 16 SMs early.
COMPACT_CTA_ELEMS, COMPACT_SPLIT = 8192, 256

#: Substrings of the device-kernel names (as ``torch.profiler`` records
#: them) of each wrapper of this module.
KERNEL_NAMES = {"gather_rows": ("gather_wide", "gather_narrow"),
                "scatter_rows": ("scatter_rows4", "scatter_narrow"),
                "best_response": ("flexa_best_response_kernel",),
                "apply_update": ("flexa_apply_update_kernel",),
                "batched_best_response":
                    ("flexa_batched_best_response_kernel",
                     "flexa_batched_best_response_two_level_kernel"),
                "batched_apply_update":
                    ("flexa_batched_apply_update_kernel",),
                "compact_best_response": ("compact_br_cluster",
                                          "compact_br_wide",
                                          "compact_br_narrow")}

#: d modes of the batched kernels (enum DMode in flexa_prox.cu).
D_SCALAR, D_INSTANCE, D_DENSE = 0, 1, 2

_lib = None
_br_lib = None
#: (SM count, largest cluster of a one-launch form) by (CUDA device index,
#: ``"batched"`` or ``"compact"``), read once per device and kernel.
_cards: dict[tuple[int, str], tuple[int, int]] = {}


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
        fl, ll = ctypes.c_float, ctypes.c_longlong
        lib.apply_update_launch.argtypes = [vp, vp, ci, vp, ci, fl, vp, vp,
                                            ll, ci, vp]
        lib.apply_update_launch.restype = ci
        lib.batched_best_response_launch.argtypes = [
            vp, vp, ci, vp, ci, vp, ci, fl, vp, vp, vp, ll, ci, ci, ci, vp]
        lib.batched_best_response_launch.restype = ci
        lib.batched_max_cluster.argtypes = [vp]
        lib.batched_max_cluster.restype = ci
        lib.batched_kernel_info.argtypes = [ci, ci, vp]
        lib.batched_kernel_info.restype = ci
        lib.batched_apply_update_launch.argtypes = [
            vp, vp, ci, vp, ci, vp, ci, fl, vp, ci, vp, ll, ci, ci, vp]
        lib.batched_apply_update_launch.restype = ci
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


def _check_cuda(dev, named, dtypes=(torch.float32,)) -> None:
    """Each (name, tensor) of ``named`` on ``dev``, contiguous, of a dtype
    in ``dtypes`` (None entries are skipped)."""
    for name, t in named:
        if t is None:
            continue
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{name} must be a CUDA tensor on {dev}, got "
                             f"{t.device}")
        if t.dtype not in dtypes:
            raise TypeError(f"{name} dtype {t.dtype} not in {dtypes}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_xg(x: torch.Tensor, g: torch.Tensor) -> None:
    _check_cuda(x.device, (("x", x),), BR_DTYPES)
    _check_cuda(x.device, (("g", g),), (x.dtype,))
    if g.shape != x.shape:
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, g "
                         f"{tuple(g.shape)}")


def apply_update(x: torch.Tensor, g: torch.Tensor, d: torch.Tensor,
                 c: float, gamma_mask: torch.Tensor,
                 out: torch.Tensor | None = None) -> torch.Tensor:
    """CUDA  x + γ·m·(soft(x − g/d, c/d) − x)  → ``out`` (a new tensor of
    x's shape and dtype when None; ``x`` itself updates in place).

    ``x`` and ``g`` contiguous, of one shape and dtype (fp32 or bf16);
    ``d`` a 0-d fp32 tensor or contiguous fp32 of x's shape;
    ``gamma_mask`` a 0-d fp32 tensor (read by the kernel through its
    pointer); all on one CUDA device.  ``c`` a host float ≥ 0.
    """
    _check_xg(x, g)
    dev = x.device
    _check_cuda(dev, (("d", d), ("gamma_mask", gamma_mask)))
    dense = d.dim() > 0
    if (dense and d.shape != x.shape) or gamma_mask.dim() != 0:
        raise ValueError(f"d must be 0-d or of x's shape {tuple(x.shape)}, "
                         f"gamma_mask 0-d; got {tuple(d.shape)}, "
                         f"{tuple(gamma_mask.shape)}")
    if out is None:
        out = torch.empty_like(x)
    _check_cuda(dev, (("out", out),), (x.dtype,))
    if out.shape != x.shape:
        raise ValueError(f"out {tuple(out.shape)} is not x's shape")
    n = x.numel()
    if n == 0:
        return out
    blocks = best_response_blocks(
        n, torch.cuda.get_device_properties(dev).multi_processor_count)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = br_library().apply_update_launch(
            x.data_ptr(), g.data_ptr(), DTYPE_CODES[x.dtype], d.data_ptr(),
            int(dense), float(c), gamma_mask.data_ptr(), out.data_ptr(), n,
            blocks, stream)
    _raise_on(rc, "apply_update")
    apply_update.launches += 1
    return out


def update_blocks(n: int, B: int, sm_count: int) -> int:
    """Blocks per instance of the grid-stride batched kernels
    (``batched_apply_update``, and the best response's two-level form): a
    function of n, B and the SM count only (e2's summation order is then
    fixed), the whole grid capped near 8 blocks per SM."""
    per_block = BR_THREADS * BR_ELEMS_PER_THREAD
    cap = max(1, BR_BLOCKS_PER_SM * sm_count // B)
    return max(1, min(-(-n // per_block), cap))


class ClusterGrid(NamedTuple):
    """Grid of a batched best response (``ctas`` per instance) or of
    :func:`compact_best_response`: ``ctas`` CTAs (a cluster in the
    one-launch form), ``per_cta`` elements each (in the other form
    ⌈n / ctas⌉, walked grid-stride), and the form."""
    ctas: int
    per_cta: int
    one_launch: bool


def _one_cluster(n: int, max_cluster: int, split: int) -> ClusterGrid:
    """One cluster over n ≤ ``max_cluster`` × the kernel's CTA share of
    elements: ⌈n / split⌉ CTAs capped at ``max_cluster``, each a share
    of ⌈n / C⌉ rounded up to 8 elements."""
    C = min(max_cluster, max(1, -(-n // split)))
    return ClusterGrid(C, -(-n // (8 * C)) * 8, True)


@functools.lru_cache(maxsize=1024)
def batched_blocks(n: int, B: int, sm_count: int,
                   max_cluster: int = BATCHED_MAX_CLUSTER) -> ClusterGrid:
    """Grid of :func:`batched_best_response` from (n, B, SM count) and the
    card's largest cluster, nothing else, so e2's summation order is the
    same on every launch.

    Up to ``max_cluster`` × :data:`BATCHED_CTA_ELEMS` elements per
    instance (131072 on an H100) one launch of one cluster per instance:
    C = ⌈n / :data:`BATCHED_SPLIT`⌉ CTAs capped at ``max_cluster`` (1 where
    one CTA covers n), each a share of ⌈n / C⌉ rounded up to 8 elements.
    Above it the two-level form, :func:`update_blocks` blocks per
    instance."""
    if n <= max_cluster * BATCHED_CTA_ELEMS:
        return _one_cluster(n, max_cluster, BATCHED_SPLIT)
    blocks = update_blocks(n, B, sm_count)
    return ClusterGrid(blocks, -(-n // blocks), False)


def _card(index: int, kernel: str = "batched") -> tuple[int, int]:
    """(SM count, largest cluster of ``kernel``'s one-launch form:
    ``"batched"`` for :func:`batched_best_response`, ``"compact"`` for
    :func:`compact_best_response`) of CUDA device ``index``, read on the
    first call for them."""
    card = _cards.get((index, kernel))
    if card is None:
        sms = torch.cuda.get_device_properties(index).multi_processor_count
        query = (br_library().batched_max_cluster if kernel == "batched"
                 else library().compact_max_cluster)
        out = ctypes.c_int()
        with torch.cuda.device(index):
            rc = query(ctypes.byref(out))
        _raise_on(rc, f"{kernel} max_cluster")
        card = _cards[(index, kernel)] = (sms, out.value)
    return card


def _launch(index: int, fn, *args) -> int:
    """``fn(*args, stream)`` on device ``index``'s current stream, under a
    device guard only where ``index`` is not the current device."""
    if index == torch.cuda.current_device():
        return fn(*args, torch._C._cuda_getCurrentRawStream(index))
    with torch.cuda.device(index):
        return fn(*args, torch._C._cuda_getCurrentRawStream(index))


def _instance_arg(v, B: int, dev, name: str):
    """(pointer or None, stride, host value) of a per-instance scalar: a
    host float, or a 0-d or (B,) contiguous fp32 tensor on ``dev``."""
    if not isinstance(v, torch.Tensor):
        return None, 0, float(v)
    _check_cuda(dev, ((name, v),))
    if v.dim() == 0:
        return v.data_ptr(), 0, 0.0
    if v.shape != (B,):
        raise ValueError(f"{name} must be a scalar or ({B},), got "
                         f"{tuple(v.shape)}")
    return v.data_ptr(), 1, 0.0


def _batched_args(x, g, d, c):
    """Checks of a batched call → (B, n, d mode, c pointer, c stride, c
    host value)."""
    dev = x.device
    _check_cuda(dev, (("x", x),), BR_DTYPES)
    _check_cuda(dev, (("g", g),), (x.dtype,))
    _check_cuda(dev, (("d", d),))
    if x.dim() != 2:
        raise ValueError(f"x must be (B, n), got {tuple(x.shape)}")
    B, n = x.shape
    if g.shape != x.shape:
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, g "
                         f"{tuple(g.shape)}")
    if B > 65535:
        raise ValueError(f"B = {B} instances exceed the grid's 65535")
    if d.dim() == 0:
        mode = D_SCALAR
    elif d.shape == (B,):
        mode = D_INSTANCE
    elif d.shape == x.shape:
        mode = D_DENSE
    else:
        raise ValueError(f"d must be (), ({B},) or {tuple(x.shape)}, got "
                         f"{tuple(d.shape)}")
    return (B, n, mode) + _instance_arg(c, B, dev, "c")


def batched_best_response(x: torch.Tensor, g: torch.Tensor,
                          d: torch.Tensor, c
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """CUDA batched best response → (z (B, n) fp32, e2 (B,) fp32).

    ``x``, ``g`` contiguous (B, n), fp32 or bf16, one dtype; ``d`` fp32
    (), (B,) or (B, n); ``c`` a host float or an fp32 0-d or (B,) tensor;
    all on one CUDA device.  z = soft(x − g/d, (1/d)·c) per instance.
    """
    B, n, mode, cp, cs, ch = _batched_args(x, g, d, c)
    dev = x.device
    z = torch.empty((B, n), dtype=torch.float32, device=dev)
    if B == 0 or n == 0:
        return z, torch.zeros((B,), dtype=torch.float32, device=dev)
    e2 = torch.empty((B,), dtype=torch.float32, device=dev)
    index = x.get_device()
    grid = batched_blocks(n, B, *_card(index))
    # the two-level form's per-block partials and per-instance tickets
    work = None if grid.one_launch else torch.empty(
        B * (grid.ctas + 1), dtype=torch.float32, device=dev)
    rc = _launch(index, br_library().batched_best_response_launch,
                 x.data_ptr(), g.data_ptr(), DTYPE_CODES[x.dtype],
                 d.data_ptr(), mode, cp, cs, ch, z.data_ptr(),
                 e2.data_ptr(), None if work is None else work.data_ptr(),
                 n, B, grid.ctas, grid.per_cta)
    _raise_on(rc, "batched_best_response")
    batched_best_response.launches += 1
    return z, e2


def batched_kernel_info(n: int, B: int) -> dict:
    """What the compiler and the card (the current CUDA device) made of
    :func:`batched_best_response` at (n, B) for the solver's inputs (fp32
    x and g, dense d, 16-byte aligned rows): registers and local (spill)
    bytes per thread, threads per CTA, the cluster size C (CTAs per
    instance), elements per CTA, clusters of C the card can hold at once,
    and the form a launch there takes (``"one_launch"`` or
    ``"two_level"``; the cluster keys describe the one-launch form
    only)."""
    index = torch.cuda.current_device()
    grid = batched_blocks(n, B, *_card(index))
    out = (ctypes.c_longlong * 5)()
    rc = br_library().batched_kernel_info(
        int(not grid.one_launch), grid.ctas if grid.one_launch else 1, out)
    _raise_on(rc, "batched_kernel_info")
    return {"registers": out[0], "local_bytes": out[1], "threads": out[2],
            "cluster_ctas": grid.ctas if grid.one_launch else 1,
            "per_cta": grid.per_cta,
            "max_active_clusters": out[4] if grid.one_launch else None,
            "form": "one_launch" if grid.one_launch else "two_level"}


def batched_apply_update(x: torch.Tensor, g: torch.Tensor, d: torch.Tensor,
                         c, gamma_mask: torch.Tensor) -> torch.Tensor:
    """CUDA batched  x + γᵢ·mᵢ·(z − x)  → a new (B, n) tensor in x's
    dtype, z as :func:`batched_best_response` computes it.

    Arguments as there; ``gamma_mask`` an fp32 0-d or (B,) tensor (read
    by the kernel through its pointer).
    """
    B, n, mode, cp, cs, ch = _batched_args(x, g, d, c)
    if not isinstance(gamma_mask, torch.Tensor):
        raise TypeError("gamma_mask must be a 0-d or (B,) fp32 tensor")
    gp, gs, _ = _instance_arg(gamma_mask, B, x.device, "gamma_mask")
    out = torch.empty_like(x)
    if B == 0 or n == 0:
        return out
    index = x.get_device()
    rc = _launch(index, br_library().batched_apply_update_launch,
                 x.data_ptr(), g.data_ptr(), DTYPE_CODES[x.dtype],
                 d.data_ptr(), mode, cp, cs, ch, gp, gs, out.data_ptr(), n,
                 B, update_blocks(n, B, _card(index)[0]))
    _raise_on(rc, "batched_apply_update")
    batched_apply_update.launches += 1
    return out


def library() -> ctypes.CDLL:
    """The loaded gather/scatter library (built on first call)."""
    global _lib
    if _lib is None:
        lib = build.load("compact_rows")
        vp, ll = ctypes.c_void_p, ctypes.c_longlong
        lib.gather_rows_launch.argtypes = [vp, ctypes.c_int, vp, vp, ll, ll,
                                           vp]
        lib.gather_rows_launch.restype = ctypes.c_int
        ci = ctypes.c_int
        lib.scatter_rows_launch.argtypes = [vp, ci, vp, vp, vp, ci, ll, ll,
                                            vp]
        lib.scatter_rows_launch.restype = ci
        lib.compact_best_response_launch.argtypes = [
            vp, vp, ci, vp, ci, ctypes.c_float, vp, vp, vp, vp, ll, ll, ci,
            ci, vp]
        lib.compact_best_response_launch.restype = ci
        lib.compact_max_cluster.argtypes = [vp]
        lib.compact_max_cluster.restype = ci
        lib.compact_kernel_info.argtypes = [ci, ci, vp]
        lib.compact_kernel_info.restype = ci
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
    (N, C); fp32/bf16/fp16, contiguous, on one CUDA device.  C = 1 with
    fp32 vals and base and 16-byte aligned inv and base takes the 4-row
    form; anything else, a view into its storage among them, one row per
    thread.
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
    rc = _launch(base.get_device(), library().scatter_rows_launch,
                 vals.data_ptr(), DTYPE_CODES[vals.dtype], inv.data_ptr(),
                 base.data_ptr(), out.data_ptr(), DTYPE_CODES[base.dtype],
                 N, C)
    _raise_on(rc, "scatter_rows")
    scatter_rows.launches += 1
    return out


#: Narrow rows (C below this) take one thread per row in the grid form of
#: ``compact_best_response`` (kNarrowCols in compact_rows.cu), 256 rows a
#: block (kCbrNarrowThreads).
NARROW_COLS, NARROW_ROWS_PER_BLOCK = 32, 256


@functools.lru_cache(maxsize=1024)
def compact_blocks(K: int, C: int, sm_count: int,
                   max_cluster: int = BATCHED_MAX_CLUSTER) -> ClusterGrid:
    """Grid of :func:`compact_best_response` from (K, C, SM count) and
    the card's largest cluster, nothing else, so e2's summation order is
    the same on every launch.

    Up to ``max_cluster`` × :data:`COMPACT_CTA_ELEMS` gathered elements
    K·C (every bucket of the (n, 1) path up to K = 131072 on an H100) one
    launch of one cluster of ⌈K·C / :data:`COMPACT_SPLIT`⌉ CTAs capped at
    ``max_cluster``, each a share of ⌈K·C / CTAs⌉ rounded up to 8: the
    path's K = 16384 at C = 1 is 16 CTAs of 1024.  Above it the grid
    form: wide rows (C ≥ 32) one per block-step, narrow rows 256 per
    block, capped at 8 blocks per SM."""
    n = K * C
    if n <= max_cluster * COMPACT_CTA_ELEMS:
        return _one_cluster(n, max_cluster, COMPACT_SPLIT)
    units = K if C >= NARROW_COLS else -(-K // NARROW_ROWS_PER_BLOCK)
    blocks = max(1, min(units, BR_BLOCKS_PER_SM * sm_count))
    return ClusterGrid(blocks, -(-n // blocks), False)


def compact_best_response(x: torch.Tensor, g: torch.Tensor,
                          d: torch.Tensor, c: float, idx: torch.Tensor
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """CUDA fused gather + best response → (z (K, C) fp32, e2 0-d fp32).

    ``x`` and ``g`` (N, C) contiguous, of one dtype (fp32 or bf16); ``d``
    a 0-d fp32 tensor (read through its pointer) or contiguous fp32
    (N, C), gathered through idx; ``idx`` (K,) int32 with entries in
    [−1, N) (the dispatch checks), −1 a pad row (z 0, nothing to e2); all
    on one CUDA device.  ``c`` a host float ≥ 0.  z = soft(x − g/d, c/d)
    with both quotients true divisions, bit for bit the plain version's.
    """
    dev = x.device
    _check("x", x, 2, BR_DTYPES, dev)
    _check("g", g, 2, (x.dtype,), dev)
    _check("idx", idx, 1, (torch.int32,), dev)
    _check_cuda(dev, (("d", d),))
    dense = d.dim() > 0
    if g.shape != x.shape or (dense and d.shape != x.shape):
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, g "
                         f"{tuple(g.shape)}, d {tuple(d.shape)}")
    K, C = idx.shape[0], x.shape[1]
    z = torch.empty((K, C), dtype=torch.float32, device=dev)
    if K == 0 or C == 0:
        return z, torch.zeros((), dtype=torch.float32, device=dev)
    e2 = torch.empty((), dtype=torch.float32, device=dev)
    index = x.get_device()
    grid = compact_blocks(K, C, *_card(index, "compact"))
    # the grid form's per-block partials and ticket counter
    work = None if grid.one_launch else torch.empty(
        grid.ctas + 1, dtype=torch.float32, device=dev)
    rc = _launch(index, library().compact_best_response_launch,
                 x.data_ptr(), g.data_ptr(), DTYPE_CODES[x.dtype],
                 d.data_ptr(), int(dense), float(c), idx.data_ptr(),
                 z.data_ptr(), e2.data_ptr(),
                 None if work is None else work.data_ptr(), K, C,
                 grid.ctas, grid.per_cta)
    _raise_on(rc, "compact_best_response")
    compact_best_response.launches += 1
    return z, e2


#: The one-cluster form's ways of taking elements (enum CbrForm in
#: compact_rows.cu): 4 rows a step at C = 1 with aligned idx and z, else
#: one element.
CBR_FORMS = ("rows4", "scalar")


def compact_kernel_info(K: int, C: int) -> dict:
    """What the compiler and the card (the current CUDA device) made of
    :func:`compact_best_response` at (K, C) for fp32 x and g, dense d and
    16-byte aligned pointers: registers and local (spill) bytes per
    thread, threads per CTA, CTAs per cluster, elements per CTA, clusters
    the card can hold at once, the one-cluster form's way of taking
    elements (``CBR_FORMS``), and the form a launch there takes
    (``"one_launch"`` or ``"grid"``; the other keys describe the
    one-cluster kernel)."""
    index = torch.cuda.current_device()
    grid = compact_blocks(K, C, *_card(index, "compact"))
    form = 0 if C == 1 else 1
    out = (ctypes.c_longlong * 5)()
    rc = library().compact_kernel_info(
        grid.ctas if grid.one_launch else 1, form, out)
    _raise_on(rc, "compact_kernel_info")
    return {"registers": out[0], "local_bytes": out[1], "threads": out[2],
            "cluster_ctas": grid.ctas if grid.one_launch else None,
            "per_cta": grid.per_cta, "max_active_clusters": out[4],
            "elements": CBR_FORMS[form],
            "form": "one_launch" if grid.one_launch else "grid"}


best_response.launches = 0
best_response.plain = ref.flexa_best_response_ref
apply_update.launches = 0
apply_update.plain = ref.flexa_apply_ref
batched_best_response.launches = 0
batched_best_response.plain = ref.flexa_best_response_batched_ref
batched_apply_update.launches = 0
batched_apply_update.plain = ref.flexa_apply_batched_ref
gather_rows.launches = 0
gather_rows.plain = ref.gather_rows_ref
scatter_rows.launches = 0
scatter_rows.plain = ref.scatter_rows_ref
compact_best_response.launches = 0
compact_best_response.plain = ref.compact_best_response_ref
