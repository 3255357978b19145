"""The CUDA kernels of the port against their plain versions, on the card.

Every test here is marked ``cuda`` and skips where CUDA is unavailable
(the kernels have no CPU mode).  The module imports neither ``jax`` nor
the JAX package, so it runs on a machine with only PyTorch:

    python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

``gather_rows`` and ``scatter_rows`` only move data, so they must equal
their plain versions bit for bit.  ``ssd_scan`` sums in another order
than its plain version: y within 1e-4 × max |y| and h within 1e-4 ×
max |h| in fp32; in bf16 (fp16), y within 2 bf16 (fp16) ulps of each
element plus that fp32 bound (both round an fp32 sum that differs in the
last bits).  Two launches on the same inputs give the same bits.  Its
bf16 kernels run on the tensor cores (HMMA in their SASS), the fp32 and
fp16 ones none.  ``ssd_scan_bwd`` is held to the same gate against its
plain version (autograd of ``ssd_scan_ragged``), each of dx, ddt, dA, dB
and dC against its own max, and a second launch gives the same bits; its
bf16 product passes run on the tensor cores, the others none, and no
instantiation holds a global atomic.
``flash_attention`` sums in another order than its plain version: fp32
within 2e-5 (the reference's ``tests/test_kernels.py`` tolerance), bf16
within 2 bf16 ulps of each element plus that.  Its bf16 body runs both
products on the tensor cores (HMMA in its SASS), the fp32 body none.  ``best_response``'s
z is elementwise IEEE fp32 arithmetic in the plain version's order, so
it equals the plain z bit for bit; its e2 sums in another order: within
1e-5 relative.  The same holds for ``batched_best_response``, and
``apply_update`` / ``batched_apply_update`` equal their plain versions
bit for bit (elementwise, each op rounded as the plain version rounds
it); a FLEXA iteration that calls them can be captured in a CUDA graph.
``compact_best_response`` gathers and computes as ``best_response``
does: z bit for bit, pad rows exactly 0, e2 within 1e-5 relative; up to
one cluster's 16 × 8192 gathered elements it is one device record with
no atomic or fence in its SASS, and so is ``scatter_rows`` at the path's
(100000, 1).
``gauss_seidel_sweep`` sums its dot products in another order than its
plain version (and corrects them with a Gram block of 32 coordinates):
after 3 sweeps x within 1e-5 and max |δ| within 1e-5 relative; two runs
from one start give the same bits.
"""
import json
import numpy as np
import pytest
import torch

from repro_torch.kernels import build, flexa_prox
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import gauss_seidel as tgs
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import ssd_scan as tssd

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
    monkeypatch.setattr(flexa_prox, "_br_lib", None)
    monkeypatch.setattr(tssd, "_lib", None)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(build, "find_nvcc", no_nvcc)
    with pytest.raises(RuntimeError):
        tops.gather_blocks(torch.ones((4, 2), device=cuda),
                           np.zeros(2, np.int32))
    with pytest.raises(RuntimeError):
        tops.flexa_best_response(torch.ones(8, device=cuda),
                                 torch.ones(8, device=cuda), 1.0, 0.0)
    with pytest.raises(RuntimeError):
        tops.flexa_apply(torch.ones(8, device=cuda),
                         torch.ones(8, device=cuda), 1.0, 0.0, 0.9)
    with pytest.raises(RuntimeError):
        tops.flexa_best_response_batched(torch.ones((2, 8), device=cuda),
                                         torch.ones((2, 8), device=cuda),
                                         1.0, 0.1)
    with pytest.raises(RuntimeError):
        tops.flexa_apply_batched(torch.ones((2, 8), device=cuda),
                                 torch.ones((2, 8), device=cuda), 1.0, 0.1,
                                 0.9)
    x = torch.ones((1, 8, 1, 4), device=cuda)
    with pytest.raises(RuntimeError):
        tops.ssd_scan(x, torch.ones((1, 8, 1), device=cuda),
                      -torch.ones(1, device=cuda), x[:, :, 0], x[:, :, 0],
                      chunk=4)


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


# ------------------------------------------------------------------ #
# ssd_scan                                                           #
# ------------------------------------------------------------------ #
#: (Bt, S, H, P, N, chunk): the sweep of tests/test_kernels.py, the
#: reduced mamba2 config, full mamba2-1.3b width (one and several
#: chunks, ragged S), zamba2-1.2b's width (N 64), odd widths.
SSD_CASES = [
    (1, 32, 2, 8, 8, 8),
    (2, 64, 3, 16, 8, 16),
    (1, 48, 1, 8, 16, 16),
    (1, 37, 2, 4, 6, 8),
    (1, 256, 64, 64, 128, 256),
    (2, 1024, 64, 64, 128, 256),
    (1, 600, 64, 64, 128, 256),
    (1, 600, 64, 64, 64, 256),
    (1, 200, 5, 48, 100, 96),
]


def ssd_inputs(Bt, S, H, P, N, dtype, seed, device, strided=False):
    """x, B and C (as views of one xBC buffer when ``strided``), dt and
    A, the mixer's ranges: dt in (0.001, 0.3), A in [−16, −1]."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    xBC = torch.randn((Bt, S, H * P + 2 * N), generator=g)
    dt = torch.rand((Bt, S, H), generator=g) * 0.3 + 1e-3
    A = -torch.linspace(1.0, 16.0, H)
    xBC = xBC.to(device=device, dtype=dtype)
    x = xBC[..., :H * P].reshape(Bt, S, H, P)
    B, C = xBC[..., H * P: H * P + N], xBC[..., H * P + N:]
    if not strided:
        x, B, C = x.contiguous(), B.contiguous(), C.contiguous()
    return x, dt.to(device), A.to(device), B, C


def assert_gate(y, y0, what=""):
    """y finite and within 1e-4 × max |y0| of y0, plus 2 ulps of each
    element in bf16 (fp16)."""
    assert torch.isfinite(y.float()).all(), what
    assert y.dtype == y0.dtype and y.shape == y0.shape, what
    yf, y0f = y.float(), y0.float()
    bound = 1e-4 * float(y0f.abs().max())
    if y.dtype in (torch.bfloat16, torch.float16):
        bits = 7 if y.dtype == torch.bfloat16 else 10
        ulp = torch.exp2(torch.floor(torch.log2(
            y0f.abs().clamp_min(2.0 ** -126))) - bits)
        assert ((yf - y0f).abs() <= 2 * ulp + bound).all(), what
    else:
        assert float((yf - y0f).abs().max()) <= bound, what


def assert_ssd_close(got, want):
    (y, h), (y0, h0) = got, want
    assert torch.isfinite(h).all()
    assert_gate(y, y0)
    assert float((h - h0).abs().max()) <= 1e-4 * float(h0.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("case", SSD_CASES, ids=str)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("strided", [False, True])
def test_ssd_scan_kernel_matches_plain_version(cuda, case, dtype, strided):
    Bt, S, H, P, N, chunk = case
    args = ssd_inputs(Bt, S, H, P, N, getattr(torch, dtype), seed=S + H,
                      device=cuda, strided=strided)
    n0 = tssd.ssd_scan.launches
    got = tops.ssd_scan(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert tssd.ssd_scan.launches == n0 + 1
    assert_ssd_close(got, tssd.ssd_scan.plain(*args, chunk=chunk))
    again = tops.ssd_scan(*args, chunk=chunk)
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])


#: Many chunks at batch 1, bf16, x/B/C strided as the mixer passes them:
#: ragged 4133 and a prefill_32k sequence (128 chunks).
SSD_LONG = [(1, 4133, 64, 64, 128, 256), (1, 32768, 64, 64, 128, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", SSD_LONG, ids=str)
def test_ssd_scan_kernel_over_many_chunks_at_batch_one(cuda, case):
    """The chunk-parallel passes over 17 and 128 chunks of one row: within
    the plain version's tolerance, and a second launch bit for bit."""
    Bt, S, H, P, N, chunk = case
    args = ssd_inputs(Bt, S, H, P, N, torch.bfloat16, seed=S, device=cuda,
                      strided=True)
    got = tops.ssd_scan(*args, chunk=chunk)
    assert_ssd_close(got, tssd.ssd_scan.plain(*args, chunk=chunk))
    again = tops.ssd_scan(*args, chunk=chunk)
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])


@pytest.mark.cuda
@pytest.mark.parametrize("S", [64, 70])
@pytest.mark.parametrize("strided", [False, True])
def test_ssd_scan_kernel_in_fp16_at_the_reduced_config(cuda, S, strided):
    """fp16 (fp32 arithmetic on the CUDA cores) at the reduced mamba2
    config (2, 64, 3, 16, 8), chunk 16, and with ragged S: within 2 fp16
    ulps plus the fp32 bound, and a second launch bit for bit."""
    args = ssd_inputs(2, S, 3, 16, 8, torch.float16, seed=S, device=cuda,
                      strided=strided)
    got = tops.ssd_scan(*args, chunk=16)
    assert_ssd_close(got, tssd.ssd_scan.plain(*args, chunk=16))
    again = tops.ssd_scan(*args, chunk=16)
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])


@pytest.mark.cuda
def test_ssd_scan_bf16_kernels_run_on_tensor_cores(cuda):
    """The SASS of the bf16 chunk-state and chunk-output kernels holds
    HMMA (mma.sync); the fp32 and fp16 ones and the state pass hold no
    tensor-core instruction; each pass's registers, spills and occupancy
    are readable at the full mamba2-1.3b width."""
    counts = build.sass_counts("ssd_scan")
    ours = {k: v for k, v in counts.items()
            if "ssd_chunk" in k or "ssd_state_pass" in k}
    mma = {k: v for k, v in ours.items() if "_mma" in k}
    rest = {k: v for k, v in ours.items() if k not in mma}
    assert len(mma) == 2 and len(rest) == 5, sorted(counts)
    assert all(v["HMMA"] + v["HGMMA"] > 0 for v in mma.values()), mma
    assert all(sum(v.values()) == 0 for v in rest.values()), rest
    for dtype in (torch.bfloat16, torch.float32, torch.float16):
        for pass_ in tssd.PASSES:
            info = tssd.kernel_info(dtype, pass_, 128, 64, 256)
            assert info["registers"] > 0 and info["blocks_per_sm"] >= 1, info


@pytest.mark.cuda
def test_ssd_scan_bwd_bf16_kernels_run_on_tensor_cores(cuda):
    """The SASS of the backward's bf16 product passes (dH, the rows of u,
    the rows of t) holds HMMA (mma.sync); its fp32 and fp16 instantiations,
    the state pass, the ds pass and the head sums hold no tensor-core
    instruction; no instantiation holds a global atomic or reduction (every
    sum in a fixed order); each pass's registers and occupancy are readable
    at mamba2-1.3b's N 128 and zamba2-1.2b's N 64."""
    ops = ("HMMA", "HGMMA", "ATOMG", "RED", "REDG")
    counts = build.sass_counts("ssd_scan_bwd", opcodes=ops)
    ours = {k: v for k, v in counts.items() if "ssd_bwd_" in k}
    mma = {k: v for k, v in ours.items() if "_mma" in k}
    rest = {k: v for k, v in ours.items() if k not in mma}
    assert len(mma) == 3 and len(rest) == 11, sorted(counts)
    assert all(v["HMMA"] + v["HGMMA"] > 0 for v in mma.values()), mma
    assert all(v["HMMA"] + v["HGMMA"] == 0 for v in rest.values()), rest
    assert not any(v["ATOMG"] + v["RED"] + v["REDG"]
                   for v in ours.values()), ours
    for dtype in (torch.bfloat16, torch.float32, torch.float16):
        for N in (128, 64):
            for pass_ in tssd.BWD_PASSES:
                info = tssd.bwd_kernel_info(dtype, pass_, N, 64, 256)
                assert info["registers"] > 0 and \
                    info["blocks_per_sm"] >= 1, (dtype, N, pass_, info)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_scan_kernel_is_finite_where_the_decay_overflows(cuda, dtype):
    """A = −16, dt = 0.1 at chunk 256: exp(s_t − s_u) for u > t would
    overflow; the kernel never forms it."""
    x, _, _, B, C = ssd_inputs(1, 512, 2, 64, 128, getattr(torch, dtype),
                               seed=3, device=cuda)
    dt = torch.full((1, 512, 2), 0.1, device=cuda)
    A = torch.tensor([-1.0, -16.0], device=cuda)
    got = tops.ssd_scan(x, dt, A, B, C, chunk=256)
    assert_ssd_close(got, tssd.ssd_scan.plain(x, dt, A, B, C, chunk=256))


@pytest.mark.cuda
def test_ssd_scan_kernel_refuses_what_it_cannot_hold(cuda):
    x, dt, A, B, C = ssd_inputs(1, 16, 1, 80, 8, torch.float32, seed=0,
                                device=cuda)
    with pytest.raises(ValueError):
        tssd.ssd_scan(x, dt, A, B, C, chunk=8)           # P > 64
    x, dt, A, B, C = ssd_inputs(1, 16, 1, 8, 8, torch.float32, seed=0,
                                device=cuda)
    with pytest.raises(RuntimeError):                    # shared memory
        tssd.ssd_scan(x, dt, A, B, C, chunk=1 << 16)


@pytest.mark.cuda
def test_reduced_mamba2_serves_on_the_card_through_the_kernel(cuda):
    """The reduced model on the card (fp32) launches ssd_scan once per
    layer in prefill and agrees with the same model on the CPU."""
    from repro_torch.configs.registry import get_reduced
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import ServeEngine

    cfg = get_reduced("mamba2-1.3b").replace(dtype="float32")
    gen = torch.Generator().manual_seed(0)
    cpu = T.init_params(cfg, generator=gen, device="cpu")
    card = T.Mamba2LM(cfg, device=cuda)
    card.load_state_dict(cpu.state_dict())
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 40)).astype(np.int32)
    n0 = tssd.ssd_scan.launches
    lg, cache = T.prefill(cfg, card, {"tokens": prompts})
    assert tssd.ssd_scan.launches == n0 + cfg.num_layers
    lg0, cache0 = T.prefill(cfg, cpu, {"tokens": prompts})
    np.testing.assert_allclose(lg.cpu().numpy(), lg0.numpy(), atol=1e-4)
    np.testing.assert_allclose(cache["ssm"].cpu().numpy(),
                               cache0["ssm"].numpy(), atol=1e-4)
    res = ServeEngine(cfg, card, max_len=48, device=cuda).generate(
        prompts, max_new_tokens=4)
    res0 = ServeEngine(cfg, cpu, max_len=48, device="cpu").generate(
        prompts, max_new_tokens=4)
    np.testing.assert_array_equal(res.tokens, res0.tokens)


def ssd_grads(x, dt, A, B, C, seed, dh, strided):
    """dy (a view into a wider buffer when ``strided``) and dh_final (None
    unless ``dh``) for the backward of a scan over these inputs."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    Bt, S, H, P = x.shape
    buf = torch.randn((Bt, S, H, P + 3 * strided), generator=g)
    dy = buf[..., :P].to(device=x.device, dtype=x.dtype)
    if not strided:
        dy = dy.contiguous()
    dhf = torch.randn((Bt, H, B.shape[-1], P), generator=g).to(x.device) \
        if dh else None
    return dy, dhf


def assert_bwd_close(got, want):
    for name, t, t0 in zip(("dx", "ddt", "dA", "dB", "dC"), got, want):
        assert_gate(t, t0, name)


@pytest.mark.cuda
@pytest.mark.parametrize("case", SSD_CASES, ids=str)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("strided", [False, True])
@pytest.mark.parametrize("dh", [False, True])
def test_ssd_scan_bwd_kernel_matches_plain_version(cuda, case, dtype,
                                                   strided, dh):
    Bt, S, H, P, N, chunk = case
    args = ssd_inputs(Bt, S, H, P, N, getattr(torch, dtype), seed=S + H,
                      device=cuda, strided=strided)
    dy, dhf = ssd_grads(*args, seed=S, dh=dh, strided=strided)
    scratch = tssd.ssd_scan(*args, chunk=chunk, keep_scratch=True)[2]
    n0 = tssd.ssd_scan_bwd.launches
    got = tssd.ssd_scan_bwd(*args, dy, dhf, chunk=chunk, scratch=scratch)
    torch.cuda.synchronize()
    assert tssd.ssd_scan_bwd.launches == n0 + 1
    assert_bwd_close(got, tssd.ssd_scan_bwd.plain(*args, dy, dhf,
                                                  chunk=chunk))
    again = tssd.ssd_scan_bwd(*args, dy, dhf, chunk=chunk, scratch=scratch)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_scan_bwd_is_finite_where_the_decay_overflows(cuda, dtype):
    """A = −16, dt = 0.1 at chunk 256, a ragged last chunk: the backward
    forms exp(s_t − s_u) only for u ≤ t."""
    x, _, _, B, C = ssd_inputs(1, 600, 2, 64, 128, getattr(torch, dtype),
                               seed=3, device=cuda)
    dt = torch.full((1, 600, 2), 0.1, device=cuda)
    A = torch.tensor([-1.0, -16.0], device=cuda)
    dy, dhf = ssd_grads(x, dt, A, B, C, seed=4, dh=True, strided=False)
    scratch = tssd.ssd_scan(x, dt, A, B, C, chunk=256, keep_scratch=True)[2]
    got = tssd.ssd_scan_bwd(x, dt, A, B, C, dy, dhf, chunk=256,
                            scratch=scratch)
    assert_bwd_close(got, tssd.ssd_scan_bwd.plain(x, dt, A, B, C, dy, dhf,
                                                  chunk=256))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_scan_is_differentiable_on_the_card(cuda, dtype):
    """``ops.ssd_scan`` under autograd: one forward and one backward
    launch, the gradients of a loss on y and h at the gate against
    autograd of the plain version; under ``inference_mode`` the forward's
    one launch and no backward."""
    x, dt, A, B, C = ssd_inputs(2, 300, 4, 32, 64, getattr(torch, dtype),
                                seed=5, device=cuda, strided=True)
    ins = [t.detach().requires_grad_(True) for t in (x, dt, A, B, C)]
    n0, b0 = tssd.ssd_scan.launches, tssd.ssd_scan_bwd.launches
    y, h = tops.ssd_scan(*ins, chunk=128)
    (y.float().square().sum() + h.sum()).backward()
    assert (tssd.ssd_scan.launches, tssd.ssd_scan_bwd.launches) == \
        (n0 + 1, b0 + 1)
    dy = (2 * y.float()).to(y.dtype).detach()
    want = tssd.ssd_scan_bwd.plain(x, dt, A, B, C, dy, torch.ones_like(h),
                                   chunk=128)
    assert_bwd_close([t.grad for t in ins], want)
    with torch.inference_mode():
        tops.ssd_scan(*ins, chunk=128)
    assert (tssd.ssd_scan.launches, tssd.ssd_scan_bwd.launches) == \
        (n0 + 2, b0 + 1)


@pytest.mark.cuda
def test_ssd_scan_bwd_refuses_what_it_cannot_take(cuda):
    x, dt, A, B, C = ssd_inputs(1, 16, 1, 8, 8, torch.float32, seed=0,
                                device=cuda)
    dy = torch.zeros_like(x)
    scratch = tssd.ssd_scan(x, dt, A, B, C, chunk=8, keep_scratch=True)[2]
    with pytest.raises(TypeError):                       # dy's dtype
        tssd.ssd_scan_bwd(x, dt, A, B, C, dy.double(), chunk=8,
                          scratch=scratch)
    with pytest.raises(ValueError):                      # not its scratch
        tssd.ssd_scan_bwd(x, dt, A, B, C, dy, chunk=8,
                          scratch=torch.zeros(3, device=cuda))
    with pytest.raises(ValueError):                      # dh_final's shape
        tssd.ssd_scan_bwd(x, dt, A, B, C, dy, torch.zeros(1, device=cuda)
                          .expand(1, 1, 8, 4), chunk=8, scratch=scratch)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-1.2b"])
def test_reduced_ssm_families_train_on_the_card_through_the_kernels(cuda,
                                                                    arch):
    """The reduced model's fp32 loss and gradients on the card against the
    same model on the CPU, with ``ssd_scan`` launched twice per layer under
    remat and ``ssd_scan_bwd`` once."""
    from repro_torch.configs.registry import get_reduced
    from repro_torch.data.synthetic import TokenPipeline
    from repro_torch.models import transformer as T

    cfg = get_reduced(arch).replace(dtype="float32")
    cpu = T.init_params(cfg, generator=torch.Generator().manual_seed(0),
                        device="cpu")
    card = type(cpu)(cfg, device=cuda)
    card.load_state_dict(cpu.state_dict())
    batch = TokenPipeline(cfg, 2, 40, seed=0)(0)
    n0, b0 = tssd.ssd_scan.launches, tssd.ssd_scan_bwd.launches
    loss, _ = T.loss_fn(cfg, card, batch, remat=True)
    loss.backward()
    assert (tssd.ssd_scan.launches - n0, tssd.ssd_scan_bwd.launches - b0) \
        == (2 * cfg.num_layers, cfg.num_layers)
    loss0, _ = T.loss_fn(cfg, cpu, batch, remat=True)
    loss0.backward()
    assert abs(float(loss) - float(loss0)) <= 1e-5 * abs(float(loss0))
    for (name, p), p0 in zip(card.named_parameters(), cpu.parameters()):
        g, g0 = p.grad.cpu(), p0.grad
        assert float((g - g0).abs().max()) <= 1e-4 * float(
            g0.abs().max()) + 1e-9, name


# ------------------------------------------------------------------ #
# best_response                                                      #
# ------------------------------------------------------------------ #
#: Shapes of the sweep at small size: 1, ragged 1000, the layer tensors
#: of the reduced dense configs, a 2560-wide row block.
BR_SHAPES = [(1,), (1000,), (64, 160), (160, 64), (3, 2560), (2049, 7)]


def br_inputs(shape, dtype, dense, seed, device, offset=0):
    """x, g (as views at ``offset`` elements into their storage), d."""
    g0 = torch.Generator(device="cpu").manual_seed(seed)
    n = int(np.prod(shape))
    x = torch.randn(n + offset, generator=g0)[offset:].view(shape)
    g = 0.1 * torch.randn(n + offset, generator=g0)[offset:].view(shape)
    d = (torch.rand(shape, generator=g0) * 1.5 + 0.5) if dense \
        else torch.tensor(1.7)
    x = x.to(dtype)
    g = g.to(dtype)
    # .to(device) copies into fresh, aligned storage: rebuild the offset
    if offset:
        xs = torch.empty(n + offset, dtype=dtype, device=device)
        gs = torch.empty(n + offset, dtype=dtype, device=device)
        xs[offset:] = x.reshape(-1).to(device)
        gs[offset:] = g.reshape(-1).to(device)
        return xs[offset:].view(shape), gs[offset:].view(shape), d.to(device)
    return x.to(device), g.to(device), d.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", BR_SHAPES, ids=str)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dense", [False, True])
@pytest.mark.parametrize("c", [0.0, 1e-3])
def test_best_response_kernel_matches_plain_version(cuda, shape, dtype,
                                                    dense, c):
    x, g, d = br_inputs(shape, getattr(torch, dtype), dense,
                        seed=len(shape) + int(dense), device=cuda)
    n0 = flexa_prox.best_response.launches
    z, e2 = tops.flexa_best_response(x, g, d, c)
    torch.cuda.synchronize()
    assert flexa_prox.best_response.launches == n0 + 1
    z0, e0 = flexa_prox.best_response.plain(x, g, d, c)
    assert z.dtype == torch.float32 and z.shape == x.shape and e2.dim() == 0
    assert torch.equal(z, z0)
    assert abs(float(e2) - float(e0)) <= 1e-5 * float(e0)
    z2, e22 = tops.flexa_best_response(x, g, d, c)
    assert torch.equal(z2, z) and torch.equal(e22, e2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_best_response_kernel_on_misaligned_views(cuda, dtype):
    """A view one element into its storage is not 16-byte aligned: the
    kernel takes its scalar loop and gives the same z."""
    x, g, d = br_inputs((1001,), getattr(torch, dtype), False, seed=3,
                        device=cuda, offset=1)
    assert x.data_ptr() % 16 != 0
    z, e2 = flexa_prox.best_response(x, g, d, 0.01)
    z0, e0 = flexa_prox.best_response.plain(x, g, d, 0.01)
    assert torch.equal(z, z0)
    assert abs(float(e2) - float(e0)) <= 1e-5 * float(e0)


@pytest.mark.cuda
def test_best_response_kernel_refuses_what_it_cannot_take(cuda):
    x = torch.ones(8, device=cuda)
    d = torch.tensor(1.0, device=cuda)
    bad = [
        (x.cpu(), x, d, ValueError),                        # a CPU tensor
        (x, x.cpu(), d, ValueError),
        (x, x, d.cpu(), ValueError),
        (x, x.to(torch.bfloat16), d, TypeError),            # mixed dtypes
        (x.half(), x.half(), d, TypeError),                 # fp16 x, g
        (x, x, d.double(), TypeError),                      # d not fp32
        (x, torch.ones(9, device=cuda), d, ValueError),     # shapes
        (x, x, torch.ones(9, device=cuda), ValueError),
        (torch.ones((4, 4), device=cuda).t(), torch.ones(
            (4, 4), device=cuda), d, ValueError),           # not contiguous
    ]
    for xx, gg, dd, err in bad:
        with pytest.raises(err):
            flexa_prox.best_response(xx, gg, dd, 0.0)
    with pytest.raises(ValueError):                         # via dispatch
        tops.flexa_best_response(x, x.cpu(), 1.0, 0.0)


@pytest.mark.cuda
def test_reduced_dense_training_step_on_the_card(cuda):
    """One FLEXA step of reduced stablelm-3b (fp32) on the card launches
    best_response once per port tensor (3 + 9 per layer) and agrees with
    the same step on the CPU (within 1e-5: cuBLAS sums in another order)."""
    from repro_torch.config.base import TrainConfig
    from repro_torch.configs.registry import get_reduced
    from repro_torch.models import transformer as T
    from repro_torch.train.loop import TrainLoop

    cfg = get_reduced("stablelm-3b").replace(dtype="float32")
    cpu = T.init_params(cfg, generator=torch.Generator().manual_seed(0),
                        device="cpu")
    card = T.DenseLM(cfg, device=cuda)
    card.load_state_dict(cpu.state_dict())
    out = {}
    for dev, model in (("cpu", cpu), ("cuda", card)):
        loop = TrainLoop(cfg, TrainConfig(), batch=2, seq_len=32, device=dev)
        opt = loop.opt_init(T.param_leaves(cfg, model))
        n0 = flexa_prox.best_response.launches
        _, _, _, m = loop.step_fn(model, opt, None, loop.batch(0))
        launched = flexa_prox.best_response.launches - n0
        assert launched == (3 + 9 * cfg.num_layers if dev == "cuda" else 0)
        out[dev] = float(m["loss"])
    assert abs(out["cuda"] - out["cpu"]) <= 1e-5 * abs(out["cpu"])
    for (k, v), w in zip(cpu.state_dict().items(),
                         card.state_dict().values()):
        np.testing.assert_allclose(w.cpu().numpy(), v.numpy(), rtol=0,
                                   atol=1e-5, err_msg=k)


# ------------------------------------------------------------------ #
# flash_attention                                                    #
# ------------------------------------------------------------------ #
#: (B, Hq, Hkv, Sq, Skv, D, causal): MHA, GQA and MQA; Sq = Skv, the
#: end-aligned offset Sq < Skv, Sq = 1, ragged Sq and Skv; D 8, 16, 80
#: (stablelm-3b), 88 (a half 16-column group), 128 (yi-6b); non-causal;
#: phi3-medium-14b's 40 heads over 10 and deepseek-67b's 64 over 8.
FA_CASES = [
    (1, 2, 2, 64, 64, 16, True),
    (2, 4, 2, 64, 64, 16, True),
    (1, 8, 1, 128, 128, 64, True),
    (2, 4, 2, 8, 32, 16, True),
    (1, 4, 2, 37, 133, 80, True),
    (2, 4, 1, 1, 29, 128, True),
    (1, 2, 1, 100, 45, 8, False),
    (1, 4, 4, 200, 200, 80, False),
    (2, 8, 2, 130, 300, 128, True),
    (1, 3, 3, 65, 65, 88, True),
    (1, 40, 10, 130, 130, 128, True),
    (1, 64, 8, 97, 97, 128, True),
]


def fa_inputs(B, Hq, Hkv, Sq, Skv, D, dtype, seed, device):
    g = torch.Generator(device="cpu").manual_seed(seed)
    q = torch.randn((B, Hq, Sq, D), generator=g)
    k = torch.randn((B, Hkv, Skv, D), generator=g)
    v = torch.randn((B, Hkv, Skv, D), generator=g)
    return tuple(t.to(device=device, dtype=dtype) for t in (q, k, v))


def assert_fa_close(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    gf, wf = got.float(), want.float()
    assert torch.isfinite(gf).all()
    tol = torch.full_like(wf, 2e-5)
    if got.dtype == torch.bfloat16:
        tol += 2 * torch.exp2(torch.floor(torch.log2(
            wf.abs().clamp_min(2.0 ** -126))) - 7)
    assert bool(((gf - wf).abs() <= tol).all()), float((gf - wf).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("case", FA_CASES, ids=str)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_kernel_matches_plain_version(cuda, case, dtype):
    B, Hq, Hkv, Sq, Skv, D, causal = case
    q, k, v = fa_inputs(B, Hq, Hkv, Sq, Skv, D, getattr(torch, dtype),
                        seed=Sq + Skv + D, device=cuda)
    n0 = tfa.flash_attention.launches
    got = tops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert tfa.flash_attention.launches == n0 + 1
    assert_fa_close(got, tfa.flash_attention.plain(q, k, v, causal=causal))
    again = tops.flash_attention(q, k, v, causal=causal)
    assert torch.equal(got, again)


#: The tensor-core body's edges: D 64, 80 (stablelm-3b), 128 (yi-6b), and
#: 40 and 72 (multiples of 8, not of 16: zero-padded to the mma depth),
#: with Sq and Skv not multiples of the 64-row tile; GQA; non-causal.
FA_HOPPER_CASES = [
    (1, 2, 2, 100, 100, 64, True),
    (2, 3, 3, 130, 200, 80, True),
    (2, 4, 2, 77, 301, 128, True),
    (1, 2, 1, 90, 150, 40, False),
    (1, 4, 2, 200, 263, 72, True),
    (1, 4, 4, 1, 67, 80, True),
    (1, 2, 2, 129, 129, 128, False),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", FA_HOPPER_CASES, ids=str)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_tensor_core_body_matches_plain_version(cuda, case,
                                                                dtype):
    """bf16 on the tensor cores (p split into three exact bf16 terms) and
    fp32 on the CUDA cores: within the plain version's tolerance, and a
    second launch bit for bit."""
    B, Hq, Hkv, Sq, Skv, D, causal = case
    q, k, v = fa_inputs(B, Hq, Hkv, Sq, Skv, D, getattr(torch, dtype),
                        seed=3 * Sq + Skv + D, device=cuda)
    got = tops.flash_attention(q, k, v, causal=causal)
    assert_fa_close(got, tfa.flash_attention.plain(q, k, v, causal=causal))
    assert torch.equal(got, tops.flash_attention(q, k, v, causal=causal))


#: seamless-m4t-large-v2's cross-attentions, in its serve path's layout:
#: the prefill's (4 × 4096 queries, not roped, heads split out of the
#: (B, S, 16·64) projection, over 4096 frames) and decode's (one query
#: over the 4128-position cross cache), k and v contiguous cache slices.
FA_CROSS_CASES = [(4, 16, 4096, 4096, 64), (4, 16, 1, 4128, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", FA_CROSS_CASES, ids=str)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_encdec_cross_calls_match_plain_version(cuda, case,
                                                                dtype):
    B, H, Sq, Skv, D = case
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cpu").manual_seed(Sq + Skv)
    q = torch.randn((B, Sq, H * D), generator=g).to(device=cuda, dtype=dt)
    q = q.reshape(B, Sq, H, D).transpose(1, 2)
    k, v = (torch.randn((B, H, Skv, D), generator=g).to(device=cuda,
                                                         dtype=dt)
            for _ in range(2))
    n0 = tfa.flash_attention.launches
    got = tops.flash_attention(q, k, v, causal=False)
    assert tfa.flash_attention.launches == n0 + 1
    assert_fa_close(got, tfa.flash_attention.plain(q, k, v, causal=False))
    assert torch.equal(got, tops.flash_attention(q, k, v, causal=False))


@pytest.mark.cuda
def test_flash_attention_bf16_body_runs_on_tensor_cores(cuda):
    """The SASS of every bf16 instantiation holds HMMA (mma.sync) and no
    fp32 instantiation holds any tensor-core instruction; each kernel's
    registers, spills and occupancy are readable."""
    counts = build.sass_counts("flash_attention")
    mma = {k: v for k, v in counts.items() if "flash_attention_fwd_mma" in k}
    fp32 = {k: v for k, v in counts.items()
            if "flash_attention_fwd" in k and k not in mma}
    assert len(mma) == 8 and len(fp32) == 8, sorted(counts)
    assert all(v["HMMA"] > 0 for v in mma.values()), mma
    assert all(sum(v.values()) == 0 for v in fp32.values()), fp32
    for dtype, D in ((torch.bfloat16, 80), (torch.bfloat16, 128),
                     (torch.float32, 80)):
        info = tfa.kernel_info(dtype, D)
        assert info["registers"] > 0 and info["blocks_per_sm"] >= 1, info


@pytest.mark.cuda
def test_flash_attention_kernel_reads_strided_views(cuda):
    """q, k, v as the model passes them: heads split out of (B, S, H·D)
    projections, v never copied; a view with an odd offset is copied
    first.  Same values as contiguous inputs."""
    B, S, Hq, Hkv, D = 2, 70, 4, 2, 80
    g = torch.Generator(device="cpu").manual_seed(5)
    proj = torch.randn((B, S, (Hq + 2 * Hkv) * D), generator=g).to(cuda)
    q = proj[..., :Hq * D].reshape(B, S, Hq, D).transpose(1, 2)
    k = proj[..., Hq * D:(Hq + Hkv) * D].reshape(B, S, Hkv, D).transpose(1, 2)
    v = proj[..., (Hq + Hkv) * D:].reshape(B, S, Hkv, D).transpose(1, 2)
    assert tfa._kernel_ready(v) is v               # read where it lies
    odd = torch.randn((B, S, Hkv * D + 1), generator=g).to(cuda)
    v_odd = odd[..., 1:].reshape(B, S, Hkv, D).transpose(1, 2)
    assert tfa._kernel_ready(v_odd) is not v_odd   # 4 bytes off: copied
    for vv in (v, v_odd):
        got = tfa.flash_attention(q, k, vv)
        assert got.transpose(1, 2).is_contiguous()   # (B, S, Hq, D) memory
        assert_fa_close(got, tfa.flash_attention.plain(q, k, vv))
        assert torch.equal(got, tfa.flash_attention(
            q.contiguous(), k.contiguous(), vv.contiguous()))


@pytest.mark.cuda
def test_flash_attention_kernel_refuses_what_it_cannot_take(cuda):
    q, k, v = fa_inputs(1, 2, 1, 8, 8, 16, torch.float32, 0, cuda)
    bad = [
        ((q.cpu(), k, v), {}, ValueError),                 # a CPU tensor
        ((q, k, v.cpu()), {}, ValueError),
        ((q.half(), k.half(), v.half()), {}, TypeError),   # fp16
        ((q, k.bfloat16(), v), {}, TypeError),             # mixed dtypes
        ((q[..., :12], k[..., :12], v[..., :12]), {}, ValueError),  # D 12
        ((q[..., :4], k[..., :4], v[..., :4]), {}, ValueError),     # D 4
        ((q, k[:, :, :4], v[:, :, :4]), {"causal": True}, ValueError),
    ]
    big = torch.zeros((1, 1, 8, 136), device=cuda)                # D 136
    bad.append(((big, big, big), {}, ValueError))
    for args, kw, err in bad:
        with pytest.raises(err):
            tfa.flash_attention(*args, **kw)
    with pytest.raises(ValueError):                                # dispatch
        tops.flash_attention(q, k, v.cpu())


@pytest.mark.cuda
def test_flash_attention_with_failed_build_raises(cuda, monkeypatch,
                                                  tmp_path):
    """No fallback: when the kernel cannot be built a CUDA call raises."""
    monkeypatch.setattr(tfa, "_lib", None)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(build, "find_nvcc", no_nvcc)
    q, k, v = fa_inputs(1, 2, 1, 8, 8, 16, torch.float32, 0, cuda)
    n0 = tfa.flash_attention.launches
    with pytest.raises(RuntimeError):
        tops.flash_attention(q, k, v)
    assert tfa.flash_attention.launches == n0


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["stablelm-3b", "yi-6b"])
def test_reduced_dense_serves_on_the_card_through_the_kernel(cuda, arch):
    """The reduced dense model on the card (fp32) launches flash_attention
    once per layer in prefill and agrees with the same model on the CPU
    (logits and cache within 1e-4: cuBLAS sums in another order)."""
    from repro_torch.configs.registry import get_reduced
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import ServeEngine

    cfg = get_reduced(arch).replace(dtype="float32")
    cpu = T.init_params(cfg, generator=torch.Generator().manual_seed(0),
                        device="cpu")
    card = T.DenseLM(cfg, device=cuda)
    card.load_state_dict(cpu.state_dict())
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 40)).astype(np.int32)
    n0 = tfa.flash_attention.launches
    lg, cache = T.prefill(cfg, card, {"tokens": prompts})
    assert tfa.flash_attention.launches == n0 + cfg.num_layers
    lg0, cache0 = T.prefill(cfg, cpu, {"tokens": prompts})
    np.testing.assert_allclose(lg.cpu().numpy(), lg0.numpy(), atol=1e-4)
    for name in ("k", "v"):
        np.testing.assert_allclose(cache[name].cpu().numpy(),
                                   cache0[name].numpy(), atol=1e-4)
    res = ServeEngine(cfg, card, max_len=48, device=cuda).generate(
        prompts, max_new_tokens=4)
    res0 = ServeEngine(cfg, cpu, max_len=48, device="cpu").generate(
        prompts, max_new_tokens=4)
    np.testing.assert_array_equal(res.tokens, res0.tokens)


# ------------------------------------------------------------------ #
# apply_update, batched_best_response, batched_apply_update          #
# ------------------------------------------------------------------ #
#: Instance shapes of the batched sweep: 1, ragged 1000, the solver's
#: (1, 100000) and (8, 100000), ones with n not a multiple of 8 (scalar
#: loop); n one element past one CTA's share (2 CTAs), n that needs
#: exactly 16 CTAs and one that would need 17 (16, a ragged last share),
#: and the two sides of the switch to the two-level form (131072 on an
#: H100's clusters of 16).
BATCHED_SHAPES = [(1, 1), (1, 1000), (1, 100_000), (8, 100_000), (3, 1001),
                  (4, 517), (2, 2049), (2, 32_768), (1, 32_769),
                  (1, 131_072), (1, 131_073)]


def batched_inputs(B, n, dkind, ckind, dtype, seed, device):
    g0 = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn((B, n), generator=g0).to(dtype)
    g = (0.1 * torch.randn((B, n), generator=g0)).to(dtype)
    d = {"scalar": torch.tensor(1.7),
         "instance": torch.rand(B, generator=g0) * 1.5 + 0.5,
         "dense": torch.rand((B, n), generator=g0) * 1.5 + 0.5}[dkind]
    c = {"zero": 0.0, "host": 0.05,
         "instance": torch.rand(B, generator=g0) * 0.1}[ckind]
    move = (lambda t: t.to(device) if isinstance(t, torch.Tensor) else t)
    return tuple(move(t) for t in (x, g, d, c))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", BR_SHAPES + [(1001,)], ids=str)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dense", [False, True])
@pytest.mark.parametrize("c,gm", [(0.0, 0.9), (1e-3, 1.0), (1e-3, 0.0)])
def test_apply_update_kernel_matches_plain_version(cuda, shape, dtype,
                                                   dense, c, gm):
    x, g, d = br_inputs(shape, getattr(torch, dtype), dense,
                        seed=len(shape) + int(dense), device=cuda,
                        offset=int(shape == (1001,)))
    gmt = torch.tensor(gm, device=cuda)
    n0 = flexa_prox.apply_update.launches
    out = tops.flexa_apply(x, g, d, c, gmt)
    torch.cuda.synchronize()
    assert flexa_prox.apply_update.launches == n0 + 1
    want = flexa_prox.apply_update.plain(x, g, d, c, gmt)
    assert out.dtype == x.dtype and out.shape == x.shape
    assert torch.equal(out, want)
    assert torch.equal(tops.flexa_apply(x, g, d, c, gmt), out)
    x2 = x.clone()
    assert flexa_prox.apply_update(x2, g, d, c, gmt, out=x2) is x2
    assert torch.equal(x2, want)


@pytest.mark.cuda
@pytest.mark.parametrize("B,n", BATCHED_SHAPES, ids=str)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dkind", ["scalar", "instance", "dense"])
@pytest.mark.parametrize("ckind", ["zero", "host", "instance"])
def test_batched_kernels_match_plain_versions(cuda, B, n, dtype, dkind,
                                              ckind):
    x, g, d, c = batched_inputs(B, n, dkind, ckind, getattr(torch, dtype),
                                seed=B + n, device=cuda)
    gm = torch.rand(B, device=cuda) if ckind == "instance" else 0.9
    n0 = (flexa_prox.batched_best_response.launches,
          flexa_prox.batched_apply_update.launches)
    z, e2 = tops.flexa_best_response_batched(x, g, d, c)
    out = tops.flexa_apply_batched(x, g, d, c, gm)
    torch.cuda.synchronize()
    assert (flexa_prox.batched_best_response.launches,
            flexa_prox.batched_apply_update.launches) == (n0[0] + 1,
                                                          n0[1] + 1)
    z0, e0 = flexa_prox.batched_best_response.plain(x, g, d, c)
    assert z.dtype == torch.float32 and z.shape == x.shape
    assert e2.shape == (B,) and torch.equal(z, z0)
    assert bool(((e2 - e0).abs() <= 1e-5 * e0.abs()).all())
    assert torch.equal(out, flexa_prox.batched_apply_update.plain(
        x, g, d, c, gm))
    z2, e22 = tops.flexa_best_response_batched(x, g, d, c)
    assert torch.equal(z2, z) and torch.equal(e22, e2)


@pytest.mark.cuda
@pytest.mark.parametrize("B,n", [(1, 100_000), (8, 100_000), (3, 1001),
                                 (2, 131_073)], ids=str)
def test_batched_best_response_gives_the_same_bits_on_every_launch(cuda, B,
                                                                   n):
    """e2's cluster-wide sum (and the two-level form's) is in a fixed
    order: three launches on one input give the same bits."""
    x, g, d, c = batched_inputs(B, n, "dense", "instance", torch.float32,
                                seed=7 + n, device=cuda)
    runs = [flexa_prox.batched_best_response(x, g, d, c) for _ in range(3)]
    for z, e2 in runs[1:]:
        assert torch.equal(z, runs[0][0]) and torch.equal(e2, runs[0][1])


@pytest.mark.cuda
def test_batched_kernel_info_names_its_clusters(cuda):
    """At the solver's n = 100000 a call is one launch of one cluster of
    C > 1 CTAs per instance, and the card holds the 8 clusters of a
    batch at once; past the switch the two-level form."""
    solo = flexa_prox.batched_kernel_info(100_000, 1)
    batch = flexa_prox.batched_kernel_info(100_000, 8)
    for info in (solo, batch):
        assert info["form"] == "one_launch", info
        assert 1 < info["cluster_ctas"] <= 16 and info["threads"] == 512
        assert info["cluster_ctas"] * info["per_cta"] >= 100_000
    assert batch["max_active_clusters"] >= 8, batch
    assert flexa_prox.batched_kernel_info(10**6, 2)["form"] == "two_level"


@pytest.mark.cuda
def test_batched_best_response_one_launch_form_has_no_atomics(cuda):
    """The one-launch form's SASS (every instantiation) holds no global
    atomic, reduction or memory fence; the two-level form's ticket does."""
    counts = build.sass_counts("flexa_prox", opcodes=(
        "ATOMG", "RED", "REDG", "MEMBAR"))
    one = {k: v for k, v in counts.items()
           if "flexa_batched_best_response_kernelI" in k}
    two = {k: v for k, v in counts.items()
           if "flexa_batched_best_response_two_level_kernelI" in k}
    assert len(one) == 12 and len(two) == 12, sorted(counts)
    assert not any(any(v.values()) for v in one.values()), one
    assert all(v["ATOMG"] for v in two.values()), two


@pytest.mark.cuda
def test_batched_kernels_refuse_what_they_cannot_take(cuda):
    x = torch.ones((2, 8), device=cuda)
    d = torch.tensor(1.0, device=cuda)
    bad = [
        (x.cpu(), x, d, 0.1, ValueError),
        (x, x, d.cpu(), 0.1, ValueError),
        (x, x, d, torch.ones(2), ValueError),               # c on the CPU
        (x, x, d, torch.ones(3, device=cuda), ValueError),   # c not (B,)
        (x, x, torch.ones(3, device=cuda), 0.1, ValueError),
        (x, x.half(), d, 0.1, TypeError),
        (x.reshape(-1), x.reshape(-1), d, 0.1, ValueError),  # not (B, n)
        (x.t(), x.t(), d, 0.1, ValueError),                  # not contiguous
    ]
    for xx, gg, dd, cc, err in bad:
        with pytest.raises(err):
            flexa_prox.batched_best_response(xx, gg, dd, cc)
        with pytest.raises(err):
            flexa_prox.batched_apply_update(xx, gg, dd, cc, 0.9)
    with pytest.raises(ValueError):
        flexa_prox.apply_update(x, x, d, 0.0, torch.ones(2, device=cuda))
    with pytest.raises(TypeError):                 # γ·m is read on the card
        flexa_prox.batched_apply_update(x, x, d, 0.1, 0.9)
    with pytest.raises(ValueError):
        flexa_prox.batched_apply_update(x, x, d, 0.1,
                                        torch.ones(3, device=cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("rule", ["greedy", "jacobi"])
def test_flexa_iteration_is_captured_in_a_cuda_graph(cuda, rule):
    """One solver iteration (the fused S.2, and under the full rule the
    fused S.4) captured in a CUDA graph and replayed gives the eager
    iteration's bits."""
    from repro_torch.config.base import SolverConfig
    from repro_torch.core import flexa
    from repro_torch.problems.lasso import nesterov_instance

    p = nesterov_instance(m=200, n=1000, nnz_frac=0.05, seed=0, device=cuda)
    cfg = SolverConfig(jacobi=rule == "jacobi", tau0=400.0,
                       tau_adapt=False)
    tau = flexa._base_tau(p, cfg)
    state = flexa.init_state(p, torch.zeros(p.n, device=cuda), cfg)
    state, _ = flexa.flexa_iteration(p, cfg, tau, state)   # x ≠ 0
    eager, _ = flexa.flexa_iteration(p, cfg, tau, state)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        flexa.flexa_iteration(p, cfg, tau, state)          # warm-up
    torch.cuda.current_stream().wait_stream(side)
    n0 = (flexa_prox.batched_best_response.launches,
          flexa_prox.batched_apply_update.launches)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured, _ = flexa.flexa_iteration(p, cfg, tau, state)
    assert flexa_prox.batched_best_response.launches == n0[0] + 1
    assert flexa_prox.batched_apply_update.launches \
        == n0[1] + (rule == "jacobi")
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(captured.x, eager.x)
        assert torch.equal(captured.stat, eager.stat)


@pytest.mark.cuda
@pytest.mark.parametrize("jacobi", [False, True])
def test_batch_spec_on_the_card_matches_the_cpu(cuda, jacobi):
    """``BatchSpec`` on the card launches the batched best response once
    per iteration (and the fused update under Jacobi) and agrees with
    the CPU within 1e-5."""
    from repro_torch.client import BatchSpec, FlexaClient
    from repro_torch.config.base import SolverConfig
    from repro_torch.problems.lasso import nesterov_instance

    cfg = SolverConfig(max_iters=100, tol=-1.0, tau_adapt=False,
                       jacobi=jacobi, tau0=60.0 if jacobi else 0.0)
    out = {}
    for dev in ("cpu", "cuda"):
        probs = [nesterov_instance(m=20, n=64, nnz_frac=0.15, seed=s,
                                   device=dev) for s in range(3)]
        n0 = (flexa_prox.batched_best_response.launches,
              flexa_prox.batched_apply_update.launches)
        out[dev] = FlexaClient(device=dev, solver=cfg).run(
            BatchSpec(problems=probs))
        launched = (flexa_prox.batched_best_response.launches - n0[0],
                    flexa_prox.batched_apply_update.launches - n0[1])
        want = (100, 100 if jacobi else 0) if dev == "cuda" else (0, 0)
        assert launched == want, (dev, launched)
    np.testing.assert_allclose(out["cuda"].x, out["cpu"].x, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["logreg", "group_lasso"])
def test_reduced_family_solve_on_the_card_matches_the_cpu(cuda, family):
    """A reduced logreg solve on the card launches the batched best
    response once per iteration (ℓ1, scalar blocks); a reduced group
    Lasso under the inexact ``newton_cg`` loop launches none (its prox is
    the group shrink in torch).  Both agree with the CPU within 1e-5."""
    from repro_torch.client import FlexaClient, SoloSpec
    from repro_torch.config.base import SolverConfig
    from repro_torch.problems.group_lasso import nesterov_group_instance
    from repro_torch.problems.logreg import random_logreg_instance

    iters = 150
    kw = dict(max_iters=iters, tol=-1.0, tau_adapt=False)
    out = {}
    for dev in ("cpu", "cuda"):
        p = (random_logreg_instance(m=60, n=200, nnz_frac=0.1, c=0.5,
                                    seed=1, device=dev)
             if family == "logreg" else
             nesterov_group_instance(m=40, n_blocks=30, block_size=5,
                                     nnz_frac=0.2, c=1.0, seed=1,
                                     device=dev))
        if family == "group_lasso" and dev == "cpu":
            # the default τ diverges at fixed τ; L_F / 8 converges
            kw.update(surrogate="newton_cg", inexact_alpha1=0.5,
                      tau0=p.lipschitz / 8)
        n0 = flexa_prox.batched_best_response.launches
        out[dev] = FlexaClient(device=dev, solver=SolverConfig(**kw)).run(
            SoloSpec(problem=p))
        launched = flexa_prox.batched_best_response.launches - n0
        want = iters if dev == "cuda" and family == "logreg" else 0
        assert launched == want, (dev, launched)
        assert out[dev].iters == iters
    np.testing.assert_allclose(out["cuda"].x, out["cpu"].x, atol=1e-5)
    np.testing.assert_allclose(out["cuda"].history["V"],
                               out["cpu"].history["V"], rtol=1e-5)


#: (n_rows, k_active, capacity, C) of the compact_best_response sweep: the
#: (n, 1) layout of ℓ1 block size 1, C 64, ragged 200, fig1d's m = 5000
#: (the wide vector path) and 4999 (its scalar loop), all-padding; the
#: fig1d path's last-point bucket (K = 16384, 9286 valid), a K that is
#: not a multiple of 4, C 37 and 7 (one element per step, as every C > 1
#: in the one-cluster form), and K·C at the
#: H100's one-cluster switch (16 × 8192) and one row past it, at C 1 and
#: 64.
CBR_CASES = [(300, 170, 256, 1), (40, 23, 32, 64), (40, 23, 32, 200),
             (64, 37, 64, 5000), (64, 37, 64, 4999), (16, 0, 8, 64),
             (16, 0, 8, 1), (100_000, 9286, 16384, 1), (301, 170, 255, 1),
             (40, 23, 32, 37), (3000, 1100, 2048, 7),
             (140_000, 100_000, 131_072, 1), (140_000, 100_000, 131_073, 1),
             (4000, 2000, 2048, 64), (4000, 2000, 2049, 64)]


def cbr_inputs(n_rows, k, cap, C, dtype, dense, seed, device):
    g0 = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn((n_rows, C), generator=g0).to(dtype).to(device)
    g = (0.5 * torch.randn((n_rows, C), generator=g0)).to(dtype).to(device)
    d = (torch.rand((n_rows, C), generator=g0) * 2.5 + 0.5).to(device) \
        if dense else torch.tensor(1.7, device=device)
    idx, _ = _plan_arrays(n_rows, k, seed=seed, cap=cap)
    return x, g, d, torch.from_numpy(idx).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("case", CBR_CASES, ids=str)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dense", [False, True])
def test_compact_best_response_kernel_matches_plain_version(cuda, case,
                                                            dtype, dense):
    x, g, d, idx = cbr_inputs(*case, getattr(torch, dtype), dense,
                              seed=case[3] + case[1], device=cuda)
    n0 = flexa_prox.compact_best_response.launches
    z, e2 = tops.compact_best_response(x, g, d, 0.3, idx)
    torch.cuda.synchronize()
    assert flexa_prox.compact_best_response.launches == n0 + 1
    z0, e0 = flexa_prox.compact_best_response.plain(x, g, d, 0.3, idx)
    assert z.dtype == torch.float32 and z.shape == (case[2], case[3])
    assert torch.equal(z, z0)
    assert bool((z[idx < 0] == 0).all())
    assert abs(float(e2) - float(e0)) <= 1e-5 * float(e0)
    z2, e22 = tops.compact_best_response(x, g, d, 0.3, idx)
    assert torch.equal(z2, z) and torch.equal(e22, e2)


@pytest.mark.cuda
def test_compact_best_response_one_cluster_form_covers_the_path(cuda):
    """On the card every (n, 1) bucket up to 16 × 8192 is one launch of
    one cluster (16 CTAs of 1024 at the path's K = 16384) that the card
    can place; the wide (65536, 5000) shape keeps the grid form."""
    sms, cap = flexa_prox._card(torch.cuda.current_device(), "compact")
    assert cap == 16, cap
    path = flexa_prox.compact_kernel_info(16384, 1)
    assert path["form"] == "one_launch" and path["elements"] == "rows4"
    assert (path["cluster_ctas"], path["per_cta"]) == (16, 1024)
    assert path["threads"] == 512 and path["local_bytes"] == 0, path
    assert path["max_active_clusters"] >= 1
    top = flexa_prox.compact_kernel_info(131_072, 1)
    assert top["form"] == "one_launch" and top["cluster_ctas"] == 16
    assert top["max_active_clusters"] >= 1
    assert flexa_prox.compact_kernel_info(131_073, 1)["form"] == "grid"
    assert flexa_prox.compact_kernel_info(65536, 5000)["form"] == "grid"


@pytest.mark.cuda
def test_compact_best_response_one_cluster_form_has_no_atomics(cuda):
    """The one-cluster form's SASS (every instantiation) holds no global
    atomic, reduction or memory fence; the grid form's ticket does."""
    counts = build.sass_counts("compact_rows", opcodes=(
        "ATOMG", "RED", "REDG", "MEMBAR"))
    one = {k: v for k, v in counts.items() if "compact_br_clusterI" in k}
    grid = {k: v for k, v in counts.items()
            if "compact_br_wideI" in k or "compact_br_narrowI" in k}
    assert len(one) == 8 and len(grid) == 12, sorted(counts)
    assert not any(any(v.values()) for v in one.values()), one
    assert all(v["ATOMG"] for v in grid.values()), grid
    scatter = {k: v for k, v in counts.items() if "scatter_" in k}
    assert len(scatter) == 10 and not any(
        any(v.values()) for v in scatter.values()), scatter


#: (N, K, C, base dtype, offset) of the scatter sweep: the path's 65536
#: values into (100000, 1) fp32, a ragged N, a view one element into its
#: storage, a bf16 base and C > 1 (the last three one row per thread).
SCATTER_CASES = [(100_000, 65536, 1, "float32", 0),
                 (100_003, 65536, 1, "float32", 0),
                 (100_000, 65536, 1, "float32", 1),
                 (100_000, 65536, 1, "bfloat16", 0),
                 (2000, 700, 3, "float32", 0)]


def _device_kernels(fn, path):
    """(name, grid) of each device kernel ``fn()`` launches, from a
    ``torch.profiler`` trace written to ``path``."""
    import time
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(1.0)                  # records inside the window
        fn()
        torch.cuda.synchronize()
        time.sleep(1.0)
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return [(e["name"], tuple(e["args"]["grid"])) for e in events
            if e.get("cat") == "kernel"]


@pytest.mark.cuda
@pytest.mark.parametrize("N,K,C,dtype,offset", SCATTER_CASES, ids=str)
def test_scatter_rows_kernel_matches_plain_version(cuda, tmp_path, N, K, C,
                                                   dtype, offset):
    """scatter_rows bitwise equal to its plain version, in the form and on
    the grid the launcher picks (4 rows a thread on ⌈N / 1024⌉ blocks for
    aligned fp32 (N, 1) only, one row a thread on ⌈N / 256⌉ otherwise); a
    second launch gives the same bits."""
    _, inv = _plan_arrays(N, K, seed=N + offset, cap=K)
    inv = torch.from_numpy(inv).to(cuda)
    vals = _src(K, C, "float32", seed=K).to(cuda)
    buf = _src(N * C + offset, 1, dtype, seed=N).to(cuda).reshape(-1)
    base = buf[offset:].view(N, C)
    n0 = flexa_prox.scatter_rows.launches
    out = flexa_prox.scatter_rows(vals, inv, base)
    torch.cuda.synchronize()
    assert flexa_prox.scatter_rows.launches == n0 + 1
    assert torch.equal(out, flexa_prox.scatter_rows.plain(vals, inv, base))
    assert torch.equal(flexa_prox.scatter_rows(vals, inv, base), out)
    fast = C == 1 and dtype == "float32" and offset == 0
    rows = 4 * 256 if fast else 256
    want = ("scatter_rows4" if fast else "scatter_narrow",
            (-(-N // rows), 1, 1))
    kernels = _device_kernels(
        lambda: flexa_prox.scatter_rows(vals, inv, base), tmp_path / "t.json")
    assert len(kernels) == 1 and want[0] in kernels[0][0], kernels
    assert kernels[0][1] == want[1], kernels


@pytest.mark.cuda
def test_redesigned_kernels_are_one_device_record_per_call(cuda):
    """Under ``torch.profiler``, 10 calls of compact_best_response at the
    path's state shape and 10 of scatter_rows at the path's (100000, 1)
    give 10 device records each: the one-cluster kernel and the 4-row
    scatter, no memset and no second kernel."""
    import time
    from torch.profiler import ProfilerActivity, profile

    x, g, d, idx = cbr_inputs(100_000, 9286, 16384, 1, torch.float32, True,
                              seed=9, device=cuda)
    _, inv = _plan_arrays(100_000, 65536, seed=9, cap=65536)
    inv = torch.from_numpy(inv).to(cuda)
    vals = _src(65536, 1, "float32", seed=1).to(cuda)
    base = _src(100_000, 1, "float32", seed=2).to(cuda)
    flexa_prox.compact_best_response(x, g, d, 0.3, idx)
    flexa_prox.scatter_rows(vals, inv, base)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(1.0)                  # records inside the window
        for _ in range(10):
            flexa_prox.compact_best_response(x, g, d, 0.3, idx)
            flexa_prox.scatter_rows(vals, inv, base)
        torch.cuda.synchronize()
        time.sleep(1.0)
    names = [e.name() for e in prof.profiler.kineto_results.events()
             if e.device_type() == torch.autograd.DeviceType.CUDA]
    assert sum("compact_br_cluster" in n for n in names) == 10, names
    assert sum("scatter_rows4" in n for n in names) == 10, names
    assert len(names) == 20, names


@pytest.mark.cuda
def test_compact_best_response_kernel_refuses_what_it_cannot_take(cuda):
    x = torch.ones((8, 40), device=cuda)
    d = torch.tensor(1.0, device=cuda)
    idx = torch.tensor([3, 0, -1], dtype=torch.int32, device=cuda)
    bad = [
        (x.cpu(), x, d, idx, ValueError),                   # a CPU tensor
        (x, x, d, idx.cpu(), ValueError),
        (x, x.to(torch.bfloat16), d, idx, TypeError),       # mixed dtypes
        (x.half(), x.half(), d, idx, TypeError),            # fp16 x, g
        (x, x, d.double(), idx, TypeError),                 # d not fp32
        (x, x, d, idx.long(), TypeError),                   # idx not int32
        (x, torch.ones((8, 41), device=cuda), d, idx, ValueError),
        (x, x, torch.ones((8, 41), device=cuda), idx, ValueError),
        (x.reshape(-1), x.reshape(-1), d, idx, ValueError),  # not (N, C)
    ]
    for xx, gg, dd, ii, err in bad:
        with pytest.raises(err):
            flexa_prox.compact_best_response(xx, gg, dd, 0.1, ii)
    for out_of_range in (8, -2):
        with pytest.raises(IndexError):
            tops.compact_best_response(
                x, x, d, 0.1, torch.tensor([0, out_of_range], device=cuda))


def gs_inputs(m, n, seed, device):
    """At (n, m), colsq (n,), x (n,) = 0 and r = −b (m,) of a Nesterov
    instance, fp32 on ``device``."""
    from repro_torch.problems.lasso import nesterov_instance
    p = nesterov_instance(m=m, n=n, nnz_frac=0.05, seed=seed, device=device)
    A, b = p.data["A"], p.data["b"]
    colsq = torch.clamp_min((A * A).sum(0), 1e-12)
    return A.T.contiguous(), colsq, torch.zeros(n, device=device), -b


@pytest.mark.cuda
@pytest.mark.parametrize("m,n", [(64, 300), (501, 700), (500, 2000)],
                         ids=str)
def test_gauss_seidel_sweep_kernel_matches_plain_version(cuda, m, n):
    """3 sweeps from x = 0 (m = 501: the scalar loop; the others the
    float4 one): x within 1e-5, each sweep's max |δ| within 1e-5
    relative, and a second run from the same start bit for bit."""
    At, colsq, x, r = gs_inputs(m, n, seed=m, device=cuda)
    runs = []
    for sweep in (tops.gauss_seidel_sweep, tops.gauss_seidel_sweep,
                  tgs.gauss_seidel_sweep.plain):
        xs, rs = x.clone(), r.clone()
        n0 = tgs.gauss_seidel_sweep.launches
        stats = [sweep(At, colsq, xs, rs, 1.0) for _ in range(3)]
        torch.cuda.synchronize()
        assert tgs.gauss_seidel_sweep.launches == n0 + (
            3 if sweep is tops.gauss_seidel_sweep else 0)
        runs.append((xs, rs, torch.stack(stats)))
    (xk, rk, sk), (xk2, rk2, sk2), (xp, rp, sp) = runs
    assert torch.equal(xk, xk2) and torch.equal(rk, rk2) \
        and torch.equal(sk, sk2)
    assert float((xk - xp).abs().max()) <= 1e-5
    assert bool(((sk - sp).abs() <= 1e-5 * sp.abs()).all())
    assert bool((sk > 0).all()) and bool(torch.isfinite(rk).all())


def gs_random(m, n, seed, device, c=1.0):
    """At (n, m), colsq, x = 0 and r = −b of a dense N(0, 1) instance
    scaled by 1/√m, and the ℓ1 weight c."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    A = torch.randn((m, n), generator=g) / m ** 0.5
    b = torch.randn(m, generator=g)
    colsq = torch.clamp_min((A * A).sum(0), 1e-12)
    return (A.T.contiguous().to(device), colsq.to(device),
            torch.zeros(n, device=device), (-b).to(device), c)


@pytest.mark.cuda
@pytest.mark.parametrize("m,n", [(5000, 100), (501, 20), (333, 96),
                                 (10340, 70), (57344, 40)], ids=str)
def test_gauss_seidel_blocked_sweep_edges_match_plain_version(cuda, m, n):
    """The blocked sweep's edges: n not a multiple of the 32-coordinate
    block (100, 70) and n < 32 (20); m not a multiple of the cluster's
    slice of r (5000, 501, 333), not of 4 (501, 333: 4-byte copies), a
    slice staged in two chunks (10340) and the largest m (57344).  Three
    sweeps: x and each sweep's max |δ| within 1e-5 × max(1, max |x|) (δ
    is a difference of x's values and carries their rounding: by the
    third sweep it is ~1e-4 of x), r within 1e-4 × max(1, max |r|); a
    second run bit for bit."""
    At, colsq, x, r, c = gs_random(m, n, seed=m + n, device=cuda)
    runs = []
    for sweep in (tops.gauss_seidel_sweep, tops.gauss_seidel_sweep,
                  tgs.gauss_seidel_sweep.plain):
        xs, rs = x.clone(), r.clone()
        stats = torch.stack([sweep(At, colsq, xs, rs, c) for _ in range(3)])
        runs.append((xs, rs, stats))
    torch.cuda.synchronize()
    (xk, rk, sk), (xk2, rk2, sk2), (xp, rp, sp) = runs
    assert torch.equal(xk, xk2) and torch.equal(rk, rk2) \
        and torch.equal(sk, sk2)
    x_scale = max(1.0, float(xp.abs().max()))
    readings = (f"max |dx| {float((xk - xp).abs().max())}, max |dr| "
                f"{float((rk - rp).abs().max())}, max |δ| {sk.tolist()} vs "
                f"{sp.tolist()}, max |x| {x_scale}")
    assert float((xk - xp).abs().max()) <= 1e-5 * x_scale, readings
    assert float((rk - rp).abs().max()) <= 1e-4 * max(
        1.0, float(rp.abs().max())), readings
    assert float((sk - sp).abs().max()) <= 1e-5 * x_scale, readings
    assert bool((sk > 0).all()) and bool((xk != 0).any())


@pytest.mark.cuda
def test_gauss_seidel_sweep_with_every_delta_zero_leaves_r_alone(cuda):
    """c above every |2 a_iᵀ r| at x = 0: every δ is 0, so x stays 0, r
    keeps its bits and max |δ| is 0."""
    At, colsq, x, r, _ = gs_random(700, 90, seed=4, device=cuda)
    c = 2.0 * float((At @ r).abs().max()) + 1.0
    r0 = r.clone()
    stat = tops.gauss_seidel_sweep(At, colsq, x, r, c)
    torch.cuda.synchronize()
    assert float(stat) == 0.0
    assert torch.equal(r, r0) and not bool((x != 0).any())


@pytest.mark.cuda
def test_gauss_seidel_kernel_info_names_its_cluster(cuda):
    """The sweep runs as one cluster of 8 or 16 CTAs, each holding its
    slice of r (at fig1d's m = 5000: one staged chunk)."""
    info = tgs.kernel_info(5000)
    assert info["cluster_ctas"] in (8, 16) and info["max_active_clusters"] >= 1
    assert info["slice_rows"] * info["cluster_ctas"] >= 5000
    assert info["chunk_rows"] == info["slice_rows"], info


@pytest.mark.cuda
def test_gauss_seidel_sweep_kernel_refuses_what_it_cannot_take(cuda):
    At, colsq, x, r = gs_inputs(16, 40, seed=0, device=cuda)
    bad = [
        (At.cpu(), colsq, x, r, ValueError),
        (At, colsq, x, r.cpu(), ValueError),
        (At.double(), colsq, x, r, TypeError),
        (At, colsq, x.half(), r, TypeError),
        (At.T, colsq, x, r, ValueError),                    # not contiguous
        (At, colsq[:-1], x, r, ValueError),                 # shapes
        (At, colsq, x, r[:-1], ValueError),
    ]
    for a, cs, xx, rr, err in bad:
        with pytest.raises(err):
            tgs.gauss_seidel_sweep(a, cs, xx, rr, 1.0)
    m = tgs.MAX_ROWS + 4                                  # r won't fit
    with pytest.raises(ValueError, match="shared memory"):
        tgs.gauss_seidel_sweep(torch.zeros((2, m), device=cuda),
                               torch.ones(2, device=cuda),
                               torch.zeros(2, device=cuda),
                               torch.zeros(m, device=cuda), 1.0)


@pytest.mark.cuda
@pytest.mark.parametrize("method,options", [
    ("fista", {}), ("admm", {"rho": 10.0}), ("grock", {"P": 4}),
    ("gauss_seidel", {})], ids=str)
def test_baselines_on_the_card_match_the_cpu(cuda, method, options):
    """Each baseline through ``SoloSpec`` on the card agrees with the CPU
    within 1e-4 (products sum in other orders); Gauss-Seidel launches its
    kernel once per sweep."""
    from repro_torch.client import FlexaClient, SoloSpec
    from repro_torch.config.base import SolverConfig
    from repro_torch.problems.lasso import nesterov_instance

    cfg = SolverConfig(max_iters=8 if method == "gauss_seidel" else 100,
                       tol=0.0)
    out = {}
    for dev in ("cpu", "cuda"):
        p = nesterov_instance(m=40, n=120, nnz_frac=0.1, seed=0, device=dev)
        n0 = tgs.gauss_seidel_sweep.launches
        out[dev] = FlexaClient(device=dev, solver=cfg).run(
            SoloSpec(problem=p, method=method, options=options))
        want = cfg.max_iters if (dev == "cuda"
                                 and method == "gauss_seidel") else 0
        assert tgs.gauss_seidel_sweep.launches - n0 == want
    assert out["cuda"].iters == out["cpu"].iters == cfg.max_iters
    np.testing.assert_allclose(out["cuda"].x, out["cpu"].x, atol=1e-4)
