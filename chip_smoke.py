#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Runs from the root of a checkout, needs one CUDA card, ``nvcc`` and
``nvidia-smi``, and exits non-zero (printing no result) when CUDA is
unavailable or the port's sources are missing.  Phases, each one line,
each failing the run when its check fails:

1. setup    — the card's name and power limit, torch/CUDA versions, and
               the build of every CUDA source in ``csrc/`` (one nvcc per
               source, all started together; seconds).
1b. hopper_kernels — the kernels redesigned for Hopper as built:
               registers, local (spill) bytes, static and dynamic shared
               memory and blocks per SM of ``flash_attention`` (bf16 at D
               80 and 128, fp32), of each of ``ssd_scan``'s three passes
               (bf16 and fp32 at mamba2-1.3b's width, and at
               zamba2-1.2b's N 64), clusters of
               ``gauss_seidel_sweep`` at fig1d's m, and of
               ``batched_best_response`` at (1, 100000) and (8, 100000)
               (registers, cluster size, elements per CTA, clusters the
               card holds at once, the form: one launch at both); and
               ``cuobjdump -sass`` of the flash-attention and ssd-scan
               libraries: HMMA in every bf16 instantiation, no
               tensor-core instruction in any fp32 (or fp16) one; of
               ``flexa_prox``: no ATOMG, RED(G) or MEMBAR in any
               instantiation of the one-launch batched best response;
               and ``compact_best_response`` at the path state's K =
               16384, C = 1 (registers, spill bytes, CTAs per cluster,
               clusters resident, the form: one launch), with no ATOMG,
               RED(G) or MEMBAR in any instantiation of its one-cluster
               form in ``compact_rows``' SASS.
2. kernels  — every kernel against its plain torch version on the card:
               ``gather_rows`` / ``scatter_rows`` exactly (pure data
               movement) over a sweep that includes the fig1d shapes, the
               path's padded bucket, ragged C, all-padding, K = 1,
               bf16/fp16 sources, and a scatter at a ragged n and on a
               view one element into its storage; ``ssd_scan`` at the reduced and the full
               mamba2-1.3b width, zamba2-1.2b's (4 × 4096, N 64),
               ragged S, strided views of an xBC
               buffer, fp32 and bf16, and the decay-overflow case, within
               1e-4 × max |y| (bf16: 2 ulps per element plus that), finite
               and bitwise repeatable.
3. goldens  — ``tests/golden/flexa_lasso_V.json``,
               ``fista_lasso_V.json``, ``admm_lasso_V.json`` and
               ``path_lasso_compact_V.json`` on the card, at the tests'
               tolerances.
4. solo     — the paper's fig1d Lasso (m=5000, n=100000, 5% nnz) through
               ``FlexaClient().run(SoloSpec(...))``, methods ``flexa`` and
               ``flexa_compiled``, 1000 iterations each; ms per iteration
               beside the two-GEMV bound.  ``batched_best_response`` (step
               S.2) launched once per iteration (1000 per method, by
               counter); one fig1d iteration's z and x_new from the
               kernels equal their plain versions' bit for bit.
4b. fig1    — the paper's Fig. 1 race at fig1d (``benchmarks/fig1.py``'s
               field for 16 processors) on the solo phase's instance, each
               method through ``FlexaClient(solver=SolverConfig(max_iters=
               ..., tol=0)).run(SoloSpec(...))``: FPA, FISTA, GRock1,
               GRockP16 and ADMM (ρ 10) for 1000 iterations, GS for 100
               sweeps (fig1.py's max_iters // 10).  Per method the
               iterations, wall time, ms per iteration, the final
               (V − V*)/V*, and the time and iterations to 1e-2, 1e-4 and
               1e-6.  Each method runs its budget (GRock may stop at a
               non-finite V, as the reference's loop does); V finite for
               FPA, FISTA, ADMM and GS; ``gauss_seidel_sweep`` launched
               once per sweep (100, by counter); V of GS's final x,
               recomputed on the host in float64, within 1e-5 relative of
               the reported V.  The ranking is printed, not gated.  Then
               one sweep from x = 0 at fig1d through ``gauss_seidel_sweep``
               and through its plain version on the same inputs: V and
               max |δ| within 1e-5 relative, x within 1e-5 × max |x|.
5. path     — slice 1's main path: ``FlexaClient().run(PathSpec(...,
               compact=True))`` at fig1d, with the kernels' launch
               counters set to 0 just before and read just after (all
               must be > 0), under ``torch.profiler``, whose kernel
               records give each kernel's launches (they must equal the
               counters) and device time; ``batched_best_response``
               launched once per solver iteration (between the
               iterations' sum and that plus 15 per solve: a solve stops
               at the stop-flag check after it converges).  Then
               ``ops.compact_best_response`` (no path calls it) once on
               the last point's real state: its support plan, x, ∇F and
               dense d in the (100000, 1) layout, z bit for bit the
               composition ``gather_blocks`` → ``flexa_best_response``,
               and under ``torch.profiler`` the call one device record
               (the one-cluster kernel: no memset, no second kernel).
6. compact  — the compacted path against the masked-dense path at fig1b
               (m=2000, n=10000, 10% nnz) on the golden grid.
6b. batch   — slice 5's batched path (``benchmarks/fig1.py:run_batched``
               at fig1d's size): ``FlexaClient().run(BatchSpec(...))`` over
               8 fig1d instances (seeds 0–7, 16 GB of A stacked), 300
               iterations at fixed τ, greedy then Jacobi; the Jacobi run
               launches ``batched_apply_update`` once per iteration (300,
               by counter and by profiler), both ``batched_best_response``
               300; against a ``SoloSpec`` of seed 0 under the same
               settings row 0's x within 1e-4 under Jacobi and its V
               within 1e-3 under greedy (the ρ-rule's mask flips on
               last-bit differences, so greedy trajectories part); every
               V finite and V₃₀₀ < V₀; ms per batched iteration beside
               the two-GEMV bound, peak memory.
6c. cv      — ``FlexaClient().run(CVSpec(...))``: K = 4 row-folds of a
               planted sparse regression (m_total 8000, n 10000, support
               500, ``benchmarks/path_bench.py:make_cv_folds``), 16
               λ-points down to 0.05 λ_max at tol 1e-6: every point
               converged, fold 0's path within 1e-4 of a ``PathSpec`` of
               fold 0 on the same grid, the selected λ index equal to the
               one recomputed on the host from the fold x's by the
               validation MSE.
7. serve    — slice 2's main path: full-width mamba2-1.3b (48 layers,
               random weights from a seeded generator) through
               ``ServeEngine.generate``, 4 prompts of 4096 tokens and 32
               new tokens, greedy; ``ssd_scan`` launched once per layer
               (48, by counter and by profiler), finite logits; prefill
               ms, decode ms per token, tokens/s, peak memory.  The first
               4 tokens against a full ``forward`` teacher-forced on the
               engine's tokens: in bf16 the gaps to the max logit are
               printed (a top-2 margin below bf16 rounding can flip), and
               the same weights in fp32 must give each token within 1e-4
               of the max logit.
8. serve_dense — slice 4's main path: full-width stablelm-3b (32
               layers, MHA, D 80, random weights from a seeded generator)
               through ``ServeEngine.generate``, 4 prompts of 4096 tokens
               and 32 new tokens, greedy; ``flash_attention`` launched
               once per layer in the prefill (32, by counter and by
               profiler), finite logits, the same measurements and greedy
               checks as ``serve``.  Then yi-6b (GQA, 32 query heads over
               4, D 128) at full width, 2 prompts of 2048 and 8 new
               tokens: 32 launches by counter, finite logits, the fp32
               greedy check.
8b. serve_families — slice 11's main path: full-width zamba2-1.2b (38
               Mamba2 layers and one shared attention block after each 6,
               random weights from a seeded generator) through
               ``ServeEngine.generate``, 4 prompts of 4096 tokens and 32
               new tokens, greedy: ``ssd_scan`` 38 and ``flash_attention``
               6 launches per prefill, by counter and by profiler, and the
               measurements and greedy checks of ``serve``.  Then, at
               full width with their depth cut (``SERVE_FAMILIES``),
               qwen3-moe-30b-a3b (12 of 48 layers) and phi3-medium-14b
               (20 of 40) at 2 × 2048 + 8, deepseek-67b and
               moonshot-v1-16b-a3b (4 layers each) at 1 × 1024 + 4:
               ``flash_attention`` once per layer run, by counter and by
               profiler, finite logits, the fp32 greedy check, peak
               memory; the MoE runs print the share of (token, choice)
               pairs dropped at capacity factor 1.25 and hold the fp32
               check at capacity factor E / k, where nothing drops.  One
               line per run, with its depth and the full depth, and its
               seconds.
9. train    — slice 3's main path: full-width stablelm-3b (32 layers,
               random weights from a seeded generator) through
               ``TrainLoop.run``, FLEXA with the default settings, bf16
               activations, batch 2 × 4096 (train_4k's sequence, the
               batch cut from 256 to 2), 6 steps: ``best_response``
               launched once per parameter tensor per step (291), by
               counter and by profiler; every loss finite; per-step ms,
               tokens/s, peak memory, the device busy share of a profiled
               step; ``apply_update`` launched once per parameter tensor
               per step as well (291), by counter and by profiler.  Before
               it, on step 1's x and gradients, every tensor's kernel z
               equals its plain version bit for bit and e2 agrees within
               1e-5 relative, and the kernel's updated x equals the plain
               update's bit for bit.
10. descent — reduced stablelm-3b on the card, 30 FLEXA steps at batch
               4 × 64: the mean of the last 5 losses is below the mean of
               the first 5 (the reference's own check,
               ``tests/test_train_serve.py:16-26``).

The ``kernels`` phase also sweeps ``best_response`` against its plain
version: sizes 1, 1000, (2560, 2560), (2560, 6912), (50304, 2560) and a
view one element into its storage; scalar and dense d; c = 0 and 1e-3;
fp32 and bf16 x and g.  z must equal the plain z bit for bit, e2 agree
within 1e-5 relative, and a second launch give the same bits.  And
``flash_attention``: MHA (32/32 heads, D 80), GQA (32/4, D 128) and MQA
(8/1, D 64), causal and not, Sq = Skv, the end-aligned Sq < Skv, Sq = 1,
ragged Skv (4133), and the stablelm-3b, yi-6b and zamba2-1.2b (32/32,
D 64) prefills at full size (4 × 4096), phi3-medium-14b's (2 × 2048, 40
heads over 10, D 128) and deepseek-67b's (1 × 1024, 64 over 8); fp32 within 2e-5 and bf16 within 2 bf16 ulps per element
plus 2e-5, finite, a second launch bitwise, and a causal call with
Sq > Skv refused.  And ``apply_update``, ``batched_best_response`` and
``batched_apply_update``: sizes 1, 1000, (8, 100000), (50304, 2560) and a
misaligned view; scalar, per-instance and dense d; c 0, a host value and
per instance; γ·m 0, 1, 0.9 and per instance; fp32 and bf16 x: outputs
bitwise equal to the plain versions', e2 within 1e-5 relative, a second
launch bitwise (the batched sweep adds (1, 100000), the solver's solo
shape); then 10 calls each of ``batched_best_response`` at (1, 100000) and
(8, 100000) under ``torch.profiler``: 20 device records, each the
one-launch kernel (no memset, no second kernel).  And
``compact_best_response``: C 1, 7, 64, 200, 5000 (and
4999), scalar and dense d, fp32 and bf16 x/g, ragged K with −1 pads, an
all-pad idx, K = 1, K·C at the one-cluster switch and one row past it:
z bitwise, pad rows 0, e2 within 1e-5 relative, a
second launch bitwise.  And ``gauss_seidel_sweep`` at (m, n) = (500,
2000), 3 sweeps from x = 0: x within 1e-5 and each sweep's max |δ|
within 1e-5 relative of the plain version (the dot products sum in
another order), a second run bitwise; at the race's shape it is held in
the fig1 phase.

Then a ``{"kernels": [...]}`` line (device time, plain time, library
time and bound of each kernel at its path's shapes; beside the bound of
the microsecond kernels — the gather, the scatter, the batched kernels
and ``compact_best_response`` — ``launch_floor_ms``, the device time of an
empty kernel replayed from a CUDA graph in the same harness; beside
``scatter_rows`` its one-row-per-thread form on the same values with
base a view one element into its storage, ``one_row_ms``), the card's
name and power limit, and,
last, the device line.
"""
import contextlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
GOLDEN = ROOT / "tests" / "golden"

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
FIG1D = dict(m=5000, n=100_000, nnz_frac=0.05, c=1.0, seed=0)
FIG1B = dict(m=2000, n=10_000, nnz_frac=0.10, c=1.0, seed=0)
SOLO_ITERS = 1000
GATHER_KS = (4096, 16384, 65536)   # capacity buckets timed on Aᵀ at fig1d
VECTOR_K = 65536                   # bucket of the (n, 1) vector gathers
PADDED_K_VALID = 35926             # active rows in the 65536 bucket on the path
FP32_OPS_PER_S = 66.9e12            # H100 SXM, CUDA cores, no tensor cores
TF32_OPS_PER_S = 495e12             # tensor cores, beside it for reference
BF16_OPS_PER_S = 989e12             # tensor cores, dense bf16 in, fp32 sums
REPLACES = {"gather_rows": "src/repro/kernels/flexa_prox.py:278",
            "scatter_rows": "src/repro/kernels/flexa_prox.py:308",
            "ssd_scan": "src/repro/kernels/ssd_scan.py:83",
            "best_response": "src/repro/kernels/flexa_prox.py:55",
            "apply_update": "src/repro/kernels/flexa_prox.py:104",
            "batched_best_response": "src/repro/kernels/flexa_prox.py:174",
            "batched_apply_update": "src/repro/kernels/flexa_prox.py:223",
            "flash_attention": "src/repro/kernels/flash_attention.py:86",
            "compact_best_response": "src/repro/kernels/flexa_prox.py:351",
            # no Pallas kernel: the reference's one-program sweep
            "gauss_seidel_sweep": "src/repro/baselines/gauss_seidel.py:37"}
FLEXA_CU = "src/repro_torch/kernels/csrc/flexa_prox.cu"
SOURCES = {"gather_rows": "src/repro_torch/kernels/csrc/compact_rows.cu",
           "scatter_rows": "src/repro_torch/kernels/csrc/compact_rows.cu",
           "ssd_scan": "src/repro_torch/kernels/csrc/ssd_scan.cu",
           "best_response": FLEXA_CU, "apply_update": FLEXA_CU,
           "batched_best_response": FLEXA_CU,
           "batched_apply_update": FLEXA_CU,
           "flash_attention":
               "src/repro_torch/kernels/csrc/flash_attention.cu",
           "compact_best_response":
               "src/repro_torch/kernels/csrc/compact_rows.cu",
           "gauss_seidel_sweep":
               "src/repro_torch/kernels/csrc/gauss_seidel.cu"}
#: Device-kernel names (substrings of the profiler's records) per wrapper;
#: ``main`` adds those of ``flexa_prox``'s, ``gauss_seidel``'s and
#: ``ssd_scan``'s wrappers (their KERNEL_NAMES).
KERNEL_NAMES = {"flash_attention": ("flash_attention_fwd",)}
#: Wrappers that launch several device kernels per call: the kernel whose
#: records count the wrapper's launches (the others' time is summed too).
CALL_MARKS = {"ssd_scan": "ssd_chunk_out"}
SERVE = dict(arch="mamba2-1.3b", batch=4, prompt=4096, new=32, seed=0)
SERVE_DENSE = dict(arch="stablelm-3b", batch=4, prompt=4096, new=32, seed=0)
SERVE_GQA = dict(arch="yi-6b", batch=2, prompt=2048, new=8, seed=0)
#: This slice's runs (``serve_families``): zamba2-1.2b whole, the main
#: path; the others with their depth cut to what one card holds beside
#: fp32 master weights and their bf16 casts (≈ 6 bytes a parameter):
#: qwen3-moe-30b-a3b 12 of 48 layers (≈ 8.1 B parameters), phi3-medium-14b
#: 20 of 40 (≈ 7.9 B), and deepseek-67b and moonshot-v1-16b-a3b 4 layers
#: each, witnesses of their shapes.
SERVE_FAMILIES = [
    dict(arch="zamba2-1.2b", batch=4, prompt=4096, new=32, seed=0,
         profile="full"),
    dict(arch="qwen3-moe-30b-a3b", layers=12, batch=2, prompt=2048, new=8,
         seed=0, profile="prefill"),
    dict(arch="phi3-medium-14b", layers=20, batch=2, prompt=2048, new=8,
         seed=0, profile="prefill"),
    dict(arch="deepseek-67b", layers=4, batch=1, prompt=1024, new=4, seed=0,
         profile="prefill"),
    dict(arch="moonshot-v1-16b-a3b", layers=4, batch=1, prompt=1024, new=4,
         seed=0, profile="prefill")]
TRAIN = dict(arch="stablelm-3b", batch=2, seq=4096, steps=6)
DESCENT = dict(arch="stablelm-3b", batch=4, seq=64, steps=30)
#: Shapes of the best_response sweep: 1, ragged 1000, the layer tensors
#: of stablelm-3b (attn 2560², mlp 2560 × 6912) and its lm_head.
BR_SHAPES = [(1,), (1000,), (2560, 2560), (2560, 6912), (50304, 2560)]
BR_MISALIGNED = (1_000_001,)       # a view one element into its storage
#: Shapes of the apply_update sweep (the misaligned view added as above)
#: and (B, n) of the batched sweep: 1, ragged 1000, the solo solver's
#: (1, 100000), the batch phase's bucket, lm_head's elements in two
#: instances (the best response's two-level form), and rows of 1001 from
#: a view one element into its storage (the scalar loop).
UPD_SHAPES = [(1,), (1000,), (8, 100_000), (50304, 2560)]
BATCHED_SHAPES = [(1, 1), (1, 1000), (1, 100_000), (8, 100_000),
                  (2, 50304 * 1280)]
BATCHED_MISALIGNED = (3, 1001)
#: The batch phase: B fig1d instances (seeds 0..B−1), generated on this
#: many host threads; each holds ≈ 10 GB of host memory while it runs.
BATCH = dict(B=8, iters=300, gen_threads=4)
#: The cv phase (``benchmarks/path_bench.py:run_cv`` at fig1b's width).
CV = dict(m_total=8000, n=10_000, support=500, K=4, P=16, ratio=0.05,
          seed=0, tol=1e-6)
#: (Bt, S, H, P, N, chunk) of the ssd_scan sweep: reduced, full width.
SSD_REDUCED = (2, 64, 3, 16, 8, 16)
SSD_FULL = [(1, 256, 64, 64, 128, 256), (4, 4096, 64, 64, 128, 256),
            (4, 4133, 64, 64, 128, 256)]
SSD_32K = (1, 32768, 64, 64, 128, 256)       # a prefill_32k sequence
SSD_ZAMBA = (4, 4096, 64, 64, 64, 256)       # zamba2-1.2b's prefill, N 64
#: (B, Hq, Hkv, Sq, Skv, D, causal) of the flash_attention sweep: MHA
#: (stablelm-3b, 32/32, D 80), GQA (yi-6b, 32/4, D 128), MQA (8/1, D 64);
#: causal and not; Sq = Skv, the end-aligned Sq < Skv, Sq = 1, ragged
#: Skv; and the two serve prefills at full size.
FA_SWEEP = [(1, 32, 32, 512, 512, 80, True), (1, 32, 32, 512, 512, 80, False),
            (2, 32, 4, 256, 1024, 128, True), (2, 8, 1, 1, 4133, 64, True),
            (1, 32, 4, 300, 4133, 128, True), (1, 8, 1, 777, 777, 64, False),
            (2, 32, 32, 1, 4133, 80, True)]
FA_STABLELM = (4, 32, 32, 4096, 4096, 80, True)
#: The fig1 phase: ``benchmarks/fig1.py:_field(16)`` as (label, method,
#: options), 1000 iterations each, GS max_iters // 10 sweeps.
FIG1_FIELD = [("FPA", "flexa", {}), ("FISTA", "fista", {}),
              ("GRock1", "grock", {"P": 1}),
              ("GRockP16", "grock", {"P": 16}),
              ("GS", "gauss_seidel", {}), ("ADMM", "admm", {"rho": 10.0})]
FIG1_ITERS = 1000
FIG1_THRESHOLDS = (1e-2, 1e-4, 1e-6)
#: (n_rows, k_valid, capacity, C) of the compact_best_response sweep: the
#: (n, 1) layout of the fig1d path's bucket, C 1, 64, 200, fig1d's m =
#: 5000 and ragged 4999, all padding, K = 1; C 7 (one element per step of
#: the one-cluster form), K·C at the one-cluster switch (16 × 8192) and
#: one row past it.
CBR_SWEEP = [(100_000, 35926, 65536, 1), (2000, 700, 1024, 1),
             (2000, 700, 1024, 64), (2000, 700, 1024, 200),
             (3000, 1100, 2048, 5000), (1000, 300, 512, 4999),
             (300, 0, 64, 64), (300, 0, 64, 1), (1000, 1, 1, 5000),
             (3000, 1100, 2048, 7), (140_000, 100_000, 131_072, 1),
             (140_000, 100_000, 131_073, 1)]
#: The bucket of the fig1d path's last-point state (9286 rows valid on
#: an H100), at which ``hopper_kernels`` reads the one-cluster
#: compact_best_response.
PATH_STATE_K = 16384
#: Opcodes read from the SASS of ``flexa_prox`` and ``compact_rows``: the
#: one-launch batched best response and the one-cluster compact best
#: response must hold none of the first four (global atomics and
#: reductions, memory fences).
BR_SASS_OPS = ("ATOMG", "RED", "REDG", "MEMBAR", "HMMA")
#: gauss_seidel_sweep against its plain version, one sweep from x = 0 at
#: fig1d: V = rᵀr + c‖x‖₁ and max |δ| within GS_SWEEP_RTOL relative, and
#: max |x − x_plain| within GS_SWEEP_XTOL × max |x_plain| (the dot products
#: sum in another order, and 100000 sequential updates carry the rounding
#: forward; PERF.md gives the readings this was set from).
GS_SWEEP_RTOL = 1e-5
GS_SWEEP_XTOL = 1e-5
#: (m, n, sweeps) of the small gauss_seidel_sweep check: several sweeps,
#: where x stays small enough for an absolute 1e-5.
GS_CHECK = (500, 2000, 3)
FA_YI = (4, 32, 4, 4096, 4096, 128, True)
#: The new serve paths' prefills: zamba2-1.2b's shared attention (32/32
#: heads, D 64), phi3-medium-14b's GQA (40 heads over 10, D 128) and
#: deepseek-67b's (64 over 8).
FA_ZAMBA = (4, 32, 32, 4096, 4096, 64, True)
FA_PHI3 = (2, 40, 10, 2048, 2048, 128, True)
FA_DEEPSEEK = (1, 64, 8, 1024, 1024, 128, True)


class PhaseError(Exception):
    pass


def check(ok, what):
    if not ok:
        raise PhaseError(what)


def say(phase, **fields):
    print(f"{phase}: " + json.dumps(fields, sort_keys=False), flush=True)


def cuda_ms(torch, fn, reps=20):
    """Mean CUDA-event time of ``fn`` over ``reps`` back-to-back calls."""
    fn()
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def graph_ms(torch, fn, reps=20, replays=5):
    """Device time of one ``fn`` call: ``reps`` calls captured in one CUDA
    graph and replayed, so the host's launch overhead is left out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    ms = cuda_ms(torch, graph.replay, reps=replays) / reps
    del graph
    return ms


def bytes_ms(nbytes):
    return nbytes / HBM_BYTES_PER_S * 1e3


# ---------------------------------------------------------------- phases
def device_kernels(torch, prof, names=KERNEL_NAMES):
    """From a ``torch.profiler`` run: per wrapper, [device launches, summed
    device ms] of its kernels (a wrapper in ``CALL_MARKS`` counts the
    records of its marking kernel), and [records, summed ms] of all device
    work (kernels, copies, sets) the profile saw."""
    out = {k: [0, 0.0] for k in names}
    busy = [0, 0.0]
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        ms = e.duration_ns() / 1e6
        busy[0] += 1
        busy[1] += ms
        for k, subs in names.items():
            if any(sub in e.name() for sub in subs):
                mark = CALL_MARKS.get(k)
                out[k][0] += mark is None or mark in e.name()
                out[k][1] += ms
    check(busy[0] > 0, "the profiler recorded no device work")
    return out, busy


def top_kernels(torch, prof, n=12):
    """The ``n`` device kernels with the most summed time in a profile:
    [name (first 70 characters), launches, ms]."""
    acc = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        rec = acc.setdefault(e.name()[:70], [0, 0.0])
        rec[0] += 1
        rec[1] += e.duration_ns() / 1e6
    top = sorted(acc.items(), key=lambda kv: -kv[1][1])[:n]
    return [[k, c, round(ms, 3)] for k, (c, ms) in top]


#: Idle seconds at the start of a profiled window, and the least at its
#: end.  The profiler keeps a device record only if its timestamps, mapped
#: onto the host clock, fall inside the window, and on the H100 that
#: mapping errs either way, by more the longer the window.  A window that
#: closed right after a training step lost the records of the step's end:
#: its optimizer, every ``best_response`` in it.  The margins keep the
#: work's records inside the window; the train phase prints how far
#: inside (``profiled_step_edges_ms``).  At 1 s a mamba2-1.3b prefill's
#: profile on one host kept 47 of its 48 ``ssd_scan`` records.
PROFILE_HEAD_S = 2.0
PROFILE_TAIL_FRAC = 0.2            # of the work's time, if more than HEAD


@contextlib.contextmanager
def profiled(torch):
    """``torch.profiler`` over CUDA activity around the body, the device
    idle for ``PROFILE_HEAD_S`` before it and for the larger of that and
    ``PROFILE_TAIL_FRAC`` of its time after it.  Sets ``prof.work_ns``
    to the host's (start, end) of the body, end after a synchronize, on
    the clock of the profiler's records."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_HEAD_S)
        t0 = time.time_ns()
        yield prof
        torch.cuda.synchronize()
        t1 = time.time_ns()
        prof.work_ns = (t0, t1)
        time.sleep(max(PROFILE_HEAD_S, PROFILE_TAIL_FRAC * (t1 - t0) / 1e9))


def window_edges(torch, prof):
    """[first device record's start − the body's start, the body's end −
    the last device record's end] in ms, and the number of device records:
    how far the profile's records sit inside the profiled work."""
    ev = [e for e in prof.profiler.kineto_results.events()
          if e.device_type() == torch.autograd.DeviceType.CUDA]
    if not ev:
        return [None, None], 0
    t0, t1 = prof.work_ns
    return [(min(e.start_ns() for e in ev) - t0) / 1e6,
            (t1 - max(e.end_ns() for e in ev)) / 1e6], len(ev)


def phase_setup(torch, build, fp, ssd, fa, gs):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    t = time.perf_counter()
    build.build_all(verbose=True)
    build_wall = time.perf_counter() - t
    fp.library()
    fp.br_library()
    ssd.library()
    fa.library()
    gs.library()
    check(not torch.backends.cuda.matmul.allow_tf32,
          "fp32 matmuls must run in full fp32 (TF32 is on)")
    say("setup", card=card, torch=torch.__version__,
        cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
        build_s={k: round(v, 3) for k, v in build.build_seconds.items()},
        build_wall_s=round(build_wall, 3))
    return card


def phase_hopper(torch, build, fp, fa, gs, ssd):
    """The kernels redesigned for Hopper as the compiler and the card
    made them: registers, local (spill) bytes, static and dynamic shared
    memory, blocks per SM (``flash_attention`` at the prefill's D 80 and
    128 in bf16, and its fp32 body; each of ``ssd_scan``'s passes in bf16
    and fp32 at mamba2-1.3b's N 128, P 64, chunk 256) and clusters the
    card can hold (``gauss_seidel_sweep`` at fig1d's m); and the
    tensor-core instructions in the SASS of ``flash_attention`` and
    ``ssd_scan``: every bf16 instantiation (one per D / 16; the chunk
    states and chunk outputs) must hold HMMA or HGMMA, no fp32 (or fp16)
    one any; ``batched_best_response`` at the solver's (1, 100000) and
    (8, 100000): one launch of one cluster of C > 1 CTAs per instance, no
    global atomic, reduction or fence in any instantiation of that
    form's SASS (the two-level form's ticket shows as ATOMG and MEMBAR)."""
    import re
    info = {f"flash_attention {str(dt).split('.')[-1]} D={D}":
            fa.kernel_info(dt, D)
            for dt, D in ((torch.bfloat16, 80), (torch.bfloat16, 128),
                          (torch.float32, 80), (torch.float32, 128))}
    N, P, chunk = SSD_FULL[0][4], SSD_FULL[0][3], SSD_FULL[0][5]
    for dt in (torch.bfloat16, torch.float32):
        for pass_ in ssd.PASSES:
            info[f"ssd_scan {str(dt).split('.')[-1]} {pass_}"] = \
                ssd.kernel_info(dt, pass_, N, P, chunk)
            # zamba2-1.2b's state size
            info[f"ssd_scan {str(dt).split('.')[-1]} {pass_} "
                 f"N={SSD_ZAMBA[4]}"] = ssd.kernel_info(
                     dt, pass_, SSD_ZAMBA[4], P, chunk)
    info[f"gauss_seidel_sweep m={FIG1D['m']}"] = gs.kernel_info(FIG1D["m"])
    for B in (1, 8):
        info[f"batched_best_response n={FIG1D['n']} B={B}"] = \
            fp.batched_kernel_info(FIG1D["n"], B)
    forms = {"one_launch": "flexa_batched_best_response_kernelI",
             "two_level": "flexa_batched_best_response_two_level_kernelI"}
    br_sass = {f: {"instantiations": 0, **dict.fromkeys(BR_SASS_OPS, 0)}
               for f in forms}
    for name, ops in build.sass_counts("flexa_prox",
                                       opcodes=BR_SASS_OPS).items():
        for form, key in forms.items():
            if key in name:
                br_sass[form]["instantiations"] += 1
                for op in BR_SASS_OPS:
                    br_sass[form][op] += ops[op]
    sass = {"bf16": {}, "fp32": {}}
    for name, ops in build.sass_counts("flash_attention").items():
        if "flash_attention_fwd" not in name:
            continue
        nc = re.search(r"Li(\d+)E", name)
        key = f"D<={16 * int(nc.group(1))}" if nc else name
        sass["bf16" if "flash_attention_fwd_mma" in name else "fp32"][key] = \
            ops["HMMA"] + ops["HGMMA"]
    ssd_sass = {"bf16": {}, "fp32": {}}
    for name, ops in build.sass_counts("ssd_scan").items():
        kern = re.search(r"(ssd_chunk_\w+?|ssd_state_pass)(I|E)", name)
        if kern is None:
            continue
        kind = "bf16" if kern.group(1).endswith("_mma") else "fp32"
        elem = re.search(r"I(f|6__half)EEv", name)
        key = kern.group(1) + ({"f": "<float>", "6__half": "<half>"}[
            elem.group(1)] if elem else "")
        ssd_sass[kind][key] = ops["HMMA"] + ops["HGMMA"]
    info[f"compact_best_response K={PATH_STATE_K} C=1"] = \
        fp.compact_kernel_info(PATH_STATE_K, 1)
    cbr_forms = {"one_launch": ("compact_br_clusterI",),
                 "grid": ("compact_br_wideI", "compact_br_narrowI")}
    cbr_sass = {f: {"instantiations": 0, **dict.fromkeys(BR_SASS_OPS, 0)}
                for f in cbr_forms}
    for name, ops in build.sass_counts("compact_rows",
                                       opcodes=BR_SASS_OPS).items():
        for form, keys in cbr_forms.items():
            if any(k in name for k in keys):
                cbr_sass[form]["instantiations"] += 1
                for op in BR_SASS_OPS:
                    cbr_sass[form][op] += ops[op]
    say("hopper_kernels", info=info, tensor_core_sass=sass,
        ssd_scan_tensor_core_sass=ssd_sass,
        batched_best_response_sass=br_sass,
        compact_best_response_sass=cbr_sass)
    one = cbr_sass["one_launch"]
    check(one["instantiations"] == 8 and not any(
        one[op] for op in ("ATOMG", "RED", "REDG", "MEMBAR")),
        f"the one-cluster compact best response holds atomics or fences: "
        f"{cbr_sass}")
    ci = info[f"compact_best_response K={PATH_STATE_K} C=1"]
    check(ci["form"] == "one_launch" and ci["max_active_clusters"] >= 1,
          f"compact_best_response at K={PATH_STATE_K} is not one launch of "
          f"a cluster: {ci}")
    one = br_sass["one_launch"]
    check(one["instantiations"] == 12 and not any(
        one[op] for op in ("ATOMG", "RED", "REDG", "MEMBAR")),
        f"the one-launch batched best response holds atomics or fences: "
        f"{br_sass}")
    for B in (1, 8):
        bi = info[f"batched_best_response n={FIG1D['n']} B={B}"]
        check(bi["form"] == "one_launch" and bi["cluster_ctas"] > 1,
              f"batched_best_response at ({B}, {FIG1D['n']}) is not one "
              f"launch of a cluster: {bi}")
    check(len(sass["bf16"]) == 8 and all(v > 0 for v in sass["bf16"].values()),
          f"flash_attention's bf16 body lacks tensor-core SASS: {sass}")
    check(len(sass["fp32"]) == 8 and not any(sass["fp32"].values()),
          f"flash_attention's fp32 body holds tensor-core SASS: {sass}")
    check(len(ssd_sass["bf16"]) == 2
          and all(v > 0 for v in ssd_sass["bf16"].values()),
          f"ssd_scan's bf16 passes lack tensor-core SASS: {ssd_sass}")
    check(len(ssd_sass["fp32"]) == 5 and not any(ssd_sass["fp32"].values()),
          f"ssd_scan's fp32, fp16 or state passes hold tensor-core SASS: "
          f"{ssd_sass}")
    return info


def _plan(torch, n_rows, k_valid, cap, seed, dev):
    """Sorted distinct active rows (k_valid of them) padded with −1 to
    ``cap``, and the inverse permutation; int32 on ``dev``."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    act = torch.randperm(n_rows, generator=g)[:k_valid].sort().values
    idx = torch.full((cap,), -1, dtype=torch.int32)
    idx[:k_valid] = act.to(torch.int32)
    inv = torch.full((n_rows,), -1, dtype=torch.int32)
    inv[act] = torch.arange(k_valid, dtype=torch.int32)
    return idx.to(dev), inv.to(dev)


def ssd_inputs(torch, shape, dtype, seed, dev, strided=True,
               overflow=False):
    """x, dt, A, B, C of an ssd_scan call: x, B and C as views of one
    (Bt, S, H·P + 2N) buffer when ``strided`` (as the mixer passes them),
    A = −linspace(1, 16, H) as the model's A_log gives, dt in (0.001,
    0.301), or 0.1 everywhere for ``overflow`` (Σ dt·|A| over a chunk of
    256 then passes 88.7 for every head with |A| ≥ 3.5)."""
    Bt, S, H, P, N, _ = shape
    g = torch.Generator(device=dev).manual_seed(seed)
    xBC = torch.randn((Bt, S, H * P + 2 * N), generator=g,
                      device=dev).to(dtype)
    x = xBC[..., :H * P].reshape(Bt, S, H, P)
    B, C = xBC[..., H * P: H * P + N], xBC[..., H * P + N:]
    if not strided:
        x, B, C = x.contiguous(), B.contiguous(), C.contiguous()
    if overflow:
        dt = torch.full((Bt, S, H), 0.1, device=dev)
    else:
        dt = torch.rand((Bt, S, H), generator=g, device=dev) * 0.3 + 1e-3
    A = -torch.linspace(1.0, 16.0, H, device=dev)
    return x, dt, A, B, C


def ssd_compare(torch, got, want):
    """Max |Δy|, |Δh| of the kernel against its plain version; fails
    unless finite and y within 1e-4 × max |y| (bf16: plus 2 bf16 ulps of
    each element), h within 1e-4 × max |h|."""
    (y, h), (y0, h0) = got, want
    check(y.dtype == y0.dtype and y.shape == y0.shape and h.shape ==
          h0.shape, f"ssd_scan: {y.dtype}{tuple(y.shape)} vs "
          f"{y0.dtype}{tuple(y0.shape)}")
    yf, y0f = y.float(), y0.float()
    check(bool(torch.isfinite(yf).all() and torch.isfinite(h).all()),
          "ssd_scan: non-finite output")
    check(bool(torch.isfinite(y0f).all()), "ssd_scan plain: non-finite")
    dy = (yf - y0f).abs()
    bound = 1e-4 * float(y0f.abs().max())
    if y.dtype == torch.bfloat16:
        ulp = torch.exp2(torch.floor(torch.log2(
            y0f.abs().clamp_min(2.0 ** -126))) - 7)
        ok = bool((dy <= 2 * ulp + bound).all())
    else:
        ok = float(dy.max()) <= bound
    dh = float((h - h0).abs().max())
    check(ok and dh <= 1e-4 * float(h0.abs().max()),
          f"ssd_scan differs from its plain version: max |dy| "
          f"{float(dy.max())} (bound {bound}), max |dh| {dh}")
    return float(dy.max()), dh


def ssd_sweep(torch, ssd, dev):
    """ssd_scan against its plain version over the sweep; every launch
    repeated once, bitwise."""
    cases = []
    for shape in [SSD_REDUCED] + SSD_FULL + [SSD_ZAMBA]:
        for strided in ((False, True) if shape[1] <= 256 else (True,)):
            cases.append((shape, strided, False))
    cases.append(((1, 512, 64, 64, 128, 256), True, True))    # overflow
    err = {"float32": [0.0, 0.0], "bfloat16": [0.0, 0.0]}
    for i, (shape, strided, overflow) in enumerate(cases):
        for name in err:
            args = ssd_inputs(torch, shape, getattr(torch, name), seed=i,
                              dev=dev, strided=strided, overflow=overflow)
            got = ssd.ssd_scan(*args, chunk=shape[-1])
            again = ssd.ssd_scan(*args, chunk=shape[-1])
            check(torch.equal(got[0], again[0]) and torch.equal(
                got[1], again[1]), f"ssd_scan {shape} {name}: a second "
                "launch gave other bits")
            dy, dh = ssd_compare(torch, got, ssd.ssd_scan.plain(
                *args, chunk=shape[-1]))
            err[name] = [max(err[name][0], dy), max(err[name][1], dh)]
            del args, got, again
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return err, len(cases) * len(err)


def fa_inputs(torch, shape, dtype, seed, dev, model_layout=False):
    """q, k, v of a flash_attention call, N(0, 1) in ``dtype``.

    With ``model_layout`` they are laid out as the prefill passes them
    (``attention._qkv``): heads split out of (B, S, H·D) projections, q
    and k through ``apply_rope`` at positions 0..S−1, v the strided view
    itself (needs Sq = Skv)."""
    B, Hq, Hkv, Sq, Skv, D, _ = shape
    g = torch.Generator(device=dev).manual_seed(seed)
    if not model_layout:
        return tuple(torch.randn(s, generator=g, device=dev).to(dtype)
                     for s in ((B, Hq, Sq, D), (B, Hkv, Skv, D),
                               (B, Hkv, Skv, D)))
    from repro_torch.models import layers as L
    pos = torch.arange(Sq, device=dev).expand(B, Sq)
    q, k, v = (torch.randn((B, Sq, H * D), generator=g, device=dev).to(dtype)
               .reshape(B, Sq, H, D).transpose(1, 2)
               for H in (Hq, Hkv, Hkv))
    return L.apply_rope(q, pos), L.apply_rope(k, pos), v


def fa_sweep(torch, fa, dev):
    """flash_attention against its plain version over the sweep: fp32
    within 2e-5 (``tests/test_kernels.py``'s tolerance), bf16 within 2
    bf16 ulps of each element plus that; finite, and a second launch
    bitwise.  A causal call with Sq > Skv must raise."""
    err = {"float32": 0.0, "bfloat16": 0.0}
    cases = FA_SWEEP + [FA_STABLELM, FA_YI, FA_ZAMBA, FA_PHI3, FA_DEEPSEEK]
    for i, shape in enumerate(cases):
        causal = shape[-1]
        for name in err:
            q, k, v = fa_inputs(torch, shape, getattr(torch, name), i, dev,
                                model_layout=i >= len(FA_SWEEP))
            got = fa.flash_attention(q, k, v, causal=causal)
            again = fa.flash_attention(q, k, v, causal=causal)
            check(torch.equal(got, again), f"flash_attention {shape} {name}: "
                  "a second launch gave other bits")
            want = fa.flash_attention.plain(q, k, v, causal=causal)
            check(got.dtype == want.dtype and got.shape == want.shape,
                  f"flash_attention {shape}: {got.dtype}{tuple(got.shape)} "
                  f"vs {want.dtype}{tuple(want.shape)}")
            gf, wf = got.float(), want.float()
            check(bool(torch.isfinite(gf).all()),
                  f"flash_attention {shape} {name}: non-finite output")
            dy = (gf - wf).abs()
            tol = torch.full_like(wf, 2e-5)
            if name == "bfloat16":
                tol += 2 * torch.exp2(torch.floor(torch.log2(
                    wf.abs().clamp_min(2.0 ** -126))) - 7)
            check(bool((dy <= tol).all()), f"flash_attention {shape} {name} "
                  f"differs from its plain version: max |dy| "
                  f"{float(dy.max())}")
            err[name] = max(err[name], float(dy.max()))
            del q, k, v, got, again, want, gf, wf, dy, tol
            torch.cuda.empty_cache()
    q, k, v = fa_inputs(torch, (1, 2, 1, 9, 8, 16, True), torch.float32, 0,
                        dev)
    try:
        fa.flash_attention(q, k, v, causal=True)
        refused = False
    except ValueError:
        refused = True
    check(refused, "flash_attention took a causal call with Sq > Skv")
    torch.cuda.synchronize()
    return err, len(cases) * len(err)


def cbr_sweep(torch, fp, kops, dev):
    """compact_best_response against its plain version over
    ``CBR_SWEEP`` × scalar and dense d × fp32 and bf16 x/g: z bitwise,
    pad rows 0, e2 within 1e-5 relative, a second launch bitwise."""
    z_err, rel_max, n = 0.0, 0.0, 0
    for i, (N, k, cap, C) in enumerate(CBR_SWEEP):
        idx, _ = _plan(torch, N, k, cap, 80 + i, dev)
        gen = torch.Generator(device=dev).manual_seed(80 + i)
        x32 = torch.randn((N, C), generator=gen, device=dev)
        g32 = 0.5 * torch.randn((N, C), generator=gen, device=dev)
        dense = torch.rand((N, C), generator=gen, device=dev) * 2.5 + 0.5
        for dtype in (torch.float32, torch.bfloat16):
            x, g = x32.to(dtype), g32.to(dtype)
            for d in (torch.tensor(1.7, device=dev), dense):
                what = (f"({N}, {C}) K={cap} valid={k} {dtype} "
                        f"dense={d.dim() > 0}")
                z, e2 = kops.compact_best_response(x, g, d, 0.3, idx)
                z0, e0 = fp.compact_best_response.plain(x, g, d, 0.3, idx)
                z_err = max(z_err, equal_or_fail(
                    torch, "compact_best_response", z, z0, what))
                check(bool((z[idx < 0] == 0).all()),
                      f"compact_best_response {what}: a pad row is not 0")
                e2, e0 = float(e2), float(e0)
                rel = abs(e2 - e0) / max(e0, 1e-30)
                check(rel <= 1e-5, f"compact_best_response {what}: e2 {e2} "
                      f"vs plain {e0}")
                rel_max = max(rel_max, rel)
                z2, e22 = kops.compact_best_response(x, g, d, 0.3, idx)
                check(torch.equal(z2, z) and float(e22) == e2,
                      f"compact_best_response {what}: a second launch gave "
                      "other bits")
                n += 1
                del z, z0, z2
        del x32, g32, dense, x, g
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return z_err, rel_max, n


def gs_check(torch, gs, dev):
    """gauss_seidel_sweep against its plain version: ``GS_CHECK``'s sweeps
    from x = 0 (r = −b), twice through the kernel (bitwise), once through
    the plain version: x within 1e-5, each sweep's max |δ| within 1e-5
    relative."""
    from repro_torch.problems.lasso import nesterov_instance

    m, n, sweeps = GS_CHECK
    p = nesterov_instance(**{**FIG1D, "m": m, "n": n}, device=dev)
    A = p.data["A"]
    At, colsq = A.T.contiguous(), torch.clamp_min((A * A).sum(0), 1e-12)
    runs = []
    for fn in (gs.gauss_seidel_sweep, gs.gauss_seidel_sweep,
               gs.gauss_seidel_sweep.plain):
        x = torch.zeros(n, device=dev)
        r = -p.data["b"]
        runs.append((x, r, torch.stack([fn(At, colsq, x, r, p.g_weight)
                                        for _ in range(sweeps)])))
    (xk, rk, sk), (xk2, rk2, sk2), (xp, _, sp) = runs
    check(torch.equal(xk, xk2) and torch.equal(rk, rk2)
          and torch.equal(sk, sk2),
          "gauss_seidel_sweep: a second run gave other bits")
    dx = float((xk - xp).abs().max())
    rel = float(((sk - sp).abs() / sp.abs()).max())
    check(dx <= 1e-5 and rel <= 1e-5, f"gauss_seidel_sweep vs its plain "
          f"version over {sweeps} sweeps: max |dx| {dx}, max |δ| rel {rel}")
    return dx, rel


def phase_kernels(torch, fp, ssd, fa, gs, dev):
    err = {"gather_rows": 0.0, "scatter_rows": 0.0}
    times = {}

    def compare(name, got, want):
        check(got.dtype == want.dtype and got.shape == want.shape,
              f"{name}: {got.dtype}{tuple(got.shape)} vs "
              f"{want.dtype}{tuple(want.shape)}")
        e = float((got.float() - want.float()).abs().max()) \
            if got.numel() else 0.0
        err[name] = max(err[name], e)
        check(torch.equal(got, want), f"{name} differs from its plain "
              f"version (max abs err {e})")

    def case(n_rows, C, k_valid, cap, dtype, seed, timed=False):
        src = torch.randn((n_rows, C), device=dev).to(dtype)
        idx, inv = _plan(torch, n_rows, k_valid, cap, seed, dev)
        got = fp.gather_rows(src, idx)
        compare("gather_rows", got, fp.gather_rows.plain(src, idx))
        vals = torch.randn((cap, C), device=dev)
        base = torch.randn((n_rows, C), device=dev).to(dtype)
        compare("scatter_rows", fp.scatter_rows(vals, inv, base),
                fp.scatter_rows.plain(vals, inv, base))
        if timed:
            key = f"gather {n_rows}x{C} K={cap} valid={k_valid}"
            times[key] = round(graph_ms(
                torch, lambda: fp.gather_rows(src, idx)), 4)
        del src, vals, base, got

    n, m = FIG1D["n"], FIG1D["m"]
    for K in GATHER_KS:                     # pack_columns on Aᵀ at fig1d
        case(n, m, K, K, torch.float32, K, timed=True)
    # a padded bucket, as the path packs it (zero rows past the support)
    case(n, m, PADDED_K_VALID, GATHER_KS[-1], torch.float32, 9, timed=True)
    case(n, 1, VECTOR_K, VECTOR_K, torch.float32, 1)   # the (n, 1) vectors
    case(n, 1, VECTOR_K * 5 // 8, VECTOR_K, torch.float32, 2)   # padding
    for C in (37, 300, 4999):                     # ragged C
        case(1000, C, 300, 512, torch.float32, C)
    case(1000, 300, 0, 64, torch.float32, 3)      # every slot −1
    case(1000, 300, 1, 1, torch.float32, 4)       # K = 1
    case(1000, 1, 1, 1, torch.float32, 5)
    for dt in (torch.bfloat16, torch.float16):
        case(2000, 520, 700, 1024, dt, 6)
        case(2000, 1, 700, 1024, dt, 7)
    # the scatter at a ragged N and on a view one element into its storage
    for N, off in ((n + 3, 0), (n, 1)):
        idx, inv = _plan(torch, N, VECTOR_K, VECTOR_K, 10 + off, dev)
        vals = torch.randn((VECTOR_K, 1), device=dev)
        base = torch.randn(N + off, device=dev)[off:].view(N, 1)
        compare("scatter_rows", fp.scatter_rows(vals, inv, base),
                fp.scatter_rows.plain(vals, inv, base))
    # mixed value/base dtypes of the scatter
    vals = torch.randn((64, 40), device=dev).to(torch.bfloat16)
    idx, inv = _plan(torch, 300, 50, 64, 8, dev)
    for bdt in (torch.float32, torch.float16):
        base = torch.randn((300, 40), device=dev).to(bdt)
        compare("scatter_rows", fp.scatter_rows(vals, inv, base),
                fp.scatter_rows.plain(vals, inv, base))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    ssd_err, n_ssd = ssd_sweep(torch, ssd, dev)
    err["ssd_scan"] = max(e[0] for e in ssd_err.values())
    br_z_err, br_e2_rel, n_br = br_sweep(torch, fp, dev)
    err["best_response"] = br_z_err
    fa_err, n_fa = fa_sweep(torch, fa, dev)
    err["flash_attention"] = max(fa_err.values())
    upd_err, upd_cases = upd_sweep(torch, fp, dev)
    bat_err, bat_e2_rel, bat_cases = batched_sweep(torch, fp, dev)
    bat_one = batched_one_launch(torch, fp, dev)
    err["apply_update"] = upd_err
    err.update(bat_err)
    from repro_torch.kernels import ops as kops
    err["compact_best_response"], cbr_e2_rel, cbr_cases = cbr_sweep(
        torch, fp, kops, dev)
    gs_dx, gs_delta_rel = gs_check(torch, gs, dev)
    say("kernels", max_abs_err=err, gather_ms=times, ssd_scan_cases=n_ssd,
        ssd_scan_max_abs_err_y_h=ssd_err, best_response_cases=n_br,
        best_response_max_e2_rel_err=br_e2_rel, flash_attention_cases=n_fa,
        flash_attention_max_abs_err=fa_err, apply_update_cases=upd_cases,
        batched_cases=bat_cases, batched_best_response_max_e2_rel_err=(
            bat_e2_rel), batched_best_response_one_launch=bat_one,
        compact_best_response_cases=cbr_cases,
        compact_best_response_max_e2_rel_err=cbr_e2_rel,
        gauss_seidel_sweep_check=dict(zip(("m", "n", "sweeps"), GS_CHECK)),
        gauss_seidel_sweep_max_abs_dx=gs_dx,
        gauss_seidel_sweep_max_delta_rel_err=gs_delta_rel)
    return err


def equal_or_fail(torch, name, got, want, what):
    """``got`` bitwise equal to ``want`` (dtype, shape and bits); returns
    max |got − want| (0.0)."""
    check(got.dtype == want.dtype and got.shape == want.shape,
          f"{name} {what}: {got.dtype}{tuple(got.shape)} vs "
          f"{want.dtype}{tuple(want.shape)}")
    e = float((got.float() - want.float()).abs().max()) if got.numel() \
        else 0.0
    check(torch.equal(got, want), f"{name} {what}: differs from its plain "
          f"version (max abs err {e})")
    return e


def upd_sweep(torch, fp, dev):
    """apply_update against its plain version: out bitwise, in place as
    the optimizer calls it too, a second launch bitwise."""
    cases = [(shape, 0) for shape in UPD_SHAPES] + [(BR_MISALIGNED, 1)]
    err, n = 0.0, 0
    for i, (shape, offset) in enumerate(cases):
        for dtype in (torch.float32, torch.bfloat16):
            for dense in (False, True):
                x, g, d = br_inputs(torch, shape, dtype, dense, seed=50 + i,
                                    dev=dev, offset=offset)
                for c, gm in ((0.0, 0.9), (1e-3, 1.0), (1e-3, 0.0)):
                    gmt = torch.tensor(gm, device=dev)
                    what = (f"{shape}+{offset} {dtype} dense={dense} c={c} "
                            f"gm={gm}")
                    got = fp.apply_update(x, g, d, c, gmt)
                    want = fp.apply_update.plain(x, g, d, c, gmt)
                    err = max(err, equal_or_fail(torch, "apply_update", got,
                                                 want, what))
                    equal_or_fail(torch, "apply_update", fp.apply_update(
                        x, g, d, c, gmt), got, what + " (second launch)")
                    x2 = x.clone()
                    fp.apply_update(x2, g, d, c, gmt, out=x2)
                    equal_or_fail(torch, "apply_update", x2, want,
                                  what + " (in place)")
                    n += 1
                    del got, want, x2
                del x, g, d
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return err, n


def batched_inputs(torch, B, n, dtype, dkind, ckind, seed, dev, offset=0):
    """x, g ((B, n), views ``offset`` elements into their storage), d ((),
    (B,) or (B, n)), c (0.0, a host float or (B,)) of a batched call."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(B * n + offset, generator=gen, device=dev).to(dtype)
    g = (0.1 * torch.randn(B * n + offset, generator=gen, device=dev)
         ).to(dtype)
    x, g = x[offset:].view(B, n), g[offset:].view(B, n)
    d = {"scalar": lambda: torch.tensor(1.7, device=dev),
         "instance": lambda: torch.rand(B, generator=gen, device=dev) * 1.5
         + 0.5,
         "dense": lambda: torch.rand((B, n), generator=gen, device=dev)
         * 1.5 + 0.5}[dkind]()
    c = {"zero": 0.0, "host": 0.05,
         "instance": torch.rand(B, generator=gen, device=dev) * 0.1}[ckind]
    return x, g, d, c


def batched_sweep(torch, fp, dev):
    """batched_best_response and batched_apply_update against their plain
    versions: z and the update bitwise, e2 within 1e-5 relative, a second
    launch bitwise."""
    cases = [(bn, 0) for bn in BATCHED_SHAPES] + [(BATCHED_MISALIGNED, 1)]
    err = {"batched_best_response": 0.0, "batched_apply_update": 0.0}
    rel_max, n = 0.0, 0
    gms = (0.9, 1.0, 0.0, "instance")
    for i, ((B, nn), offset) in enumerate(cases):
        for dtype in (torch.float32, torch.bfloat16):
            for dkind in ("scalar", "instance", "dense"):
                for ckind in ("zero", "host", "instance"):
                    x, g, d, c = batched_inputs(torch, B, nn, dtype, dkind,
                                                ckind, 60 + i, dev, offset)
                    gm_kind = gms[n % len(gms)]
                    gm = torch.rand(B, device=dev) if gm_kind == "instance" \
                        else torch.tensor(gm_kind, device=dev)
                    what = (f"({B}, {nn})+{offset} {dtype} d={dkind} "
                            f"c={ckind} gm={gm_kind}")
                    z, e2 = fp.batched_best_response(x, g, d, c)
                    z0, e0 = fp.batched_best_response.plain(x, g, d, c)
                    err["batched_best_response"] = max(
                        err["batched_best_response"], equal_or_fail(
                            torch, "batched_best_response", z, z0, what))
                    rel = float(((e2 - e0).abs() / e0.abs().clamp_min(
                        1e-30)).max())
                    check(rel <= 1e-5, f"batched_best_response {what}: e2 "
                          f"rel err {rel}")
                    rel_max = max(rel_max, rel)
                    z2, e22 = fp.batched_best_response(x, g, d, c)
                    check(torch.equal(z2, z) and torch.equal(e22, e2),
                          f"batched_best_response {what}: a second launch "
                          "gave other bits")
                    o = fp.batched_apply_update(x, g, d, c, gm)
                    err["batched_apply_update"] = max(
                        err["batched_apply_update"], equal_or_fail(
                            torch, "batched_apply_update", o,
                            fp.batched_apply_update.plain(x, g, d, c, gm),
                            what))
                    equal_or_fail(torch, "batched_apply_update",
                                  fp.batched_apply_update(x, g, d, c, gm),
                                  o, what + " (second launch)")
                    n += 1
                    del x, g, d, c, z, z0, z2, o
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return err, rel_max, n


def batched_one_launch(torch, fp, dev, calls=10):
    """``calls`` batched best responses at (1, 100000) and at (8, 100000)
    (fp32, dense d, c per instance, as the solver calls it) under
    ``torch.profiler``: every device record must be the one-launch
    kernel, one per call (no memset, no second kernel)."""
    args = [batched_inputs(torch, B, FIG1D["n"], torch.float32, "dense",
                           "instance", 80 + B, dev) for B in (1, 8)]
    for a in args:
        fp.batched_best_response(*a)
    with profiled(torch) as prof:
        for a in args:
            for _ in range(calls):
                fp.batched_best_response(*a)
    names = [e.name() for e in prof.profiler.kineto_results.events()
             if e.device_type() == torch.autograd.DeviceType.CUDA]
    ours = [n for n in names if "flexa_batched_best_response_kernel" in n]
    check(len(names) == len(ours) == 2 * calls,
          f"batched_best_response: {len(names)} device records for "
          f"{2 * calls} calls, {len(ours)} of the one-launch kernel; others: "
          f"{sorted(set(names) - set(ours))[:4]}")
    return {"calls": 2 * calls, "device_records": len(names)}


def br_inputs(torch, shape, dtype, dense, seed, dev, offset=0):
    """x, g (bf16 or fp32; views ``offset`` elements into their storage)
    and d (0-d τ = 1.7, or dense in [0.5, 2)) of a best_response call."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    n = math.prod(shape)
    x = torch.randn(n + offset, generator=gen, device=dev).to(dtype)
    g = (0.1 * torch.randn(n + offset, generator=gen, device=dev)).to(dtype)
    x, g = x[offset:].view(shape), g[offset:].view(shape)
    d = (torch.rand(shape, generator=gen, device=dev) * 1.5 + 0.5) if dense \
        else torch.tensor(1.7, device=dev)
    return x, g, d


def br_compare(torch, fp, args, c, what, kernel=None):
    """Kernel (``kernel``, default the wrapper itself) vs plain version on
    ``args``: z bitwise, e2 within 1e-5 relative, a second launch bitwise.
    Returns (max |Δz|, e2 rel err, kernel e2, plain e2)."""
    kernel = kernel or fp.best_response
    z, e2 = kernel(*args, c)
    z2, e22 = kernel(*args, c)
    z0, e0 = fp.best_response.plain(*args, c)
    dz = float((z - z0).abs().max())
    e2, e0 = float(e2), float(e0)
    rel = abs(e2 - e0) / max(e0, 1e-30)
    check(torch.equal(z, z0), f"best_response {what}: z differs from its "
          f"plain version (max |dz| {dz})")
    check(rel <= 1e-5, f"best_response {what}: e2 {e2} vs plain {e0} "
          f"(rel {rel})")
    check(torch.equal(z2, z) and float(e22) == e2,
          f"best_response {what}: a second launch gave other bits")
    return dz, rel, e2, e0


def br_sweep(torch, fp, dev):
    cases = [(shape, 0) for shape in BR_SHAPES] + [(BR_MISALIGNED, 1)]
    dz_max, rel_max, n = 0.0, 0.0, 0
    for i, (shape, offset) in enumerate(cases):
        for dtype in (torch.float32, torch.bfloat16):
            for dense in (False, True):
                args = br_inputs(torch, shape, dtype, dense, seed=i, dev=dev,
                                 offset=offset)
                for c in (0.0, 1e-3):
                    dz, rel, _, _ = br_compare(
                        torch, fp, args, c, f"{shape}+{offset} {dtype} "
                        f"dense={dense} c={c}")
                    dz_max, rel_max, n = max(dz_max, dz), max(rel_max, rel), \
                        n + 1
                del args
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return dz_max, rel_max, n


def phase_goldens(torch, dev):
    from repro_torch.client import FlexaClient, PathSpec, SoloSpec
    from repro_torch.config.base import SolverConfig
    from repro_torch.problems.lasso import nesterov_instance

    rel_v = {}
    for method in ("flexa", "fista", "admm"):
        gold = json.loads((GOLDEN / f"{method}_lasso_V.json").read_text())
        p = nesterov_instance(**gold["instance"], device=dev)
        r = FlexaClient(solver=SolverConfig(**gold["budget"],
                                            **gold["cfg_overrides"])).run(
            SoloSpec(problem=p, method=method, options=gold["options"]))
        V = r.history["V"]
        check(len(V) == len(gold["V"]), f"{method} golden: iteration count")
        rel_v[method] = max(abs(a - b) / abs(b) for a, b in zip(V, gold["V"]))
        check(rel_v[method] <= 5e-4,
              f"{method} golden: V rel err {rel_v[method]}")

    gold = json.loads((GOLDEN / "path_lasso_compact_V.json").read_text())
    p = nesterov_instance(**gold["instance"], device=dev)
    r = FlexaClient(solver=SolverConfig(**gold["cfg"])).run(
        PathSpec(problem=p, compact=True, **gold["grid"]))
    rel_p = max(abs(a - b) / abs(b) for a, b in zip(r.V, gold["V"]))
    check(rel_p <= 5e-4, f"path golden: V rel err {rel_p}")
    check(abs(r.lam_max - gold["lam_max"]) <= 1e-6 * gold["lam_max"],
          "path golden: lam_max")
    check([int(s) for s in r.support] == gold["support"],
          f"path golden: support {list(r.support)}")
    check(r.meta["program_widths"] == gold["program_widths"],
          f"path golden: widths {r.meta['program_widths']}")
    flops_rel = abs(r.device_flops - gold["device_flops"]) \
        / gold["device_flops"]
    check(flops_rel <= 0.02, f"path golden: device_flops {r.device_flops}")
    say("goldens", V_rel_err=rel_v, path_V_rel_err=rel_p,
        support=[int(s) for s in r.support],
        program_widths=r.meta["program_widths"],
        device_flops=r.device_flops, golden_device_flops=gold[
            "device_flops"])


def phase_solo(torch, fp, dev):
    from repro_torch.client import FlexaClient, SoloSpec
    from repro_torch.config.base import SolverConfig
    from repro_torch.core import flexa, surrogate
    from repro_torch.problems.lasso import nesterov_instance

    t0 = time.perf_counter()
    p = nesterov_instance(**FIG1D, device=dev)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    A, b = p.data["A"], p.data["b"]
    x = torch.zeros(p.n, device=dev)

    def two_gemv():
        A.T @ (A @ x - b)

    gemv_ms = graph_ms(torch, two_gemv)
    bound_ms = bytes_ms(2 * A.numel() * 4)
    # V(x_new) = ‖A x_new − b‖² is a third pass over A each iteration
    v_ms = graph_ms(torch, lambda: p.v(x))
    # Device time of one iteration (captured in a CUDA graph): what the
    # card spends when the host is not in the way.
    cfg = SolverConfig(max_iters=SOLO_ITERS, tol=-1.0)
    tau = flexa._base_tau(p, cfg)
    state = flexa.init_state(p, x, cfg)
    iter_device_ms = graph_ms(
        torch, lambda: flexa.flexa_iteration(p, cfg, tau, state), reps=10)
    client = FlexaClient(solver=cfg)
    v0 = float(p.v(x))
    out, xs = {}, {}
    br = fp.batched_best_response
    for method in ("flexa", "flexa_compiled"):
        torch.cuda.synchronize()
        br.launches = 0
        t = time.perf_counter()
        r = client.run(SoloSpec(problem=p, method=method))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        check(r.iters == SOLO_ITERS and r.x.shape == (p.n,), method)
        check(br.launches == SOLO_ITERS, f"{method}: batched_best_response "
              f"launched {br.launches} times in {SOLO_ITERS} iterations")
        v = float(p.v(torch.as_tensor(r.x, device=dev)))
        check(math.isfinite(v), f"{method}: V {v} (V at x=0: {v0})")
        xs[method] = r.x
        out[method] = {"ms_per_iter": round(wall / SOLO_ITERS * 1e3, 4),
                       "V_rel_err": (v - p.v_star) / p.v_star}
    dx = float(abs(xs["flexa"] - xs["flexa_compiled"]).max())
    check(dx <= 1e-5, f"flexa vs flexa_compiled: max |dx| {dx}")
    # one fig1d iteration's S.2 and S.4 (full rule) at the solve's x:
    # kernels against plain versions, and the chain through the kernel
    x1 = torch.as_tensor(xs["flexa"], device=dev)
    g1 = p.grad_f(x1)
    d1 = surrogate.curvature(p, tau, cfg.surrogate)
    rows = (x1[None], g1[None], d1[None], p.g_weight)
    z, _ = fp.batched_best_response(*rows)
    equal_or_fail(torch, "batched_best_response", z,
                  fp.batched_best_response.plain(*rows)[0], "fig1d iteration")
    equal_or_fail(torch, "batched_best_response", surrogate.best_response(
        p, x1, g1, d1)[None], z, "fig1d iteration, through the chain")
    xn = fp.batched_apply_update(*rows, state.gamma)
    equal_or_fail(torch, "batched_apply_update", xn,
                  fp.batched_apply_update.plain(*rows, state.gamma),
                  "fig1d iteration")
    say("solo", instance="fig1d", gen_s=round(gen_s, 2),
        two_gemv_ms=round(gemv_ms, 4), two_gemv_bound_ms=round(bound_ms, 4),
        v_eval_ms=round(v_ms, 4), iter_device_ms=round(iter_device_ms, 4),
        batched_best_response_launches_per_method=SOLO_ITERS,
        max_dx_methods=dx, **out)
    return p


def time_to(V, T, v_star, thr):
    """(seconds, iterations) until (V − V*)/V* ≤ ``thr`` first, on the
    solver's history clock (``benchmarks/fig1.py:time_to``); (None, None)
    if never."""
    for k, v in enumerate(V):
        if (v - v_star) / v_star <= thr:
            return T[k], k + 1
    return None, None


def phase_fig1(torch, fp, gs, p, dev):
    """The paper's Fig. 1 race at fig1d (``benchmarks/fig1.py:run_group``'s
    field for 16 processors) on the solo phase's instance, each method a
    ``SoloSpec`` through ``FlexaClient`` with tol 0; then one Gauss-Seidel
    sweep from x = 0 at fig1d through the kernel and its plain version,
    gated and timed (``gs_sweep_check``).  Returns (the sweep kernel's
    launches in the race, the sweep's readings and times)."""
    from repro_torch.client import FlexaClient, SoloSpec
    from repro_torch.config.base import SolverConfig

    counters = {"best_response": fp.best_response,
                "apply_update": fp.apply_update,
                "gather_rows": fp.gather_rows,
                "scatter_rows": fp.scatter_rows,
                "batched_best_response": fp.batched_best_response,
                "batched_apply_update": fp.batched_apply_update,
                "compact_best_response": fp.compact_best_response,
                "gauss_seidel_sweep": gs.gauss_seidel_sweep}
    for k in counters.values():
        k.launches = 0
    sweeps = FIG1_ITERS // 10
    rows, final = {}, {}
    for label, method, options in FIG1_FIELD:
        iters = sweeps if method == "gauss_seidel" else FIG1_ITERS
        client = FlexaClient(solver=SolverConfig(max_iters=iters, tol=0))
        before = {k: w.launches for k, w in counters.items()}
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = client.run(SoloSpec(problem=p, method=method, options=options))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        V, T = r.history["V"], r.history["time"]
        diverged = not math.isfinite(V[-1])
        check(r.iters == iters or (method == "grock" and diverged),
              f"fig1 {label}: {r.iters} of {iters} iterations, V {V[-1]}")
        check(method == "grock" or not diverged, f"fig1 {label}: V {V[-1]}")
        row = {"method": method, "options": options, "iters": r.iters,
               "budget": iters, "wall_s": round(wall, 4),
               "ms_per_iter": wall / r.iters * 1e3,
               "rel_err_final": (V[-1] - p.v_star) / p.v_star,
               # the history clock's first stamp: set-up and one iteration
               "first_iter_s": T[0],
               # V after 1, 10, 100, 1000 iterations: what a run of the
               # reference at fig1d from the same seed would be held to
               "V_at": {k: V[k - 1] for k in (1, 10, 100, 1000)
                        if k <= len(V)},
               "launches": {k: w.launches - before[k]
                            for k, w in counters.items()
                            if w.launches > before[k]}}
        for thr in FIG1_THRESHOLDS:
            row[f"t_{thr:.0e}"], row[f"it_{thr:.0e}"] = time_to(
                V, T, p.v_star, thr)
        rows[label] = row
        final[label] = (r.x, V[-1])
        print(f"fig1 {label}: " + json.dumps(row), flush=True)
    launches = {k: w.launches for k, w in counters.items()}
    check(launches["gauss_seidel_sweep"] == rows["GS"]["launches"].get(
        "gauss_seidel_sweep") == sweeps, f"fig1: gauss_seidel_sweep launched "
          f"{launches['gauss_seidel_sweep']} times in {sweeps} sweeps")
    # V of GS's final x on the host, float64, against the reported V (the
    # sweep's incrementally kept residual, fp32)
    x_gs, v_gs = final["GS"]
    A64 = p.data["A"].cpu().numpy().astype(np.float64)
    x64 = np.asarray(x_gs, np.float64)
    res = A64 @ x64 - p.data["b"].cpu().numpy().astype(np.float64)
    del A64
    v_host = float(res @ res + p.g_weight * np.abs(x64).sum())
    gs_v_rel = abs(v_gs - v_host) / abs(v_host)
    check(gs_v_rel <= 1e-5, f"fig1 GS: reported V {v_gs} vs {v_host} "
          f"recomputed on the host (rel {gs_v_rel})")

    sweep = gs_sweep_check(torch, gs, p, dev)
    sweep["race_ms_per_sweep"] = rows["GS"]["ms_per_iter"]
    ranking = sorted(rows, key=lambda k: (not math.isfinite(
        rows[k]["rel_err_final"]), rows[k]["rel_err_final"]))
    say("fig1", instance="fig1d", v_star=p.v_star, iters=FIG1_ITERS,
        gs_sweeps=sweeps, launches=launches,
        ranking_by_final_rel_err=ranking,
        gs_V_host_float64_rel_err=gs_v_rel)
    return launches["gauss_seidel_sweep"], sweep


def gs_sweep_check(torch, gs, p, dev):
    """gauss_seidel_sweep against its plain version at the race's shape:
    one sweep from x = 0 (r = −b) on the fig1d instance through each, on
    the same inputs, timed with CUDA events.  Gates: V = rᵀr + c‖x‖₁ of
    each (float64, from its own x and r) and the sweeps' max |δ| within
    ``GS_SWEEP_RTOL`` relative; max |x − x_plain| within ``GS_SWEEP_XTOL``
    × max |x_plain|.  The readings are printed before the gates."""
    A, b = p.data["A"], p.data["b"]
    At = A.T.contiguous()
    colsq = torch.clamp_min((A * A).sum(0), 1e-12)
    runs, sweep = {}, {}
    for key, fn in (("ms", gs.gauss_seidel_sweep),
                    ("plain_ms", gs.gauss_seidel_sweep.plain)):
        x, r = torch.zeros(p.n, device=dev), -b
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        t0.record()
        delta = fn(At, colsq, x, r, p.g_weight)
        t1.record()
        torch.cuda.synchronize()
        sweep[key] = t0.elapsed_time(t1)
        r64, x64 = r.double(), x.double()
        runs[key] = (x, float(delta),
                     float(r64 @ r64 + p.g_weight * x64.abs().sum()))
    (xk, dk, vk), (xp, dp, vp) = runs["ms"], runs["plain_ms"]
    diff = (xk - xp).abs()
    x_scale = float(xp.abs().max())
    n, m = At.shape
    sweep.update({
        "shape": [n, m], "max_abs_dx": float(diff.max()),
        "max_abs_x": x_scale,
        "dx_rel_to_max_x": float(diff.max()) / x_scale,
        "coords_differ": int((diff > 0).sum()),
        "support": int((xp != 0).sum()),
        "support_differ": int(((xk != 0) != (xp != 0)).sum()),
        "V": vk, "V_plain": vp, "V_rel_err": abs(vk - vp) / abs(vp),
        "max_delta": dk, "max_delta_plain": dp,
        "max_delta_rel_err": abs(dk - dp) / abs(dp),
        # Aᵀ read once; x and colsq read, x written; r read and written
        "bound_ms": bytes_ms(4 * n * m + 12 * n + 8 * m),
        "ops_ms": 4 * n * m / FP32_OPS_PER_S * 1e3})
    del At, colsq, runs, xk, xp, diff
    torch.cuda.empty_cache()
    print("fig1 GS sweep vs plain: " + json.dumps(sweep), flush=True)
    check(sweep["V_rel_err"] <= GS_SWEEP_RTOL
          and sweep["max_delta_rel_err"] <= GS_SWEEP_RTOL,
          f"gauss_seidel_sweep vs its plain version at fig1d: V rel "
          f"{sweep['V_rel_err']}, max |δ| rel {sweep['max_delta_rel_err']}")
    check(sweep["max_abs_dx"] <= GS_SWEEP_XTOL * x_scale,
          f"gauss_seidel_sweep vs its plain version at fig1d: max |dx| "
          f"{sweep['max_abs_dx']} > {GS_SWEEP_XTOL} × max |x| {x_scale}")
    return sweep


def cbr_on_path_state(torch, fp, p, r, cfg):
    """``ops.compact_best_response`` once on the path's last point: its
    support's plan (``solvers.compaction.make_plan``), x, ∇F = 2Aᵀ(Ax − b)
    and the solver's dense d there, in the (n, 1) layout, its launch
    counter set to 0 just before and read just after; z bit for bit (e2
    within 1e-5 relative) the composition ``gather_blocks`` →
    ``flexa_best_response`` with pad rows' d set to 1; the call's device
    time (graph) beside its bound."""
    from repro_torch.core import flexa, surrogate
    from repro_torch.kernels import ops as kops
    from repro_torch.path.driver import _problem_at
    from repro_torch.solvers.compaction import make_plan

    lam = float(r.lambdas[-1])
    pk = _problem_at(p, lam)
    x = torch.as_tensor(r.x[-1], device=p.device)
    plan = make_plan(r.x[-1] != 0, 1)
    d = surrogate.curvature(pk, flexa._base_tau(pk, cfg), cfg.surrogate)
    cols = [t.reshape(-1, 1).contiguous() for t in (x, pk.grad_f(x), d)]
    cbr = fp.compact_best_response
    cbr.launches = 0
    z, e2 = kops.compact_best_response(*cols, lam, plan.block_idx)
    launches = cbr.launches
    check(launches == 1, f"compact_best_response launched {launches} times")
    idx = torch.as_tensor(plan.block_idx, device=p.device)
    dc = kops.gather_blocks(cols[2], idx)
    dc[idx < 0] = 1.0
    z0, e0 = kops.flexa_best_response(kops.gather_blocks(cols[0], idx),
                                      kops.gather_blocks(cols[1], idx),
                                      dc, lam)
    err = equal_or_fail(torch, "compact_best_response", z, z0,
                        "the fig1d path's last point")
    rel = abs(float(e2) - float(e0)) / max(float(e0), 1e-30)
    check(rel <= 1e-5, f"compact_best_response on the path state: e2 "
          f"{float(e2)} vs {float(e0)}")
    valid = int((idx >= 0).sum())
    K = plan.capacity
    with profiled(torch) as prof:
        cbr(*cols, lam, idx)
    names = [e.name() for e in prof.profiler.kineto_results.events()
             if e.device_type() == torch.autograd.DeviceType.CUDA]
    check(len(names) == 1 and "compact_br_cluster" in names[0],
          f"compact_best_response on the path state: device records "
          f"{names}, not the one-cluster kernel alone")
    return {"launches": launches, "max_abs_err": err, "e2_rel_err": rel,
            "lambda": lam, "support": valid, "K": K,
            "device_records": names,
            "ms": graph_ms(torch, lambda: cbr(*cols, lam, idx)),
            "eager_ms": cuda_ms(torch, lambda: cbr(*cols, lam, idx)),
            # eager: the plain version copies c to the card, which a
            # graph capture refuses
            "plain_ms": cuda_ms(torch, lambda: cbr.plain(*cols, lam, idx)),
            # idx read; x, g, d read and z written per valid row, z per pad
            "bound_ms": bytes_ms(4 * K + 16 * valid + 4 * (K - valid))}


def phase_path(torch, fp, p):
    """Slice 1's main path under ``torch.profiler``: the wrappers'
    counters give the launches, the profiler's kernel records the same
    count and each kernel's device time."""
    from repro_torch.client import FlexaClient, PathSpec
    from repro_torch.config.base import SolverConfig
    from repro_torch.obs import trace as obs
    from repro_torch.path.driver import _problem_at
    from repro_torch.path.screening import block_scores
    from repro_torch.problems.families import get_family

    gather, scatter = fp.gather_rows, fp.scatter_rows
    br = fp.batched_best_response
    cfg = SolverConfig(tol=1e-6, max_iters=20000)
    client = FlexaClient(solver=cfg)
    spec = PathSpec(problem=p, n_points=10, lam_min_ratio=0.1, compact=True)
    tracer = obs.Tracer()
    gather.launches = scatter.launches = br.launches = 0
    torch.cuda.synchronize()
    with profiled(torch) as prof:
        t = time.perf_counter()
        with obs.tracing(tracer):
            r = client.run(spec)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    launches = {"gather_rows": gather.launches,
                "scatter_rows": scatter.launches,
                "batched_best_response": br.launches}
    t = time.perf_counter()
    per_kernel, busy = device_kernels(torch, prof, {
        k: KERNEL_NAMES[k] for k in launches})
    read_s = time.perf_counter() - t
    del prof
    check(all(n > 0 for n in launches.values()),
          f"kernel not launched on the path: {launches}")
    check(all(per_kernel[k][0] == n for k, n in launches.items()),
          f"profiler launches {per_kernel} differ from the counters "
          f"{launches}")
    check(bool(r.converged.all()), f"path not converged: {r.converged}")
    # one S.2 per solver iteration: every solve (one per KKT round of each
    # point the path solved) runs its iterations and at most 15 more
    # before the stop-flag check that ends it
    solves = sum(rep.kkt_rounds + 1 for rep, it in zip(r.screened, r.iters)
                 if it > 0)
    check(r.row_iters <= launches["batched_best_response"]
          <= r.row_iters + 15 * solves,
          f"batched_best_response launched {launches['batched_best_response']}"
          f" times for {r.row_iters} iterations in {solves} solves")
    check(bool((r.x[0] == 0).all()) and r.support[-1] > 0, "path support")
    fam = get_family("lasso")
    kkt = 0.0
    for k, lam in enumerate(r.lambdas):
        pk = _problem_at(p, float(lam))
        s = block_scores(fam, pk, r.x[k])
        zero = r.x[k] == 0
        if zero.any():
            kkt = max(kkt, float((s[zero] - lam).max() / lam))
    check(kkt <= 1e-3, f"KKT violated on zero blocks: {kkt}")
    # host wall time of each solved point (the driver reads every point's
    # result back, so its span ends after the device work)
    point_s = [0.0] * len(r.lambdas)
    for sp in tracer.spans:
        if sp.name == "path.point":
            point_s[sp.args["k"]] = round(sp.t1 - sp.t0, 3)
    kernel_ms = sum(v[1] for v in per_kernel.values())
    cbr = cbr_on_path_state(torch, fp, p, r, cfg)
    say("path", instance="fig1d", wall_s=round(wall, 3),
        point_wall_s=point_s,
        iters=[int(i) for i in r.iters],
        support=[int(s) for s in r.support],
        active_blocks=[int(a) for a in r.active_blocks],
        program_widths=r.meta["program_widths"],
        device_flops=r.device_flops,
        # every iteration reads its (m × width) matrix twice, fp32
        gemv_bound_s=round(bytes_ms(8 * r.device_flops) / 1e3, 3),
        launches=launches, solves=solves, row_iters=r.row_iters,
        # per kernel, from the profiler: [launches, device ms]
        profiler_kernels={k: [n, round(ms, 4)]
                          for k, (n, ms) in per_kernel.items()},
        kernel_device_ms=round(kernel_ms, 4),
        kernel_share=kernel_ms / (wall * 1e3),
        device_records=busy[0], device_busy_s=round(busy[1] / 1e3, 3),
        device_busy_share=busy[1] / (wall * 1e3),
        profile_read_s=round(read_s, 2),
        max_zero_block_kkt=kkt, compact_best_response_on_last_point=cbr)
    return r, launches, cbr


def phase_compact_vs_dense(torch, dev):
    from repro_torch.client import FlexaClient, PathSpec
    from repro_torch.config.base import SolverConfig
    from repro_torch.problems.lasso import nesterov_instance

    p = nesterov_instance(**FIG1B, device=dev)
    client = FlexaClient(solver=SolverConfig(tol=1e-7, max_iters=20000,
                                             tau_adapt=False))
    runs, secs = {}, {}
    for compact in (True, False):
        t = time.perf_counter()
        runs[compact] = client.run(PathSpec(problem=p, n_points=10,
                                            lam_min_ratio=0.05,
                                            compact=compact))
        torch.cuda.synchronize()
        secs[compact] = round(time.perf_counter() - t, 3)
    c, d = runs[True], runs[False]
    dx = float(abs(c.x - d.x).max())
    one_only = (c.x != 0) != (d.x != 0)
    worst = float(max(abs(c.x[one_only]).max(initial=0.0),
                      abs(d.x[one_only]).max(initial=0.0)))
    check(dx <= 1e-5, f"compact vs dense: max |dx| {dx}")
    check(worst <= 1e-5, f"block nonzero in one path only: |x| {worst}")
    check(c.device_flops < d.device_flops, "compaction saved no FLOPs")
    say("compact", instance="fig1b", max_abs_dx=dx,
        iters_compact=[int(i) for i in c.iters],
        iters_dense=[int(i) for i in d.iters],
        converged_compact=[bool(v) for v in c.converged],
        converged_dense=[bool(v) for v in d.converged],
        blocks_in_one_path_only=int(one_only.sum()),
        max_abs_x_in_one_path_only=worst,
        supports_equal=bool((c.support == d.support).all()),
        flops_ratio=d.device_flops / c.device_flops,
        compact_s=secs[True], dense_s=secs[False])


def phase_batch(torch, fp, dev):
    """``benchmarks/fig1.py:run_batched`` at fig1d's size: B fig1d
    instances through ``BatchSpec``, greedy then Jacobi, against a
    ``SoloSpec`` of seed 0 under the same settings.

    τ is fixed (``tau_adapt=False``, as run_batched runs, so batched and
    solo take the same steps) at τ⁰ = max L_F / 2 over the instances: at
    the default τ⁰ = tr(AᵀA)/2n with τ fixed both rules diverge on these
    instances (V over 1e27, Jacobi to NaN, in 300 iterations at a tenth
    of fig1d's size on the CPU)."""
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.client import BatchSpec, FlexaClient, SoloSpec
    from repro_torch.config.base import SolverConfig
    from repro_torch.problems.lasso import nesterov_instance

    B, iters = BATCH["B"], BATCH["iters"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    with ThreadPoolExecutor(BATCH["gen_threads"]) as ex:
        probs = list(ex.map(lambda s: nesterov_instance(
            **{**FIG1D, "seed": s}, device=dev), range(B)))
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t
    print(f"batch: {B} instances generated in {gen_s:.2f} s", flush=True)
    tau0 = max(p.lipschitz for p in probs) / 2
    v0 = [float(p.v(torch.zeros(p.n, device=dev))) for p in probs]
    br, ap = fp.batched_best_response, fp.batched_apply_update
    m, n = FIG1D["m"], FIG1D["n"]
    out = {}
    for rule in ("greedy", "jacobi"):
        cfg = SolverConfig(max_iters=iters, tol=-1.0, tau_adapt=False,
                           tau0=tau0, jacobi=rule == "jacobi")
        client = FlexaClient(solver=cfg)
        spec = BatchSpec(problems=probs)
        br.launches = ap.launches = 0
        with (profiled(torch) if rule == "jacobi"
              else contextlib.nullcontext()) as prof:
            torch.cuda.synchronize()
            t = time.perf_counter()
            rb = client.run(spec)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        if rule == "jacobi":
            per_kernel, busy = device_kernels(torch, prof, {
                k: KERNEL_NAMES[k] for k in ("batched_best_response",
                                             "batched_apply_update")})
            del prof
        launches = {"batched_best_response": br.launches,
                    "batched_apply_update": ap.launches}
        want = {"batched_best_response": iters,
                "batched_apply_update": iters if rule == "jacobi" else 0}
        check(launches == want, f"batch {rule}: launches {launches}, want "
              f"{want}")
        if rule == "jacobi":
            check(all(per_kernel[k][0] == want[k] for k in want),
                  f"batch {rule}: profiler launches {per_kernel}, counters "
                  f"{launches}")
        check(rb.x.shape == (B, n) and bool((rb.iters == iters).all()),
              f"batch {rule}: x {rb.x.shape}, iters {rb.iters}")
        V = [float(p.v(torch.as_tensor(rb.x[i], device=dev)))
             for i, p in enumerate(probs)]
        solo = client.run(SoloSpec(problem=probs[0], method="flexa"))
        v_solo = float(probs[0].v(torch.as_tensor(solo.x, device=dev)))
        dx = float(abs(solo.x - rb.x[0]).max())
        out[rule] = {"wall_s": round(wall, 3),
                     "ms_per_iter": wall / iters * 1e3,
                     "launches": launches, "V": V, "V0": v0,
                     "V_rel_err": [(v - p.v_star) / p.v_star
                                   for v, p in zip(V, probs)],
                     "row0_vs_solo_max_dx": dx, "V_solo": v_solo,
                     "row0_vs_solo_V_rel": abs(V[0] - v_solo) / v_solo}
        if rule == "jacobi":
            out[rule]["profiler_kernels"] = {
                k: [c, round(ms, 4)] for k, (c, ms) in per_kernel.items()}
            out[rule]["device_busy_share"] = busy[1] / (wall * 1e3)
        print(f"batch {rule}: " + json.dumps(out[rule]), flush=True)
    for rule, o in out.items():
        check(all(math.isfinite(v) and v < v_0 for v, v_0 in zip(o["V"],
                                                                   v0)),
              f"batch {rule}: V {o['V']}, V at x = 0 {v0}")
    # Jacobi's iteration has no branch, so row 0 follows the solo
    # trajectory up to fp32 summation order.  The greedy ρ-rule compares
    # E against ρ·max E, and the batched and the solo products sum in
    # another order, so a coordinate whose E lies within rounding of the
    # threshold is selected in one run and not in the other, and the
    # trajectories part (max |dx| 0.0102 after 300 iterations on the
    # H100); there row 0 must reach the solo run's V within 1e-3.
    check(out["jacobi"]["row0_vs_solo_max_dx"] <= 1e-4, f"batch jacobi: row "
          f"0 vs SoloSpec max |dx| {out['jacobi']['row0_vs_solo_max_dx']}")
    check(out["greedy"]["row0_vs_solo_V_rel"] <= 1e-3, f"batch greedy: row "
          f"0 vs SoloSpec V rel {out['greedy']['row0_vs_solo_V_rel']}")
    del probs, rb, solo
    peak = torch.cuda.max_memory_allocated()
    torch.cuda.empty_cache()
    say("batch", instances=B, instance=f"fig1d seeds 0..{B - 1}",
        gen_s=round(gen_s, 2), gen_threads=BATCH["gen_threads"],
        iters=iters, tau0=tau0, peak_memory_gib=round(peak / 2 ** 30, 3),
        # each iteration reads the (B, m, n) stack twice for ∇F (and once
        # more for V)
        two_gemv_bound_ms=bytes_ms(2 * B * m * n * 4),
        three_gemv_bound_ms=bytes_ms(3 * B * m * n * 4), **out)
    return out["jacobi"]["launches"]["batched_apply_update"]


def make_cv_folds(m_total, n, s, K, seed, noise=0.5):
    """Planted sparse regression split into K row-folds: a copy of
    ``benchmarks/path_bench.py:make_cv_folds`` (that module imports the
    JAX package)."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m_total, n)).astype(np.float32)
    x_true = np.zeros(n, np.float32)
    sup = rng.choice(n, size=s, replace=False)
    x_true[sup] = rng.uniform(0.5, 1.5, s) * rng.choice([-1, 1], s)
    b = A @ x_true + noise * rng.standard_normal(m_total).astype(
        np.float32)
    idx = rng.permutation(m_total)[:K * (m_total // K)]
    out = []
    for f in np.array_split(idx, K):
        val = np.zeros(m_total, bool)
        val[f] = True
        out.append((A[~val], b[~val], A[val], b[val]))
    return out, x_true


def phase_cv(torch, fp, dev):
    """K-fold CV through ``CVSpec``, as ``benchmarks/path_bench.py:run_cv``
    builds it, at fig1b's width; fold 0 against a ``PathSpec`` of fold 0
    on the same grid, the selection recomputed on the host."""
    from repro_torch.client import CVSpec, FlexaClient, PathSpec
    from repro_torch.config.base import SolverConfig
    from repro_torch.problems.lasso import make_lasso

    t = time.perf_counter()
    folds, _ = make_cv_folds(CV["m_total"], CV["n"], CV["support"],
                             CV["K"], CV["seed"])
    probs = [make_lasso(A, b, c=1.0, name=f"cv_fold{i}", device=dev)
             for i, (A, b, _, _) in enumerate(folds)]
    validation = [(Av, bv) for (_, _, Av, bv) in folds]
    gen_s = time.perf_counter() - t
    client = FlexaClient(solver=SolverConfig(tol=CV["tol"], max_iters=20000,
                                             tau_adapt=False))
    br = fp.batched_best_response
    br.launches = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    cv = client.run(CVSpec(problems=probs, validation=validation,
                           n_points=CV["P"], lam_min_ratio=CV["ratio"]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = br.launches
    check(all(bool(f.converged.all()) for f in cv.folds),
          f"cv: not converged {[f.converged.tolist() for f in cv.folds]}")
    sweep_rows = cv.folds[0].meta["sweep_row_iters"]
    check(launches > 0, "cv: batched_best_response not launched")
    t = time.perf_counter()
    p0 = client.run(PathSpec(problem=probs[0], lambdas=cv.lambdas))
    torch.cuda.synchronize()
    path_s = time.perf_counter() - t
    dx = float(abs(p0.x - cv.folds[0].x).max())
    check(dx <= 1e-4, f"cv: fold 0 vs PathSpec max |dx| {dx}")
    mse = np.array([[float(np.mean((Av.astype(np.float64)
                                    @ f.x[k].astype(np.float64) - bv) ** 2))
                     for k in range(CV["P"])]
                    for f, (Av, bv) in zip(cv.folds, validation)])
    best = int(np.argmin(mse.mean(axis=0)))
    check(best == cv.best_index, f"cv: selected λ index {cv.best_index}, "
          f"recomputed on the host {best}")
    say("cv", folds=CV["K"], m_total=CV["m_total"], n=CV["n"],
        support=CV["support"], points=CV["P"], gen_s=round(gen_s, 2),
        wall_s=round(wall, 3), fold0_path_s=round(path_s, 3),
        sweep_row_iters=sweep_rows, batched_best_response_launches=launches,
        iters=[f.iters.tolist() for f in cv.folds],
        supports=[f.support.tolist() for f in cv.folds],
        best_index=cv.best_index, best_lambda=cv.best_lambda,
        val_mse_mean=[round(float(v), 5) for v in cv.scores_mean],
        fold0_vs_path_max_dx=dx)
    del probs, folds, cv, p0
    torch.cuda.empty_cache()


def prefill_launches(cfg):
    """Launches of each kernel in one prefill of ``cfg``: ``ssd_scan`` once
    per Mamba2 layer, ``flash_attention`` once per attention (the hybrid's
    shared block once per group of ``attn_every`` layers)."""
    if cfg.family == "ssm":
        return {"ssd_scan": cfg.num_layers}
    if cfg.family == "hybrid":
        return {"ssd_scan": cfg.num_layers,
                "flash_attention": cfg.num_layers // cfg.attn_every}
    return {"flash_attention": cfg.num_layers}


def serve_run(torch, spec, wrappers, dev, profile="full"):
    """One LM's main serving path: ``ServeEngine.generate`` of ``spec``'s
    arch at full width (its batch, prompt length and new tokens; depth
    cut to ``spec["layers"]`` where given) with random weights from a
    seeded generator, greedy.  ``wrappers`` maps kernel names (those of
    ``KERNEL_NAMES``) to wrappers; each kernel of ``prefill_launches(cfg)``
    must launch that many times a prefill.  With ``profile``
    (``"full"`` or ``"prefill"``), the prefill alone runs under
    ``torch.profiler`` first, and each kernel's profiler launches must
    equal its counter's and that count; the device time of each of its
    device kernels is printed; ``"full"`` adds the prefill with 8 decode
    steps under the profiler.  Then the main run, the counters set to 0
    just before and read just after, and the first 4 tokens against full
    ``forward``s teacher-forced on the engine's tokens: the gaps to the
    max logit printed in the activation dtype and, with the same weights
    in fp32, each within 1e-4.  For ``moe`` the main run prints the share
    of (token, choice) pairs dropped at the config's capacity factor, and
    the fp32 check routes at capacity factor E / k, where nothing drops
    (a drop depends on the count of tokens routed together, so a
    teacher-forced forward drops other pairs than the engine's prefill).
    Returns the phase's fields."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import moe as MOE
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import ServeEngine

    full = get_config(spec["arch"])
    cfg = full.replace(num_layers=spec.get("layers", full.num_layers))
    arch, nb, lp, new = cfg.name, spec["batch"], spec["prompt"], spec["new"]
    want = prefill_launches(cfg)
    kernels = {k: wrappers[k] for k in want}
    t = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(spec["seed"])
    model = T.init_params(cfg, generator=gen, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    eng = ServeEngine(cfg, model, max_len=lp + new, device=dev)
    prompts = np.random.default_rng(spec["seed"]).integers(
        0, cfg.vocab_size, (nb, lp)).astype(np.int32)
    # warm-up: cuBLAS handles, the weight casts, the kernels' first launch
    eng.generate(prompts[:, :512], max_new_tokens=2)
    out = {"arch": arch, "layers": cfg.num_layers,
           "layers_of": full.num_layers, "batch": nb, "prompt": lp,
           "new_tokens": new, "dtype": cfg.dtype,
           "init_s": round(init_s, 3)}

    def zero():
        for wrapper in kernels.values():
            wrapper.launches = 0

    if profile:
        # the prefill alone (generate of one token), under the profiler
        zero()
        torch.cuda.synchronize()
        with profiled(torch) as prof:
            t = time.perf_counter()
            eng.generate(prompts, max_new_tokens=1)
            torch.cuda.synchronize()
            prof_prefill_s = time.perf_counter() - t
        prof_launches = {k: w.launches for k, w in kernels.items()}
        per_kernel, busy = device_kernels(torch, prof, {
            k: KERNEL_NAMES[k] for k in kernels})
        # each of the wrappers' device kernels: [records, summed ms]
        by_kernel, _ = device_kernels(torch, prof, {
            sub: (sub,) for k in kernels for sub in KERNEL_NAMES[k]})
        edges, _ = window_edges(torch, prof)
        del prof
        for kname, n in want.items():
            check(per_kernel[kname][0] == n == prof_launches[kname],
                  f"{kname} launches in the {arch} prefill: profiler "
                  f"{per_kernel[kname][0]}, counter {prof_launches[kname]}, "
                  f"want {n} (records by kernel {by_kernel}; the records' "
                  f"edges inside the window, ms: {edges})")
            kernel_ms = per_kernel[kname][1]
            out.update({
                f"{kname}_profiler_launches": per_kernel[kname][0],
                f"{kname}_device_ms": round(kernel_ms, 3),
                f"{kname}_device_ms_by_kernel": {
                    sub: [by_kernel[sub][0], round(by_kernel[sub][1], 3)]
                    for sub in KERNEL_NAMES[kname]},
                f"{kname}_share_of_prefill":
                    kernel_ms / (prof_prefill_s * 1e3)})
        out.update({
            "profiled_prefill_ms": round(prof_prefill_s * 1e3, 3),
            "prefill_device_busy_ms": round(busy[1], 3),
            "prefill_device_busy_share": busy[1] / (prof_prefill_s * 1e3)})
    if profile == "full":
        # prefill + 8 decode steps under the profiler: device busy in decode
        with profiled(torch) as prof:
            t = time.perf_counter()
            eng.generate(prompts, max_new_tokens=9)
            torch.cuda.synchronize()
            prof_decode_s = time.perf_counter() - t - prof_prefill_s
        _, busy9 = device_kernels(torch, prof, {})
        del prof
        out.update({
            # (device busy ms, wall ms) of 8 profiled decode steps, minus
            # the profiled prefill's
            "decode_device_busy_share":
                (busy9[1] - busy[1]) / (prof_decode_s * 1e3),
            "profiled_decode_ms_per_token": round(prof_decode_s * 1e3 / 8,
                                                  3)})
    # the prefill alone, host clock
    torch.cuda.synchronize()
    t = time.perf_counter()
    eng.generate(prompts, max_new_tokens=1)
    prefill_s = time.perf_counter() - t

    # the main run
    moes = [blk.moe for blk in model.layers] if cfg.family == "moe" else []
    for moe in moes:
        moe.drop_log = []
    torch.cuda.reset_peak_memory_stats()
    zero()
    torch.cuda.synchronize()
    t = time.perf_counter()
    res = eng.generate(prompts, max_new_tokens=new)
    wall = time.perf_counter() - t
    launches = {k: w.launches for k, w in kernels.items()}
    peak = torch.cuda.max_memory_allocated()
    check(launches == want, f"launches on the {arch} serve path: "
          f"{launches}, want {want}")
    check(res.tokens.shape == (nb, new) and bool(
        ((res.tokens >= 0) & (res.tokens < cfg.vocab_size)).all()),
        f"generated tokens {res.tokens.shape}")
    check(bool(np.isfinite(res.prefill_logits).all()),
          "non-finite prefill logits")
    if moes:
        check(all(len(m.drop_log) == new for m in moes),
              f"MoE calls per layer {[len(m.drop_log) for m in moes]}, "
              f"want {new}")
        # each layer's first call is the prefill's, the others decode's
        pre = [m.drop_log[0] for m in moes]
        dec = [c for m in moes for c in m.drop_log[1:]]
        share = [sum(int(d) for d, _ in calls) / sum(n for _, n in calls)
                 for calls in (pre, dec)]
        for moe in moes:
            moe.drop_log = None
        out.update({"capacity_factor": cfg.capacity_factor,
                    "capacity_prefill": MOE.capacity(nb * lp, cfg),
                    "dropped_share_prefill": share[0],
                    "dropped_share_decode": share[1]})

    # the first tokens against full forwards, teacher-forced: reported
    # in bf16, checked in fp32 (same weights, fp32 activations)
    gaps = {"bfloat16": greedy_gaps(torch, T, cfg, model, prompts,
                                    res.tokens, dev)}
    cfg32 = cfg.replace(dtype="float32")
    if cfg.family == "moe":
        cfg32 = cfg32.replace(
            capacity_factor=cfg.num_experts / cfg.moe_top_k)
        out["fp32_check_capacity_factor"] = cfg32.capacity_factor
    eng32 = ServeEngine(cfg32, model, max_len=lp + new, device=dev)
    zero()
    res32 = eng32.generate(prompts, max_new_tokens=4)
    launches32 = {k: w.launches for k, w in kernels.items()}
    check(launches32 == want, f"the fp32 prefill launched {launches32}")
    gaps["float32"] = greedy_gaps(torch, T, cfg32, model, prompts,
                                  res32.tokens, dev)
    check(max(gaps["float32"]) <= 1e-4, f"{arch} fp32: an engine token is "
          f"{max(gaps['float32'])} below the forward's max logit")
    torch.cuda.synchronize()
    decode_ms = (wall - prefill_s) / (new - 1) * 1e3
    out.update({
        "wall_s": round(wall, 4), "prefill_ms": round(prefill_s * 1e3, 3),
        "decode_ms_per_token": round(decode_ms, 4),
        "tokens_per_s": round(nb * new / wall, 3),
        "decode_tokens_per_s": round(nb / decode_ms * 1e3, 3),
        "prefill_tokens_per_s": round(nb * lp / prefill_s, 1),
        "peak_memory_gib": round(peak / 2 ** 30, 3),
        "launches": launches,
        # per step, the largest (max logit − engine token's logit) of a
        # full forward teacher-forced on the engine's tokens
        "max_logit_gap_first_4": gaps,
        "first_tokens": res.tokens[0, :8].tolist()})
    del model, eng, eng32
    torch.cuda.empty_cache()
    return out


def phase_serve(torch, ssd, dev):
    """Slice 2's main path: full-width mamba2-1.3b through
    ``ServeEngine.generate`` (batch 4 × prompt 4096, 32 new tokens,
    greedy)."""
    out = serve_run(torch, SERVE, {"ssd_scan": ssd.ssd_scan}, dev)
    say("serve", **out)
    return out["launches"]["ssd_scan"]


def phase_serve_dense(torch, fa, dev):
    """Slice 4's main path: full-width stablelm-3b through
    ``ServeEngine.generate`` (batch 4 × prompt 4096, 32 new tokens,
    greedy), ``flash_attention`` once per layer in the prefill; then
    yi-6b (GQA) at full width, batch 2 × 2048, 8 new tokens."""
    out = serve_run(torch, SERVE_DENSE, {"flash_attention":
                                         fa.flash_attention}, dev)
    launches = out["launches"]["flash_attention"]
    say("serve_dense", **out)
    out = serve_run(torch, SERVE_GQA, {"flash_attention":
                                       fa.flash_attention}, dev,
                    profile=None)
    say("serve_dense", **out)
    return launches


def phase_serve_families(torch, ssd, fa, dev):
    """This slice's main path and its witnesses: ``serve_run`` of each
    ``SERVE_FAMILIES`` run, one line each with its seconds, the model
    deleted and the cache emptied between runs (``serve_run`` does both).  zamba2-1.2b (the main
    path, profiled in full) launches ``ssd_scan`` 38 and
    ``flash_attention`` 6 times a prefill; the others ``flash_attention``
    once per layer run.  Returns {run: launches}."""
    wrappers = {"ssd_scan": ssd.ssd_scan, "flash_attention":
                fa.flash_attention}
    launches = {}
    for spec in SERVE_FAMILIES:
        t = time.perf_counter()
        out = serve_run(torch, spec, wrappers, dev, profile=spec["profile"])
        out["run_s"] = round(time.perf_counter() - t, 2)
        say("serve_families", **out)
        launches[spec["arch"]] = out["launches"]
    return launches


def step1_check(torch, fp, kops, T, loop, cfg):
    """Step 1's best responses through ``br_compare`` (kernel against plain
    version, and a second launch bitwise): the gradients of the first batch
    at the initial weights, every tensor of every leaf with the optimizer's
    τᵢ and c; and each tensor's update x + γ·(z − x) (the mask's 1), the
    kernel's bitwise equal to the plain version's.  Returns (tensors
    checked, max e2 rel err over tensors, max e2 rel err over leaves)."""
    from repro_torch.core.optimizer import _l1_mask

    model, opt, _ = loop.init_state()
    loss, _ = T.loss_fn(cfg, model, loop.batch(0), remat=loop.tcfg.remat)
    loss.backward()
    loss = loss.detach()
    check(math.isfinite(float(loss)), f"step-1 loss {float(loss)}")
    n, rel_t, rel_leaf = 0, 0.0, 0.0
    with torch.no_grad():
        for i, leaf in enumerate(T.param_leaves(cfg, model)):
            c = loop.tcfg.flexa_l1 if (loop.tcfg.flexa_l1 > 0
                                       and _l1_mask(leaf.path)) else 0.0
            e_k = e_p = 0.0
            for j, x in enumerate(leaf.tensors):
                what = f"step 1, {'/'.join(leaf.path)}[{j}]"
                _, r, e2, e0 = br_compare(
                    torch, fp, (x, x.grad, opt.tau[i]), c, what,
                    kernel=kops.flexa_best_response)
                e_k, e_p, n, rel_t = e_k + e2, e_p + e0, n + 1, max(rel_t, r)
                args = (x, x.grad, opt.tau[i], c, opt.gamma)
                equal_or_fail(torch, "apply_update", kops.flexa_apply(*args),
                              fp.apply_update.plain(*args), what)
            rel_leaf = max(rel_leaf, abs(e_k - e_p) / max(e_p, 1e-30))
    del model, opt, loss
    torch.cuda.empty_cache()
    return n, rel_t, rel_leaf


def phase_train(torch, fp, dev):
    """Slice 3's main path: full-width stablelm-3b through
    ``TrainLoop.run`` (FLEXA defaults, bf16 activations, batch 2 × 4096,
    6 steps), then one more step under the profiler."""
    from repro_torch.config.base import TrainConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops as kops
    from repro_torch.models import transformer as T
    from repro_torch.train.loop import TrainLoop

    cfg = get_config(TRAIN["arch"])
    nb, seq, steps = TRAIN["batch"], TRAIN["seq"], TRAIN["steps"]
    tcfg = TrainConfig(steps=steps, log_every=1)
    loop = TrainLoop(cfg, tcfg, batch=nb, seq_len=seq, device=dev)
    t = time.perf_counter()
    n_checked, rel_t, rel_leaf = step1_check(torch, fp, kops, T, loop, cfg)
    check_s = time.perf_counter() - t
    per_step = cfg.num_layers * 9 + 3
    check(n_checked == per_step, f"step-1 check saw {n_checked} tensors")

    # the main path: counters to 0 just before, read just after
    torch.cuda.reset_peak_memory_stats()
    for k in (fp.best_response, fp.apply_update, fp.gather_rows,
              fp.scatter_rows, fp.batched_best_response,
              fp.batched_apply_update):
        k.launches = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    model, opt = loop.run()
    wall = time.perf_counter() - t
    launches = fp.best_response.launches
    apply_launches = fp.apply_update.launches
    peak = torch.cuda.max_memory_allocated()
    losses = [m["loss"] for m in loop.metrics_log]
    step_s = [m["time"] for m in loop.metrics_log]
    check(len(losses) == steps and all(math.isfinite(v) for v in losses),
          f"losses {losses}")
    check(launches == apply_launches == steps * per_step,
          f"best_response launched {launches} times, apply_update "
          f"{apply_launches}, in {steps} steps, want {steps * per_step}")

    # one more step under the profiler: launches and device time
    torch.cuda.synchronize()
    with profiled(torch) as prof:
        t = time.perf_counter()
        _, opt, _, m = loop.step_fn(model, opt, None, loop.batch(steps))
        check(math.isfinite(float(m["loss"])), "profiled step: loss")
        torch.cuda.synchronize()
        prof_s = time.perf_counter() - t
    prof_launches = fp.best_response.launches - launches
    prof_apply = fp.apply_update.launches - apply_launches
    per_kernel, busy = device_kernels(torch, prof, {
        k: KERNEL_NAMES[k] for k in ("best_response", "apply_update")})
    top = top_kernels(torch, prof)
    edges, records = window_edges(torch, prof)
    del prof
    # one more step split by hand: forward, backward, optimizer
    split = {}
    leaves = T.param_leaves(cfg, model)
    torch.cuda.synchronize()
    t = time.perf_counter()
    loss, _ = T.loss_fn(cfg, model, loop.batch(steps + 1), remat=True)
    torch.cuda.synchronize()
    split["forward_ms"] = (time.perf_counter() - t) * 1e3
    t = time.perf_counter()
    loss.backward()
    torch.cuda.synchronize()
    split["backward_ms"] = (time.perf_counter() - t) * 1e3
    grads = [[x.grad for x in leaf.tensors] for leaf in leaves]
    model.zero_grad(set_to_none=True)
    t = time.perf_counter()
    _, opt, _ = loop.opt_update(grads, opt, leaves, loss.detach())
    torch.cuda.synchronize()
    split["optimizer_ms"] = (time.perf_counter() - t) * 1e3
    del grads, loss
    check(per_kernel["best_response"][0] == prof_launches == per_step
          and per_kernel["apply_update"][0] == prof_apply == per_step,
          f"launches in the profiled step: best_response profiler "
          f"{per_kernel['best_response'][0]}, counter {prof_launches}; "
          f"apply_update profiler {per_kernel['apply_update'][0]}, counter "
          f"{prof_apply}; want {per_step} ({records} device records; "
          f"first and last {edges} ms inside the step)")
    steady = step_s[1:]
    say("train", arch=cfg.name, layers=cfg.num_layers, batch=nb, seq=seq,
        dtype=cfg.dtype, optimizer=tcfg.optimizer, steps=steps,
        params=sum(p.numel() for p in model.parameters()),
        losses=losses, step_ms=[round(v * 1e3, 3) for v in step_s],
        wall_s=round(wall, 3),
        tokens_per_s=round(nb * seq * len(steady) / sum(steady), 1),
        peak_memory_gib=round(peak / 2 ** 30, 3),
        launches={"best_response": launches,
                  "apply_update": apply_launches,
                  "gather_rows": fp.gather_rows.launches,
                  "scatter_rows": fp.scatter_rows.launches,
                  "batched_best_response": fp.batched_best_response.launches,
                  "batched_apply_update": fp.batched_apply_update.launches},
        launches_per_step=per_step,
        profiled_step_ms=round(prof_s * 1e3, 3),
        best_response_device_ms_per_step=round(
            per_kernel["best_response"][1], 4),
        best_response_profiler_launches=per_kernel["best_response"][0],
        apply_update_device_ms_per_step=round(
            per_kernel["apply_update"][1], 4),
        apply_update_profiler_launches=per_kernel["apply_update"][0],
        device_busy_ms=round(busy[1], 3),
        device_busy_share=busy[1] / (prof_s * 1e3),
        profiled_step_device_records=records,
        profiled_step_edges_ms=edges,
        top_device_kernels=top,
        split_step_ms={k: round(v, 3) for k, v in split.items()},
        sel_frac=float(m["flexa/sel_frac"]),
        tau_mean=float(m["flexa/tau_mean"]),
        step1_tensors_checked=n_checked, step1_e2_max_rel_err=rel_t,
        step1_leaf_e2_max_rel_err=rel_leaf, step1_check_s=round(check_s, 2))
    del model, opt, loop
    torch.cuda.empty_cache()
    return launches, apply_launches


def phase_descent(torch, dev):
    """The reference's descent check at reduced size, on the card."""
    from repro_torch.config.base import TrainConfig
    from repro_torch.configs.registry import get_reduced
    from repro_torch.train.loop import TrainLoop

    loop = TrainLoop(get_reduced(DESCENT["arch"]),
                     TrainConfig(steps=DESCENT["steps"], log_every=1000),
                     batch=DESCENT["batch"], seq_len=DESCENT["seq"],
                     device=dev)
    loop.run()
    losses = [m["loss"] for m in loop.metrics_log]
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    check(all(math.isfinite(v) for v in losses) and last < first,
          f"reduced stablelm-3b did not descend: {losses}")
    say("descent", arch=DESCENT["arch"] + " (reduced)", steps=len(losses),
        mean_first_5=first, mean_last_5=last,
        losses=[round(v, 4) for v in losses])


def greedy_gaps(torch, T, cfg, model, prompts, tokens, dev):
    """For each of the first 4 engine tokens, the largest gap (over the
    batch) between a full forward's max logit and the token's logit, the
    forward teacher-forced on the engine's earlier tokens."""
    seq, gaps = prompts, []
    for step in range(4):
        lg, _ = T.forward(cfg, model, {"tokens": seq})
        check(bool(torch.isfinite(lg).all()),
              f"{cfg.dtype} forward {step}: non-finite logits")
        last = lg[:, -1, :]
        tok = torch.as_tensor(tokens[:, step], device=dev).long()
        gap = last.max(dim=-1).values - last.gather(1, tok[:, None])[:, 0]
        gaps.append(float(gap.max()))
        seq = np.concatenate([seq, tokens[:, step: step + 1]], axis=1)
        del lg, last
    return gaps


def ssd_work(shape, itemsize):
    """(G FLOPs, the other products' FLOPs, bytes) an ssd_scan call needs
    at ``shape``: G = C·Bᵀ once per (batch row, chunk) over the lower
    triangle; then per head W·X over the triangle, C·h and the state
    update (the products with an fp32 factor); each input read once (x,
    B, C in the activation dtype, dt fp32), y and h written once."""
    Bt, S, H, P, N, L = shape
    g_fma = rest_fma = 0
    for c0 in range(0, S, L):
        lc = min(L, S - c0)
        tri = lc * (lc + 1) // 2
        g_fma += Bt * tri * N
        rest_fma += Bt * H * (tri * P + 2 * lc * N * P)
    nbytes = (2 * Bt * S * H * P * itemsize + 2 * Bt * S * N * itemsize
              + Bt * S * H * 4 + H * 4 + Bt * H * N * P * 4)
    return 2 * g_fma, 2 * rest_fma, nbytes


def br_row(torch, fp, launches, err, dev):
    """best_response at the train path's shapes: stablelm-3b's lm_head
    (50304, 2560) and its largest layer tensor, mlp.w1 (2560, 6912), fp32
    x and g with a 0-d τ and c = 0 as the default optimizer calls it;
    and the 291 calls of one step (every parameter tensor of the model,
    shapes only).  Times from CUDA events around back-to-back eager
    calls; bound: 12 bytes per element (x, g read, z written) over HBM."""
    timed = {}
    for key, shape in (("lm_head", (50304, 2560)), ("mlp.w1", (2560, 6912))):
        x, g, d = br_inputs(torch, shape, torch.float32, False, 31, dev)
        timed[key] = {
            "ms": cuda_ms(torch, lambda: fp.best_response(x, g, d, 0.0)),
            "plain_ms": cuda_ms(torch, lambda: fp.best_response.plain(
                x, g, d, 0.0), reps=5),
            "bound_ms": bytes_ms(12 * x.numel())}
        del x, g, d
    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer as T
    cfg = get_config(TRAIN["arch"])
    shapes = [tuple(p.shape) for p in
              T.DenseLM(cfg, device="meta").parameters()]
    n = sum(math.prod(sh) for sh in shapes)
    gen = torch.Generator(device=dev).manual_seed(32)
    pool_x = torch.randn(n, generator=gen, device=dev)
    pool_g = 0.01 * torch.randn(n, generator=gen, device=dev)
    d = torch.tensor(1.0, device=dev)
    views, o = [], 0
    for sh in shapes:
        k = math.prod(sh)
        views.append((pool_x[o:o + k].view(sh), pool_g[o:o + k].view(sh)))
        o += k

    def step(fn):
        for x, g in views:
            fn(x, g, d, 0.0)
    timed["step"] = {
        "tensors": len(shapes), "elements": n,
        "ms": cuda_ms(torch, lambda: step(fp.best_response), reps=5),
        "plain_ms": cuda_ms(torch, lambda: step(fp.best_response.plain),
                            reps=2),
        "bound_ms": bytes_ms(12 * n)}
    del pool_x, pool_g, views
    torch.cuda.empty_cache()
    t = timed["lm_head"]
    return {"name": "best_response", "route": "cuda",
            "source": SOURCES["best_response"],
            "replaces": REPLACES["best_response"],
            "launches": launches, "max_abs_err": err,
            "ms": round(t["ms"], 5), "plain_ms": round(t["plain_ms"], 5),
            "bound_ms": round(t["bound_ms"], 5), "bound_by": "bytes",
            # no single PyTorch call computes z and e2 together
            "library_ms": None,
            "shape": "x, g (50304, 2560) fp32, 0-d d, c = 0 (lm_head)",
            "timed": {k: {kk: (round(vv, 5) if isinstance(vv, float)
                               else vv) for kk, vv in v.items()}
                      for k, v in timed.items()}}


def kernel_line(torch, fp, ssd, fa, r, launches, serve_launches, err,
                cbr_state, gs_sweep, family_launches, dev):
    """Each kernel timed at the path's largest shapes: the gather of Aᵀ
    at the widest bucket K (a full bucket, so ``index_select`` computes
    the same function), and the scatter of K values into (n, 1).

    ``ms``, ``plain_ms`` and ``library_ms`` are device times (calls
    replayed from a CUDA graph); ``eager_ms`` is the kernel's time per
    call when launched from Python back to back, host overhead
    included; ``launch_floor_ms`` is an empty kernel's time
    (``torch.cuda._sleep(0)``) replayed from a CUDA graph the same way,
    the least a launch costs there."""
    n, m = FIG1D["n"], FIG1D["m"]
    floor = graph_ms(torch, lambda: torch.cuda._sleep(0))
    K = max(r.meta["program_widths"])
    src = torch.randn((n, m), device=dev)
    idx, inv = _plan(torch, n, K, K, 11, dev)
    idx64 = idx.to(torch.int64)
    g = {"ms": graph_ms(torch, lambda: fp.gather_rows(src, idx)),
         "eager_ms": cuda_ms(torch, lambda: fp.gather_rows(src, idx)),
         "plain_ms": graph_ms(torch, lambda: fp.gather_rows.plain(src, idx)),
         "library_ms": graph_ms(torch,
                                lambda: torch.index_select(src, 0, idx64)),
         "bound_ms": bytes_ms(2 * K * m * 4 + K * 4)}
    del src
    vals = torch.randn((K, 1), device=dev)
    base = torch.randn((n, 1), device=dev)
    # base one element into its storage: not 16-byte aligned, so the
    # wrapper takes one row per thread, the design before the 4-row form
    view = torch.empty(n + 1, device=dev)[1:].view(n, 1)
    view.copy_(base)
    check(torch.equal(fp.scatter_rows(vals, inv, view),
                      fp.scatter_rows(vals, inv, base)),
          "scatter_rows: the 4-row and one-row forms disagree")
    s = {"ms": graph_ms(torch, lambda: fp.scatter_rows(vals, inv, base)),
         "one_row_ms": graph_ms(torch,
                                lambda: fp.scatter_rows(vals, inv, view)),
         "eager_ms": cuda_ms(torch,
                             lambda: fp.scatter_rows(vals, inv, base)),
         "plain_ms": graph_ms(torch,
                              lambda: fp.scatter_rows.plain(vals, inv, base)),
         "library_ms": graph_ms(torch, lambda: torch.index_copy(
             base, 0, idx64, vals)),
         # inv, the K values and the n − K kept base rows in; n rows out
         "bound_ms": bytes_ms(n * 4 + K * 4 + (n - K) * 4 + n * 4)}
    rows = []
    for name, t, shape in (("gather_rows", g, f"src ({n}, {m}) K={K}"),
                           ("scatter_rows", s, f"base ({n}, 1) K={K}")):
        rows.append({"name": name, "route": "cuda", "source": SOURCES[name],
                     "replaces": REPLACES[name],
                     "launches": launches[name],
                     "max_abs_err": err[name],
                     "ms": round(t["ms"], 5),
                     "plain_ms": round(t["plain_ms"], 5),
                     "bound_ms": round(t["bound_ms"], 5),
                     "bound_by": "bytes",
                     "launch_floor_ms": round(floor, 5),
                     "library_ms": round(t["library_ms"], 5),
                     "eager_ms": round(t["eager_ms"], 5),
                     **({"one_row_ms": round(t["one_row_ms"], 5)}
                        if "one_row_ms" in t else {}),
                     "shape": shape})
    # each kernel's launches per prefill on every serve path that runs it
    by_path = {name: {f"serve {SERVE['arch']}": serve_launches}
               if name == "ssd_scan" else
               {f"serve_dense {SERVE_DENSE['arch']}":
                launches["flash_attention"]}
               for name in ("ssd_scan", "flash_attention")}
    for arch, n in family_launches.items():
        for name, count in n.items():
            by_path[name][f"serve_families {arch}"] = count
    rows.append(ssd_row(torch, ssd, serve_launches, err["ssd_scan"],
                        by_path["ssd_scan"], dev))
    rows.append(br_row(torch, fp, launches["best_response"],
                       err["best_response"], dev))
    rows.append(fa_row(torch, fa, launches["flash_attention"],
                       err["flash_attention"], by_path["flash_attention"],
                       dev))
    rows += update_rows(torch, fp, launches, err, floor, dev)
    rows.append(cbr_row(torch, fp, err["compact_best_response"], cbr_state,
                        floor, dev))
    rows.append(gs_row(launches["gauss_seidel_sweep"], gs_sweep))
    return rows


def cbr_row(torch, fp, err, state, floor, dev):
    """compact_best_response at ``gather_rows``' timed shape: x, g (n, m)
    = (100000, 5000) fp32, a full K = 65536 bucket, scalar d, device times
    of calls replayed from a CUDA graph (the plain version's: eager, it
    holds several GB of temporaries).  Bound: 12 bytes per gathered
    element (x and g read, z written) and idx, over HBM.  Beside it the
    call on the fig1d path's last-point state (``cbr_on_path_state``),
    which is where its one launch was counted."""
    n, m = FIG1D["n"], FIG1D["m"]
    K = VECTOR_K
    gen = torch.Generator(device=dev).manual_seed(12)
    x = torch.randn((n, m), generator=gen, device=dev)
    g = 0.1 * torch.randn((n, m), generator=gen, device=dev)
    d = torch.tensor(1.7, device=dev)
    idx, _ = _plan(torch, n, K, K, 12, dev)
    kernel = fp.compact_best_response
    t = {"ms": graph_ms(torch, lambda: kernel(x, g, d, 0.3, idx)),
         "eager_ms": cuda_ms(torch, lambda: kernel(x, g, d, 0.3, idx)),
         "plain_ms": cuda_ms(torch, lambda: kernel.plain(x, g, d, 0.3, idx),
                             reps=5),
         "bound_ms": bytes_ms(12 * K * m + 4 * K)}
    del x, g
    torch.cuda.empty_cache()
    path = {k: (round(v, 6) if isinstance(v, float) else v)
            for k, v in state.items()}
    return {"name": "compact_best_response", "route": "cuda",
            "source": SOURCES["compact_best_response"],
            "replaces": REPLACES["compact_best_response"],
            "launches": state["launches"],
            "launches_on": "ops.compact_best_response on the fig1d path's "
                           "last-point state (no path of the reference "
                           "calls it)",
            "max_abs_err": err,
            "ms": round(t["ms"], 5), "plain_ms": round(t["plain_ms"], 5),
            "bound_ms": round(t["bound_ms"], 5), "bound_by": "bytes",
            "launch_floor_ms": round(floor, 5),
            # no single PyTorch call gathers and soft-thresholds
            "library_ms": None, "eager_ms": round(t["eager_ms"], 5),
            "shape": f"x, g ({n}, {m}) fp32, K={K}, scalar d",
            "timed": {"path_state": path}}


def gs_row(launches, sweep):
    """gauss_seidel_sweep: one sweep from x = 0 at fig1d
    (``gs_sweep_check``), CUDA events around one launch and around the
    plain version's loop; max_abs_err is that sweep's max |x − x_plain|.
    Bound: Aᵀ read once over HBM (the operations, 4 per element, take
    less); the sweep is sequential, so latency, not this, bounds it."""
    return {"name": "gauss_seidel_sweep", "route": "cuda",
            "source": SOURCES["gauss_seidel_sweep"],
            "replaces": REPLACES["gauss_seidel_sweep"],
            "tpu_kernel": False,
            "launches": launches,
            "launches_on": "the fig1 phase's GS run (one per sweep)",
            "max_abs_err": sweep["max_abs_dx"],
            "ms": round(sweep["ms"], 4),
            "plain_ms": round(sweep["plain_ms"], 4),
            "bound_ms": round(sweep["bound_ms"], 5), "bound_by": "bytes",
            "library_ms": None,
            "shape": f"Aᵀ {tuple(sweep['shape'])} fp32, one sweep from "
                     "x = 0 (fig1d)",
            "timed": {k: (round(v, 6) if isinstance(v, float) else v)
                      for k, v in sweep.items()}}


def update_rows(torch, fp, launches, err, floor, dev):
    """apply_update at the train path's shapes (lm_head (50304, 2560)
    fp32, 0-d τ and γ·m, c = 0, in place as the optimizer calls it; and
    one step's 291 calls), times from CUDA events around back-to-back
    eager calls; the batched kernels at the batch phase's (8, 100000)
    bucket (dense d, c and γ·m per instance) and at fig1d's solo
    (1, 100000), device times of calls replayed from a CUDA graph (a call
    takes microseconds) with the eager time beside.  Bounds: bytes over
    HBM — x and g read, x written (12 per fp32 element); x, g and dense d
    read, z or x written (16)."""
    x, g, d = br_inputs(torch, (50304, 2560), torch.float32, False, 71, dev)
    gm = torch.tensor(0.9, device=dev)
    timed = {"lm_head": {
        "ms": cuda_ms(torch, lambda: fp.apply_update(x, g, d, 0.0, gm,
                                                     out=x)),
        "plain_ms": cuda_ms(torch, lambda: fp.apply_update.plain(
            x, g, d, 0.0, gm, out=x), reps=5),
        "bound_ms": bytes_ms(12 * x.numel())}}
    del x, g, d
    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer as T
    shapes = [tuple(p.shape) for p in
              T.DenseLM(get_config(TRAIN["arch"]), device="meta").parameters()]
    n = sum(math.prod(sh) for sh in shapes)
    gen = torch.Generator(device=dev).manual_seed(72)
    pool_x = torch.randn(n, generator=gen, device=dev)
    pool_g = 0.01 * torch.randn(n, generator=gen, device=dev)
    d = torch.tensor(1.0, device=dev)
    views, o = [], 0
    for sh in shapes:
        k = math.prod(sh)
        views.append((pool_x[o:o + k].view(sh), pool_g[o:o + k].view(sh)))
        o += k

    def step(fn):
        for xv, gv in views:
            fn(xv, gv, d, 0.0, gm, out=xv)
    timed["step"] = {
        "tensors": len(shapes), "elements": n,
        "ms": cuda_ms(torch, lambda: step(fp.apply_update), reps=5),
        "plain_ms": cuda_ms(torch, lambda: step(fp.apply_update.plain),
                            reps=2),
        "bound_ms": bytes_ms(12 * n)}
    del pool_x, pool_g, views
    torch.cuda.empty_cache()
    t = timed["lm_head"]
    rows = [{"name": "apply_update", "route": "cuda",
             "source": SOURCES["apply_update"],
             "replaces": REPLACES["apply_update"],
             "launches": launches["apply_update"],
             "launches_per_step": len(shapes),
             "max_abs_err": err["apply_update"],
             "ms": round(t["ms"], 5), "plain_ms": round(t["plain_ms"], 5),
             "bound_ms": round(t["bound_ms"], 5), "bound_by": "bytes",
             # no single PyTorch call computes the fused update
             "library_ms": None,
             "shape": "x, g (50304, 2560) fp32, 0-d d and γ·m, c = 0, in "
                      "place (lm_head)",
             "timed": {k: {kk: (round(vv, 5) if isinstance(vv, float)
                                else vv) for kk, vv in v.items()}
                       for k, v in timed.items()}}]
    for name in ("batched_best_response", "batched_apply_update"):
        kernel = getattr(fp, name)
        timed = {}
        for key, B in (("batch", 8), ("solo", 1)):
            x, g, d, c = batched_inputs(torch, B, FIG1D["n"], torch.float32,
                                        "dense", "instance", 73, dev)
            args = (x, g, d, c) if name == "batched_best_response" \
                else (x, g, d, c, torch.rand(B, device=dev))
            timed[key] = {
                "shape": [B, FIG1D["n"]],
                "ms": graph_ms(torch, lambda: kernel(*args)),
                "eager_ms": cuda_ms(torch, lambda: kernel(*args)),
                "plain_ms": graph_ms(torch, lambda: kernel.plain(*args)),
                "bound_ms": bytes_ms(16 * x.numel())}
            del x, g, d, c, args
        t = timed["batch"]
        rows.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": err[name],
            "ms": round(t["ms"], 5), "plain_ms": round(t["plain_ms"], 5),
            "bound_ms": round(t["bound_ms"], 5), "bound_by": "bytes",
            "launch_floor_ms": round(floor, 6),
            "library_ms": None,
            "shape": "x, g, d (8, 100000) fp32, c" + (
                "" if name == "batched_best_response" else " and γ·m")
            + " per instance (the batch phase's bucket)",
            "launches_on": ("the path phase" if name ==
                            "batched_best_response" else
                            "the batch phase's Jacobi run"),
            "timed": {k: {kk: (round(vv, 6) if isinstance(vv, float)
                               else vv) for kk, vv in v.items()}
                      for k, v in timed.items()}})
    torch.cuda.empty_cache()
    return rows


def fa_work(shape, itemsize):
    """(q·kᵀ FLOPs, P·V FLOPs, bytes) of a flash_attention call at
    ``shape`` with ``itemsize``-byte q, k, v: 2·D each per (query, key)
    pair that the mask keeps (a multiply and an add per element), pairs
    counted exactly; q, k, v read once and the output written once."""
    B, Hq, Hkv, Sq, Skv, D, causal = shape
    if causal:
        off = Skv - Sq
        pairs = sum(min(Skv, off + i + 1) for i in range(Sq))
    else:
        pairs = Sq * Skv
    flops = 2 * B * Hq * D * pairs
    nbytes = itemsize * (2 * B * Hq * Sq * D + 2 * B * Hkv * Skv * D)
    return flops, flops, nbytes


def fa_row(torch, fa, launches, err, by_path, dev):
    """flash_attention at the stablelm-3b prefill's per-layer shape (4 × 32
    heads × 4096, D 80, bf16, causal), at yi-6b's (32 heads over 4, D
    128), zamba2-1.2b's (32/32, D 64), phi3-medium-14b's (2 × 2048, 40
    over 10, D 128) and deepseek-67b's (1 × 1024, 64 over 8), q, k, v laid
    out as the prefill passes them.  Times from CUDA
    events around back-to-back eager launches (a launch takes
    milliseconds).  The library call is ``scaled_dot_product_attention``
    on fp32 copies with ``is_causal`` (the same fp32 function; timed here
    only, never on the path).

    The bound by operations is the least time the card needs for this
    function: q·kᵀ multiplies bf16 by bf16 into fp32 sums, which the
    tensor cores do exactly at the bf16 rate, and P·V of the fp32 p is
    three exact bf16 products at that rate (p split into three bf16
    terms): ``split_ops_ms``.  The first kernel's bound, P·V at the fp32
    rate (``fp32_pv_ops_ms``), and both products at the fp32 rate
    (``fp32_ops_ms``) stand beside it; ``bound_ms`` is the larger of the
    bytes' time and the lesser of the two operation bounds."""
    F = torch.nn.functional
    timed = {}
    for key, shape in (("stablelm-3b", FA_STABLELM), ("yi-6b", FA_YI),
                       ("zamba2-1.2b", FA_ZAMBA),
                       ("phi3-medium-14b", FA_PHI3),
                       ("deepseek-67b", FA_DEEPSEEK)):
        q, k, v = fa_inputs(torch, shape, torch.bfloat16, 41, dev,
                            model_layout=True)
        qk, pv, nbytes = fa_work(shape, 2)
        t_qk, t_pv = qk / BF16_OPS_PER_S * 1e3, pv / FP32_OPS_PER_S * 1e3
        t_split = (qk + 3 * pv) / BF16_OPS_PER_S * 1e3
        t_bytes, t_ops = bytes_ms(nbytes), min(t_split, t_qk + t_pv)
        rep = shape[1] // shape[2]
        qf = q.float()
        kf = k.float().repeat_interleave(rep, dim=1)
        vf = v.float().repeat_interleave(rep, dim=1)
        timed[key] = {
            "shape": list(shape[:6]),
            "ms": cuda_ms(torch, lambda: fa.flash_attention(q, k, v),
                          reps=10),
            "plain_ms": cuda_ms(torch, lambda: fa.flash_attention.plain(
                q, k, v), reps=3),
            "library_ms": cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                qf, kf, vf, is_causal=True), reps=10),
            "qk_flops": qk, "pv_flops": pv, "bytes": nbytes,
            "bytes_ms": t_bytes, "qk_bf16_ms": t_qk, "pv_fp32_ms": t_pv,
            "split_ops_ms": t_split, "fp32_pv_ops_ms": t_qk + t_pv,
            "fp32_ops_ms": (qk + pv) / FP32_OPS_PER_S * 1e3,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
        del q, k, v, qf, kf, vf
        torch.cuda.empty_cache()
    t = timed["stablelm-3b"]
    return {"name": "flash_attention", "route": "cuda",
            "source": SOURCES["flash_attention"],
            "replaces": REPLACES["flash_attention"],
            "launches": launches, "launches_by_path": by_path,
            "max_abs_err": err,
            "ms": round(t["ms"], 5), "plain_ms": round(t["plain_ms"], 5),
            "bound_ms": round(t["bound_ms"], 5), "bound_by": t["bound_by"],
            "library_ms": round(t["library_ms"], 5),
            "split_ops_ms": round(t["split_ops_ms"], 5),
            "fp32_pv_ops_ms": round(t["fp32_pv_ops_ms"], 5),
            "faster_than_library": {kk: vv["ms"] < vv["library_ms"]
                                    for kk, vv in timed.items()},
            "shape": "q, k, v (4, 32, 4096, 80) bf16, causal (stablelm-3b "
                     "prefill, one layer)",
            "peak": "q·kᵀ and three bf16 P·V products at 989 TFLOP/s "
                    "(tensor cores); fp32_pv_ops_ms: P·V at fp32 66.9",
            "timed": {kk: {a: (round(b, 5) if isinstance(b, float) else b)
                           for a, b in vv.items()}
                      for kk, vv in timed.items()}}


def ssd_row(torch, ssd, launches, err, by_path, dev):
    """ssd_scan at the serve path's per-layer shape (4 × 4096, bf16, x/B/C
    strided as the mixer passes them), at a prefill_32k sequence
    (1 × 32768) and at zamba2-1.2b's prefill (4 × 4096, N 64).  Times from CUDA events around back-to-back eager
    launches (a launch takes milliseconds, so host overhead is noise).

    The bound by operations is the least time the card needs for this
    function: G = C·Bᵀ multiplies bf16 by bf16 into fp32 sums, which the
    tensor cores do exactly at the bf16 rate, and W·X, C·h and the state
    update each have one fp32 factor, three exact bf16 products at that
    rate (the factor split into three bf16 terms): ``split_ops_ms``.  All
    products at the fp32 CUDA-core rate (``fp32_ops_ms``, the first
    kernel's bound) stand beside it; ``bound_ms`` is the larger of the
    bytes' time and the lesser of the two operation bounds."""
    timed = {}
    for key, shape in (("serve", SSD_FULL[1]), ("prefill_32k", SSD_32K),
                       ("zamba2-1.2b", SSD_ZAMBA)):
        args = ssd_inputs(torch, shape, torch.bfloat16, seed=21, dev=dev)
        g_flops, rest_flops, nbytes = ssd_work(shape, 2)
        flops = g_flops + rest_flops
        t_split = (g_flops + 3 * rest_flops) / BF16_OPS_PER_S * 1e3
        t_fp32 = flops / FP32_OPS_PER_S * 1e3
        t_bytes, t_ops = bytes_ms(nbytes), min(t_split, t_fp32)
        timed[key] = {
            "shape": list(shape),
            "ms": cuda_ms(torch, lambda: ssd.ssd_scan(
                *args, chunk=shape[-1]), reps=5),
            "plain_ms": cuda_ms(torch, lambda: ssd.ssd_scan.plain(
                *args, chunk=shape[-1]), reps=3),
            "flops": flops, "g_flops": g_flops, "bytes": nbytes,
            "bytes_ms": t_bytes, "split_ops_ms": t_split,
            "fp32_ops_ms": t_fp32,
            "tf32_ops_ms": flops / TF32_OPS_PER_S * 1e3,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
        del args
        torch.cuda.empty_cache()
    t = timed["serve"]
    return {"name": "ssd_scan", "route": "cuda",
            "source": SOURCES["ssd_scan"], "replaces": REPLACES["ssd_scan"],
            "launches": launches, "launches_by_path": by_path,
            "max_abs_err": err,
            "ms": round(t["ms"], 5), "plain_ms": round(t["plain_ms"], 5),
            "bound_ms": round(t["bound_ms"], 5), "bound_by": t["bound_by"],
            # no single PyTorch call computes the SSD scan
            "library_ms": None,
            "split_ops_ms": round(t["split_ops_ms"], 5),
            "fp32_ops_ms": round(t["fp32_ops_ms"], 5),
            "faster_than_plain": {k: v["ms"] < v["plain_ms"]
                                  for k, v in timed.items()},
            "shape": "x (4, 4096, 64, 64) bf16, B/C (4, 4096, 128), "
                     "chunk 256",
            "peak": "G and three bf16 products of each fp32-factor product "
                    "at 989 TFLOP/s (tensor cores); fp32_ops_ms: all at "
                    "fp32 66.9 (CUDA cores); TF32 495 beside it",
            "timed": {k: {kk: (round(vv, 5) if isinstance(vv, float)
                               else vv) for kk, vv in v.items()}
                      for k, v in timed.items()}}


def main() -> int:
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: src/repro_torch not found next to this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 3
    from repro_torch.kernels import build
    from repro_torch.kernels import flexa_prox as fp
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import gauss_seidel as gs
    from repro_torch.kernels import ssd_scan as ssd

    KERNEL_NAMES.update(fp.KERNEL_NAMES)
    KERNEL_NAMES.update(gs.KERNEL_NAMES)
    KERNEL_NAMES.update(ssd.KERNEL_NAMES)
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    phase = "setup"
    try:
        card = phase_setup(torch, build, fp, ssd, fa, gs)
        phase = "hopper_kernels"
        phase_hopper(torch, build, fp, fa, gs, ssd)
        phase = "kernels"
        err = phase_kernels(torch, fp, ssd, fa, gs, dev)
        phase = "goldens"
        phase_goldens(torch, dev)
        phase = "solo"
        p = phase_solo(torch, fp, dev)
        phase = "fig1"
        gs_launches, gs_sweep = phase_fig1(torch, fp, gs, p, dev)
        phase = "path"
        r, launches, cbr_state = phase_path(torch, fp, p)
        launches["gauss_seidel_sweep"] = gs_launches
        del p
        torch.cuda.empty_cache()
        phase = "compact"
        phase_compact_vs_dense(torch, dev)
        phase = "batch"
        launches["batched_apply_update"] = phase_batch(torch, fp, dev)
        phase = "cv"
        phase_cv(torch, fp, dev)
        phase = "serve"
        serve_launches = phase_serve(torch, ssd, dev)
        phase = "serve_dense"
        launches["flash_attention"] = phase_serve_dense(torch, fa, dev)
        phase = "serve_families"
        family_launches = phase_serve_families(torch, ssd, fa, dev)
        phase = "train"
        launches["best_response"], launches["apply_update"] = phase_train(
            torch, fp, dev)
        phase = "descent"
        phase_descent(torch, dev)
        phase = "kernel timing"
        rows = kernel_line(torch, fp, ssd, fa, r, launches, serve_launches,
                           err, cbr_state, gs_sweep, family_launches, dev)
    except Exception as exc:                          # report and fail
        print(f"FAIL {phase}: {type(exc).__name__}: {exc}", flush=True)
        raise
    say("done", total_s=round(time.perf_counter() - t_start, 2))
    print(card, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
