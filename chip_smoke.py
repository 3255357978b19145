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
               path's padded bucket, the compacted group path's (Aᵀ's
               blocks as rows of 25000 floats, the C = 5 vectors; full
               and padded buckets of 4096), ragged C, all-padding, K = 1,
               bf16/fp16 sources, and a scatter at a ragged n and on a
               view one element into its storage; ``ssd_scan`` at the reduced and the full
               mamba2-1.3b width, zamba2-1.2b's (4 × 4096, N 64),
               ragged S, strided views of an xBC
               buffer, fp32 and bf16, and the decay-overflow case, within
               1e-4 × max |y| (bf16: 2 ulps per element plus that), finite
               and bitwise repeatable.  ``ssd_scan_bwd`` against its plain
               version (autograd of ``ssd_scan_ragged``) at mamba2-1.3b's
               training shape (2 × 4096, N 128, chunk 256), zamba2-1.2b's
               N 64 with a nonzero dh_final, the reduced config, a ragged
               odd shape (1 × 200, 5 heads of 48, N 100, chunk 96) and the
               decay-overflow case over a ragged S of 600; fp32 and bf16;
               dx, ddt, dA, dB and dC each at that gate, and a second
               launch bitwise.
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
               (m=2000, n=10000, 10% nnz) on the first 4 points of the
               10-point grid to 0.05 λ_max (``COMPACT_POINTS``; its later
               points cost the masked-dense run 160–210 s).
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
6d. families — slice 15's main path: the other problem families at
               fig1d's dimensions (m 5000, n 100000, 5 % nnz, seed 0,
               generated on 3 host threads): the planted group Lasso
               (20000 blocks of 5, c 1), logreg and svm at c = 0.1 λ_max
               (λ_max printed).  ``SoloSpec`` 500 iterations each (group
               Lasso again under ``newton_cg``'s inexact loop): ms per
               iteration, V at x = 0 and at the end (finite and below),
               the stationarity residual, group Lasso's (V − V*)/V* and
               last certificate; ``batched_best_response`` launched 500
               times for logreg and svm (by counter; logreg's solve once
               more by profiler, a short profile printed and the solve
               profiled again, 3 times at most) and never for group
               Lasso; one full-size logreg
               and svm iteration's z and x_new from the kernels equal
               their plain versions bit for bit.  Logreg under Jacobi,
               100 iterations: ``batched_best_response`` and
               ``batched_apply_update`` 100 each.  Compacted λ-paths
               (``PathSpec(..., compact=True)``, 8 points) of group Lasso
               to 0.15 λ_max and logreg to 0.1 λ_max: every point
               converged, zero blocks within 1e-3 of the KKT bound, the
               gather and scatter launched, ``batched_best_response``
               once per solver iteration for logreg and never for group
               Lasso; wall s, row iterations, supports, KKT rounds and
               violations, launches by counter.  At fig1b's dimensions
               (m 2000, n 10000) each family, 100 Jacobi iterations at
               fixed τ⁰ = L_F / 2 on the card and on the CPU: x within
               1e-4, V within 1e-5 relative.  A logreg ``BatchSpec`` of 4
               fig1b instances, greedy for 300 iterations at fixed τ⁰ =
               max L_F / 2: row 0's V within 1e-3 of a ``SoloSpec``.
6e. solver_serve — slice 16's main path: 24 Nesterov Lassos at fig1b's
               dimensions from a copy of ``benchmarks/serve_load.py``'s
               heavy-tail trace (Poisson arrivals, mean gap 12
               slab-iteration units, Pareto 1.1 difficulty → nnz 0.05–0.18),
               ``SolverConfig(max_iters=2500, tol=1e-7, tau_adapt=False)``,
               ``ServeConfig(slab_capacity=8, chunk_iters=100,
               max_batch=8)``, replayed on their arrival times through
               ``FlexaClient(backend="continuous")`` and then
               ``backend="wave"`` (submit, step, drain), each after an
               untimed warm-up that calibrates the unit and profiles one
               chunk (``batched_best_response`` records = the counter's
               100).  Every response equals its ``SoloSpec`` on the card
               bit for bit (x, iterations, convergence); every request is
               served once (the continuous audit; every trace completed);
               ``batched_best_response`` launched chunks × 100 times on the
               continuous run and once per bucket iteration on the wave
               run, by counter.  Printed: makespan, requests/s, p50/p99
               latency, median step ms, occupancy, row and live
               iterations, the wave's padding and freeze waste, the
               admission copy ms per row, the profiled chunk's device ms
               and busy share.  Then 4 logreg requests (c 0.1 λ_max)
               among the trace's first 8 Lassos with ``slabs_per_tick=1``
               (two slabs serviced from the first ticks, every response
               bitwise its solo run); 8 Lassos under Jacobi (200 iterations, no mask:
               ``batched_apply_update`` 200 by counter, rows bitwise);
               a served ``PathSpec`` (8 points to 0.1 λ_max, nnz 0.05)
               against the inline one: x within 1e-5, equal supports,
               every point converged; 8 easy requests with the watchdog
               on and off (bitwise, nothing quarantined), and with
               ``compact_drain`` (bitwise the fixed capacity's, at least
               one migration).  The solo runs are ``SoloSpec(method=
               "flexa_compiled")``: ``flexa``'s iteration and stop, its
               flag read every 16 iterations.
7. serve   — slice 2's main path: full-width mamba2-1.3b (48 layers,
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
8c. serve_vlm_encdec — slice 12's main path: seamless-m4t-large-v2
               whole (24 encoder and 24 decoder layers, d_model 1024, 16
               heads of 64, vocab 256206; random weights from a seeded
               generator) through ``ServeEngine.generate``, 4 prompts of
               4096 tokens, 4096 frames of seeded normal ``enc_embeds``
               and 32 new tokens, greedy: ``flash_attention`` 72
               launches per prefill (encoder non-causal, decoder self
               causal, cross non-causal) and 24 per decode step (cross,
               one query over the 4128-position cross cache), by counter
               and by profiler; the measurements of ``serve``; the fp32
               first token within 1e-4 of the forward's max logit (the
               later ones cannot be held so: decode reads a cross cache
               zero past the frames, as the reference's does), and decode's
               cross-attention at full shape, layer 0 of step 1, against
               the plain version at the kernel gate in bf16 and fp32.
               Then qwen2-vl-72b (M-RoPE) at 6 of its 80 layers, width
               never cut, 2 × 2048 + 8: ``flash_attention`` 6 per
               prefill, by counter and by profiler, finite logits, the
               fp32 greedy check.  One line per run with its seconds.
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
9b. train_ssm — slice 13's main path: full-width mamba2-1.3b (48
               layers, d_model 2048, N 128, chunk 256, random weights from
               a seeded generator) through ``TrainLoop.run``, FLEXA
               defaults, bf16, 2 × 4096, 4 steps, with ``train``'s checks
               and measurements: the step-1 check of all 434 tensors,
               every loss finite, ``best_response`` and ``apply_update``
               434 per step, and ``ssd_scan`` 96 (two per layer: remat's
               recompute) and ``ssd_scan_bwd`` 48 per step, by counter and
               by profiler; per-step ms, the split step, peak memory, the
               device time of the scan and its backward per step.
9c. train_hybrid — zamba2-1.2b whole (38 Mamba2 layers, the shared block
               after each 6), 2 × 4096, 2 steps, with ``train_ssm``'s checks
               and measurements: the step-1 check of all 353 tensors,
               every loss finite, ``ssd_scan`` 76, ``ssd_scan_bwd`` 38 and
               ``best_response`` / ``apply_update`` 353 per step, by counter
               and by profiler.
9d. train_families — the moe, vlm and encdec families at their published
               widths, 2 × 4096 (encdec with 4096 frames), 3 steps each,
               with the same checks and measurements: seamless-m4t-large-v2
               whole, qwen3-moe-30b-a3b at 6 of 48 layers and qwen2-vl-72b
               at 2 of 80.  One line per arch.
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
heads over 10, D 128), deepseek-67b's (1 × 1024, 64 over 8),
seamless-m4t-large-v2's (4 × 4096, 16/16, D 64: encoder non-causal,
decoder self causal, cross non-causal with q not roped and k, v
contiguous, decode's cross of one query over 4128) and qwen2-vl-72b's
(2 × 2048, 64 over 8); fp32 within 2e-5 and bf16 within 2 bf16 ulps per
element plus 2e-5, finite, a second launch bitwise, and a causal call
with Sq > Skv refused.  And ``apply_update``, ``batched_best_response`` and
``batched_apply_update``: sizes 1, 1000, (8, 100000), (50304, 2560) and a
misaligned view; scalar, per-instance and dense d; c 0, a host value and
per instance; γ·m 0, 1, 0.9 and per instance; fp32 and bf16 x: outputs
bitwise equal to the plain versions', e2 within 1e-5 relative, a second
launch bitwise (the batched sweep adds (1, 100000), the solver's solo
shape, and (8, 10000), the solver_serve slab's); then 10 calls each of ``batched_best_response`` at (1, 100000) and
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
            "gauss_seidel_sweep": "src/repro/baselines/gauss_seidel.py:37",
            # the gradient of the ssd_scan kernel, which has no VJP there:
            # the reference differentiates its jnp oracle
            "ssd_scan_bwd": "src/repro/kernels/ssd_scan.py:83"}
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
               "src/repro_torch/kernels/csrc/gauss_seidel.cu",
           "ssd_scan_bwd": "src/repro_torch/kernels/csrc/ssd_scan_bwd.cu"}
#: Device-kernel names (substrings of the profiler's records) per wrapper;
#: ``main`` adds those of ``flexa_prox``'s, ``gauss_seidel``'s and
#: ``ssd_scan``'s wrappers (their KERNEL_NAMES).
KERNEL_NAMES = {"flash_attention": ("flash_attention_fwd",)}
#: Wrappers that launch several device kernels per call: the kernel whose
#: records count the wrapper's launches (the others' time is summed too).
CALL_MARKS = {"ssd_scan": "ssd_chunk_out",
              "ssd_scan_bwd": "ssd_bwd_head_sum"}
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
#: This slice's runs (``serve_vlm_encdec``): seamless-m4t-large-v2 whole
#: (24 encoder and 24 decoder layers, 2.03 B parameters) at 4 × 4096 + 32
#: with 4096 frames, the main path, profiled in full; qwen2-vl-72b at 6 of
#: 80 layers (≈ 7.76 B of 72.7 B parameters, width never cut): in bf16
#: the whole model (144 GB) exceeds the card's 80 GB, and at ≈ 6 bytes a
#: parameter (fp32 masters and bf16 casts) 6 layers put the peak near
#: qwen3-moe-30b-a3b's 46 GiB.
SERVE_VLM_ENCDEC = [
    dict(arch="seamless-m4t-large-v2", batch=4, prompt=4096, new=32,
         frames=4096, seed=0, profile="full"),
    dict(arch="qwen2-vl-72b", layers=6, batch=2, prompt=2048, new=8,
         seed=0, profile="prefill")]
TRAIN = dict(arch="stablelm-3b", batch=2, seq=4096, steps=6)
#: Slice 13's main path: mamba2-1.3b whole (48 layers, d_model 2048, N
#: 128, chunk 256) at train_4k's sequence, the batch cut from 256 to 2.
TRAIN_SSM = dict(arch="mamba2-1.3b", batch=2, seq=4096, steps=4)
#: zamba2-1.2b whole (38 Mamba2 layers, the shared block 6 times).
TRAIN_HYBRID = dict(arch="zamba2-1.2b", batch=2, seq=4096, steps=2)
#: The moe, vlm and encdec families at their published widths and train_4k's
#: sequence (the batch cut from 256 to 2), 3 steps each: seamless-m4t-large-v2
#: whole (24 + 24 layers, 2.03 B parameters; 4096 frames); qwen3-moe-30b-a3b
#: at 6 of 48 layers (4.36 B) and qwen2-vl-72b at 2 of 80 (4.25 B: its two
#: untied 152064 × 8192 tables are 2.49 B), cut in depth to what one card
#: holds beside fp32 masters and their fp32 gradients (8 bytes a parameter),
#: the fp32 logits and their gradient.
TRAIN_FAMILIES = [
    dict(arch="qwen3-moe-30b-a3b", layers=6, batch=2, seq=4096, steps=3),
    dict(arch="qwen2-vl-72b", layers=2, batch=2, seq=4096, steps=3),
    dict(arch="seamless-m4t-large-v2", batch=2, seq=4096, steps=3)]
DESCENT = dict(arch="stablelm-3b", batch=4, seq=64, steps=30)
#: Shapes of the best_response sweep: 1, ragged 1000, the layer tensors
#: of stablelm-3b (attn 2560², mlp 2560 × 6912) and its lm_head.
BR_SHAPES = [(1,), (1000,), (2560, 2560), (2560, 6912), (50304, 2560)]
BR_MISALIGNED = (1_000_001,)       # a view one element into its storage
#: Shapes of the apply_update sweep (the misaligned view added as above)
#: and (B, n) of the batched sweep: 1, ragged 1000, the solo solver's
#: (1, 100000), the batch phase's bucket, the solver_serve slab's
#: (8, 10000), lm_head's elements in two instances (the best response's
#: two-level form), and rows of 1001 from a view one element into its
#: storage (the scalar loop).
UPD_SHAPES = [(1,), (1000,), (8, 100_000), (50304, 2560)]
BATCHED_SHAPES = [(1, 1), (1, 1000), (1, 100_000), (8, 100_000),
                  (8, 10_000), (2, 50304 * 1280)]
BATCHED_MISALIGNED = (3, 1001)
#: The batch phase: B fig1d instances (seeds 0..B−1), generated on this
#: many host threads; each holds ≈ 10 GB of host memory while it runs.
BATCH = dict(B=8, iters=300, gen_threads=4)
#: The cv phase (``benchmarks/path_bench.py:run_cv`` at fig1b's width).
CV = dict(m_total=8000, n=10_000, support=500, K=4, P=16, ratio=0.05,
          seed=0, tol=1e-6)
#: The families phase: group Lasso, logreg and svm at fig1d's dimensions
#: (m 5000, n 100000; group blocks of 5), seed 0; logreg and svm at
#: c = ``lam_frac`` · λ_max.  Solo runs of ``iters``, logreg under
#: Jacobi for ``jacobi_iters``, compacted paths of ``path_points``, the
#: card against the CPU at fig1b's dimensions (``check``), and a logreg
#: ``BatchSpec`` of ``batch`` fig1b instances.
FAMILIES = dict(m=5000, n=100_000, nnz_frac=0.05, block_size=5, seed=0,
                lam_frac=0.1, iters=500, jacobi_iters=100, path_points=8,
                path_tol=1e-6, gen_threads=3)
FAMILIES_CHECK = dict(m=2000, n=10_000, nnz_frac=0.10, block_size=5,
                      seed=0, iters=100)
FAMILIES_BATCH = dict(B=4, iters=300)
# Solver serving (slice 16): benchmarks/serve_load.py's heavy-tail trace
# and its engine settings (:558-576), at fig1b's dimensions.
SOLVER_SERVE = dict(m=2000, n=10_000, requests=24, mean_gap=12.0,
                    tail_alpha=1.1, seed=0, nnz=(0.05, 0.18), gen_threads=4,
                    logreg=4, logreg_lam_frac=0.1, jacobi=8,
                    jacobi_iters=200, path_points=8, path_ratio=0.1)
SERVE_SOLVER = dict(max_iters=2500, tol=1e-7, tau_adapt=False)
SERVE_SLABS = dict(slab_capacity=8, chunk_iters=100, max_batch=8)
# The compact phase runs both paths on the first points of its 10-point
# grid (to 0.05 λ_max): the masked-dense run's later points took 160–210
# s, which the chip's time limit no longer holds beside solver_serve.
COMPACT_POINTS = 4
#: Gathers of the compacted group path at fig1d: Aᵀ's blocks as rows of
#: bs·m = 25000 floats, and the (n_blocks, 5) vectors.
GROUP_GATHER = (20_000, 25_000, 4096)
GROUP_VECTOR = (20_000, 5, 4096)
#: (Bt, S, H, P, N, chunk) of the ssd_scan sweep: reduced, full width.
SSD_REDUCED = (2, 64, 3, 16, 8, 16)
SSD_FULL = [(1, 256, 64, 64, 128, 256), (4, 4096, 64, 64, 128, 256),
            (4, 4133, 64, 64, 128, 256)]
SSD_32K = (1, 32768, 64, 64, 128, 256)       # a prefill_32k sequence
SSD_ZAMBA = (4, 4096, 64, 64, 64, 256)       # zamba2-1.2b's prefill, N 64
#: ssd_scan_bwd's sweep: (shape, x/B/C strided, a nonzero dh_final, dt 0.1
#: with A down to −16): mamba2-1.3b's training shape, zamba2-1.2b's N 64,
#: the reduced config, a ragged odd shape, and the decay's overflow at
#: chunk 256 over a ragged S.
SSD_TRAIN = (2, 4096, 64, 64, 128, 256)
SSD_TRAIN_ZAMBA = (2, 4096, 64, 64, 64, 256)
SSD_BWD_CASES = [(SSD_TRAIN, True, False, False),
                 (SSD_TRAIN_ZAMBA, True, True, False),
                 ((2, 64, 3, 16, 8, 16), False, True, False),
                 ((1, 200, 5, 48, 100, 96), True, False, False),
                 ((1, 600, 2, 64, 128, 256), True, True, True)]
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
#: Opcodes counted in ssd_scan_bwd's SASS: its bf16 product passes must
#: hold tensor-core instructions (the first two), no pass the others.
SSD_BWD_SASS_OPS = ("HMMA", "HGMMA", "ATOMG", "RED", "REDG")
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
#: The vlm and encdec serve paths' attentions: seamless-m4t-large-v2's
#: encoder (non-causal) and decoder self-attention (causal) over 4 × 4096,
#: its cross-attention (4096 queries over 4096 frames, q not roped, k and v
#: the cross cache's slice) and decode's cross-attention (one query over
#: the grown cache, max_len 4128); qwen2-vl-72b's prefill (64 over 8).
FA_SEAMLESS_ENC = (4, 16, 16, 4096, 4096, 64, False)
FA_SEAMLESS_SELF = (4, 16, 16, 4096, 4096, 64, True)
FA_SEAMLESS_DECODE = (4, 16, 16, 1, 4128, 64, False)
FA_QWEN2VL = (2, 64, 8, 2048, 2048, 128, True)
#: (shape, layout) of the model-shaped flash_attention calls that the
#: sweep gates and the kernels line times (``fa_inputs``' layouts).
FA_MODEL = [(FA_STABLELM, "self"), (FA_YI, "self"), (FA_ZAMBA, "self"),
            (FA_PHI3, "self"), (FA_DEEPSEEK, "self"),
            (FA_SEAMLESS_ENC, "self"), (FA_SEAMLESS_SELF, "self"),
            (FA_SEAMLESS_ENC, "cross"), (FA_SEAMLESS_DECODE, "cross"),
            (FA_QWEN2VL, "self")]


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


def top_kernels(torch, prof, n=12, only=None):
    """The ``n`` device kernels with the most summed time in a profile
    (of those whose names hold one of ``only``, where given): [name
    (first 70 characters), launches, ms]."""
    acc = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        if only is not None and not any(sub in e.name() for sub in only):
            continue
        rec = acc.setdefault(e.name()[:70], [0, 0.0])
        rec[0] += 1
        rec[1] += e.duration_ns() / 1e6
    top = sorted(acc.items(), key=lambda kv: -kv[1][1])[:n]
    return [[k, c, round(ms, 3)] for k, (c, ms) in top]


def device_classes(torch, prof, names=KERNEL_NAMES):
    """A profile's device records by class, summing to its busy time:
    the port's kernels (``names``), cuBLAS's GEMMs, PyTorch's own kernels
    (elementwise, reductions, copies), memory copies and sets, the rest:
    {class: [records, ms]}."""
    subs = [sub for v in names.values() for sub in v]
    out = {c: [0, 0.0] for c in ("port_kernels", "cublas_gemm",
                                 "pytorch_native", "memcpy_memset",
                                 "other")}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        n = e.name()
        if any(sub in n for sub in subs):
            c = "port_kernels"
        elif any(t in n.lower() for t in ("gemm", "nvjet", "cutlass",
                                          "xmma")):
            c = "cublas_gemm"
        elif "at::native" in n:
            c = "pytorch_native"
        elif n.startswith(("Memcpy", "Memset")):
            c = "memcpy_memset"
        else:
            c = "other"
        out[c][0] += 1
        out[c][1] += e.duration_ns() / 1e6
    return {c: [k, round(ms, 3)] for c, (k, ms) in out.items()}


def matmul_bound_ms(cfg, model, tokens, remat):
    """Least device ms of a training step's weight products over
    ``tokens`` tokens: each layer's 2-D weight (not the causal conv's)
    once per token and application (the hybrid's shared block once per
    application; encdec's encoder over as many frames) in bf16, forward,
    backward's two products and remat's recompute, at the bf16 peak; the
    fp32 logits' three products at the fp32 peak.  None for moe, whose
    expert products follow the routing."""
    if cfg.family == "moe":
        return None
    uses = {"shared": cfg.num_layers // cfg.attn_every} \
        if cfg.family == "hybrid" else {}
    n = sum(x.numel() * uses.get(k.split(".")[0], 1)
            for k, x in model.named_parameters()
            if x.ndim == 2 and not k.endswith("conv_w")
            and k.split(".")[0] in ("layers", "shared", "enc_layers",
                                    "dec_layers"))
    proj = (8 if remat else 6) * n * tokens
    logits = 6 * cfg.vocab_size * cfg.d_model * tokens
    return {"layer_weight_elements": n,
            "projections_bf16_ms": round(proj / BF16_OPS_PER_S * 1e3, 3),
            "logits_fp32_ms": round(logits / FP32_OPS_PER_S * 1e3, 3)}


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
PROFILE_ATTEMPTS = 3               # profiled training steps at most
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
    ssd.bwd_library()
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
    and fp32 at mamba2-1.3b's N 128, P 64, chunk 256, ``ssd_scan_bwd``'s
    in bf16 at N 128 and 64) and clusters the card can hold
    (``gauss_seidel_sweep`` at fig1d's m); and the tensor-core
    instructions in the SASS of ``flash_attention``, ``ssd_scan`` and
    ``ssd_scan_bwd``: every bf16 instantiation (one per D / 16; the chunk
    states and chunk outputs; the backward's dH, rows of u and rows of t)
    must hold HMMA or HGMMA, no fp32 (or fp16) one any, and no
    instantiation of ``ssd_scan_bwd`` a global atomic or reduction;
    ``batched_best_response`` at the solver's (1, 100000) and
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
    # ssd_scan_bwd's passes (bf16: tensor cores)
    for pass_ in ssd.BWD_PASSES:
        for Ns in (N, SSD_ZAMBA[4]):
            info[f"ssd_scan_bwd bfloat16 {pass_} N={Ns}"] = \
                ssd.bwd_kernel_info(torch.bfloat16, pass_, Ns, P, chunk)
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
    bwd_sass = {"bf16": {}, "fp32": {}, "atomics": 0}
    for name, ops in build.sass_counts("ssd_scan_bwd",
                                       opcodes=SSD_BWD_SASS_OPS).items():
        kern = re.search(r"(ssd_bwd_\w+?)(I|E)", name)
        if kern is None:
            continue
        kind = "bf16" if kern.group(1).endswith("_mma") else "fp32"
        elem = re.search(r"I(f|6__half|13__nv_bfloat16)EEv", name)
        key = kern.group(1) + ({"f": "<float>", "6__half": "<half>",
                                "13__nv_bfloat16": "<bf16>"}[elem.group(1)]
                               if elem else "")
        bwd_sass[kind][key] = ops["HMMA"] + ops["HGMMA"]
        bwd_sass["atomics"] += ops["ATOMG"] + ops["RED"] + ops["REDG"]
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
        ssd_scan_bwd_tensor_core_sass=bwd_sass,
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
    check(len(bwd_sass["bf16"]) == 3
          and all(v > 0 for v in bwd_sass["bf16"].values()),
          f"ssd_scan_bwd's bf16 product passes lack tensor-core SASS: "
          f"{bwd_sass}")
    check(len(bwd_sass["fp32"]) == 11 and not any(bwd_sass["fp32"].values())
          and bwd_sass["atomics"] == 0,
          f"ssd_scan_bwd's fp32, fp16 or scalar passes hold tensor-core "
          f"SASS, or a pass holds an atomic: {bwd_sass}")
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
    return gate(torch, y, y0, "ssd_scan y"), gate(torch, h, h0, "ssd_scan h")


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


def gate(torch, got, want, what):
    """Max |Δ| of ``got`` against ``want``; fails unless finite, of one
    dtype and shape, and within 1e-4 × max |want| (bf16: plus 2 bf16 ulps
    of each element), the gate of ``ssd_compare``."""
    check(got.dtype == want.dtype and got.shape == want.shape,
          f"{what}: {got.dtype}{tuple(got.shape)} vs "
          f"{want.dtype}{tuple(want.shape)}")
    gf, wf = got.float(), want.float()
    check(bool(torch.isfinite(gf).all() and torch.isfinite(wf).all()),
          f"{what}: non-finite values")
    d = (gf - wf).abs()
    bound = 1e-4 * float(wf.abs().max())
    if got.dtype == torch.bfloat16:
        ulp = torch.exp2(torch.floor(torch.log2(
            wf.abs().clamp_min(2.0 ** -126))) - 7)
        ok = bool((d <= 2 * ulp + bound).all())
    else:
        ok = float(d.max()) <= bound
    check(ok, f"{what} differs from its plain version: max |d| "
          f"{float(d.max())} (bound {bound})")
    return float(d.max())


def ssd_bwd_args(torch, shape, dtype, seed, dev, strided, dh, overflow):
    """An ssd_scan_bwd call's inputs: the scan's (``ssd_inputs``), dy (a
    view into a wider buffer when ``strided``) and dh_final (None unless
    ``dh``)."""
    args = ssd_inputs(torch, shape, dtype, seed, dev, strided=strided,
                      overflow=overflow)
    Bt, S, H, P, N, _ = shape
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    dy = torch.randn((Bt, S, H, P + 3 * strided), generator=g,
                     device=dev).to(dtype)[..., :P]
    dhf = torch.randn((Bt, H, N, P), generator=g, device=dev) if dh else None
    return args, dy, dhf


SSD_GRADS = ("dx", "ddt", "dA", "dB", "dC")


def ssd_bwd_sweep(torch, ssd, dev):
    """ssd_scan_bwd against its plain version (autograd of
    ``ssd_scan_ragged``) over ``SSD_BWD_CASES`` in fp32 and bf16, each of
    dx, ddt, dA, dB, dC at the gate; every launch repeated once,
    bitwise.  → ({dtype: {grad: max |Δ|}}, calls)."""
    err = {name: dict.fromkeys(SSD_GRADS, 0.0)
           for name in ("float32", "bfloat16")}
    for i, (shape, strided, dh, overflow) in enumerate(SSD_BWD_CASES):
        for name in err:
            args, dy, dhf = ssd_bwd_args(torch, shape, getattr(torch, name),
                                         100 + i, dev, strided, dh, overflow)
            chunk = shape[-1]
            scratch = ssd.ssd_scan(*args, chunk=chunk, keep_scratch=True)[2]
            got = ssd.ssd_scan_bwd(*args, dy, dhf, chunk=chunk,
                                   scratch=scratch)
            again = ssd.ssd_scan_bwd(*args, dy, dhf, chunk=chunk,
                                     scratch=scratch)
            check(all(torch.equal(a, b) for a, b in zip(got, again)),
                  f"ssd_scan_bwd {shape} {name}: a second launch gave "
                  "other bits")
            want = ssd.ssd_scan_bwd.plain(*args, dy, dhf, chunk=chunk)
            for g, a, b in zip(SSD_GRADS, got, want):
                err[name][g] = max(err[name][g], gate(
                    torch, a, b, f"ssd_scan_bwd {shape} {name} {g}"))
            del args, dy, dhf, scratch, got, again, want
            torch.cuda.empty_cache()
    return err, len(SSD_BWD_CASES) * len(err)


def fa_inputs(torch, shape, dtype, seed, dev, layout=None):
    """q, k, v of a flash_attention call, N(0, 1) in ``dtype``.

    ``layout`` lays them out as the model passes them: ``"self"`` as a
    prefill's self-attention (``attention._qkv``: heads split out of (B,
    S, H·D) projections, q and k through ``apply_rope`` at positions
    0..S−1, v the strided view itself; needs Sq = Skv), ``"cross"`` as
    the encdec cross-attention (q such a view, not roped; k and v
    contiguous, as slices of the cross cache)."""
    B, Hq, Hkv, Sq, Skv, D, _ = shape
    g = torch.Generator(device=dev).manual_seed(seed)
    if layout is None:
        return tuple(torch.randn(s, generator=g, device=dev).to(dtype)
                     for s in ((B, Hq, Sq, D), (B, Hkv, Skv, D),
                               (B, Hkv, Skv, D)))

    def heads(S, H):
        return torch.randn((B, S, H * D), generator=g, device=dev).to(
            dtype).reshape(B, S, H, D).transpose(1, 2)
    if layout == "cross":
        return (heads(Sq, Hq), *(heads(Skv, Hkv).contiguous()
                                 for _ in range(2)))
    from repro_torch.models import layers as L
    pos = torch.arange(Sq, device=dev).expand(B, Sq)
    q, k, v = heads(Sq, Hq), heads(Sq, Hkv), heads(Sq, Hkv)
    return L.apply_rope(q, pos), L.apply_rope(k, pos), v


def fa_gate(torch, got, want, what):
    """The kernel gate: ``got`` finite, of ``want``'s dtype and shape, and
    within 2e-5 of it (bf16: plus 2 bf16 ulps of each element); returns
    max |got − want|."""
    check(got.dtype == want.dtype and got.shape == want.shape,
          f"flash_attention {what}: {got.dtype}{tuple(got.shape)} vs "
          f"{want.dtype}{tuple(want.shape)}")
    gf, wf = got.float(), want.float()
    check(bool(torch.isfinite(gf).all()),
          f"flash_attention {what}: non-finite output")
    dy = (gf - wf).abs()
    tol = torch.full_like(wf, 2e-5)
    if got.dtype == torch.bfloat16:
        tol += 2 * torch.exp2(torch.floor(torch.log2(
            wf.abs().clamp_min(2.0 ** -126))) - 7)
    check(bool((dy <= tol).all()), f"flash_attention {what} differs from "
          f"its plain version: max |dy| {float(dy.max())}")
    return float(dy.max())


def fa_sweep(torch, fa, dev):
    """flash_attention against its plain version over the sweep: fp32
    within 2e-5 (``tests/test_kernels.py``'s tolerance), bf16 within 2
    bf16 ulps of each element plus that; finite, and a second launch
    bitwise.  A causal call with Sq > Skv must raise."""
    err = {"float32": 0.0, "bfloat16": 0.0}
    cases = [(shape, None) for shape in FA_SWEEP] + FA_MODEL
    for i, (shape, layout) in enumerate(cases):
        causal = shape[-1]
        for name in err:
            q, k, v = fa_inputs(torch, shape, getattr(torch, name), i, dev,
                                layout)
            got = fa.flash_attention(q, k, v, causal=causal)
            again = fa.flash_attention(q, k, v, causal=causal)
            check(torch.equal(got, again), f"flash_attention {shape} {name}: "
                  "a second launch gave other bits")
            want = fa.flash_attention.plain(q, k, v, causal=causal)
            err[name] = max(err[name], fa_gate(
                torch, got, want, f"{shape} {name} {layout}"))
            del q, k, v, got, again, want
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
        if timed == "all":          # beside the plain version and the
            idx64 = idx.to(torch.int64)   # library's (a full bucket)
            times[key + " plain"] = round(graph_ms(
                torch, lambda: fp.gather_rows.plain(src, idx)), 4)
            times[key + " index_select"] = round(graph_ms(
                torch, lambda: torch.index_select(src, 0, idx64)), 4)
        del src, vals, base, got

    n, m = FIG1D["n"], FIG1D["m"]
    for K in GATHER_KS:                     # pack_columns on Aᵀ at fig1d
        case(n, m, K, K, torch.float32, K, timed=True)
    # a padded bucket, as the path packs it (zero rows past the support)
    case(n, m, PADDED_K_VALID, GATHER_KS[-1], torch.float32, 9, timed=True)
    case(n, 1, VECTOR_K, VECTOR_K, torch.float32, 1)   # the (n, 1) vectors
    case(n, 1, VECTOR_K * 5 // 8, VECTOR_K, torch.float32, 2)   # padding
    # the compacted group path: Aᵀ's blocks of bs·m floats, the C = 5
    # vectors (the scatter's general form), each full and padded
    rows, C, K = GROUP_GATHER
    case(rows, C, K, K, torch.float32, 11, timed="all")
    case(rows, C, K * 5 // 8, K, torch.float32, 12)
    rows, C, K = GROUP_VECTOR
    case(rows, C, K, K, torch.float32, 13)
    case(rows, C, K * 5 // 8, K, torch.float32, 14)
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
    err["ssd_scan_bwd"], n_ssd_bwd = ssd_bwd_sweep(torch, ssd, dev)
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
        ssd_scan_max_abs_err_y_h=ssd_err, ssd_scan_bwd_cases=n_ssd_bwd,
        ssd_scan_bwd_max_abs_err=err["ssd_scan_bwd"],
        best_response_cases=n_br,
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
    kkt = max_zero_block_kkt(get_family("lasso"), p, r)
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

    from repro_torch.path.grid import geometric_grid, lambda_max

    p = nesterov_instance(**FIG1B, device=dev)
    client = FlexaClient(solver=SolverConfig(tol=1e-7, max_iters=20000,
                                             tau_adapt=False))
    grid = geometric_grid(lambda_max(p), n_points=10,
                          lam_min_ratio=0.05)[:COMPACT_POINTS]
    runs, secs = {}, {}
    for compact in (True, False):
        t = time.perf_counter()
        runs[compact] = client.run(PathSpec(problem=p, lambdas=grid,
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
    say("compact", instance="fig1b", points=f"the first {COMPACT_POINTS} "
        "of 10 to 0.05 λ_max", lambdas=[float(v) for v in grid],
        max_abs_dx=dx,
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
    # Row 0 runs its instance's own closures and column-norm reduction
    # (``problems.lasso.stacked_fns``), so under either rule it follows
    # the solo trajectory bit for bit (max |dx| 0.0 on the H100).  One
    # batched product over the stack would sum in another order, and the
    # greedy ρ-rule, which compares E against ρ·max E, would then select
    # a coordinate whose E lies within rounding of the threshold in one
    # run and not in the other (max |dx| 0.0102 after 300 iterations);
    # so greedy holds row 0 to the solo run's V within 1e-3.
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


FAMILY_NAMES = ("group_lasso", "logreg", "svm")
NEWTON = dict(surrogate="newton_cg", inexact_alpha1=0.5)


def family_instance(family, spec, device, seed=None):
    """``family``'s generated instance at ``spec``'s dimensions and seed on
    ``device``: the planted group Lasso at c = 1, logreg and svm at their
    generators' default weight."""
    from repro_torch.problems.group_lasso import nesterov_group_instance
    from repro_torch.problems.logreg import random_logreg_instance
    from repro_torch.problems.svm import random_svm_instance

    m, n, bs = spec["m"], spec["n"], spec["block_size"]
    seed = spec["seed"] if seed is None else seed
    if family == "group_lasso":
        return nesterov_group_instance(m, n // bs, bs, spec["nnz_frac"],
                                       c=1.0, seed=seed, device=device)
    make = random_logreg_instance if family == "logreg" \
        else random_svm_instance
    return make(m, n, spec["nnz_frac"], seed=seed, device=device)


def at_lam_frac(p, frac):
    """``p`` at c = ``frac`` · λ_max (``path.grid.lambda_max``), and λ_max:
    the generators' c = 0.5 barely regularises at m = 5000."""
    import dataclasses
    from repro_torch.path.grid import lambda_max

    lam = lambda_max(p)
    return dataclasses.replace(p, g_weight=frac * lam), lam


def max_zero_block_kkt(fam, p, r):
    """Largest (score − λ)/λ over the zero blocks of every path point."""
    from repro_torch.path.driver import _problem_at
    from repro_torch.path.screening import block_scores

    kkt = 0.0
    for k, lam in enumerate(r.lambdas):
        s = block_scores(fam, _problem_at(p, float(lam)), r.x[k])
        zero = np.linalg.norm(r.x[k].reshape(p.n_blocks, p.block_size),
                              axis=-1) == 0
        if zero.any():
            kkt = max(kkt, float((s[zero] - lam).max() / lam))
    return kkt


def families_solo(torch, fp, probs, dev):
    """500 iterations per family through ``SoloSpec`` (group Lasso also
    under ``newton_cg``'s inexact loop); the logreg solve once more under
    the profiler; one full-size logreg and svm iteration's kernels
    against their plain versions."""
    from repro_torch.client import FlexaClient, SoloSpec
    from repro_torch.config.base import SolverConfig
    from repro_torch.core import flexa, surrogate

    F = FAMILIES
    iters = F["iters"]
    br = fp.batched_best_response
    out = {}
    for fam, extra in (("group_lasso", {}), ("group_lasso", NEWTON),
                       ("logreg", {}), ("svm", {})):
        p = probs[fam]
        name = fam + ("_newton_cg" if extra else "")
        cfg = SolverConfig(max_iters=iters, tol=-1.0, **extra)
        v0 = float(p.v(torch.zeros(p.n, device=dev)))
        last = {}

        def keep(it, state, info):
            last["cert"] = info["inexact_cert"]

        br.launches = 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = FlexaClient(solver=cfg).run(SoloSpec(
            problem=p, method="flexa", options={"callback": keep}))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches = br.launches
        want = 0 if fam == "group_lasso" else iters
        check(r.iters == iters, f"families {name}: {r.iters} iterations")
        check(launches == want, f"families {name}: batched_best_response "
              f"launched {launches} times, want {want}")
        x = torch.as_tensor(r.x, device=dev)
        v = float(p.v(x))
        check(math.isfinite(v) and v < v0,
              f"families {name}: V {v}, V at x = 0 {v0}")
        o = {"ms_per_iter": wall / iters * 1e3, "V0": v0, "V": v,
             "stationarity": float(p.stationarity(x)),
             "batched_best_response_launches": launches}
        if fam == "logreg":
            o["profiled"] = families_profiled(torch, fp, p, cfg)
        if fam == "group_lasso":
            o["V_rel_err"] = (v - p.v_star) / p.v_star
            o["inexact_cert_last"] = float(last["cert"])
        else:
            # one full-size iteration's S.2 and S.4 (full rule) at the
            # solve's x: the kernels against their plain versions
            tau = flexa._base_tau(p, cfg)
            g1 = p.grad_f(x)
            d1 = surrogate.curvature(p, tau, cfg.surrogate)
            rows = (x[None], g1[None], d1[None], p.g_weight)
            z, _ = fp.batched_best_response(*rows)
            equal_or_fail(torch, "batched_best_response", z,
                          fp.batched_best_response.plain(*rows)[0],
                          f"{fam} iteration")
            equal_or_fail(torch, "batched_best_response",
                          surrogate.best_response(p, x, g1, d1)[None], z,
                          f"{fam} iteration, through the chain")
            gamma = r.raw.state.gamma
            equal_or_fail(torch, "batched_apply_update",
                          fp.batched_apply_update(*rows, gamma),
                          fp.batched_apply_update.plain(*rows, gamma),
                          f"{fam} iteration")
            o["iteration_kernels_vs_plain"] = "bitwise"
        out[name] = o
        print(f"families solo {name}: " + json.dumps(o), flush=True)
    return out


def families_profiled(torch, fp, p, cfg):
    """The logreg solve once more under the profiler: its
    ``batched_best_response`` records must equal the counter.  The
    profiler can lose a device record (ROADMAP Queue 3, measurement): a
    profile short of the counter is printed in ``short_profiles`` and the
    solve profiled again, PROFILE_ATTEMPTS in all."""
    from repro_torch.client import FlexaClient, SoloSpec

    br = fp.batched_best_response
    names = {"batched_best_response": KERNEL_NAMES["batched_best_response"]}
    short = []
    for attempt in range(PROFILE_ATTEMPTS):
        br.launches = 0
        torch.cuda.synchronize()
        with profiled(torch) as prof:
            t = time.perf_counter()
            FlexaClient(solver=cfg).run(SoloSpec(problem=p, method="flexa"))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        per_kernel, busy = device_kernels(torch, prof, names)
        got, ms = per_kernel["batched_best_response"]
        if got == br.launches:
            break
        short.append({"profiler": got, "counter": br.launches,
                      "window_edges_ms": window_edges(torch, prof)[0]})
        del prof
    check(got == br.launches == cfg.max_iters,
          f"families logreg: profiler {got}, counter {br.launches}, "
          f"short profiles {short}")
    return {"batched_best_response": [got, round(ms, 4)],
            "device_busy_share": busy[1] / (wall * 1e3),
            "short_profiles": short}


def families_jacobi(torch, fp, p):
    """Logreg under the full rule: S.2 and S.4 are one launch each of the
    batched kernels per iteration."""
    from repro_torch.client import FlexaClient, SoloSpec
    from repro_torch.config.base import SolverConfig

    iters = FAMILIES["jacobi_iters"]
    br, ap = fp.batched_best_response, fp.batched_apply_update
    br.launches = ap.launches = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    r = FlexaClient(solver=SolverConfig(max_iters=iters, tol=-1.0,
                                        jacobi=True)).run(
        SoloSpec(problem=p, method="flexa"))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = {"batched_best_response": br.launches,
                "batched_apply_update": ap.launches}
    check(launches == {k: iters for k in launches},
          f"families jacobi: launches {launches} in {iters} iterations")
    V = r.history["V"]
    check(r.iters == iters and all(math.isfinite(v) for v in V),
          f"families jacobi: {r.iters} iterations, V {V[-1]}")
    return {"iters": iters, "ms_per_iter": wall / iters * 1e3,
            "V_first": V[0], "V": V[-1], "launches": launches}


def families_paths(torch, fp, probs):
    """The compacted λ-paths of group Lasso and logreg, each with the
    kernels' counters set to 0 just before it and read just after."""
    from repro_torch.client import FlexaClient, PathSpec
    from repro_torch.config.base import SolverConfig
    from repro_torch.problems.families import get_family

    F = FAMILIES
    gather, scatter = fp.gather_rows, fp.scatter_rows
    br = fp.batched_best_response
    client = FlexaClient(solver=SolverConfig(tol=F["path_tol"],
                                             max_iters=20000))
    out = {}
    for fam, ratio in (("group_lasso", 0.15), ("logreg", 0.1)):
        p = probs[fam]
        gather.launches = scatter.launches = br.launches = 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = client.run(PathSpec(problem=p, n_points=F["path_points"],
                                lam_min_ratio=ratio, compact=True))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches = {"gather_rows": gather.launches,
                    "scatter_rows": scatter.launches,
                    "batched_best_response": br.launches}
        check(bool(r.converged.all()),
              f"families path {fam}: converged {r.converged.tolist()}")
        check(launches["gather_rows"] > 0 and launches["scatter_rows"] > 0,
              f"families path {fam}: launches {launches}")
        solves = sum(rep.kkt_rounds + 1
                     for rep, it in zip(r.screened, r.iters) if it > 0)
        if fam == "group_lasso":        # the group prox is plain torch
            check(launches["batched_best_response"] == 0,
                  f"families path {fam}: launches {launches}")
        else:                           # one S.2 per solver iteration
            check(r.row_iters <= launches["batched_best_response"]
                  <= r.row_iters + 15 * solves,
                  f"families path {fam}: batched_best_response launched "
                  f"{launches['batched_best_response']} times for "
                  f"{r.row_iters} iterations in {solves} solves")
        kkt = max_zero_block_kkt(get_family(fam), p, r)
        check(kkt <= 1e-3, f"families path {fam}: KKT on zero blocks {kkt}")
        out[fam] = {
            "wall_s": round(wall, 3), "points": F["path_points"],
            "lam_min_ratio": ratio, "lam_max": r.lam_max,
            "row_iters": r.row_iters, "solves": solves,
            "iters": [int(i) for i in r.iters],
            "support": [int(s) for s in r.support],
            "program_widths": r.meta["program_widths"],
            "kkt_rounds": [rep.kkt_rounds for rep in r.screened],
            "kkt_violations": [rep.violations for rep in r.screened],
            "max_zero_block_kkt": kkt, "launches": launches}
        print(f"families path {fam}: " + json.dumps(out[fam]), flush=True)
    return out


def families_card_vs_cpu(torch, dev):
    """Each family at fig1b's dimensions, 100 Jacobi iterations at fixed
    τ⁰ = L_F / 2 on the card and on the CPU from the same instance (the
    default τ with fixed τ diverges under Jacobi)."""
    from repro_torch.client import FlexaClient, SoloSpec
    from repro_torch.config.base import SolverConfig

    C = FAMILIES_CHECK
    out = {}
    for fam in FAMILY_NAMES:
        p = family_instance(fam, C, "cpu")
        if fam != "group_lasso":
            p, _ = at_lam_frac(p, FAMILIES["lam_frac"])
        cfg = SolverConfig(max_iters=C["iters"], tol=-1.0, tau_adapt=False,
                           jacobi=True, tau0=p.lipschitz / 2)
        rc = FlexaClient(device="cpu", solver=cfg).run(SoloSpec(problem=p))
        rg = FlexaClient(device=dev, solver=cfg).run(SoloSpec(problem=p))
        dx = float(abs(rg.x - rc.x).max())
        vc, vg = rc.history["V"][-1], rg.history["V"][-1]
        v_rel = abs(vg - vc) / abs(vc)
        check(dx <= 1e-4 and v_rel <= 1e-5 and math.isfinite(vg),
              f"families card vs cpu {fam}: max |dx| {dx}, V rel {v_rel}")
        out[fam] = {"max_dx": dx, "V_rel": v_rel, "V": vg}
    return out


def families_batch(torch, fp, dev):
    """A logreg ``BatchSpec`` of fig1b instances (seeds 0..B−1), greedy at
    fixed τ⁰ = max L_F / 2, against a ``SoloSpec`` of seed 0."""
    from repro_torch.client import BatchSpec, FlexaClient, SoloSpec
    from repro_torch.config.base import SolverConfig

    B, iters = FAMILIES_BATCH["B"], FAMILIES_BATCH["iters"]
    probs = [at_lam_frac(family_instance("logreg", FAMILIES_CHECK, dev,
                                         seed=s), FAMILIES["lam_frac"])[0]
             for s in range(B)]
    cfg = SolverConfig(max_iters=iters, tol=-1.0, tau_adapt=False,
                       tau0=max(p.lipschitz for p in probs) / 2)
    client = FlexaClient(solver=cfg)
    br = fp.batched_best_response
    br.launches = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    rb = client.run(BatchSpec(problems=probs))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = br.launches
    check(launches == iters, f"families batch: batched_best_response "
          f"launched {launches} times in {iters} iterations")
    V = [float(p.v(torch.as_tensor(rb.x[i], device=dev)))
         for i, p in enumerate(probs)]
    solo = client.run(SoloSpec(problem=probs[0], method="flexa"))
    v_solo = float(probs[0].v(torch.as_tensor(solo.x, device=dev)))
    v_rel = abs(V[0] - v_solo) / abs(v_solo)
    check(all(math.isfinite(v) for v in V) and v_rel <= 1e-3,
          f"families batch: V {V}, row 0 vs SoloSpec V rel {v_rel}")
    return {"instances": B, "iters": iters, "wall_s": round(wall, 3),
            "ms_per_iter": wall / iters * 1e3, "V": V,
            "row0_vs_solo_V_rel": v_rel,
            "row0_vs_solo_max_dx": float(abs(solo.x - rb.x[0]).max()),
            "batched_best_response_launches": launches}


def phase_families(torch, fp, dev):
    """Slice 15's main path: the group-Lasso, logreg and svm families at
    fig1d's dimensions through the client (see the module docstring)."""
    from concurrent.futures import ThreadPoolExecutor

    F = FAMILIES
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    with ThreadPoolExecutor(F["gen_threads"]) as ex:
        made = list(ex.map(lambda f: family_instance(f, F, dev),
                           FAMILY_NAMES))
    probs = dict(zip(FAMILY_NAMES, made))
    del made
    lam_max = {}
    for fam in ("logreg", "svm"):
        probs[fam], lam_max[fam] = at_lam_frac(probs[fam], F["lam_frac"])
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t
    print(f"families: instances generated in {gen_s:.2f} s, λ_max "
          f"{lam_max}", flush=True)
    t = time.perf_counter()
    solo = families_solo(torch, fp, probs, dev)
    jacobi = families_jacobi(torch, fp, probs["logreg"])
    paths = families_paths(torch, fp, probs)
    del probs
    torch.cuda.empty_cache()
    card_vs_cpu = families_card_vs_cpu(torch, dev)
    batch = families_batch(torch, fp, dev)
    peak = torch.cuda.max_memory_allocated()
    torch.cuda.empty_cache()
    say("families", instance="fig1d dims, seed 0", m=F["m"], n=F["n"],
        block_size=F["block_size"], nnz_frac=F["nnz_frac"],
        gen_s=round(gen_s, 2), lam_frac=F["lam_frac"], lam_max=lam_max,
        two_gemv_bound_ms=bytes_ms(2 * F["m"] * F["n"] * 4),
        solo=solo, jacobi_logreg=jacobi, paths=paths,
        card_vs_cpu_fig1b=card_vs_cpu, batch_logreg_fig1b=batch,
        peak_memory_gib=round(peak / 2 ** 30, 3),
        run_s=round(time.perf_counter() - t + gen_s, 2))


# ------------------------------------------------------ solver serving
def heavy_tail_trace(n, *, mean_gap, seed, tail_alpha):
    """A copy of ``benchmarks/serve_load.py:poisson_trace(..., difficulty=
    "pareto")`` (the bench imports the JAX package): exponential gaps of
    ``mean_gap`` slab-iteration units, Pareto-II difficulty in [0, 1]
    (mostly easy, a few near the cap).  [(arrival, difficulty, seed)]."""
    rng = np.random.default_rng(seed)
    arrivals = np.cumsum(rng.exponential(mean_gap, size=n))
    diff = np.minimum(rng.pareto(tail_alpha, size=n) / 8.0, 1.0)
    return [(float(a), float(d), seed * 1000 + i)
            for i, (a, d) in enumerate(zip(arrivals, diff))]


def serve_instance(item, dev):
    """The trace item's Nesterov Lasso at fig1b's dimensions: difficulty
    d → nnz 0.05 + 0.13·d (``serve_load.py:build_instance``)."""
    from repro_torch.problems.lasso import nesterov_instance
    lo, hi = SOLVER_SERVE["nnz"]
    return nesterov_instance(m=SOLVER_SERVE["m"], n=SOLVER_SERVE["n"],
                             nnz_frac=lo + (hi - lo) * item[1], c=1.0,
                             seed=item[2], device=dev)


class SimClock:
    """``perf_counter`` plus an offset that jumps over idle gaps
    (``serve_load.py:SimClock``): arrivals replay at their trace times."""

    def __init__(self):
        self.offset = -time.perf_counter()

    def __call__(self):
        return time.perf_counter() + self.offset

    def advance_to(self, t):
        if t > self():
            self.offset += t - self()


def serve_replay(torch, backend, trace, probs, cfg, serve, unit):
    """Replay ``trace`` (arrivals in slab-iteration units × ``unit`` s)
    through ``FlexaClient(backend=...)``: submit what has arrived, step,
    drain (``serve_load.py:replay_continuous``).  Returns the client, the
    results in trace order, the telemetry and each step's wall."""
    from repro_torch.client import FlexaClient, SoloSpec
    from repro_torch.serve.metrics import ServeTelemetry

    clock = SimClock()
    tele = ServeTelemetry(clock=clock)
    client = FlexaClient(backend=backend, solver=cfg, serve=serve,
                         telemetry=tele)
    tickets, walls, i = [], [], 0
    while i < len(trace) or client.pending:
        if i < len(trace) and not client.pending:
            clock.advance_to(trace[i][0] * unit)
        now = clock()
        while i < len(trace) and trace[i][0] * unit <= now:
            tickets.append(client.submit(SoloSpec(problem=probs[i]),
                                         arrival=trace[i][0] * unit))
            i += 1
        if client.pending:
            t = time.perf_counter()
            client.step()
            walls.append(time.perf_counter() - t)
    done = client.drain()
    return client, [done[t] for t in tickets], tele, walls


def serve_summary(tele, walls, side):
    """The replay's end-to-end numbers from its telemetry."""
    snap = tele.snapshot()
    reqs = tele.requests.values()
    makespan = max(r.completed for r in reqs) - min(r.arrival for r in reqs)
    s = snap[side]
    out = {"makespan_s": round(makespan, 4),
           "requests_per_s": round(snap["completed"] / makespan, 4),
           "latency_p50_s": round(snap["latency_p50"], 4),
           "latency_p99_s": round(snap["latency_p99"], 4),
           "queue_wait_p99_s": round(snap["queue_wait_p99"], 4),
           "steps": len(walls),
           "median_step_ms": round(float(np.median(walls)) * 1e3, 3),
           "row_iters": s["row_iters"],
           "occupancy_mean": round(s["occupancy_mean"], 4),
           "padding_waste": round(s["padding_waste"], 4),
           "converged": snap["converged"], "iters_total": snap["iters_total"]}
    if side == "continuous":
        out.update(live_iters=s["live_iters"], chunks=s["chunks"],
                   admitted_rows=s["admitted_rows"],
                   admit_copy_ms_per_row=round(
                       s["admit_copy_s"] / s["admitted_rows"] * 1e3, 3))
    else:
        out.update(waves=s["waves"], freeze_waste=round(s["freeze_waste"],
                                                        4))
    return out


def solo_runs(cfg, probs):
    """Each problem's ``SoloSpec`` on the card under the device-resident
    driver (``flexa_compiled``: the solo iteration of ``flexa``, its stop
    flag read every 16 iterations, a finished solve frozen — the same
    bits and iterations, without a host read per iteration)."""
    from repro_torch.client import FlexaClient, SoloSpec
    client = FlexaClient(solver=cfg)
    return [client.run(SoloSpec(problem=p, method="flexa_compiled"))
            for p in probs]


def same_as_solo(name, results, solos):
    """Every served result equals its solo run bit for bit (x, iterations,
    convergence); returns the largest |dx| (0.0 when it holds)."""
    worst = 0.0
    for j, (r, s) in enumerate(zip(results, solos)):
        dx = float(np.abs(r.x - s.x).max())
        worst = max(worst, dx if math.isfinite(dx) else math.inf)
        check(r.x.tobytes() == s.x.tobytes() and r.iters == s.iters
              and r.converged == s.converged and r.status == "ok",
              f"{name} request {j}: max |dx| {dx}, iters {r.iters} vs "
              f"{s.iters}, converged {r.converged} vs {s.converged}, "
              f"status {r.status}")
    return worst


def serve_warm_up(torch, fp, probs, cfg, serve):
    """Untimed warm-up of both backends on the first slab's worth of
    requests (10000 iterations, never stopping), the calibration of the
    slab-iteration unit (median of 3 warm chunks over ``chunk_iters``,
    as ``serve_load.py:calibrate_unit``), and one chunk under the
    profiler: its ``batched_best_response`` records equal the counter's
    ``chunk_iters`` (a short profile printed and the chunk profiled
    again, PROFILE_ATTEMPTS in all)."""
    import dataclasses
    from repro_torch.client import FlexaClient, SoloSpec

    S, K = serve.slab_capacity, serve.chunk_iters
    probe = dataclasses.replace(cfg, max_iters=10_000, tol=-1.0)
    client = FlexaClient(backend="continuous", solver=probe, serve=serve)
    for p in probs[:S]:
        client.submit(SoloSpec(problem=p))
    client.step()
    client.step()
    walls = []
    for _ in range(3):
        t = time.perf_counter()
        client.step()
        walls.append(time.perf_counter() - t)
    unit = float(np.median(walls)) / K
    br = fp.batched_best_response
    names = {"batched_best_response": KERNEL_NAMES["batched_best_response"]}
    short = []
    for _ in range(PROFILE_ATTEMPTS):
        br.launches = 0
        with profiled(torch) as prof:
            t = time.perf_counter()
            client.step()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        per_kernel, busy = device_kernels(torch, prof, names)
        got, ms = per_kernel["batched_best_response"]
        if got == br.launches:
            break
        short.append({"profiler": got, "counter": br.launches,
                      "window_edges_ms": window_edges(torch, prof)[0]})
    check(got == br.launches == K, f"solver_serve: profiled chunk: "
          f"profiler {got}, counter {br.launches}, want {K}; short "
          f"profiles {short}")
    chunk = {"wall_ms": round(wall * 1e3, 3),
             "device_ms": round(busy[1], 3), "device_records": busy[0],
             "busy_share": round(busy[1] / (wall * 1e3), 4),
             "batched_best_response": [got, round(ms, 4)],
             "classes": device_classes(torch, prof),
             "top": top_kernels(torch, prof, n=8),
             "short_profiles": short}
    del prof, client
    wave = FlexaClient(backend="wave", solver=dataclasses.replace(
        cfg, max_iters=32, tol=-1.0), serve=serve)
    wave.run(SoloSpec(problem=probs[0]))
    torch.cuda.synchronize()
    return unit, chunk


def serve_second_signature(torch, fp, probs, solos, cfg, serve, dev):
    """4 logreg requests at the same (m, n) (c = 0.1 λ_max) submitted
    among the Lasso trace's first 8, ``slabs_per_tick = 1``: two slabs,
    each tick services one in rotation; both are serviced from the first
    ticks and every response equals its solo run bit for bit."""
    import dataclasses
    from repro_torch.client import FlexaClient, SoloSpec
    from repro_torch.problems.logreg import random_logreg_instance

    F = SOLVER_SERVE
    lr = [at_lam_frac(random_logreg_instance(
        F["m"], F["n"], F["nnz"][0], seed=s, device=dev),
        F["logreg_lam_frac"])[0] for s in range(F["logreg"])]
    lr_solos = solo_runs(cfg, lr)
    client = FlexaClient(backend="continuous", solver=cfg,
                         serve=dataclasses.replace(serve, slabs_per_tick=1))
    probs, solos = probs[:8], solos[:8]
    every = len(probs) // len(lr)       # a logreg after every 2 Lassos
    order = []
    for i, p in enumerate(probs):
        order.append(("lasso", i, client.submit(SoloSpec(problem=p))))
        j, rest = divmod(i + 1, every)
        if rest == 0 and j <= len(lr):
            order.append(("logreg", j - 1,
                          client.submit(SoloSpec(problem=lr[j - 1]))))
    t = time.perf_counter()
    done = client.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    eng = client._backend._engine()
    check(len(eng._slabs) == 2, f"solver_serve logreg: {len(eng._slabs)} "
          "slabs")
    first = {}
    for rec in eng.audit:
        first.setdefault(rec["signature"], rec["admit_tick"])
    check(len(first) == 2 and max(first.values()) <= 2,
          f"solver_serve logreg: first admissions {first}")
    check(eng.telemetry.chunks <= eng._tick, "solver_serve logreg: more "
          "chunks than ticks under slabs_per_tick = 1")
    lr_res = [done[t] for kind, _, t in order if kind == "logreg"]
    same_as_solo("solver_serve logreg", lr_res, lr_solos)
    same_as_solo("solver_serve logreg's lasso",
                 [done[t] for kind, _, t in order if kind == "lasso"], solos)
    return {"wall_s": round(wall, 3), "ticks": eng._tick,
            "chunks": eng.telemetry.chunks, "first_admit_tick": first,
            "logreg_iters": [r.iters for r in lr_res],
            "logreg_converged": [r.converged for r in lr_res]}


def serve_jacobi(torch, fp, probs, serve):
    """8 Lasso requests under the full rule, no masks, 200 iterations at
    fixed τ⁰ = max L_F / 2: S.4 is ``batched_apply_update`` once per slab
    iteration (chunks × chunk_iters, by counter: 200 at chunks of 100),
    and every row equals its solo run bit for bit."""
    from repro_torch.client import FlexaClient, SoloSpec
    from repro_torch.config.base import SolverConfig

    F = SOLVER_SERVE
    ps = probs[:F["jacobi"]]
    cfg = SolverConfig(jacobi=True, tol=-1.0, max_iters=F["jacobi_iters"],
                       tau_adapt=False, tau0=max(p.lipschitz for p in ps) / 2)
    solos = solo_runs(cfg, ps)
    client = FlexaClient(backend="continuous", solver=cfg, serve=serve)
    br, ap = fp.batched_best_response, fp.batched_apply_update
    br.launches = ap.launches = 0
    tickets = [client.submit(SoloSpec(problem=p)) for p in ps]
    done = client.drain()
    launches = {"batched_best_response": br.launches,
                "batched_apply_update": ap.launches}
    # one launch of each per slab iteration: chunks × chunk_iters
    want = client.telemetry.chunks * serve.chunk_iters
    check(want >= F["jacobi_iters"] and launches == {
        "batched_best_response": want, "batched_apply_update": want},
        f"solver_serve jacobi: launches {launches}, want {want} each")
    same_as_solo("solver_serve jacobi", [done[t] for t in tickets], solos)
    return launches


def serve_path(torch, dev, cfg, serve):
    """A served λ-path: ``PathSpec`` (8 points to 0.1 λ_max) on
    ``backend="continuous"`` (``ContinuousSolverEngine.submit_path``)
    against the inline ``PathSpec`` on the card, at fig1b's dimensions
    and the trace's easiest density (nnz 0.05: fig1b's own 10 % needs
    more than ``max_iters`` at 0.14 λ_max)."""
    from repro_torch.client import FlexaClient, PathSpec
    from repro_torch.problems.lasso import nesterov_instance

    F = SOLVER_SERVE
    p = nesterov_instance(m=F["m"], n=F["n"], nnz_frac=F["nnz"][0], c=1.0,
                          seed=0, device=dev)
    spec = PathSpec(problem=p, n_points=F["path_points"],
                    lam_min_ratio=F["path_ratio"])
    out = {}
    for backend in ("continuous", "inline"):
        t = time.perf_counter()
        out[backend] = FlexaClient(backend=backend, solver=cfg,
                                   serve=serve).run(spec)
        torch.cuda.synchronize()
        out[backend + "_s"] = round(time.perf_counter() - t, 3)
    s, i = out["continuous"], out["inline"]
    dx = float(np.abs(s.x - i.x).max())
    check(dx <= 1e-5, f"solver_serve path: max |dx| {dx}")
    check(bool((s.support == i.support).all()),
          f"solver_serve path: supports {s.support} vs {i.support}")
    check(bool(s.converged.all() and i.converged.all()),
          f"solver_serve path: converged {s.converged}, {i.converged}")
    return {"max_abs_dx": dx, "support": s.support.tolist(),
            "iters_served": s.iters.tolist(),
            "iters_inline": i.iters.tolist(),
            "kkt_rounds": [r.kkt_rounds for r in s.screened],
            "served_s": out["continuous_s"], "inline_s": out["inline_s"]}


def serve_watchdog_and_drain(torch, cfg, serve, dev):
    """8 easy requests (difficulty 0) with the watchdog on and off:
    bitwise the same, nothing quarantined.  The same 8 with
    ``compact_drain`` on: bitwise the fixed-capacity (watchdog-off) run,
    the slab migrated at least once."""
    import dataclasses
    from repro_torch.client import FlexaClient, SoloSpec

    def run(ps, **kw):
        client = FlexaClient(backend="continuous", solver=cfg,
                             serve=dataclasses.replace(serve, **kw))
        tickets = [client.submit(SoloSpec(problem=p)) for p in ps]
        t = time.perf_counter()
        done = client.drain()
        torch.cuda.synchronize()
        return ([done[k] for k in tickets], client.telemetry,
                client._backend._engine(), time.perf_counter() - t)

    easy = [serve_instance((0.0, 0.0, 900_000 + i), dev) for i in range(8)]
    on, tele_on, eng_on, on_s = run(easy, watchdog=True)
    off, _, _, off_s = run(easy)
    check(not eng_on.failures and "health" not in tele_on.snapshot(),
          f"solver_serve watchdog: failures {eng_on.failures}")
    same_as_solo("solver_serve watchdog on vs off", on, off)
    fixed, fixed_s = off, off_s
    moved, tele, eng, moved_s = run(easy, compact_drain=True)
    check(tele.migrations > 0, "solver_serve drain tail: no migration")
    same_as_solo("solver_serve drain tail vs fixed capacity", moved, fixed)
    trail = [(r["req_id"], [(m["from_capacity"], m["to_capacity"])
                            for m in r["migrations"]])
             for r in eng.audit if r.get("migrations")]
    return {"watchdog": {"on_s": round(on_s, 3), "off_s": round(off_s, 3),
                         "iters": [r.iters for r in on]},
            "drain_tail": {"migrations": tele.migrations, "trail": trail,
                           "compact_s": round(moved_s, 3),
                           "fixed_s": round(fixed_s, 3),
                           "buckets": [r.raw.bucket for r in moved]}}


def phase_solver_serve(torch, fp, dev):
    """Slice 16's main path: solver serving through ``FlexaClient(backend=
    "continuous" | "wave")`` on a heavy-tail trace of fig1b Lassos (see
    the module docstring).  Returns the launches of the batched kernels
    on this path."""
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.config.base import ServeConfig, SolverConfig
    from repro_torch.core.flexa import CHECK_EVERY

    F = SOLVER_SERVE
    t_phase = time.perf_counter()
    cfg = SolverConfig(**SERVE_SOLVER)
    serve = ServeConfig(**SERVE_SLABS)
    K = serve.chunk_iters
    trace = heavy_tail_trace(F["requests"], mean_gap=F["mean_gap"],
                             seed=F["seed"], tail_alpha=F["tail_alpha"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    with ThreadPoolExecutor(F["gen_threads"]) as ex:
        probs = list(ex.map(lambda it: serve_instance(it, dev), trace))
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t
    t = time.perf_counter()
    solos = solo_runs(cfg, probs)
    torch.cuda.synchronize()
    solo_s = time.perf_counter() - t
    unit, chunk = serve_warm_up(torch, fp, probs, cfg, serve)
    print(f"solver_serve: {len(probs)} instances in {gen_s:.2f} s, solo "
          f"checks {solo_s:.2f} s, unit {unit * 1e3:.4f} ms, profiled "
          "chunk " + json.dumps(chunk), flush=True)
    br, ap = fp.batched_best_response, fp.batched_apply_update
    out, launches = {}, {}
    for backend in ("continuous", "wave"):
        br.launches = ap.launches = 0
        client, results, tele, walls = serve_replay(
            torch, backend, trace, probs, cfg, serve, unit)
        launches[backend] = {"batched_best_response": br.launches,
                             "batched_apply_update": ap.launches}
        side = backend
        out[backend] = serve_summary(tele, walls, side)
        out[backend]["max_abs_dx_vs_solo"] = same_as_solo(
            f"solver_serve {backend}", results, solos)
        done = [r.req_id for r in tele.requests.values()
                if r.completed is not None]
        check(sorted(done) == sorted(tele.requests) and len(done) == len(
            trace), f"solver_serve {backend}: {len(done)} of {len(trace)} "
            "requests completed")
        if backend == "continuous":
            audit = client._backend._engine().audit
            served = sorted(rec["req_id"] for rec in audit)
            check(served == sorted(tele.requests) and all(
                rec["evict_tick"] is not None for rec in audit),
                f"solver_serve continuous: audit {served}")
            want = tele.chunks * K
        else:
            # the lockstep driver checks its stop flags every CHECK_EVERY
            # iterations: a bucket runs up to the next check past its
            # slowest row, capped at max_iters
            want = sum(min(CHECK_EVERY * -(-w["iters_max"] // CHECK_EVERY),
                           cfg.max_iters) for w in tele.waves)
        check(launches[backend] == {"batched_best_response": want,
                                    "batched_apply_update": 0},
              f"solver_serve {backend}: launches {launches[backend]}, "
              f"want {want} batched_best_response")
        print(f"solver_serve {backend}: " + json.dumps(out[backend]),
              flush=True)
        del client
    second = serve_second_signature(torch, fp, probs, solos, cfg, serve,
                                    dev)
    print("solver_serve logreg: " + json.dumps(second), flush=True)
    jacobi = serve_jacobi(torch, fp, probs, serve)
    path = serve_path(torch, dev, cfg, serve)
    health = serve_watchdog_and_drain(torch, cfg, serve, dev)
    del probs, solos
    peak = torch.cuda.max_memory_allocated()
    torch.cuda.empty_cache()
    m, n, S = F["m"], F["n"], serve.slab_capacity
    say("solver_serve", instance="fig1b dims, Nesterov, nnz 0.05-0.18",
        requests=F["requests"], trace="heavy_tail (poisson, pareto 1.1, "
        "mean gap 12 units)", solver=SERVE_SOLVER, serve=SERVE_SLABS,
        gen_s=round(gen_s, 2), solo_checks_s=round(solo_s, 2),
        unit_ms=round(unit * 1e3, 4), profiled_chunk=chunk,
        # a slab iteration: ∇F's two passes and V's one over S rows of A
        slab_iter_bytes_bound_ms=round(bytes_ms(3 * S * m * n * 4), 4),
        launches=launches, second_signature=second,
        jacobi_launches=jacobi, path=path, **health,
        peak_memory_gib=round(peak / 2 ** 30, 3),
        run_s=round(time.perf_counter() - t_phase, 2), **out)
    return {"batched_best_response": {
                "solver_serve continuous": launches["continuous"][
                    "batched_best_response"],
                "solver_serve wave": launches["wave"][
                    "batched_best_response"]},
            "batched_apply_update": {
                "solver_serve jacobi": jacobi["batched_apply_update"]}}


def prefill_launches(cfg):
    """Launches of each kernel in one prefill of ``cfg``: ``ssd_scan`` once
    per Mamba2 layer, ``flash_attention`` once per attention (the hybrid's
    shared block once per group of ``attn_every`` layers; encdec's encoder
    layers once each, its decoder layers twice: self and cross)."""
    if cfg.family == "ssm":
        return {"ssd_scan": cfg.num_layers}
    if cfg.family == "hybrid":
        return {"ssd_scan": cfg.num_layers,
                "flash_attention": cfg.num_layers // cfg.attn_every}
    if cfg.family == "encdec":
        return {"flash_attention": cfg.enc_layers + 2 * cfg.num_layers}
    return {"flash_attention": cfg.num_layers}


def decode_launches(cfg):
    """Launches of each kernel in one decode step of ``cfg``: encdec's
    cross-attention (one query over the cross cache) once per decoder
    layer; no other family's decode launches a kernel."""
    if cfg.family == "encdec":
        return {"flash_attention": cfg.num_layers}
    return {}


def run_launches(cfg, steps):
    """Launches of each kernel in a ``generate`` of ``steps`` tokens: one
    prefill and ``steps`` − 1 decode steps."""
    per_step = decode_launches(cfg)
    return {k: n + (steps - 1) * per_step.get(k, 0)
            for k, n in prefill_launches(cfg).items()}


def decode_cross_check(torch, kops, wrapper, eng, prompts, extra):
    """encdec: one ``generate`` of 2 tokens with ``kops.flash_attention``
    wrapped to keep the first decode cross-attention's q, k, v and output
    (layer 0, step 1, at full shape: one query over the grown cache), held
    against the wrapper's plain version on the same inputs at the kernel
    gate.  Returns [shape of k, max |Δ|]."""
    orig, kept = kops.flash_attention, []

    def keep(q, k, v, *, causal=True, scale=None):
        out = orig(q, k, v, causal=causal, scale=scale)
        if q.shape[2] == 1 and not kept:
            kept.append((q.clone(), k.clone(), v.clone(), out.clone(),
                         causal))
        return out
    kops.flash_attention = keep
    try:
        eng.generate(prompts, max_new_tokens=2, extra_inputs=extra)
    finally:
        kops.flash_attention = orig
    check(len(kept) == 1, "no decode cross-attention was seen")
    q, k, v, out, causal = kept[0]
    check(not causal, "decode's cross-attention ran causal")
    err = fa_gate(torch, out, wrapper.plain(q, k, v, causal=False),
                  f"decode cross-attention {tuple(k.shape)} {k.dtype}")
    return [list(k.shape), err]


def serve_run(torch, spec, wrappers, dev, profile="full"):
    """One LM's main serving path: ``ServeEngine.generate`` of ``spec``'s
    arch at full width (its batch, prompt length and new tokens; depth
    cut to ``spec["layers"]`` where given) with random weights from a
    seeded generator, greedy; encdec reads ``spec["frames"]`` frames of
    standard normal embeddings drawn after the prompts from the prompts'
    seeded generator, as ``repro_torch.launch.serve`` draws them.
    ``wrappers`` maps kernel names (those of ``KERNEL_NAMES``) to
    wrappers; each kernel of ``prefill_launches(cfg)`` must launch that
    many times a prefill and ``decode_launches(cfg)`` times a decode step.
    With ``profile`` (``"full"`` or ``"prefill"``), the prefill alone runs
    under ``torch.profiler`` first, and each kernel's profiler launches
    must equal its counter's and that count; the device time of each of
    its device kernels is printed; where decode launches a kernel, the
    prefill and one decode step are profiled and checked the same way;
    ``"full"`` adds the prefill with 8 decode steps under the profiler
    (the device's busy share in decode).  Then the main run, the counters set to 0 just before and read
    just after, and the first 4 tokens against full forwards
    teacher-forced on the engine's tokens (the last position's logits of
    ``forward_hidden``): the gaps to the max logit printed in the
    activation dtype and, with the same weights in fp32, each within
    1e-4.  encdec holds only the first token so (its decode reads a cross
    cache zero past the frames, as the reference's does: ROADMAP Queue
    3), and then its decode's cross-attention at full shape against the
    plain version at the kernel gate, in bf16 and in fp32
    (``decode_cross_check``).  For ``moe`` the main run prints the share
    of (token, choice) pairs dropped at the config's capacity factor, and
    the fp32 check routes at capacity factor E / k, where nothing drops
    (a drop depends on the count of tokens routed together, so a
    teacher-forced forward drops other pairs than the engine's prefill).
    Returns the phase's fields."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops as kops
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
    rng = np.random.default_rng(spec["seed"])
    prompts = rng.integers(0, cfg.vocab_size, (nb, lp)).astype(np.int32)
    extra = warm = None
    if cfg.is_encoder_decoder:
        extra = {"enc_embeds": torch.as_tensor(rng.standard_normal(
            (nb, spec["frames"], cfg.d_model)).astype(np.float32),
            device=dev)}
        warm = {"enc_embeds": extra["enc_embeds"][:, :512]}
    # warm-up: cuBLAS handles, the weight casts, the kernels' first launch
    eng.generate(prompts[:, :512], max_new_tokens=2, extra_inputs=warm)
    out = {"arch": arch, "layers": cfg.num_layers,
           "layers_of": full.num_layers, "batch": nb, "prompt": lp,
           "new_tokens": new, "dtype": cfg.dtype,
           **({"enc_layers": cfg.enc_layers, "frames": spec["frames"]}
              if extra else {}),
           "launches_per_prefill": want,
           "launches_per_decode_step": decode_launches(cfg),
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
            eng.generate(prompts, max_new_tokens=1, extra_inputs=extra)
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
    if profile and decode_launches(cfg):
        # the prefill and one decode step under the profiler (a window as
        # short as the prefill's): each decode launch seen by both
        zero()
        with profiled(torch) as prof:
            eng.generate(prompts, max_new_tokens=2, extra_inputs=extra)
        prof_launches = {k: w.launches for k, w in kernels.items()}
        per_kernel2, _ = device_kernels(torch, prof, {
            k: KERNEL_NAMES[k] for k in kernels})
        del prof
        for kname, n in run_launches(cfg, 2).items():
            check(per_kernel2[kname][0] == n == prof_launches[kname],
                  f"{kname} launches in the {arch} prefill + 1 decode step:"
                  f" profiler {per_kernel2[kname][0]}, counter "
                  f"{prof_launches[kname]}, want {n}")
        out["profiled_2_token_launches"] = {
            k: per_kernel2[k][0] for k in prof_launches}
    if profile == "full":
        # prefill + 8 decode steps under the profiler: device busy in decode
        with profiled(torch) as prof:
            t = time.perf_counter()
            eng.generate(prompts, max_new_tokens=9, extra_inputs=extra)
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
    eng.generate(prompts, max_new_tokens=1, extra_inputs=extra)
    prefill_s = time.perf_counter() - t

    # the main run
    moes = [blk.moe for blk in model.layers] if cfg.family == "moe" else []
    for moe in moes:
        moe.drop_log = []
    torch.cuda.reset_peak_memory_stats()
    zero()
    torch.cuda.synchronize()
    t = time.perf_counter()
    res = eng.generate(prompts, max_new_tokens=new, extra_inputs=extra)
    wall = time.perf_counter() - t
    launches = {k: w.launches for k, w in kernels.items()}
    peak = torch.cuda.max_memory_allocated()
    check(launches == run_launches(cfg, new), f"launches on the {arch} "
          f"serve path: {launches}, want {run_launches(cfg, new)}")
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
                                    res.tokens, dev, extra)}
    cfg32 = cfg.replace(dtype="float32")
    if cfg.family == "moe":
        cfg32 = cfg32.replace(
            capacity_factor=cfg.num_experts / cfg.moe_top_k)
        out["fp32_check_capacity_factor"] = cfg32.capacity_factor
    eng32 = ServeEngine(cfg32, model, max_len=lp + new, device=dev)
    zero()
    res32 = eng32.generate(prompts, max_new_tokens=4, extra_inputs=extra)
    launches32 = {k: w.launches for k, w in kernels.items()}
    check(launches32 == run_launches(cfg, 4),
          f"the fp32 run of 4 tokens launched {launches32}")
    gaps["float32"] = greedy_gaps(torch, T, cfg32, model, prompts,
                                  res32.tokens, dev, extra)
    held = gaps["float32"][:1] if cfg.is_encoder_decoder else \
        gaps["float32"]
    check(max(held) <= 1e-4, f"{arch} fp32: an engine token is "
          f"{max(held)} below the forward's max logit")
    if cfg.is_encoder_decoder:
        fa = wrappers["flash_attention"]
        out["decode_cross_vs_plain"] = {
            "bfloat16": decode_cross_check(torch, kops, fa, eng, prompts,
                                           extra),
            "float32": decode_cross_check(torch, kops, fa, eng32, prompts,
                                          extra)}
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


def phase_serve_vlm_encdec(torch, fa, dev):
    """Slice 12's main path and its witness: ``serve_run`` of each
    ``SERVE_VLM_ENCDEC`` run, one line each with its seconds.
    seamless-m4t-large-v2 (the main path, profiled in full) launches
    ``flash_attention`` 72 times a prefill (24 encoder, non-causal; 24
    decoder self, causal; 24 cross, non-causal) and 24 times a decode
    step (cross, one query over the grown cache); qwen2-vl-72b 6 times a
    prefill (one per layer run).  Returns {run: launches}."""
    launches = {}
    for spec in SERVE_VLM_ENCDEC:
        t = time.perf_counter()
        out = serve_run(torch, spec, {"flash_attention": fa.flash_attention},
                        dev, profile=spec["profile"])
        out["run_s"] = round(time.perf_counter() - t, 2)
        say("serve_vlm_encdec", **out)
        launches[spec["arch"]] = {
            "per_prefill": out["launches_per_prefill"]["flash_attention"],
            "per_decode_step": out["launches_per_decode_step"].get(
                "flash_attention", 0),
            "run": out["launches"]["flash_attention"]}
    return launches


def step1_check(torch, fp, kops, T, loop, cfg):
    """Step 1's best responses through ``br_compare`` (kernel against plain
    version, and a second launch bitwise): the gradients of the first batch
    at the initial weights, every tensor of every leaf with the optimizer's
    τᵢ and c; and each tensor's update x + γ·(z − x) (the mask's 1), the
    kernel's bitwise equal to the plain version's.  Returns (tensors
    checked, the model's tensors, max e2 rel err over tensors, max e2 rel
    err over leaves)."""
    from repro_torch.core.optimizer import _l1_mask

    model, opt, _ = loop.init_state()
    loss, _ = T.loss_fn(cfg, model, loop.batch(0), remat=loop.tcfg.remat)
    loss.backward()
    loss = loss.detach()
    check(math.isfinite(float(loss)), f"step-1 loss {float(loss)}")
    n, rel_t, rel_leaf = 0, 0.0, 0.0
    tensors = len(list(model.parameters()))
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
    return n, tensors, rel_t, rel_leaf


def ssd_per_step(cfg, remat):
    """ssd_scan and ssd_scan_bwd launches of one training step: each SSD
    layer's scan runs forward once, twice under remat (the recompute), and
    backward once."""
    n = cfg.num_layers if cfg.family in ("ssm", "hybrid") else 0
    return {"ssd_scan": (2 if remat else 1) * n, "ssd_scan_bwd": n}


def phase_train(torch, fp, ssd, dev, spec=TRAIN, name="train"):
    """A training path at full width through ``TrainLoop.run`` (FLEXA
    defaults, bf16 activations, ``spec``'s batch, sequence and steps,
    depth cut to ``spec["layers"]`` where given): the step-1 check of
    every tensor (``step1_check``), every loss finite, ``best_response``
    and ``apply_update`` once per tensor per step and each SSD layer's
    ``ssd_scan`` (twice, remat) and ``ssd_scan_bwd`` (once) by counter;
    then one more step under the profiler, its launches by profiler equal
    to the counters' and its device time by class (``device_classes``),
    and one split by hand into forward, backward and optimizer.  Slice
    3's main path is stablelm-3b (``TRAIN``), slice 13's mamba2-1.3b
    (``TRAIN_SSM``), with zamba2-1.2b (``TRAIN_HYBRID``) and the moe, vlm
    and encdec families (``TRAIN_FAMILIES``) beside it.  Returns the
    run's launches by wrapper."""
    from repro_torch.config.base import TrainConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops as kops
    from repro_torch.models import transformer as T
    from repro_torch.train.loop import TrainLoop

    full = get_config(spec["arch"])
    cfg = full.replace(num_layers=spec.get("layers", full.num_layers))
    nb, seq, steps = spec["batch"], spec["seq"], spec["steps"]
    tcfg = TrainConfig(steps=steps, log_every=1)
    loop = TrainLoop(cfg, tcfg, batch=nb, seq_len=seq, device=dev)
    t = time.perf_counter()
    n_checked, per_step, rel_t, rel_leaf = step1_check(torch, fp, kops, T,
                                                       loop, cfg)
    check_s = time.perf_counter() - t
    check(n_checked == per_step, f"step-1 check saw {n_checked} of "
          f"{per_step} tensors")
    ssd_step = ssd_per_step(cfg, tcfg.remat)
    wrappers = {"best_response": fp.best_response,
                "apply_update": fp.apply_update,
                "ssd_scan": ssd.ssd_scan, "ssd_scan_bwd": ssd.ssd_scan_bwd}
    want = {"best_response": per_step, "apply_update": per_step, **ssd_step}

    # the main path: counters to 0 just before, read just after
    torch.cuda.reset_peak_memory_stats()
    for k in (fp.best_response, fp.apply_update, fp.gather_rows,
              fp.scatter_rows, fp.batched_best_response,
              fp.batched_apply_update, ssd.ssd_scan, ssd.ssd_scan_bwd):
        k.launches = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    model, opt = loop.run()
    wall = time.perf_counter() - t
    run = {k: w.launches for k, w in wrappers.items()}
    launches = run["best_response"]
    apply_launches = run["apply_update"]
    peak = torch.cuda.max_memory_allocated()
    losses = [m["loss"] for m in loop.metrics_log]
    step_s = [m["time"] for m in loop.metrics_log]
    check(len(losses) == steps and all(math.isfinite(v) for v in losses),
          f"losses {losses}")
    check(all(run[k] == steps * want[k] for k in want),
          f"launches in {steps} steps: {run}, want {steps} × {want}")

    # one more step under the profiler: launches and device time.  The
    # profiler can lose a device record (ROADMAP Queue 3, measurement):
    # a profile whose launches fall short of the counters' is printed in
    # ``short_profiles`` and the next step profiled, PROFILE_ATTEMPTS in all
    timed = [k for k in wrappers if want[k]]
    short = []
    for attempt in range(PROFILE_ATTEMPTS):
        before = {k: w.launches for k, w in wrappers.items()}
        torch.cuda.synchronize()
        with profiled(torch) as prof:
            t = time.perf_counter()
            _, opt, _, m = loop.step_fn(model, opt, None,
                                        loop.batch(steps + attempt))
            check(math.isfinite(float(m["loss"])), "profiled step: loss")
            torch.cuda.synchronize()
            prof_s = time.perf_counter() - t
        prof_n = {k: w.launches - before[k] for k, w in wrappers.items()}
        per_kernel, busy = device_kernels(
            torch, prof, {k: KERNEL_NAMES[k] for k in timed})
        if (all(per_kernel[k][0] == prof_n[k] for k in timed)
                or attempt == PROFILE_ATTEMPTS - 1):
            break
        short.append({"profiler": {k: per_kernel[k][0] for k in timed},
                      "counter": prof_n,
                      "records_by_kernel": top_kernels(torch, prof, n=1000,
                                                       only=[
                          sub for k in timed if per_kernel[k][0] != prof_n[k]
                          for sub in KERNEL_NAMES[k]])})
        del prof
    top = top_kernels(torch, prof)
    classes = device_classes(torch, prof)
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
    check(all(per_kernel[k][0] == prof_n[k] == want[k] for k in timed),
          f"launches in the profiled step: profiler "
          f"{ {k: per_kernel[k][0] for k in timed} }, counter {prof_n}; "
          f"want {want} ({records} device records; first and last {edges} "
          f"ms inside the step)")
    ssd_fields = {} if not ssd_step["ssd_scan"] else dict(
        ssd_launches_per_step=ssd_step,
        ssd_profiler_launches={k: per_kernel[k][0]
                               for k in ("ssd_scan", "ssd_scan_bwd")},
        ssd_scan_device_ms_per_step=round(per_kernel["ssd_scan"][1], 4),
        ssd_scan_bwd_device_ms_per_step=round(
            per_kernel["ssd_scan_bwd"][1], 4))
    steady = step_s[1:]
    say(name, arch=cfg.name, family=cfg.family, layers=cfg.num_layers,
        layers_of=full.num_layers, batch=nb, seq=seq,
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
                  "batched_apply_update": fp.batched_apply_update.launches,
                  "ssd_scan": run["ssd_scan"],
                  "ssd_scan_bwd": run["ssd_scan_bwd"]},
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
        profiled_step_edges_ms=edges, short_profiles=short,
        device_ms_by_class=classes,
        matmul_bound_ms=matmul_bound_ms(cfg, model, nb * seq, tcfg.remat),
        top_device_kernels=top,
        split_step_ms={k: round(v, 3) for k, v in split.items()},
        sel_frac=float(m["flexa/sel_frac"]),
        tau_mean=float(m["flexa/tau_mean"]),
        step1_tensors_checked=n_checked, step1_e2_max_rel_err=rel_t,
        step1_leaf_e2_max_rel_err=rel_leaf, step1_check_s=round(check_s, 2),
        **ssd_fields)
    del model, opt, loop
    torch.cuda.empty_cache()
    return run


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


def greedy_gaps(torch, T, cfg, model, prompts, tokens, dev, extra=None):
    """For each of the first 4 engine tokens, the largest gap (over the
    batch) between a full forward's max logit and the token's logit, the
    forward teacher-forced on the engine's earlier tokens: its last
    position's logits (``forward_hidden``, then the head on that position
    alone: a full (4, 4100, 256206) fp32 logits tensor is 16.8 GB), with
    M-RoPE's text positions and encdec's frames ``extra``."""
    from repro_torch.models import layers as L
    seq, gaps = prompts, []
    for step in range(4):
        B, S = seq.shape
        batch = {"tokens": seq, **(extra or {})}
        if cfg.use_mrope:
            batch["positions"] = torch.arange(S, device=dev).expand(B, 3, S)
        with torch.inference_mode():
            x, _ = T.forward_hidden(cfg, model, batch)
            last = L.logits(x[:, -1:], T.lm_head_table(cfg, model))[:, 0]
        check(bool(torch.isfinite(last).all()),
              f"{cfg.dtype} forward {step}: non-finite logits")
        tok = torch.as_tensor(tokens[:, step], device=dev).long()
        gap = last.max(dim=-1).values - last.gather(1, tok[:, None])[:, 0]
        gaps.append(float(gap.max()))
        seq = np.concatenate([seq, tokens[:, step: step + 1]], axis=1)
        del x, last
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


def ssd_bwd_work(shape, itemsize):
    """(FLOPs of the products with bf16 factors only, FLOPs of those with
    an fp32 factor, bytes) an ssd_scan_bwd call needs at ``shape``.  Per
    (batch row, chunk) G = C·Bᵀ over the lower triangle; per head Q =
    dy·xᵀ over it (both bf16 × bf16), and with an fp32 factor dx's and
    dB's and dC's intra-chunk products (W·dy, Vᵀ·C, V·B over the
    triangle) and the four state products (dH = Σ e^s C dyᵀ, dhᵀ·B, dh·x,
    h_prev·dy, each L·N·P).  Bytes: x, B, C, dy in the activation dtype,
    dt, A and the forward's scratch (the entering states and the cumsums)
    read once; dx, dB, dC, ddt, dA written once."""
    Bt, S, H, P, N, L = shape
    exact = split = 0
    for c0 in range(0, S, L):
        lc = min(L, S - c0)
        tri = lc * (lc + 1) // 2
        exact += Bt * tri * N + Bt * H * tri * P
        split += Bt * H * (tri * (P + 2 * N) + 4 * lc * N * P)
    nc = -(-S // L)
    act = 2 * Bt * S * H * P + 2 * Bt * S * N
    nbytes = (2 * act * itemsize + 2 * (Bt * S * H * 4) + 2 * H * 4
              + Bt * nc * H * (N * P + L) * 4)
    return 2 * exact, 2 * split, nbytes


def ssd_bwd_row(torch, ssd, launches, err, by_path, dev):
    """ssd_scan_bwd at the train path's per-layer shape (mamba2-1.3b, 2 ×
    4096, bf16, x/B/C strided as the mixer passes them, no dh_final as
    training gives none) and at zamba2-1.2b's N 64; device times from CUDA
    events around back-to-back eager launches.  The bound by operations
    is the lesser of the tensor cores' (the bf16 × bf16 products at the
    bf16 rate, each product with an fp32 factor as three exact bf16
    products: ``split_ops_ms``) and the CUDA cores' fp32 rate
    (``fp32_ops_ms``); ``bound_ms`` is the larger of that and the bytes'
    time."""
    timed = {}
    for key, shape in (("train", SSD_TRAIN), ("zamba2-1.2b",
                                               SSD_TRAIN_ZAMBA)):
        args, dy, _ = ssd_bwd_args(torch, shape, torch.bfloat16, 31, dev,
                                   strided=True, dh=False, overflow=False)
        chunk = shape[-1]
        scratch = ssd.ssd_scan(*args, chunk=chunk, keep_scratch=True)[2]
        exact, split, nbytes = ssd_bwd_work(shape, 2)
        t_split = (exact + 3 * split) / BF16_OPS_PER_S * 1e3
        t_fp32 = (exact + split) / FP32_OPS_PER_S * 1e3
        t_bytes, t_ops = bytes_ms(nbytes), min(t_split, t_fp32)
        timed[key] = {
            "shape": list(shape),
            "ms": cuda_ms(torch, lambda: ssd.ssd_scan_bwd(
                *args, dy, None, chunk=chunk, scratch=scratch), reps=5),
            "plain_ms": cuda_ms(torch, lambda: ssd.ssd_scan_bwd.plain(
                *args, dy, None, chunk=chunk), reps=3),
            "forward_ms": cuda_ms(torch, lambda: ssd.ssd_scan(
                *args, chunk=chunk), reps=5),
            "flops": exact + split, "bytes": nbytes, "bytes_ms": t_bytes,
            "split_ops_ms": t_split, "fp32_ops_ms": t_fp32,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
        del args, dy, scratch
        torch.cuda.empty_cache()
    t = timed["train"]
    return {"name": "ssd_scan_bwd", "route": "cuda",
            "source": SOURCES["ssd_scan_bwd"],
            "replaces": REPLACES["ssd_scan_bwd"],
            "replaces_note": "the gradient of that kernel, which has no "
                             "VJP there (the JAX package differentiates "
                             "its jnp oracle)",
            "launches": launches, "launches_by_path": by_path,
            "max_abs_err": err,
            "ms": round(t["ms"], 5), "plain_ms": round(t["plain_ms"], 5),
            "bound_ms": round(t["bound_ms"], 5), "bound_by": t["bound_by"],
            # no single PyTorch call computes the scan's gradient
            "library_ms": None,
            "split_ops_ms": round(t["split_ops_ms"], 5),
            "fp32_ops_ms": round(t["fp32_ops_ms"], 5),
            "shape": "x (2, 4096, 64, 64) bf16, B/C (2, 4096, 128), "
                     "chunk 256, dy, no dh_final",
            "timed": {k: {kk: (round(vv, 5) if isinstance(vv, float)
                               else vv) for kk, vv in v.items()}
                      for k, v in timed.items()}}


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
                cbr_state, gs_sweep, family_launches, vlm_encdec_launches,
                train_ssd, serve_paths, dev):
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
    for arch, n in vlm_encdec_launches.items():
        by_path["flash_attention"][f"serve_vlm_encdec {arch}"] = n
    # the train paths' launches of the scan and its backward
    bwd_path = {}
    for path, n in train_ssd.items():
        by_path["ssd_scan"][path] = n["ssd_scan"]
        bwd_path[path] = n["ssd_scan_bwd"]
    rows.append(ssd_row(torch, ssd, serve_launches, err["ssd_scan"],
                        by_path["ssd_scan"], dev))
    rows.append(ssd_bwd_row(
        torch, ssd, train_ssd[f"train_ssm {TRAIN_SSM['arch']}"][
            "ssd_scan_bwd"], err["ssd_scan_bwd"], bwd_path, dev))
    rows.append(br_row(torch, fp, launches["best_response"],
                       err["best_response"], dev))
    rows.append(fa_row(torch, fa, launches["flash_attention"],
                       err["flash_attention"], by_path["flash_attention"],
                       dev))
    rows += update_rows(torch, fp, launches, err, floor, serve_paths, dev)
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


def update_rows(torch, fp, launches, err, floor, serve_paths, dev):
    """apply_update at the train path's shapes (lm_head (50304, 2560)
    fp32, 0-d τ and γ·m, c = 0, in place as the optimizer calls it; and
    one step's 291 calls), times from CUDA events around back-to-back
    eager calls; the batched kernels at the batch phase's (8, 100000)
    bucket (dense d, c and γ·m per instance), at fig1d's solo
    (1, 100000) and at the solver_serve slab's (8, 10000), device times
    of calls replayed from a CUDA graph (a call takes microseconds) with
    the eager time beside; their launches on the solver_serve path in
    ``launches_by_path``.  Bounds: bytes over
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
        for key, B, n in (("batch", 8, FIG1D["n"]), ("solo", 1, FIG1D["n"]),
                          ("serve_slab", SERVE_SLABS["slab_capacity"],
                           SOLVER_SERVE["n"])):
            x, g, d, c = batched_inputs(torch, B, n, torch.float32,
                                        "dense", "instance", 73, dev)
            args = (x, g, d, c) if name == "batched_best_response" \
                else (x, g, d, c, torch.rand(B, device=dev))
            timed[key] = {
                "shape": [B, n],
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
            "launches_by_path": serve_paths[name],
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
    over 10, D 128), deepseek-67b's (1 × 1024, 64 over 8),
    seamless-m4t-large-v2's (4 × 16/16 × 4096, D 64: the encoder's
    non-causal, the decoder's causal self-attention, the cross-attention
    and decode's cross-attention of one query over 4128 cached frames)
    and qwen2-vl-72b's (2 × 2048, 64 over 8), q, k, v laid out as the
    model passes them (``FA_MODEL``).  Times from CUDA events around
    back-to-back eager launches (a prefill launch takes milliseconds; the
    decode call's time includes its launch).  The library call is
    ``scaled_dot_product_attention`` on fp32 copies with the call's
    ``is_causal`` (the same fp32 function; timed here only, never on the
    path).

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
    keys = ("stablelm-3b", "yi-6b", "zamba2-1.2b", "phi3-medium-14b",
            "deepseek-67b", "seamless-m4t-large-v2 encoder",
            "seamless-m4t-large-v2 decoder self",
            "seamless-m4t-large-v2 cross",
            "seamless-m4t-large-v2 decode cross", "qwen2-vl-72b")
    for key, (shape, layout) in zip(keys, FA_MODEL, strict=True):
        causal = shape[6]
        q, k, v = fa_inputs(torch, shape, torch.bfloat16, 41, dev, layout)
        qk, pv, nbytes = fa_work(shape, 2)
        t_qk, t_pv = qk / BF16_OPS_PER_S * 1e3, pv / FP32_OPS_PER_S * 1e3
        t_split = (qk + 3 * pv) / BF16_OPS_PER_S * 1e3
        t_bytes, t_ops = bytes_ms(nbytes), min(t_split, t_qk + t_pv)
        rep = shape[1] // shape[2]
        qf = q.float()
        kf = k.float().repeat_interleave(rep, dim=1)
        vf = v.float().repeat_interleave(rep, dim=1)
        timed[key] = {
            "shape": list(shape),
            "ms": cuda_ms(torch, lambda: fa.flash_attention(
                q, k, v, causal=causal), reps=10),
            "plain_ms": cuda_ms(torch, lambda: fa.flash_attention.plain(
                q, k, v, causal=causal), reps=3),
            "library_ms": cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                qf, kf, vf, is_causal=causal), reps=10),
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
        phase = "families"
        phase_families(torch, fp, dev)
        phase = "solver_serve"
        serve_paths = phase_solver_serve(torch, fp, dev)
        phase = "serve"
        serve_launches = phase_serve(torch, ssd, dev)
        phase = "serve_dense"
        launches["flash_attention"] = phase_serve_dense(torch, fa, dev)
        phase = "serve_families"
        family_launches = phase_serve_families(torch, ssd, fa, dev)
        phase = "serve_vlm_encdec"
        vlm_encdec_launches = phase_serve_vlm_encdec(torch, fa, dev)
        phase = "train"
        run = phase_train(torch, fp, ssd, dev)
        launches["best_response"] = run["best_response"]
        launches["apply_update"] = run["apply_update"]
        phase = "train_ssm"
        train_ssd = {f"train_ssm {TRAIN_SSM['arch']}": phase_train(
            torch, fp, ssd, dev, TRAIN_SSM, "train_ssm")}
        phase = "train_hybrid"
        train_ssd[f"train_hybrid {TRAIN_HYBRID['arch']}"] = phase_train(
            torch, fp, ssd, dev, TRAIN_HYBRID, "train_hybrid")
        phase = "train_families"
        for spec in TRAIN_FAMILIES:
            phase_train(torch, fp, ssd, dev, spec, "train_families")
        phase = "descent"
        phase_descent(torch, dev)
        phase = "kernel timing"
        rows = kernel_line(torch, fp, ssd, fa, r, launches, serve_launches,
                           err, cbr_state, gs_sweep, family_launches,
                           vlm_encdec_launches, train_ssd, serve_paths,
                           dev)
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
