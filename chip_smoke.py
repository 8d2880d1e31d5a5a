"""Smoke test of the PyTorch/H100 port on one NVIDIA card.

    python3 chip_smoke.py [--weights DIR]

Phases (each prints one line; any failure raises and exits non-zero):

1. the card, as nvidia-smi reports its name and power limit;
2. the build of the hand-written CUDA kernels from ``csrc/`` (one nvcc
   per source, in parallel);
3. each kernel (K1-K8 and the fused epilogues, every mode the paths use)
   against its plain PyTorch version on the card, at the shapes the paths
   give it, with the stated tolerance, both times, the least time the card
   could take for the same work (``bound_ms``: bytes over 3.35 TB/s or
   operations over the H100's published peak for their type, whichever is
   larger) and, where one PyTorch call computes the same function, that
   call's time (``library_ms``; the port never calls it). The products
   are those of one recorded sampler step: K1's input product, the block
   products with GroupNorm+SiLU in their epilogue (K1, and K6 under int8
   "all"), the output product with the posterior step in its epilogue (K1,
   and K6 under the int8 modes), each fused case also against the
   hand-written pair it replaces (K1 or K6, then K2 or K3: ``pair_ms``,
   and the posterior epilogue's carry bit for bit equal to the pair's).
   K6 quantizing its own A (K5's work as its prologue) at every int8
   block and output product of the recorded steps, bit for bit equal to
   K5 then K6 and timed beside that pair (a ``WARNING`` line where it is
   not faster); K5 on the input product at 333 and 32,768 rows; K4 at the
   validator's and the production MMD's shapes, with its route (f32 FMA
   or three TF32 products) and that route's bound; the latent step on one
   K1 launch (both products, K7's update, the next draw) at 333 and 999
   rows in both draw modes, its state bit for bit equal to K1 -> K7 -> K1
   -> K7's under the same plan, timed beside that pair and torch's two
   products; K7's priming draw; K8 at 333 x 5142. K1, K6 and the fused kernels run each case
   twice and require equal bits, split-K included. The step's launches by
   kernel and mode, for bf16, D3PM and each int8 mode (12 a bf16 step,
   12 / 13 / 15 under int8 "out" / "io" / "all", the standalone K5 only
   before the input product), and its summed kernel time. K1, K1+GN and
   K1+posterior also at the serving buckets' rows, 1, 64 and 1,024 (the
   products of a bf16 step recorded at each size: one 64-row tile with
   one valid row and the largest split-K at 1 row), each against its
   plain version at the same tolerances, timed with its bound; and the
   same at the headline's 32,768 rows (K1's input product also beside
   ``addmm``), with each product's launch plan (tiles, rounds over the
   SMs, split-K workspace) and the step's summed time and bound; at those
   rows also the launches that int8 "out" and the D3PM head change, from
   steps of theirs recorded at that size (12 launches each): K6 quantizing
   its own A with the posterior epilogue ("philox"; beside K5 -> K6 and
   ``torch._int_mm`` on the same codes), K1's input product with the 2b-1
   prologue and K1+posterior D3PM "philox", and each variant step's summed
   time beside the bf16 step's;
3b. "[experts]": the routed experts' grouped products (``ops/moe.py``:
   ``torch._grouped_mm``, then SiLU·up, or the routing weight and the
   scatter, or the sum over k) at the transformer cell's routed shapes
   (46,656 rows of 7,776 tokens routed 6 of 64, 2048 -> 2·1408 -> 2048),
   each against its plain per-expert version within 2e-3 in relative
   norm, twice with equal bits, all timed; the two epilogue kernels
   (``moe_silu_mul``, ``moe_combine``) against their plain versions (equal
   bits) and the eager chains they replaced (SiLU·up equal bits, the
   combine within f32 reassociation), timed beside their byte bounds and
   those chains (``library_ms``), and one routed layer call with and
   without them; "[dit]": the transformer denoiser of
   config/dit_moonlight.yaml at its published widths, two of its 27
   blocks, through the generator's ``generate_scenarios`` (3 x 8
   patients, DDIM-50 on the scan loop, calibrated on the card), the two
   epilogue kernels launched once each per routed layer call and no other
   hand-written kernel; "[kimi]": the KDA kernel (``csrc/kda_chunk.cu``)
   against its plain chunked twin at the hybrid cell's shape (6 x 1,289
   tokens, 32 heads of 128), twice with equal bits, timed beside its bound
   and the twin, then config/kimi_linear_dit.yaml's 27 hybrid blocks at
   published widths (20 KDA, 7 NoPE MLA, 64 of 256 experts held) through
   ``generate_scenarios`` (3 x 1 patients, DDIM-50): one KDA launch a KDA
   layer call (20 a denoiser call), ``kda.chunks`` as counted, fewer held
   than routed expert copies;
4. "[calib]": the device calibration (``ops/copula_device.py``) against
   the host numpy path on the seeded structured cohort's data statistics
   at full width, on the kernel sampler's DDIM-50 output from the seeded
   weights: at 333 and 1,024 rows (the dual N x N whitening) and 10,002
   (the primal D x D one), per-gene bit counts equal, the sorted
   continuous columns' max |diff| (within 1e-4) and the correlation
   pattern of the two cohorts (> 0.95, max |Δ| < 0.25); device seconds
   (warm, median of 3) against host seconds (median of 3 at 333 and
   1,024 rows, one run at 10,002), the float64 ``eigh``'s share of the
   device time, and the device path's peak memory;
4b. "[copy]": the calibrated cohort's copy back at the cohort cells'
   download shapes (16,384 and 10,002 rows of 62 bits and 5,080
   continuous values, f32): ``.cpu()`` into fresh pageable memory against
   ``copula_device.to_host``'s reused page-locked blocks, GB/s (median of
   5 after a warm-up), equal bit for bit, no new block after the warm-up;
5. "[train]": the port's CLI train step at full model width (data dims
   62/5054/26, hidden 256/512/256, T = 1000) on the seeded structured
   cohort of 100 patients with the production settings (batch 16, AdamW
   1e-4, weight decay 1e-5, clip 1.0, constraints on, dropout 0.2, mixup
   0.2, pathway noise 0.05) for 100 epochs: its first and last train and
   validation losses, steps/sec and seconds; every loss finite, the best
   validation loss below epoch 0's, ``best_model.npz`` and a periodic
   checkpoint written, one more epoch resumed from a copy of that
   periodic checkpoint; then DDIM-50 generate -> calibrate -> validate at
   3 x 333 from the trained checkpoint with the continuous path's launch
   accounting (K1, K1+GN and K1+posterior launched; K1's general path,
   K2 and K3 not) and the validator's overall score and MMD printed (no
   quality gate: 100 epochs and 999 rows are not its protocol);
5. the main paths at full model width (data dims 62/5054/26, hidden
   256/512/256, T = 1000, cosine schedule) on seeded weights: the port's CLI step
   functions generate -> calibrate (copula_joint) -> validate on a
   temporary directory holding a seeded structured cohort of 100
   patients, 3 scenarios x 333 patients each:
   - "continuous": DDPM-1000, then DDIM-50;
   - "d3pm": the same with the D3PM mutation head (mutation CSVs exactly
     binary; per-gene frequencies printed; calibration keeps the bits);
   - "int8": fused_quantize "out" with DDPM-1000, "io" and "all" with
     DDIM-50, and "all" with the D3PM head at DDIM-50.
   Every launch count is set to 0 just before a path and read just
   after it; each cohort's calibration backend is printed, and on the
   card every 333-row cohort must have been calibrated on the device
   ("auto"); each (kernel, mode) the path runs must have launched, and
   K1's general ("unaligned") path, the standalone K2 and the standalone
   K3 must not have, nor K6 from K5's codes on any product but the input
   product;
   - "latent": the latent-tail hybrid sampler. ``scripts/bench_latent_torch.py``
     as a subprocess at 999 rows, DDPM-1000, once with the probe's head
     and once with head 100 (its launches counted in that process: the
     fused latent step once per latent step, K7's draw once per call, its
     update never; only the kernel latent sampler's launches join the
     path's); then in process at full width, ``LatentFusedSampler`` with
     head 100 (899 latent steps), its counts read right after the latent
     calls (11 launches a latent step: 10 in the stack, 1 fused; one
     priming draw a call), and, where the probe says the clip does not
     bind in the tail, its per-feature moments against the data-space
     kernel sampler's;
6. "[variants]" (after ``[train]``): three models of the JAX package's
   variants trained through the CLI with the production settings for 30
   epochs each, then 3 x 333 generate -> calibrate -> validate on the
   route the JAX rule gives them: (a) the AR head with k = 8 latent
   factors, DDPM-1000 and DDIM-50 on the kernels (12 launches a step,
   never the scan loop); (b) v + learned sigma + cfg_dropout_prob 0.1 at
   guidance 7.5 (DDPM-1000) and 1.0 (DDIM-50), (c) epsilon + low-rank
   sigma k = 4 at DDIM-50, both on the scan loop (no sampler kernel);
   every cohort calibrated on the card, the AR cohort with the continuous
   calibrator only and binary bits; overall / MMD / co-occurrence printed
   (no gate); (a)'s kernel sampler on its widened conditions against the
   plain loop at 333 rows, and the scan loop on the card against its CPU
   run on the same draws;
7. "[arch]" (after ``[variants]``): the two other architectures of
   ``model.architecture``, the cVAE and the flow, at the full width of
   config/config.yaml (hidden 256/512/256, latent 128, bf16 products,
   dropout 0.2, constraints on; the flow six couplings of width 512),
   each trained through the CLI with the production settings for 30
   epochs (finite losses, the best validation loss below epoch 0's, the
   cVAE's BatchNorm statistics in ``best_model.npz``, one epoch resumed
   from a copy), the train step's steps/sec and launches a step
   (``scripts/profile_torch_train.py``'s ``run``), then 3 x 333 generate
   -> calibrate -> validate through the CLI: the route ("cvae" /
   "plain"), no kernel launched while generating, every cohort
   calibrated on the card, K4 launched by the validation; the sampler at
   333 and 999 rows and the calibration timed in process; the card's
   sample against the CPU's on the same z (within 0.05 of max(1,
   max|CPU|)) and the flow's inverse(forward(x)) on the card (2e-3); the
   server on 127.0.0.1 answering five requests of 64 rows, no kernel
   launched;
8. "[pipeline]" (after ``[arch]``): the training side of the pipeline
   from raw files. The seeded structured cohort (100 patients,
   62/5054/26) written in the GDC download's layout: a gzipped MAF with
   a protein-altering record for each 1-bit and silent records the
   filter must drop, one gzipped STAR file a patient (20,000 genes and
   STAR's four N_* summary rows), ``rna_seq/metadata.csv`` and
   ``clinical.csv``; a second cohort (seed 1, 60 patients, six mutation
   and 300 expression genes and the stage column absent) under
   ``data_dir/pretrain/TARGET-SMOKE/raw``. The CLI's preprocess (both
   cohorts; the expression width is the preprocessor's 5000, not 5054),
   pathways and train steps with the production training settings:
   20 pretraining epochs, 30 epochs in blocks of 25, sample-path
   fine-tuning with config/config.yaml's values (300 steps of DDIM-8 on
   256 rows, lr 1e-5, tau 0.1, weights 5 / 1); every loss finite,
   ``pretrain/`` and ``best_model_prefinetune.npz`` written and
   ``best_model.npz`` changed; then DDIM-50 generate -> calibrate ->
   validate at 3 x 333 with the trained path's launch accounting (K1,
   K1+GN and K1+posterior "none" launched, K1's general path, K2 and K3
   not, every cohort calibrated on the card, K4 on validation) and
   overall, MMD, co-occurrence and pathway coherence printed (no gate);
   one fine-tuning step on the card against the CPU on the same draws
   (each loss within 5e-2 of itself), the fine-tuning step's ms,
   launches and device ms; the hard-thresholded co-occurrence loss of a
   999-row DDIM-50 cohort before and after fine-tuning; each step's
   seconds;
9. "[report]" (after ``[pipeline]``, on its directories: 61/5000/29,
   100 real rows, 3 x 333 synthetic rows): the CLI's doctor step (every
   entry OK, the dict printed); the report step (``summary_report.txt``
   graded from the validate step's results, which it must read back
   equal; the figures written, or a line saying they were skipped where
   matplotlib is not installed, as in the JAX package; the step's seconds
   and ``embed_2d``'s on the 1,099 x 5000 expression rows); the CLI's
   train with ``profile=True`` (``--profile``) for 2 epochs on the card:
   the ``torch.profiler`` trace under ``<results_dir>/profile`` parses as
   JSON and holds CUDA kernel events (their count, the five device
   operations with the most time, the trace's size), and
   ``device_memory_stats()`` names the card with a nonzero peak; the GAT
   encoder (``models/gnn.py``) on the pathway step's gene-pathway graph
   (371 genes x 29 pathways, edges from ``gene_pathway_edges``; hidden
   256, latent 128, 3 layers, 4 heads from ``model.gnn``), f32 with TF32
   off, on the card against the same module on the CPU (max |diff| within
   1e-4 of max |out|), one graph and two pooled, its forward's ms (CUDA
   events over 20) and peak memory. The phase launches no kernel: its
   counts are set to 0 before it and must read 0 after;
9b. "[multi]" (after the main paths): the multi-device layer
   (``parallel/``) in a child process of its own (``--multi-child``), a
   world of one NCCL rank on the card (NCCL refuses two ranks on one
   card), its NCCL version printed: the data-parallel trainer against the
   one-device trainer from the same seed at the production settings
   (diffusion 20 steps, cVAE 10, batch 16, constraints and dropout on;
   losses within 1e-6 relative, parameters within 2 lr a step and all but
   1e-3 of them within 1e-6; ms a step of each), ``sample_sharded``
   against ``sample`` at 333 rows bit for bit (DDPM-1000 on a noise
   buffer and on in-kernel noise, DDIM-50), both walls and the
   all-gather's ms, and the sharded generator (3 x 333 DDPM-1000, host
   calibration) against the unsharded one under "numpy": equal cohorts,
   overall and MMD; then ``dryrun_multichip(4)`` on 4 gloo ranks on the
   CPU. The sharded runs' launches are counted just before and after
   each (K1, K1+GN, K1+posterior in every mode, K4) and reported in the
   kernel line's ``multi`` key, and added to ``launches``;
10. "[serve]": the port's server on 127.0.0.1 from the ``[train]``
   checkpoint through ``scripts/bench_serving_torch.py`` (a subprocess):
   warmed for buckets 1, 64 and 1,024 under DDPM-1000 and DDIM-50, ten
   HTTP requests a pair (JSON at 1 and 64 rows, npz at 1,024), each
   pair's p50, p95, max and payload size; /health must name the card and
   /metrics count the requests; the launches of the timed requests
   (counted in that process, set to 0 after the warmup): K1, K1+GN and
   K1+posterior launched, K1's general path and K2/K3 apart not; the
   1,024-row requests calibrated on the device;
11. the kernel sampler against the plain PyTorch loop at 333 rows:
   continuous DDPM-20 and DDIM-10, D3PM DDPM-20, each int8 mode, and the
   latent kernel sampler against the plain ``LatentTailSampler`` (head 3,
   the same x_T, noise, zeta and eta); then at serving's small batches,
   1 and 64 rows, continuous DDPM-20 and DDIM-10;
12. "[bench]" (last): the kernel sampler against the plain loop at the
   headline's 32,768 x 5,142 (the bench's model at a 20-step schedule,
   DDPM-20 on a 13.5 GB noise buffer and DDIM-10, and DDIM-10 at the
   suite's 131,072 rows, every draw on the card, atol 0.15 / rtol 0.05),
   then the headline of
   ``python -m osteosarcoma_diffusionmodel_torch.bench`` once (DDPM-1000
   at 32,768 rows, one warm-up and the best of three calls), its JSON line
   beside the card's, its launches counted (the kernel line's ``bench``
   key) and the phase's seconds against its 60 s budget.

K8 (``posterior_update``) has no caller in either package: its launches
are those of its own check in phase 3.

The last two lines are the kernel report and
``{"ok": true, "device": {...}}``. There is no CPU branch: without a
CUDA device the script raises.
"""

from __future__ import annotations

import argparse
import copy
import gzip
import http.client
import importlib.util
import json
import logging
import math
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from osteosarcoma_diffusionmodel_torch import bench as bench_module
from osteosarcoma_diffusionmodel_torch.analysis import report as report_module
from osteosarcoma_diffusionmodel_torch.analysis.report import grade
from osteosarcoma_diffusionmodel_torch.cli import (
    _header,
    analysis_report,
    build_constraint_spec,
    compute_pathway_features,
    doctor,
    generate_synthetic_patients,
    preprocess_data,
    train_model,
    validate_synthetic_patients,
)
from osteosarcoma_diffusionmodel_torch.config import Config, TransformerConfig
from osteosarcoma_diffusionmodel_torch.data.dataset import prepare_arrays, train_val_split
from osteosarcoma_diffusionmodel_torch.data.dummy import (
    cohort_arrays,
    make_dummy_cohort,
    write_processed,
)
from osteosarcoma_diffusionmodel_torch.data.preprocessor import (
    PROTEIN_ALTERING_CLASSES,
    TOP_EXPRESSION_GENES,
)
from osteosarcoma_diffusionmodel_torch.generation import generator as gen_module
from osteosarcoma_diffusionmodel_torch.generation.generator import (
    SyntheticPatientGenerator,
    load_trained_model,
    seeded_generator,
)
from osteosarcoma_diffusionmodel_torch.models.constraints import (
    cooccurrence_matching_loss,
    mutation_corr_matrix,
)
from osteosarcoma_diffusionmodel_torch.models.diffusion import ConditionalDiffusion
from osteosarcoma_diffusionmodel_torch.models.gnn import PathwayGraphEncoder, gene_pathway_edges
from osteosarcoma_diffusionmodel_torch.models.networks import init_flax, init_weights
from osteosarcoma_diffusionmodel_torch.ops import _build, fused_sampler, moe
from osteosarcoma_diffusionmodel_torch.ops.fused_sampler import FusedSampler, coefficient_table
from osteosarcoma_diffusionmodel_torch.ops.moe import COMBINE, SILU_MUL
from osteosarcoma_diffusionmodel_torch.ops import kda as kda_ops
from osteosarcoma_diffusionmodel_torch.ops.kda import KDA
from osteosarcoma_diffusionmodel_torch.ops.latent_sampler import (
    LatentFusedSampler,
    LatentTailSampler,
    calibrate_head_steps,
)
from osteosarcoma_diffusionmodel_torch.ops.schedules import DiffusionSchedule
from osteosarcoma_diffusionmodel_torch.serving.server import serve
from osteosarcoma_diffusionmodel_torch.ops.pallas_kernels import (
    POSTERIOR_UPDATE,
    RBF,
    RBF_CHUNK,
    gaussian_noise,
    posterior_update,
    posterior_update_plain,
    posterior_update_traced,
    rbf_kernel_sum,
    rbf_kernel_sum_plain,
    rbf_plan,
)
from osteosarcoma_diffusionmodel_torch.ops.sampler_kernels import (
    GEMM,
    GEMM_BM,
    GEMM_GN,
    GEMM_LATENT,
    GEMM_POSTERIOR,
    GEMM_S8,
    GEMM_S8_GN,
    GEMM_S8_POSTERIOR,
    GEMM_S8Q,
    GEMM_S8Q_GN,
    GEMM_S8Q_POSTERIOR,
    GEMM_WIDTHS,
    GROUPNORM,
    GemmPlan,
    LATENT,
    LATENT_WIDTHS,
    POSTERIOR,
    POSTERIOR_WIDTHS,
    QUANT_WIDTHS,
    ROWQUANT,
    gemm_bf16_f32acc,
    gemm_bf16_f32acc_plain,
    gemm_bf16_gn_silu,
    gemm_bf16_latent_step,
    gemm_bf16_latent_step_plain,
    gemm_bf16_posterior,
    gemm_plan,
    gemm_s8,
    gemm_s8_gn_silu,
    gemm_s8_plain,
    gemm_s8_posterior,
    gemm_s8q,
    gemm_s8q_gn_silu,
    gemm_s8q_plain,
    gemm_s8q_posterior,
    _ctas_per_sm,
    gn_widths,
    groupnorm8_silu,
    groupnorm8_silu_plain,
    k_tiles,
    kmajor_int8,
    latent_draw,
    latent_draw_plain,
    latent_update,
    latent_update_plain,
    pack_int8,
    pad16,
    philox_uniform_noise,
    rowquant_s8,
    rowquant_s8_plain,
    x0_posterior_step,
    x0_posterior_step_plain,
)
from osteosarcoma_diffusionmodel_torch.training.finetune import sample_path_finetune
from osteosarcoma_diffusionmodel_torch.training.trainer import Trainer, build_model
from osteosarcoma_diffusionmodel_torch.training.checkpoint import (
    METADATA_FILE,
    data_stats_from_arrays,
    latest_epoch,
    load_data_stats,
    load_metadata,
    load_weights,
    metadata_to_dims,
)
from osteosarcoma_diffusionmodel_torch.utils.card import (
    KERNELS,
    SERVE_BUCKETS,
    card_line,
    seeded_checkpoint,
)
from osteosarcoma_diffusionmodel_torch.utils.io import read_matrix_csv
from osteosarcoma_diffusionmodel_torch.utils.profiling import COUNTERS, device_memory_stats
from osteosarcoma_diffusionmodel_torch.validation.validator import BiologicalValidator

# Launches of one reverse step by fused_quantize mode (the D3PM head adds none).
STEP_LAUNCHES = {"none": 12, "out": 12, "io": 13, "all": 15}
# Launches of the hidden stack (hidden 256/512/256: five blocks, two block
# products each, GN in their epilogue) and of one latent step (the stack,
# then both products with K7's work in one launch).
STACK_LAUNCHES = 10
LATENT_STEP_LAUNCHES = STACK_LAUNCHES + 1
REPO = Path(__file__).resolve().parent
BATCH = 333  # rows per scenario: 1000 // 3
BENCH_ROWS = bench_module.BATCH  # the headline's rows, 32,768
LATENT_ROWS = 999  # the latent path's rows: three scenarios of 333, batched
LATENT_HEAD = 100  # a fixed head that leaves 899 latent steps at T = 1000
DATA_DIMS = (62, 5054, 26)
D = sum(DATA_DIMS)
MUT = DATA_DIMS[0]
BF16_ULP = 2.0 ** -7  # one bf16 unit in the last place at 1.0
MAX_BIT_MISMATCH = 1e-4  # K3's D3PM bits against the plain version
F32_ULP2 = 2.0 ** -22  # two f32 units in the last place at 1.0

# Published peaks of one H100 SXM (dense, at the 700 W limit), the bound_ms
# yardstick: HBM bytes/s; operations/s by type (bf16, int8 and tf32 on the
# tensor cores, f32 on the CUDA cores).
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"bf16": 989e12, "int8": 1979e12, "tf32": 495e12, "f32": 67e12}


def roofline(bytes_moved: float, ops: float, kind: str) -> tuple:
    """(least ms, what bounds it): every input read once and every output
    written once at the HBM rate, or the operations at the peak rate of
    their type, whichever takes longer."""
    by_bytes = bytes_moved / HBM_BYTES_S * 1e3
    by_ops = ops / PEAK_OPS_S[kind] * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def time_ms(fn, iters: int = 20) -> float:
    """Mean device time of one call, by CUDA events over ``iters`` calls
    after one warm-up call. A ~50 ms device sleep is queued first, so
    the host has enqueued every call before the start event runs and
    the events time the device, not the host's launch rate."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _report(kernel, case: str, err: float, tol: float, ms: float, plain_ms: float,
            limit: tuple, library_ms=None) -> dict:
    """One [kernel] line; ``limit`` is :func:`roofline`'s (ms, what bounds it)."""
    ok = bool(err <= tol)
    lib = "none" if library_ms is None else f"{library_ms:.4f} ms"
    print(f"[kernel] {kernel.name} {case}: max|diff| {err:.3e} (tol {tol:.3e}) "
          f"{'ok' if ok else 'FAIL'}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"bound {limit[0]:.4f} ms ({limit[1]}), library {lib}", flush=True)
    if not ok:
        raise AssertionError(f"{kernel.name} {case}: max|diff| {err} > tol {tol}")
    return {"case": case, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": limit[0], "bound_by": limit[1], "library_ms": library_ms}


def _with_bits(a: torch.Tensor, g) -> torch.Tensor:
    """``a`` with 0/1 bits in its first MUT columns (the D3PM carry)."""
    a[:, :MUT] = (torch.rand(a.shape[0], MUT, generator=g) < 0.5).to(a.device, a.dtype)
    return a


_STEP_WRAPPERS = ("gemm_bf16_f32acc", "gemm_bf16_gn_silu", "gemm_bf16_posterior", "gemm_s8",
                  "gemm_s8_gn_silu", "gemm_s8_posterior", "gemm_s8q", "gemm_s8q_gn_silu",
                  "gemm_s8q_posterior", "rowquant_s8", "groupnorm8_silu")


def _signature(name: str, args, kw) -> tuple:
    """What a case needs of one call: shapes, row strides and options."""
    if name.startswith("gemm_s8q"):  # (M, K, N, lda, then the output's options)
        a, n = args[0], args[2].shape[0]
        head = (a.shape[0], a.shape[1], n, a.stride(0))
        if name == "gemm_s8q":
            return head + (kw["out"].dtype, bool(kw.get("accumulate")))
        if name == "gemm_s8q_gn_silu":
            return head + (kw["out"].stride(0), kw.get("acc_into") is not None)
        return head + (args[3].stride(0),)
    if not name.startswith("gemm_") or name == "gemm_s8":
        return ()
    a, b = args[0], args[1] if name.startswith("gemm_bf16") else args[2]
    if name == "gemm_bf16_f32acc":
        out = kw["out"]
        return (a.shape[0], a.shape[1], b.shape[1], a.stride(0), b.stride(0),
                kw.get("bias") is not None, kw.get("row_add") is not None, out.dtype,
                out.stride(0), kw.get("a_mut_cols", 0))
    if name == "gemm_bf16_gn_silu":
        return (a.shape[0], a.shape[1], b.shape[1], a.stride(0), b.stride(0), kw["out"].stride(0))
    if name == "gemm_bf16_posterior":
        return (a.shape[0], a.shape[1], b.shape[1], a.stride(0), b.stride(0), args[2].stride(0))
    if name == "gemm_s8_gn_silu":
        return (a.shape[0], a.shape[1], args[3].shape[0], kw["out"].stride(0),
                kw.get("acc_into") is not None)
    if name == "gemm_s8_posterior":
        return (a.shape[0], a.shape[1], args[3].shape[0], args[4].stride(0))
    return ()


def record_step(dev, quantize: str = "none", head: bool = False, rows: int = BATCH) -> tuple:
    """One reverse step of the main path as the sampler makes it: a seeded
    model at full width (data 62/5054/26, hidden 256/512/256), one step of
    ``FusedSampler.sample`` at ``rows`` rows (``stop_after=1``) with its kernel
    wrapper calls recorded (each call goes through). Returns the calls as
    (wrapper, :func:`_signature`) and the step's launches by kernel and
    mode (counts read before and after the step)."""
    cfg = Config()
    cfg.model.diffusion.discrete_mutation_head = head
    dims = cfg.freeze_dims(*DATA_DIMS, list(cfg.model.condition_on))
    model = ConditionalDiffusion.from_config(cfg, dims)
    init_weights(model.denoiser, torch.Generator().manual_seed(0))
    model.denoiser.to(dev)
    sampler = FusedSampler(model, dev, quantize=None if quantize == "none" else quantize)
    cond = torch.zeros(rows, dims.condition_dim, device=dev)
    sampler.sample(cond, torch.Generator(dev).manual_seed(0), stop_after=1)  # plans, maps
    torch.cuda.synchronize()
    calls, real = [], {n: getattr(fused_sampler, n) for n in _STEP_WRAPPERS}

    def recorder(name):
        def call(*args, **kw):
            calls.append((name, _signature(name, args, kw)))
            return real[name](*args, **kw)
        return call

    before = {k.name: dict(k.modes) for k in KERNELS}
    for name in _STEP_WRAPPERS:
        setattr(fused_sampler, name, recorder(name))
    try:
        sampler.sample(cond, torch.Generator(dev).manual_seed(0), stop_after=1)
    finally:
        for name in _STEP_WRAPPERS:
            setattr(fused_sampler, name, real[name])
    torch.cuda.synchronize()
    launches = {k.name: {m: n - before[k.name][m] for m, n in k.modes.items()
                         if n - before[k.name][m]} for k in KERNELS}
    return calls, {name: modes for name, modes in launches.items() if modes}


def check_step_launches(dev) -> dict:
    """The launches of one reverse step by kernel and mode at 333 rows:
    bf16 and D3PM 12 (w_in, 10 block products with the GN epilogue, the
    output product with the posterior epilogue) and int8 "out", "io" 13,
    "all" 15; never the standalone K2 or K3, and the standalone K5 only
    before the input product (once a step under "io" and "all"). Returns
    every step's recorded calls by (quantize, head)."""
    recorded = {}
    for quantize, head in (("none", False), ("none", True), ("out", False), ("io", False),
                           ("all", False), ("all", True)):
        calls, launches = record_step(dev, quantize, head)
        total = sum(sum(m.values()) for m in launches.values())
        label = f"{'d3pm ' if head else ''}{'bf16' if quantize == 'none' else 'int8-' + quantize}"
        print(f"[kernel] launches per reverse step, {label} at {BATCH} rows: {total} "
              f"{json.dumps(launches)}", flush=True)
        k5 = sum(launches.get(ROWQUANT.name, {}).values())
        if total != STEP_LAUNCHES[quantize] or GROUPNORM.name in launches or (
                POSTERIOR.name in launches) or k5 != (quantize in ("io", "all")):
            raise AssertionError(f"{label} step: {total} launches (want "
                                 f"{STEP_LAUNCHES[quantize]}, no standalone K2/K3, K5 only for "
                                 f"the input product): {launches}")
        recorded[(quantize, head)] = calls
    return recorded


def _strided(rows: int, cols: int, ld: int, dtype, dev, fill) -> torch.Tensor:
    """A (rows, cols) view with row stride ``ld``, values from ``fill``."""
    buf = torch.zeros(rows, ld, dtype=dtype, device=dev)
    view = buf[:, ld - cols:] if ld >= 2 * cols else buf[:, :cols]
    view.copy_(fill(rows, cols))
    return view


def check_gemm(dev, g, calls, extras: bool = True) -> list:
    """K1 at the products of the main path's bf16 step that it runs
    without a fused epilogue (``calls``, recorded by :func:`record_step`:
    the input product, with the t_add row as bias, c_proj as the row add,
    bf16 out), plus, with ``extras``, that product with the D3PM prologue
    on the first 62 columns and the latent step's two 256-wide products at
    999 rows. Each
    case runs twice and the two outputs must be equal bit for bit (split-K
    sums in a fixed order). No case may take the general ("unaligned")
    path. Tolerance: both sides sum bf16-exact products in f32, in
    different orders, so an f32 result differs by f32 rounding of the sum,
    1e-3 relative to max(1, |ref|); a bf16 result is the plain f32 result
    rounded once to bf16, and a sum that lands near a rounding boundary may
    round the other way: 2^-7 of max(1, |ref|)."""
    per_step = {}
    for name, sig in calls:
        if name == "gemm_bf16_f32acc":
            per_step[sig] = per_step.get(sig, 0) + 1
    cases = list(per_step.items())
    if extras:
        first = cases[0][0]
        cases.insert(1, (first[:9] + (MUT,), 0))  # the D3PM step's input product
        # The latent step's products at 999 rows: o_lat = h·M2 + m_b, n_inj = bf16(zeta)·Lᵀ.
        cases += [((LATENT_ROWS, 256, 256, 256, 256, True, False, torch.float32, 256, 0), 0),
                  ((LATENT_ROWS, 256, 256, 256, 256, False, False, torch.float32, 256, 0), 0)]
    out = []
    randn = lambda r, c: torch.randn(r, c, generator=g)  # noqa: E731
    for (m, k, n, lda, ldb, has_bias, has_row_add, out_dtype, ldc, mut), count in cases:
        a = _strided(m, k, lda, torch.bfloat16, dev, randn)
        if mut:
            a = _with_bits(a, g)
        w = _strided(k, n, ldb, torch.bfloat16, dev, lambda r, c: randn(r, c) / math.sqrt(k))
        bias = torch.randn(n, generator=g).to(dev) if has_bias else None
        row_add = (torch.randn(m, n, generator=g).to(dev, torch.bfloat16).float()
                   if has_row_add else None)
        buf = _strided(m, n, ldc, out_dtype, dev, lambda r, c: torch.zeros(r, c))
        unaligned = GEMM.modes["unaligned"]
        got = gemm_bf16_f32acc(a, w, out=buf, bias=bias, row_add=row_add, a_mut_cols=mut).clone()
        again = gemm_bf16_f32acc(a, w, out=buf, bias=bias, row_add=row_add, a_mut_cols=mut)
        ref = gemm_bf16_f32acc_plain(a, w, bias, row_add, mut).to(out_dtype).float()
        torch.cuda.synchronize()
        if GEMM.modes["unaligned"] != unaligned:
            raise AssertionError(f"K1 {m}x{k}x{n}: the path's layout took the general path")
        plan = gemm_plan(m, n, k, torch.cuda.get_device_properties(dev).multi_processor_count,
                         "bf16")
        if not torch.equal(got, again):
            raise AssertionError(f"K1 {m}x{k}x{n} plan {tuple(plan)}: two launches differ")
        err = float((got.float() - ref).abs().max())
        rel = BF16_ULP if out_dtype == torch.bfloat16 else 1e-3
        tol = rel * max(1.0, float(ref.abs().max()))
        ms = time_ms(lambda: gemm_bf16_f32acc(a, w, out=buf, bias=bias, row_add=row_add,
                                              a_mut_cols=mut))
        plain_ms = time_ms(lambda: gemm_bf16_f32acc_plain(a, w, bias, row_add, mut).to(out_dtype))
        # Yardstick: cuBLAS bf16 (bf16 out), with the bias where there is one.
        ac, wc = a.contiguous(), w.contiguous()
        if bias is not None:
            bias_bf = bias.to(torch.bfloat16)
            library_ms = time_ms(lambda: torch.addmm(bias_bf, ac, wc))
        else:
            library_ms = time_ms(lambda: torch.matmul(ac, wc))
        moved = (2 * (m * k + k * n) + (4 * n if has_bias else 0)
                 + (4 * m * n if has_row_add else 0) + buf.element_size() * m * n)
        case = (f"{m}x{k}{'(2b-1 on 62)' if mut else ''}{' view' if lda != k else ''}"
                f".{k}x{n}{' +bias' if has_bias else ''}{' +row_add' if has_row_add else ''}"
                f" ->{'bf16' if out_dtype == torch.bfloat16 else 'f32'}")
        row = _report(GEMM, case, err, tol, ms, plain_ms, roofline(moved, 2.0 * m * n * k, "bf16"),
                      library_ms)
        row.update(plan=f"{plan.bm}x{plan.bn}/{plan.splits}", per_step=count)
        print(f"[kernel] {GEMM.name} {case}: plan {plan.bm}x{plan.bn} tiles, {plan.splits} "
              f"split(s), repeat bit-equal; {count} launch(es) per bf16 step", flush=True)
        out.append(row)
    return out


def _gn_vectors(n: int, g, dev) -> tuple:
    return (torch.randn(n, generator=g).to(dev), (1.0 + 0.1 * torch.randn(n, generator=g)).to(dev),
            (0.1 * torch.randn(n, generator=g)).to(dev))


def _fused_report(kernel, case: str, got, again, ref, tol: float, ms: float, plain_ms: float,
                  pair_ms: float, limit: tuple, plan, count: int, library_ms=None) -> dict:
    """A fused case's [kernel] line, beside the hand-written pair it replaces."""
    if not torch.equal(got, again):
        raise AssertionError(f"{kernel.name} {case}: two launches differ")
    err = float((got.float() - ref).abs().max())
    row = _report(kernel, case, err, tol, ms, plain_ms, limit, library_ms)
    row.update(pair_ms=pair_ms, plan=f"{plan.bm}x{plan.bn}/{plan.splits}", per_step=count)
    print(f"[kernel] {kernel.name} {case}: pair {pair_ms:.4f} ms, fused/pair {ms / pair_ms:.3f}; "
          f"plan {plan.bm}x{plan.bn}/{plan.splits}; repeat bit-equal; {count} launch(es) per "
          "step", flush=True)
    if ms >= pair_ms:
        print(f"[kernel] WARNING {kernel.name} {case}: fused {ms:.4f} ms not below the pair's "
              f"{pair_ms:.4f} ms", flush=True)
    return row


def check_gn_epilogue(dev, g, bf16_calls, all_calls) -> dict:
    """The block products with GroupNorm+SiLU in their epilogue, at every
    distinct product of the recorded steps, in the sampler's layout (A and
    the output as [h | skip] views where the step has them): K1's in the
    bf16 step, K6's at the shapes of the int8 "all" step's fused products
    (from K5's codes: the route before K6 quantized its own A, checked
    against that route in :func:`check_quant_prologue`; the decoders'
    second fc1 part accumulating the first part's f32 sum). Against the plain composition
    (the product's plain version, then K2's) with K2's tolerance, 2^-7 of
    max(1, |ref|); timed beside the pair it replaces (K1 or K6 into an f32
    buffer, then K2)."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = {GEMM_GN.name: [], GEMM_S8_GN.name: []}
    for kind, calls, name in (("bf16", bf16_calls, "gemm_bf16_gn_silu"),
                              ("int8", all_calls, "gemm_s8q_gn_silu")):
        per_step = {}
        for wrapper, sig in calls:
            if wrapper == name:
                per_step[sig] = per_step.get(sig, 0) + 1
        for sig, count in per_step.items():
            if kind == "bf16":
                m, k, n, lda, ldb, ldo = sig
                a = _strided(m, k, lda, torch.bfloat16, dev,
                             lambda r, c: 2.0 * torch.randn(r, c, generator=g))
                w = _strided(k, n, ldb, torch.bfloat16, dev,
                             lambda r, c: torch.randn(r, c, generator=g) / math.sqrt(k))
                ops, acc_into, kernel = (a, w), None, GEMM_GN
                fused, product = gemm_bf16_gn_silu, gemm_bf16_f32acc
                plain = lambda b: gemm_bf16_f32acc_plain(a, w, b)  # noqa: E731
                kk, moved_in = k, 2 * (m * k + k * n)
            else:
                m, kp, n, _, ldo, has_acc = sig
                qa, rs = rowquant_s8_plain(3.0 * torch.randn(m, kp, generator=g).to(dev))
                q, cs = pack_int8((torch.randn(kp, n, generator=g) / math.sqrt(kp)).numpy())
                ops, kernel = (qa, rs, kmajor_int8(q).to(dev), cs.to(dev)), GEMM_S8_GN
                acc_into = torch.randn(m, n, generator=g).to(dev) if has_acc else None
                fused, product = gemm_s8_gn_silu, gemm_s8
                plain = lambda b: gemm_s8_plain(*ops, b, acc_into=acc_into)  # noqa: E731
                kk, moved_in = kp, m * kp + ops[2].numel() + 4 * (m + n)
            bias, scale, shift = _gn_vectors(n, g, dev)
            res = _strided(m, n, ldo, torch.bfloat16, dev, lambda r, c: torch.zeros(r, c))
            plan = gemm_plan(m, n, kk, sms, kind, gn_widths(n))

            def run():
                return fused(*ops, bias, scale, shift, out=res, acc_into=acc_into) if acc_into \
                    is not None else fused(*ops, bias, scale, shift, out=res)

            got = run().clone()
            again = run().clone()
            ref = groupnorm8_silu_plain(plain(bias), scale, shift).to(torch.bfloat16).float()
            torch.cuda.synchronize()
            tol = BF16_ULP * max(1.0, float(ref.abs().max()))
            pre = acc_into.clone() if acc_into is not None else torch.empty(m, n, device=dev)

            def pair():
                if acc_into is not None:  # the timed repeats add to pre again: the same work
                    product(*ops, out=pre, bias=bias, accumulate=True)
                else:
                    product(*ops, out=pre, bias=bias)
                groupnorm8_silu(pre, scale, shift, out=res)

            ms = time_ms(run)
            plain_ms = time_ms(lambda: groupnorm8_silu_plain(plain(bias), scale, shift).to(
                torch.bfloat16))
            pair_ms = time_ms(pair)
            # A, B, the four f32 vectors, the f32 sum read where it accumulates,
            # the bf16 output; the product's operations (10 per element of GN).
            moved = moved_in + 12 * n + (4 * m * n if acc_into is not None else 0) + 2 * m * n
            limit = roofline(moved, 2.0 * m * n * kk, kind)
            case = (f"{m}x{kk}{' view' if kind == 'bf16' and sig[3] != kk else ''}.{kk}x{n} +bias"
                    f"{' +acc' if acc_into is not None else ''} ->GN+SiLU bf16"
                    f"{' view' if ldo != n else ''}")
            out[kernel.name].append(_fused_report(kernel, case, got, again, ref, tol, ms, plain_ms,
                                                  pair_ms, limit, plan, count))
    return out


def check_posterior_epilogue(dev, g, m: int = BATCH, kinds=("bf16", "int8"),
                             muts=(0, MUT), modes=("philox", "buffer", "none")) -> dict:
    """The output product with the reverse step in its epilogue, at the
    path's shape (m x 256 · 256 x 5142, the padded W_out and carry; m = 333
    on the main paths): ``kinds`` of K1 (bf16) and K6 (int8, from K5's
    codes of h), in the noise ``modes``, without and with the D3PM head (62
    bit columns, the discrete DDPM table) as ``muts`` has them. The carry must equal the pair's (the product into the padded
    f32 acc, then K3, with the same plan) bit for bit. Against the plain
    composition as K3 is held: 2^-7 of max(1, |ref|) on the continuous
    columns, at most a 1e-4 share of differing bits. Timed beside the pair."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    sched = DiffusionSchedule.create("cosine", 1000)
    gains = torch.randn(1000, generator=g).numpy() * 0.3
    k = 256
    h = (2.0 * torch.randn(m, k, generator=g)).to(dev, torch.bfloat16)
    w = _strided(k, D, pad16(D), torch.bfloat16, dev,
                 lambda r, c: torch.randn(r, c, generator=g) / math.sqrt(k))
    qa, rs = rowquant_s8_plain(h)
    q, cs = pack_int8((torch.randn(k, D, generator=g) / math.sqrt(k)).numpy())
    s8_ops = (qa, rs, kmajor_int8(q).to(dev), cs.to(dev))
    b_out = (0.1 * torch.randn(D, generator=g)).to(dev)
    x0 = _strided(m, D, pad16(D), torch.bfloat16, dev, lambda r, c: torch.randn(r, c, generator=g))
    xb0 = _with_bits(x0.clone(), g)
    acc = _strided(m, D, pad16(D), torch.float32, dev, lambda r, c: torch.zeros(r, c))
    out = {GEMM_POSTERIOR.name: [], GEMM_S8_POSTERIOR.name: []}
    for kind in kinds:
        if kind == "bf16":
            ops, kernel, fused, product = (h, w), GEMM_POSTERIOR, gemm_bf16_posterior, \
                gemm_bf16_f32acc
            plain_acc = lambda: gemm_bf16_f32acc_plain(h, w)  # noqa: E731
            moved_in, kk = 2 * (m * k + k * D), k
        else:
            ops, kernel, fused, product = s8_ops, GEMM_S8_POSTERIOR, gemm_s8_posterior, gemm_s8
            plain_acc = lambda: gemm_s8_plain(*s8_ops)  # noqa: E731
            moved_in, kk = qa.numel() + s8_ops[2].numel() + 4 * (m + D), qa.shape[1]
        plan = gemm_plan(m, D, kk, sms, kind, POSTERIOR_WIDTHS)
        for mut in muts:
            coeffs = torch.from_numpy(coefficient_table(sched, gains, discrete=mut > 0)).to(dev)
            start = xb0 if mut else x0
            for mode, step in (("philox", 17), ("buffer", 0), ("none", 999)):
                if mode not in modes:
                    continue
                noise = torch.randn(1, m, D, generator=g).to(dev) if mode == "buffer" else None
                table = coeffs[17:18].contiguous() if mode == "buffer" else coeffs
                kw = dict(b_out=b_out, coeffs=table, step=step, mode=mode, noise=noise, seed=1234,
                          mut_dim=mut)
                x = start.clone()

                # Timed repeats step the same carry again: the same work.
                def run(x=x, kw=kw):
                    return fused(*ops, x, **kw, plan=plan)

                def pair(x=x, kw=kw):
                    product(*ops, out=acc, plan=plan)
                    return x0_posterior_step(acc, x, **kw)

                got = run().clone()
                x.copy_(start)
                again = run().clone()
                x.copy_(start)
                paired = pair().clone()
                ref = x0_posterior_step_plain(plain_acc(), start, b_out, table, step, mode,
                                              noise, seed=1234, mut_dim=mut)
                torch.cuda.synchronize()
                if not torch.equal(got, paired):
                    raise AssertionError(f"{kernel.name} {mode} d3pm={mut}: the carry differs from "
                                         f"the pair's ({int((got != paired).sum())} elements)")
                if mut:
                    flips = float((got[:, :mut] != ref[:, :mut]).float().mean())
                    if flips > MAX_BIT_MISMATCH:
                        raise AssertionError(f"{kernel.name} d3pm {mode}: bits differ from the "
                                             f"plain version ({flips:.2e})")
                tol = BF16_ULP * max(1.0, float(ref[:, mut:].float().abs().max()))
                ms, plain_ms, pair_ms = (time_ms(run), time_ms(
                    lambda: x0_posterior_step_plain(plain_acc(), start, b_out, table, step, mode,
                                                    noise, seed=1234, mut_dim=mut)),
                    time_ms(pair))
                # A, B, b_out, the carry read and written, the noise slab in buffer mode.
                moved = (moved_in + 4 * D + m * D * (2 + 2 + (4 if mode == "buffer" else 0)))
                limit = roofline(moved, 2.0 * m * D * kk, kind)
                case = f"{m}x{kk}.{kk}x5142 {'d3pm(62) ' if mut else ''}{mode} (bits = pair)"
                out[kernel.name].append(_fused_report(
                    kernel, case, got[:, mut:], again[:, mut:], ref[:, mut:].float(), tol, ms,
                    plain_ms, pair_ms, limit, plan, 1))
    return out


def check_quant_prologue(dev, g, steps) -> dict:
    """K6 quantizing its own A (K5's work as its prologue) at every int8
    product of the recorded steps that takes it: the decoders' first fc1
    parts (plain epilogue), the block products (GN epilogue, the second
    fc1 parts accumulating) and the output product (posterior epilogue;
    DDPM "philox" under "out", DDIM "none" under "io"/"all", and D3PM
    "none" under "all" with the head), each in the sampler's layout. Every
    result must equal the pair it replaces -- the standalone K5, then K6
    from its codes, with the same plan -- bit for bit, twice; it is held to
    the plain composition (rowquant_s8_plain, then the product's and
    epilogue's plain versions) with that product's tolerance, and timed
    beside the pair (``pair_ms``)."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = {GEMM_S8Q.name: [], GEMM_S8Q_GN.name: [], GEMM_S8Q_POSTERIOR.name: []}
    per_step = {}
    for (quantize, head), calls in steps.items():
        for wrapper, sig in calls:
            if wrapper.startswith("gemm_s8q") and (quantize, head) == ("all", False):
                per_step[(wrapper, sig)] = per_step.get((wrapper, sig), 0) + 1
    randn = lambda r, c: torch.randn(r, c, generator=g)  # noqa: E731
    for (wrapper, sig), count in per_step.items():
        m, k, n, lda = sig[:4]
        a = _strided(m, k, lda, torch.bfloat16, dev, lambda r, c: 3.0 * randn(r, c))
        q, cs = pack_int8((randn(k, n) / math.sqrt(k)).numpy())
        qb, cs = kmajor_int8(q).to(dev), cs.to(dev)
        kp = qb.shape[1]
        codes = torch.empty(m, kp, dtype=torch.int8, device=dev)
        scales = torch.empty(m, device=dev)
        moved = m * k * 2 + qb.numel() + 4 * n
        view = " view" if lda != k else ""
        if wrapper == "gemm_s8q_posterior":
            for mode, mut in (("philox", 0), ("none", 0), ("none", MUT)):
                out[GEMM_S8Q_POSTERIOR.name].append(_quant_posterior_case(
                    dev, g, a, qb, cs, codes, scales, mode, mut, sms,
                    count if mode == "philox" else 0))
            continue
        bias = torch.randn(n, generator=g).to(dev)
        if wrapper == "gemm_s8q_gn_silu":
            kernel, ldo, has_acc = GEMM_S8Q_GN, sig[4], sig[5]
            _, scale, shift = _gn_vectors(n, g, dev)
            acc_into = torch.randn(m, n, generator=g).to(dev) if has_acc else None
            res = _strided(m, n, ldo, torch.bfloat16, dev, lambda r, c: torch.zeros(r, c))
            plan = gemm_plan(m, n, kp, sms, "int8", gn_widths(n))

            def run():
                return gemm_s8q_gn_silu(a, qb, cs, bias, scale, shift, out=res, acc_into=acc_into,
                                        plan=plan)

            def pair():
                rowquant_s8(a, out=codes, scale=scales)
                return gemm_s8_gn_silu(codes, scales, qb, cs, bias, scale, shift, out=res,
                                       acc_into=acc_into, plan=plan)

            def plain():
                v = gemm_s8q_plain(a, qb, cs, bias, acc_into=acc_into)
                return groupnorm8_silu_plain(v, scale, shift).to(torch.bfloat16)

            moved += 12 * n + (4 * m * n if has_acc else 0) + 2 * m * n
            case = (f"{m}x{k}{view}.{k}x{n} +bias{' +acc' if has_acc else ''} ->GN+SiLU bf16"
                    f"{' view' if ldo != n else ''}")
        else:
            kernel, out_dtype, accumulate = GEMM_S8Q, sig[4], sig[5]
            res = _strided(m, n, n, out_dtype, dev, lambda r, c: torch.zeros(r, c))
            plan = gemm_plan(m, n, kp, sms, "int8", QUANT_WIDTHS)
            bias = None  # the decoders' first fc1 part: its bias joins the last part

            def run():
                return gemm_s8q(a, qb, cs, out=res, accumulate=accumulate, plan=plan)

            def pair():
                rowquant_s8(a, out=codes, scale=scales)
                return gemm_s8(codes, scales, qb, cs, out=res, accumulate=accumulate, plan=plan)

            def plain():
                return gemm_s8q_plain(a, qb, cs).to(out_dtype)

            moved += res.element_size() * m * n * (2 if accumulate else 1)
            case = f"{m}x{k}{view}.{k}x{n} ->{'bf16' if out_dtype == torch.bfloat16 else 'f32'}"
        got = run().clone()
        again = run().clone()
        paired = pair().clone()
        ref = plain().float()
        torch.cuda.synchronize()
        if not torch.equal(got, paired):
            raise AssertionError(f"{kernel.name} {case}: differs from K5 -> K6 "
                                 f"({int((got != paired).sum())} elements)")
        rel = F32_ULP2 if got.dtype == torch.float32 else BF16_ULP
        tol = rel * max(1.0, float(ref.abs().max()))
        ms, plain_ms, pair_ms = time_ms(run), time_ms(plain), time_ms(pair)
        limit = roofline(moved, 2.0 * m * n * kp, "int8")
        out[kernel.name].append(_fused_report(kernel, case + " (bits = K5 -> K6)", got, again, ref,
                                              tol, ms, plain_ms, pair_ms, limit, plan, count))
    return out


def _quant_posterior_case(dev, g, h, qb, cs, codes, scales, mode, mut, sms, count,
                          library: bool = False) -> dict:
    """One output-product case of :func:`check_quant_prologue`: the carry
    after the fused step against K5 -> K6 with the posterior epilogue;
    with ``library``, cuBLASLt's s8·s8 -> s32 product of the same codes
    (``torch._int_mm``) timed beside it."""
    m, k = h.shape
    sched = DiffusionSchedule.create("cosine", 1000)
    gains = torch.randn(1000, generator=g).numpy() * 0.3
    coeffs = torch.from_numpy(coefficient_table(sched, gains, discrete=mut > 0)).to(dev)
    b_out = (0.1 * torch.randn(D, generator=g)).to(dev)
    start = _strided(m, D, pad16(D), torch.bfloat16, dev,
                     lambda r, c: torch.randn(r, c, generator=g))
    if mut:
        start = _with_bits(start, g)
    step = 17 if mode == "philox" else 999
    kw = dict(b_out=b_out, coeffs=coeffs, step=step, mode=mode, seed=1234, mut_dim=mut)
    plan = gemm_plan(m, D, qb.shape[1], sms, "int8", POSTERIOR_WIDTHS)
    x = start.clone()

    def run():  # timed repeats step the same carry again: the same work
        return gemm_s8q_posterior(h, qb, cs, x, **kw, plan=plan)

    def pair():
        rowquant_s8(h, out=codes, scale=scales)
        return gemm_s8_posterior(codes, scales, qb, cs, x, **kw, plan=plan)

    def plain():
        return x0_posterior_step_plain(gemm_s8q_plain(h, qb, cs), start, b_out, coeffs, step,
                                       mode, seed=1234, mut_dim=mut)

    got = run().clone()
    x.copy_(start)
    again = run().clone()
    x.copy_(start)
    paired = pair().clone()
    x.copy_(start)
    ref = plain()
    torch.cuda.synchronize()
    case = f"{m}x{k}.{k}x5142 {'d3pm(62) ' if mut else ''}{mode} (bits = K5 -> K6)"
    if not torch.equal(got, paired):
        raise AssertionError(f"{GEMM_S8Q_POSTERIOR.name} {case}: the carry differs from the "
                             f"pair's ({int((got != paired).sum())} elements)")
    if mut and float((got[:, :mut] != ref[:, :mut]).float().mean()) > MAX_BIT_MISMATCH:
        raise AssertionError(f"{GEMM_S8Q_POSTERIOR.name} {case}: bits differ from the plain "
                             "version")
    tol = BF16_ULP * max(1.0, float(ref[:, mut:].float().abs().max()))
    ms, plain_ms, pair_ms = time_ms(run), time_ms(plain), time_ms(pair)
    library_ms = time_ms(lambda: torch._int_mm(codes, qb.t())) if library else None
    moved = m * k * 2 + qb.numel() + 8 * D + m * D * 4
    limit = roofline(moved, 2.0 * m * D * qb.shape[1], "int8")
    return _fused_report(GEMM_S8Q_POSTERIOR, case, got[:, mut:], again[:, mut:],
                         ref[:, mut:].float(), tol, ms, plain_ms, pair_ms, limit, plan, count,
                         library_ms)


def check_groupnorm(dev, g) -> list:
    """K2 at the block widths. Tolerance: the kernel stores bf16, the
    plain version is f32 rounded to bf16 once; f32 statistics in another
    order can move a value across one bf16 rounding boundary, so 2^-7 of
    max(1, |ref|): one to two bf16 ulps of the largest value."""
    out = []
    for f in (512, 256):
        h = (3.0 * torch.randn(BATCH, f, generator=g) + 1.0).to(dev)
        scale = (1.0 + 0.1 * torch.randn(f, generator=g)).to(dev)
        bias = (0.1 * torch.randn(f, generator=g)).to(dev)
        got = groupnorm8_silu(h, scale, bias).float()
        ref = groupnorm8_silu_plain(h, scale, bias)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        tol = BF16_ULP * max(1.0, float(ref.abs().max()))
        buf = torch.empty(BATCH, f, dtype=torch.bfloat16, device=dev)
        ms = time_ms(lambda: groupnorm8_silu(h, scale, bias, out=buf))
        plain_ms = time_ms(lambda: groupnorm8_silu_plain(h, scale, bias).to(torch.bfloat16))
        limit = roofline(BATCH * f * (4 + 2) + 2 * 4 * f, 10.0 * BATCH * f, "f32")
        out.append(_report(GROUPNORM, f"333x{f}", err, tol, ms, plain_ms, limit))
    return out


def check_posterior(dev, g) -> list:
    """K3 at 333 x 5142 in its three noise modes, without and with the
    D3PM head (62 bit columns, table columns 4-5 from the discrete
    DDPM table). Tolerance: both sides compute in f32 with the same
    operations in the same order and round once to bf16; 2^-7 of
    max(1, |ref|) on the continuous columns. Bits: the kernel writes the
    plain version's posterior with _rn intrinsics but for the sigmoid's
    fast divide, so a threshold u < p_prev moves only where u lies within
    a few ulp of p_prev; at
    most a 1e-4 share of the bits may differ. The Philox stream must
    equal the plain generator's exactly, repeat for a repeated seed, and
    have mean ~0 (|mean| < 0.005, 6 standard errors at 1.7M draws),
    variance ~1 (|var - 1| < 0.01) and |z| <= sqrt(3) + one bf16 ulp."""
    sched = DiffusionSchedule.create("cosine", 1000)
    gains = torch.randn(1000, generator=g).numpy() * 0.3
    acc = (3.0 * torch.randn(BATCH, D, generator=g)).to(dev)
    x0 = torch.randn(BATCH, D, generator=g).to(dev, torch.bfloat16)
    xb0 = _with_bits(x0.clone(), g)
    b_out = (0.1 * torch.randn(D, generator=g)).to(dev)
    out = []
    for mut in (0, MUT):
        coeffs = torch.from_numpy(coefficient_table(sched, gains, discrete=mut > 0)).to(dev)
        start = xb0 if mut else x0
        for mode, step in (("philox", 17), ("buffer", 0), ("none", 999)):
            if mode == "buffer":
                noise = torch.randn(1, BATCH, D, generator=g).to(dev)
                table = coeffs[17:18].contiguous()
            else:
                noise = None
                table = coeffs
            x = start.clone()
            x0_posterior_step(acc, x, b_out, table, step, mode, noise=noise, seed=1234,
                              mut_dim=mut)
            ref = x0_posterior_step_plain(acc, start, b_out, table, step, mode, noise, seed=1234,
                                          mut_dim=mut)
            torch.cuda.synchronize()
            err = float((x[:, mut:].float() - ref[:, mut:].float()).abs().max())
            tol = BF16_ULP * max(1.0, float(ref.float().abs().max()))
            case = f"333x5142 {mode}"
            if mut:
                bits = x[:, :mut].float()
                flips = float((bits != ref[:, :mut].float()).float().mean())
                binary = bool(((bits == 0) | (bits == 1)).all())
                print(f"[kernel] {POSTERIOR.name} d3pm {mode}: bits binary {binary}, "
                      f"mismatch share {flips:.2e} (<= {MAX_BIT_MISMATCH:.0e}), "
                      f"share of ones {float(bits.mean()):.3f}", flush=True)
                if not binary or flips > MAX_BIT_MISMATCH:
                    raise AssertionError(f"K3 d3pm {mode}: bits differ from the plain version")
                case = f"333x5142 d3pm(62) {mode}"
            xb = start.clone()
            ms = time_ms(lambda: x0_posterior_step(acc, xb, b_out, table, step, mode,
                                                   noise=noise, seed=1234, mut_dim=mut))
            plain_ms = time_ms(lambda: x0_posterior_step_plain(acc, start, b_out, table, step,
                                                               mode, noise, seed=1234,
                                                               mut_dim=mut))
            # acc read, carry read and written, b_out, the noise slab in buffer mode.
            moved = BATCH * D * (4 + 2 + 2 + (4 if mode == "buffer" else 0)) + 4 * D
            limit = roofline(moved, 10.0 * BATCH * D, "f32")
            out.append(_report(POSTERIOR, case, err, tol, ms, plain_ms, limit))

    # The noise alone: a row (c0, c1, sv, g) = (0, 0, 1, 0) leaves x = z.
    unit = torch.tensor([[0.0, 0.0, 1.0, 0.0, 0.0, 0.0]] * 3, device=dev)
    zs = []
    for _ in range(2):
        z = x0.clone()
        x0_posterior_step(acc, z, b_out, unit, 2, "philox", seed=99)
        zs.append(z.float())
    plain_z = philox_uniform_noise(99, 2, BATCH, D, device=dev).to(torch.bfloat16).float()
    torch.cuda.synchronize()
    z = zs[0]
    mean, var, zmax = float(z.mean()), float(z.var()), float(z.abs().max())
    same_seed = bool(torch.equal(zs[0], zs[1]))
    exact = bool(torch.equal(z, plain_z))
    bound = math.sqrt(3.0) + 2.0 ** -7
    ok = abs(mean) < 0.005 and abs(var - 1.0) < 0.01 and zmax <= bound and same_seed and exact
    print(f"[kernel] {POSTERIOR.name} philox noise: mean {mean:.2e} var {var:.5f} "
          f"max|z| {zmax:.5f} (<= {bound:.5f}) repeatable {same_seed} "
          f"equals plain {exact} {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("Philox noise check failed")
    return out


def check_rowquant(dev, g) -> list:
    """K5 where the int8 path runs it: the input product's carry, 5142
    columns in the padded (row stride 5152) bf16 buffer with bits on 62
    columns quantized as 2b - 1, at 333 rows and at bench.py's 32,768; and,
    as before K6 quantized its own A, the decoders' [h | skip] halves, 333 x
    256 and 333 x 512 row-strided views (the pairs of
    :func:`check_quant_prologue`). Tolerance 0: the same f32 operations and
    round-half-even, so the codes and scales equal the plain version's (the
    error reported is the largest code difference plus the largest scale
    difference)."""
    out = []
    base = (3.0 * torch.randn(BATCH, 1024, generator=g)).to(dev, torch.bfloat16)
    carries = {}
    for rows in (BATCH, 32768):
        c = _strided(rows, D, pad16(D), torch.bfloat16, dev,
                     lambda r, k: torch.randn(r, k, generator=g))
        carries[rows] = _with_bits(c, g)
    for case, a, mut in ((f"{BATCH}x5142 padded (2b-1 on 62)", carries[BATCH], MUT),
                         ("32768x5142 padded (2b-1 on 62)", carries[32768], MUT),
                         ("333x256 (view of 512)", base[:, 256:512], 0),
                         ("333x512 (view of 1024)", base[:, 512:], 0)):
        q, scale = rowquant_s8(a, mut_cols=mut)
        rq, rs = rowquant_s8_plain(a, mut)
        torch.cuda.synchronize()
        err = float((q.int() - rq.int()).abs().max()) + float((scale - rs).abs().max())
        ms = time_ms(lambda: rowquant_s8(a, out=q, scale=scale, mut_cols=mut))
        plain_ms = time_ms(lambda: rowquant_s8_plain(a, mut))
        m, k = a.shape
        limit = roofline(m * k * a.element_size() + q.numel() + 4 * m, 3.0 * m * k, "f32")
        out.append(_report(ROWQUANT, case, err, 0.0, ms, plain_ms, limit))
        print(f"[kernel] {ROWQUANT.name} {case}: {limit[0] / ms:.1%} of its bytes bound",
              flush=True)
        del rq, rs
    return out


def check_gemm_s8(dev, g) -> list:
    """K6 on the three kinds of int8 product: the input product
    (333x5152.5152x256 from the quantized carry, + t_add + c_proj, bf16
    out), a decoder fc1's second half (333x512.512x256, accumulated onto
    the first half's f32 result, + bias) and the output product
    (333x256.256x5142 into the padded f32 acc), with the weight codes
    K-major as the sampler stores them. Each case runs twice (from the
    same start where it accumulates) and the outputs must be equal bit
    for bit. The int32 sums are exact and the epilogue is the plain
    version's f32 operations in its order, so the results agree to f32
    rounding: 2^-22 of max(1, |ref|) in f32 (two f32 ulps), one bf16
    rounding (2^-7) for the bf16 output."""
    out = []
    carry = _with_bits(torch.randn(BATCH, D, generator=g).to(dev, torch.bfloat16), g)
    cases = [
        ("333x5152.5152x256 +t_add +c_proj ->bf16", carry, MUT, 256, torch.bfloat16, False),
        ("333x512.512x256 accumulate +bias", None, 0, 256, torch.float32, True),
        ("333x256.256x5142", None, 0, 5142, torch.float32, False),
    ]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for case, a, mut, n, out_dtype, acc in cases:
        if a is None:
            k = 512 if acc else 256
            a = (3.0 * torch.randn(BATCH, k, generator=g)).to(dev, torch.bfloat16)
        qa, rs = rowquant_s8_plain(a, mut)
        w = torch.randn(a.shape[1], n, generator=g) / math.sqrt(a.shape[1])
        q, cs = pack_int8(w.numpy())
        qb, cs = kmajor_int8(q).to(dev), cs.to(dev)
        bias = torch.randn(n, generator=g).to(dev) if n == 256 else None
        row_add = torch.randn(BATCH, n, generator=g).to(dev) if out_dtype == torch.bfloat16 else None
        start = torch.randn(BATCH, n, generator=g).to(dev) if acc else None
        buf = _strided(BATCH, n, pad16(n), out_dtype, dev, lambda r, c: torch.zeros(r, c))
        results = []
        for _ in range(2):
            if acc:
                buf.copy_(start)
            results.append(gemm_s8(qa, rs, qb, cs, out=buf, bias=bias, row_add=row_add,
                                   accumulate=acc).clone())
        ref = gemm_s8_plain(qa, rs, qb, cs, bias, row_add, start).to(out_dtype).float()
        torch.cuda.synchronize()
        plan = gemm_plan(BATCH, n, qa.shape[1], sms, "int8")
        if not torch.equal(results[0], results[1]):
            raise AssertionError(f"K6 {case} plan {tuple(plan)}: two launches differ")
        err = float((results[0].float() - ref).abs().max())
        rel = BF16_ULP if out_dtype == torch.bfloat16 else 2.0 ** -22
        tol = rel * max(1.0, float(ref.abs().max()))
        ms = time_ms(lambda: gemm_s8(qa, rs, qb, cs, out=buf, bias=bias, row_add=row_add,
                                     accumulate=acc))
        plain_ms = time_ms(lambda: gemm_s8_plain(qa, rs, qb, cs, bias, row_add, start).to(out_dtype))
        # Yardstick: cuBLASLt s8·s8 -> s32 at the padded shapes (B column-major).
        library_ms = time_ms(lambda: torch._int_mm(qa, qb.t()))
        n_p, kp = qb.shape
        moved = (qa.numel() + qb.numel() + 4 * (BATCH + n) + (4 * n if bias is not None else 0)
                 + (4 * BATCH * n if row_add is not None else 0) + (4 * BATCH * n if acc else 0)
                 + buf.element_size() * BATCH * n)
        limit = roofline(moved, 2.0 * BATCH * n * kp, "int8")
        row = _report(GEMM_S8, case, err, tol, ms, plain_ms, limit, library_ms)
        row.update(plan=f"{plan.bm}x{plan.bn}/{plan.splits}")
        print(f"[kernel] {GEMM_S8.name} {case}: plan {plan.bm}x{plan.bn} tiles, {plan.splits} "
              f"split(s), repeat bit-equal", flush=True)
        out.append(row)
    return out


def check_rbf(dev, g) -> list:
    """K4 at the validate step's shapes (real n = 100, synthetic m = 999,
    d = 5142) and the production MMD's (m = 9999) against the float64 plain
    version. Tolerance: f32-accurate cross products in the kernel against
    f64: 1e-5 relative to the sum. The bound follows the route the plan
    takes: "fma" (f32 FMA on the CUDA cores) 2nmd operations at the f32
    peak; "tf32x3" (three TF32 products on the tensor cores, never one)
    3·2nmd at the TF32 peak; or the bytes of x and y (once where y is x),
    whichever is larger. One case at gamma = 0.37/d (the validator's
    ``compute_mmd`` takes any gamma), then one ``compute_mmd`` call on the
    card at that gamma against the MMD of the float64 plain sums."""
    x = torch.randn(100, D, generator=g).to(dev)
    y = (torch.randn(999, D, generator=g) * 1.05 + 0.02).to(dev)
    z = (torch.randn(9999, D, generator=g) * 1.05 + 0.02).to(dev)
    inv_d = 1.0 / D
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = []
    for case, a, b, gamma in (("xx 100x100", x, x, inv_d), ("yy 999x999", y, y, inv_d),
                              ("xy 100x999", x, y, inv_d), ("zz 9999x9999", z, z, inv_d),
                              ("xz 100x9999", x, z, inv_d),
                              ("xy@0.37/d 100x999", x, y, 0.37 * inv_d)):
        got = float(rbf_kernel_sum(a, b, gamma))
        ref = float(rbf_kernel_sum_plain(a, b, gamma))
        again = float(rbf_kernel_sum(a, b, gamma))
        if got != again:
            raise AssertionError(f"rbf_kernel_sum not deterministic: {got} vs {again}")
        err = abs(got - ref)
        tol = 1e-5 * abs(ref)
        ms = time_ms(lambda: rbf_kernel_sum(a, b, gamma))
        plain_ms = time_ms(lambda: rbf_kernel_sum_plain(a, b, gamma))
        n, m = a.shape[0], b.shape[0]
        rows = n if a is b else n + m
        plan = rbf_plan(n, m, D, sms)
        fma = plan.route == "fma"
        limit = roofline(4 * rows * D + 8, (1 if fma else 3) * 2.0 * n * m * D,
                         "f32" if fma else "tf32")
        row = _report(RBF, f"{case}x{D}", err, tol, ms, plain_ms, limit)
        row.update(route=plan.route, plan=f"{plan.bm}x{plan.bm}/{plan.splits}")
        print(f"[kernel] {RBF.name} {case}x{D}: route {plan.route}, plan "
              f"{plan.bm}x{plan.bm} tiles, d split {plan.splits} ({RBF_CHUNK}-column chunks), "
              f"{limit[0] / ms:.1%} of its bound, repeat bit-equal", flush=True)
        if limit[0] > ms:
            raise AssertionError(f"K4 {case}: {ms} ms is under its bound {limit[0]} ms")
        out.append(row)
    check_compute_mmd(dev, x, y, 0.37 * inv_d)
    return out


def check_compute_mmd(dev, x: torch.Tensor, y: torch.Tensor, gamma: float) -> None:
    """``BiologicalValidator.compute_mmd`` on the card (three K4 launches)
    against sqrt(xx/n² + yy/m² − 2xy/nm) of the float64 plain sums. Each
    K4 sum is held within 1e-5 of its own value, so the MMD within
    1e-5·(xx/n² + yy/m² + 2xy/nm) / (2·MMD)."""
    t0 = time.perf_counter()
    got = BiologicalValidator(Config(), device=dev).compute_mmd(
        x.cpu().numpy(), y.cpu().numpy(), gamma=gamma)
    seconds = time.perf_counter() - t0
    n, m = x.shape[0], y.shape[0]
    terms = (float(rbf_kernel_sum_plain(x, x, gamma)) / n ** 2,
             float(rbf_kernel_sum_plain(y, y, gamma)) / m ** 2,
             float(rbf_kernel_sum_plain(x, y, gamma)) / (n * m))
    ref = math.sqrt(max(terms[0] + terms[1] - 2.0 * terms[2], 0.0))
    tol = 1e-5 * (terms[0] + terms[1] + 2.0 * terms[2]) / (2.0 * ref)
    print(f"[kernel] {RBF.name} compute_mmd {n}x{m}x{D} at gamma 0.37/d on the card: {got:.6f} "
          f"against {ref:.6f} (|diff| {abs(got - ref):.3e}, tol {tol:.3e}) in {seconds:.3f} s",
          flush=True)
    if not abs(got - ref) <= tol:
        raise AssertionError(f"compute_mmd {got} against {ref}: beyond {tol}")


def _latent_case(dev, g, m: int, h: int, mode: str, sms: int) -> dict:
    """The fused latent step (both products and K7's work in one K1
    launch) over a 4-step segment at m x h, against the composition it
    replaces (K1 -> K7 draw -> K1 -> K7 update a step) under the same plan:
    priming draw, every step, the last drawing nothing; s, h_in and H_acc
    equal at every step, xi after the last, the next zeta as drawn. Against
    the plain composition (cuBLAS f32 products): s, H_acc, xi within 1e-3
    of max(1, |ref|) (f32 sums in another order), h_in within one bf16
    rounding. Timed at step 1 (a step that draws) beside that pair, the
    plain version and torch's two bf16 products (addmm + mm)."""
    n_lat = 4
    coeffs = (torch.rand(n_lat, 5, generator=g) + 0.1).to(dev)
    m2 = (torch.randn(h, h, generator=g) / math.sqrt(h)).to(dev, torch.bfloat16)
    l_t = (torch.randn(h, h, generator=g) / math.sqrt(h)).to(dev, torch.bfloat16)
    m_b, s0, c_proj = (torch.randn(*shape, generator=g).to(dev) for shape in ((h,), (m, h), (m, h)))
    t_add = torch.randn(n_lat + 1, h, generator=g).to(dev)
    zeta = torch.randn(n_lat, m, h, generator=g).to(dev) if mode == "buffer" else None
    hs = [(2.0 * torch.randn(m, h, generator=g)).to(dev, torch.bfloat16) for _ in range(n_lat)]
    plan = gemm_plan(m, h, h, sms, "bf16", LATENT_WIDTHS)
    bf = lambda: torch.empty(m, h, dtype=torch.bfloat16, device=dev)  # noqa: E731
    f32 = lambda: torch.zeros(m, h, device=dev)  # noqa: E731
    seed = 77

    # the composition, on the kernels and on their plain versions; the fused loop
    s_a, hin_a, acc_a, xi_a, z_a, o_lat, n_inj = s0.clone(), bf(), f32(), f32(), bf(), f32(), f32()
    s_b, hin_b, acc_b, xi_b, zb = s0.clone(), bf(), f32(), f32(), [bf(), bf()]
    s_p, acc_p = s0.clone(), f32()
    zp, xi_p, _ = latent_draw_plain(None, None, f32(), coeffs, 0, mode, zeta, seed)
    latent_draw(None, None, xi_b, zb[0], coeffs, 0, mode, zeta=zeta, seed=seed)
    for k in range(n_lat):
        gemm_bf16_f32acc(hs[k], m2, out=o_lat, bias=m_b, plan=plan)
        latent_draw(hs[k], acc_a, xi_a, z_a, coeffs, k, mode, zeta=zeta, seed=seed)
        gemm_bf16_f32acc(z_a, l_t, out=n_inj, plan=plan)
        latent_update(s_a, o_lat, n_inj, c_proj, t_add, coeffs, k, hin_a)
        gemm_bf16_latent_step(hs[k], m2, m_b, zb[k % 2], l_t, s_b, c_proj, t_add, coeffs, k,
                              hin_b, acc_b, xi_b, zb[(k + 1) % 2], mode, zeta=zeta, seed=seed)
        s_p, hin_p, acc_p, xi_p, zn = gemm_bf16_latent_step_plain(
            hs[k], m2, m_b, zp, l_t, s_p, c_proj, t_add, coeffs, k, acc_p, xi_p, mode, zeta, seed)
        torch.cuda.synchronize()
        same = [torch.equal(s_a, s_b), torch.equal(hin_a, hin_b), torch.equal(acc_a, acc_b)]
        if k + 1 < n_lat:
            same.append(torch.equal(zb[(k + 1) % 2], zn))
            zp = zn
        else:
            same.append(torch.equal(xi_a, xi_b))
        if not all(same):
            raise AssertionError(f"{GEMM_LATENT.name} {mode} {m}x{h} step {k}: the state differs "
                                 f"from K1 -> K7 -> K1 -> K7's under plan {tuple(plan)} "
                                 f"(s, h_in, H_acc, zeta/xi equal: {same})")
    err = max(float((s_b - s_p).abs().max()), float((acc_b - acc_p).abs().max()),
              float((xi_b - xi_p).abs().max()))
    tol = 1e-3 * max(1.0, float(s_p.abs().max()), float(acc_p.abs().max()),
                     float(xi_p.abs().max()))
    herr = float((hin_b.float() - hin_p.float()).abs().max())
    if herr > BF16_ULP * max(1.0, float(hin_p.float().abs().max())):
        raise AssertionError(f"{GEMM_LATENT.name} {mode} {m}x{h}: h_in differs by {herr}")

    k = 1  # a step that draws: the timed repeats update the same state again, the same work
    ms = time_ms(lambda: gemm_bf16_latent_step(hs[k], m2, m_b, zb[0], l_t, s_b, c_proj, t_add,
                                               coeffs, k, hin_b, acc_b, xi_b, zb[1], mode,
                                               zeta=zeta, seed=seed))

    def pair():
        gemm_bf16_f32acc(hs[k], m2, out=o_lat, bias=m_b, plan=plan)
        latent_draw(hs[k], acc_a, xi_a, z_a, coeffs, k, mode, zeta=zeta, seed=seed)
        gemm_bf16_f32acc(z_a, l_t, out=n_inj, plan=plan)
        latent_update(s_a, o_lat, n_inj, c_proj, t_add, coeffs, k, hin_a)

    pair_ms = time_ms(pair)
    plain_ms = time_ms(lambda: gemm_bf16_latent_step_plain(hs[k], m2, m_b, zp, l_t, s_p, c_proj,
                                                           t_add, coeffs, k, acc_p, xi_p, mode,
                                                           zeta, seed))
    m_b_bf = m_b.to(torch.bfloat16)
    library_ms = time_ms(lambda: (torch.addmm(m_b_bf, hs[k], m2), torch.mm(zb[0], l_t)))
    # h, M2 and Lᵀ, m_b and t_add's row; s read and written, c_proj, h_in;
    # H_acc and xi read and written; zeta_k read and zeta_{k+1} written as
    # bf16 (+ zeta[k+1] read as f32 in "buffer" mode); the two products.
    moved = m * h * (2 + 8 + 4 + 2 + 8 + 8 + 4 + (4 if mode == "buffer" else 0)) + 4 * h * h + 8 * h
    limit = roofline(moved, 4.0 * m * h * h, "bf16")
    case = f"{mode} {m}x{h} (state = K1 -> K7 -> K1 -> K7)"
    row = _report(GEMM_LATENT, case, err, tol, ms, plain_ms, limit, library_ms)
    row.update(pair_ms=pair_ms, plan=f"{plan.bm}x{plan.bn}/{plan.splits}", per_step=1)
    split2 = GemmPlan(GEMM_BM, plan.bn, 2)
    split_ms = time_ms(lambda: gemm_bf16_latent_step(hs[k], m2, m_b, zb[0], l_t, s_b, c_proj,
                                                     t_add, coeffs, k, hin_b, acc_b, xi_b, zb[1],
                                                     mode, zeta=zeta, seed=seed, plan=split2))
    print(f"[kernel] {GEMM_LATENT.name} {case}: pair {pair_ms:.4f} ms, fused/pair "
          f"{ms / pair_ms:.3f}; addmm + mm {library_ms:.4f} ms; plan {plan.bm}x{plan.bn}/"
          f"{plan.splits} (split 2: {split_ms:.4f} ms); state bit-equal to the pair's; 1 launch "
          "per latent step", flush=True)
    if ms >= pair_ms:
        print(f"[kernel] WARNING {GEMM_LATENT.name} {case}: fused {ms:.4f} ms not below the "
              f"pair's {pair_ms:.4f} ms", flush=True)
    return row


def check_latent_step(dev, g) -> dict:
    """K7 at the latent tail's shapes, 333 x 256 and 999 x 256: the fused
    step on K1's mainloop (:func:`_latent_case`, both draw modes), the
    standalone draw in both modes with and without the w·h term (without:
    the sampler's priming draw of zeta_0) and the standalone update (no
    caller on the paths since the fused step). Tolerances of the standalone
    entries: the kernel writes the plain version's f32 operations with _rn
    intrinsics, so s, H_acc and xi agree to f32 rounding (two ulps of
    max(1, |ref|), expected 0) and the bf16 outputs (bf16(zeta), the next
    stack input) within one bf16 rounding. The Philox zeta at 333 x 256
    (read back through xi with (w, v) = (0, 1) from 0) must equal the plain
    generator's bit for bit, repeat for a repeated seed, stay within +-sqrt3
    and have mean ~0 and variance ~1 (|mean| < 0.02, |var - 1| < 0.02: six
    standard errors at 85k draws)."""
    h, n_lat = 256, 4
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    coeffs = (torch.rand(n_lat, 5, generator=g) + 0.1).to(dev)
    out = {LATENT.name: [], GEMM_LATENT.name: []}
    for m in (BATCH, LATENT_ROWS):
        for mode in ("philox", "buffer"):
            out[GEMM_LATENT.name].append(_latent_case(dev, g, m, h, mode, sms))
        hid = torch.randn(m, h, generator=g).to(dev, torch.bfloat16)
        zeta = torch.randn(n_lat, m, h, generator=g).to(dev)
        zbf = torch.empty(m, h, dtype=torch.bfloat16, device=dev)
        for mode in ("philox", "buffer"):
            for prime in (False, True):
                hacc0 = None if prime else torch.randn(m, h, generator=g).to(dev)
                xi0 = torch.randn(m, h, generator=g).to(dev)
                hacc, xi, hv = (None if prime else hacc0.clone()), xi0.clone(), None if prime else hid
                latent_draw(hv, hacc, xi, zbf, coeffs, 2, mode, zeta=zeta, seed=4321)
                rz, rxi, rhacc = latent_draw_plain(hv, hacc0, xi0, coeffs, 2, mode, zeta, 4321)
                torch.cuda.synchronize()
                zerr = float((zbf.float() - rz.float()).abs().max())
                if zerr > BF16_ULP * max(1.0, float(rz.float().abs().max())):
                    raise AssertionError(f"K7 draw {mode} {m}x{h}: bf16(zeta) differs by {zerr}")
                err = float((xi - rxi).abs().max())
                tol = F32_ULP2 * max(1.0, float(rxi.abs().max()))
                if not prime:
                    err = max(err, float((hacc - rhacc).abs().max()))
                    tol = F32_ULP2 * max(1.0, float(rxi.abs().max()), float(rhacc.abs().max()))
                ms = time_ms(lambda: latent_draw(hv, hacc, xi, zbf, coeffs, 2, mode, zeta=zeta,
                                                 seed=4321))
                plain_ms = time_ms(lambda: latent_draw_plain(hv, hacc0, xi0, coeffs, 2, mode, zeta,
                                                             4321))
                per = (0 if prime else 2 + 8) + 8 + 2 + (4 if mode == "buffer" else 0)
                label = "priming draw (no w·h)" if prime else "draw"
                out[LATENT.name].append(_report(LATENT, f"{label} {mode} {m}x{h}", err, tol, ms,
                                                plain_ms, roofline(m * h * per, 4.0 * m * h,
                                                                   "f32")))

        s0, o_lat, n_inj, c_proj = (torch.randn(m, h, generator=g).to(dev) for _ in range(4))
        t_add = torch.randn(n_lat + 1, h, generator=g).to(dev)
        s, h_in = s0.clone(), torch.empty(m, h, dtype=torch.bfloat16, device=dev)
        latent_update(s, o_lat, n_inj, c_proj, t_add, coeffs, 3, h_in)
        rs, rh = latent_update_plain(s0, o_lat, n_inj, c_proj, t_add, coeffs, 3)
        torch.cuda.synchronize()
        herr = float((h_in.float() - rh.float()).abs().max())
        if herr > BF16_ULP * max(1.0, float(rh.float().abs().max())):
            raise AssertionError(f"K7 update {m}x{h}: the bf16 stack input differs by {herr}")
        err = float((s - rs).abs().max())
        tol = F32_ULP2 * max(1.0, float(rs.abs().max()))
        ms = time_ms(lambda: latent_update(s, o_lat, n_inj, c_proj, t_add, coeffs, 3, h_in))
        plain_ms = time_ms(lambda: latent_update_plain(s0, o_lat, n_inj, c_proj, t_add, coeffs, 3))
        out[LATENT.name].append(_report(LATENT, f"update {m}x{h} (no caller on the paths)", err,
                                        tol, ms, plain_ms,
                                        roofline(m * h * (8 + 4 + 4 + 4 + 2) + 4 * h, 7.0 * m * h,
                                                 "f32")))

    m = BATCH
    hid = torch.randn(m, h, generator=g).to(dev, torch.bfloat16)
    zbf = torch.empty(m, h, dtype=torch.bfloat16, device=dev)
    unit = torch.tensor([[1.0, 0.0, 0.0, 0.0, 1.0]] * 3, device=dev)
    zs = []
    for _ in range(2):
        xi = torch.zeros(m, h, device=dev)
        latent_draw(hid, torch.zeros(m, h, device=dev), xi, zbf, unit, 1, "philox", seed=99)
        zs.append(xi)
    plain_z = philox_uniform_noise(99, 1, m, h, device=dev)
    torch.cuda.synchronize()
    z = zs[0]
    mean, var, zmax = float(z.mean()), float(z.var()), float(z.abs().max())
    exact, same_seed = bool(torch.equal(z, plain_z)), bool(torch.equal(zs[0], zs[1]))
    ok = (abs(mean) < 0.02 and abs(var - 1.0) < 0.02 and zmax <= math.sqrt(3.0) and exact
          and same_seed)
    print(f"[kernel] {LATENT.name} philox zeta: mean {mean:.2e} var {var:.5f} max|z| {zmax:.5f} "
          f"repeatable {same_seed} equals plain {exact} {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("K7 Philox zeta check failed")
    return out


def check_posterior_update(dev, g) -> list:
    """K8 at 333 x 5142, static and traced, with add_noise 1 and 0.
    Tolerance: the affine part is the plain version's f32 operations with
    _rn intrinsics; z goes through logf/sqrtf/sincospif, which may differ
    from the plain version's (f32 log and sqrt, float64 cosine and sine) by
    an ulp or two: 2^-19 of max(1, |ref|) (a few f32 ulps of the largest
    value). The noise alone (c0 = c1 = 0, sv = 1) must
    match the plain Box-Muller to the same bound, repeat for a repeated
    seed, be the same through both variants and have mean ~0 and std ~1
    (|mean| < 0.005, six standard errors at 1.7M draws; |std - 1| < 0.005).
    The plain noise is a function of (seed, row, col) with no grid, so the
    match also shows that the kernel's noise does not depend on its tiling.
    K8 has no caller on any path: the launches reported for it are this
    check's."""
    x = torch.randn(BATCH, D, generator=g).to(dev)
    pred = (40.0 * torch.randn(BATCH, D, generator=g)).to(dev)  # exercises the clip
    out = []
    for variant in ("static", "traced"):
        for add_noise in (1.0, 0.0):
            coefs = (0.3, 0.6, 0.8, add_noise, 30.0)
            ct = torch.tensor(coefs, device=dev)
            if variant == "static":
                call = lambda: posterior_update(x, pred, 21, *coefs)  # noqa: E731
            else:
                call = lambda: posterior_update_traced(x, pred, ct, 21)  # noqa: E731
            got = call()
            ref = posterior_update_plain(x, pred, 21, *coefs)
            torch.cuda.synchronize()
            err = float((got - ref).abs().max())
            tol = 2.0 ** -19 * max(1.0, float(ref.abs().max()))
            ms = time_ms(call)
            plain_ms = time_ms(lambda: posterior_update_plain(x, pred, 21, *coefs))
            # x0_pred read, out written, and x read only with noise; the
            # five coefficients. Per element: the clip, and with noise a
            # quarter of a Philox call, half a Box-Muller pair and the
            # affine sum (~15 operations).
            if add_noise > 0:
                limit = roofline(BATCH * D * 12 + 20, 15.0 * BATCH * D, "f32")
            else:
                limit = roofline(BATCH * D * 8 + 20, 2.0 * BATCH * D, "f32")
            out.append(_report(POSTERIOR_UPDATE, f"{variant} add_noise={add_noise:g} 333x5142",
                               err, tol, ms, plain_ms, limit))

    zeros = torch.zeros(BATCH, D, device=dev)
    unit = torch.tensor([0.0, 0.0, 1.0, 1.0, 30.0], device=dev)
    z = posterior_update(zeros, zeros, 5, 0.0, 0.0, 1.0, 1.0)
    again = posterior_update(zeros, zeros, 5, 0.0, 0.0, 1.0, 1.0)
    traced = posterior_update_traced(zeros, zeros, unit, 5)
    plain_z = gaussian_noise(5, BATCH, D, device=dev)
    torch.cuda.synchronize()
    zerr = float((z - plain_z).abs().max())
    mean, std = float(z.mean()), float(z.std())
    ok = (zerr <= 2.0 ** -19 * max(1.0, float(plain_z.abs().max())) and abs(mean) < 0.005
          and abs(std - 1.0) < 0.005 and bool(torch.equal(z, again))
          and bool(torch.equal(z, traced)))
    print(f"[kernel] {POSTERIOR_UPDATE.name} gaussian noise: mean {mean:.2e} std {std:.5f} "
          f"max|z - plain| {zerr:.2e} repeatable {bool(torch.equal(z, again))} "
          f"static == traced {bool(torch.equal(z, traced))} {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("K8 noise check failed")
    return out


# The transformer cell's routed experts (config/dit_moonlight.yaml): 3
# scenarios x 8 patients x 324 tokens a denoiser call, 6 of 64 experts a
# token, 2048 -> 2·1408 -> 2048.
DIT_TOKENS = 24 * 324
DIT_LAYERS = 2  # [dit]: layer 0 (dense) and layer 1 (routed) of the 27
DIT_PATIENTS = 8  # a scenario, as in the cell


def check_moe_grouped(dev) -> dict:
    """[experts]: the routed experts' grouped products (``ops/moe.py``) at
    the transformer cell's routed shapes: 7,776 tokens routed by a seeded
    router (sigmoid scores of a U(±1/sqrt(2048)) gate plus a 0.1·U(±1)
    correction bias, top 6 of 64, as ``MoEFeedForward.route`` chooses),
    46,656 rows permuted by :func:`moe.expert_plan`; the SwiGLU, the down
    product with the routing weight and the inverse permutation, and the
    down product summed over each token's k copies, each against its plain
    per-expert version on the same operands, which rounds the same
    products to bf16: the two sum in different orders, so a bf16 result
    may round the other way near a boundary (max|diff| 2^-7 of max(1,
    |ref|)), and within 2e-3 of it in relative norm, which operands
    rounded to fp8 (e4m3, ~3e-2) would fail; called twice with equal bits;
    each timed beside its plain version and its bound. Then the two
    epilogue kernels on the products' own outputs (:func:`epilogue_cases`)
    and one routed layer's products and epilogues beside the eager chains
    the kernels replaced. Returns the kernels' [kernel] rows."""
    g = torch.Generator().manual_seed(0)
    tc = TransformerConfig()
    e, h, inter, k = (tc.n_routed_experts, tc.hidden_size, tc.moe_intermediate_size,
                      tc.num_experts_per_tok)
    rows = DIT_TOKENS * k
    x = torch.randn(DIT_TOKENS, h, generator=g).to(dev, torch.bfloat16)
    gate = ((torch.rand(e, h, generator=g) * 2 - 1) / math.sqrt(h)).to(dev)
    bias = (0.1 * (torch.rand(e, generator=g) * 2 - 1)).to(dev)
    scores = torch.sigmoid(x.float() @ gate.T)
    choice = torch.topk(scores + bias, k, dim=1).indices
    plan, order, counts = moe.expert_plan(choice, e)
    a = x[order // k]
    row_scale = torch.rand(rows, generator=g).to(dev)

    def uniform(*shape, fan_in):
        return ((torch.rand(shape, generator=g) * 2 - 1) / math.sqrt(fan_in)).to(
            dev, torch.bfloat16)

    w_gu, w_down = uniform(e, h, 2 * inter, fan_in=h), uniform(e, inter, h, fan_in=inter)
    with torch.no_grad():
        hid = moe.grouped_swiglu(a, w_gu, plan)
    print(f"[experts] routing: {DIT_TOKENS} tokens x {k} of {e} experts, rows an expert "
          f"{int(counts.min())}-{int(counts.max())} (mean {rows / e:.0f})", flush=True)
    down_bytes = 2 * (rows * inter + e * inter * h) + 8 * rows
    cases = (
        ("swiglu", f"{rows}x{h}.{e}x{h}x{2 * inter} ->bf16 SiLU(g)·u",
         lambda: moe.grouped_swiglu(a, w_gu, plan),
         lambda: moe.grouped_swiglu_plain(a, w_gu, plan),
         (2.0 * rows * h * 2 * inter, 2 * (rows * h + e * h * 2 * inter + rows * inter))),
        ("down", f"{rows}x{inter}.{e}x{inter}x{h} ->f32 ·weight, scattered",
         lambda: moe.grouped_down(hid, w_down, plan, row_scale, order),
         lambda: moe.grouped_down_plain(hid, w_down, plan, row_scale, order),
         (2.0 * rows * inter * h, down_bytes + 4 * rows * h)),
        ("down+combine", f"{rows}x{inter}.{e}x{inter}x{h} ->f32 ·weight, summed over k",
         lambda: moe.grouped_down(hid, w_down, plan, row_scale, order, top_k=k),
         lambda: moe.grouped_down_plain(hid, w_down, plan, row_scale, order).view(
             DIT_TOKENS, k, h).sum(1),
         (2.0 * rows * inter * h, down_bytes + 4 * DIT_TOKENS * h)),
    )
    with torch.no_grad():
        for mode, case, call, plain, (ops, nbytes) in cases:
            got, again = call(), call()
            ref = plain().float()
            rel = float((got.float() - ref).norm() / ref.norm())
            err = float((got.float() - ref).abs().max())
            tol = BF16_ULP * max(1.0, float(ref.abs().max()))
            bound = roofline(nbytes, ops, "bf16")
            print(f"[experts] {mode} {case}: relative norm of the difference {rel:.3e} (tol "
                  f"2e-3), max|diff| {err:.3e} (tol {tol:.3e}), equal bits "
                  f"{torch.equal(got, again)}; {time_ms(call):.4f} ms, plain "
                  f"{time_ms(plain):.4f} ms, bound {bound[0]:.4f} ms ({bound[1]})", flush=True)
            if rel > 2e-3 or err > tol or not torch.equal(got, again):
                raise AssertionError(f"[experts] {mode}: relative difference {rel}, max|diff| "
                                     f"{err}, or two calls differ")
            del got, again, ref
        rows_out = epilogue_cases(a, w_gu, hid, w_down, plan, row_scale, order, k)
    del a, hid, w_gu, w_down
    torch.cuda.empty_cache()
    return rows_out


def epilogue_cases(a, w_gu, hid, w_down, plan, row_scale, order, k: int) -> dict:
    """The routed experts' epilogue kernels (``csrc/moe_epilogue.cu``) on
    the grouped products' own outputs: ``moe_silu_mul`` bit for bit equal
    to its plain version and to the eager chain it replaced (the f32 cast,
    SiLU in place, the mixed-dtype multiply into bf16); ``moe_combine``
    bit for bit equal to its plain version (the same products and sums in
    the same order) and, against the eager chain it replaced (the gathers,
    the multiply into f32, ``.sum(dim=1)``, which sums k in another order),
    within 2·γ_{k−1}·Σ_j|term_j| an element (γ_n = n·2^-24 / (1 − n·2^-24):
    the bound on two orders of an f32 sum of k terms); each twice with
    equal bits, timed beside its byte bound, its plain version and the
    eager chain (``library_ms``). Then one routed layer call: the two
    products with the kernels, and with the eager chains."""
    rows, n = hid.shape[0], w_down.shape[2]
    tokens = rows // k
    gu = torch._grouped_mm(a, w_gu, offs=plan.offs)
    y = torch._grouped_mm(hid, w_down, offs=plan.offs)
    src = torch.empty_like(order).scatter_(0, order, torch.arange(rows, device=order.device))

    def eager_silu_mul(gu=gu):
        g, u = gu.chunk(2, dim=1)
        out = torch.empty(u.shape, dtype=gu.dtype, device=gu.device)
        return torch.mul(F.silu(g.float(), inplace=True), u, out=out)

    def eager_combine(y=y, src=src):
        p = y.index_select(0, src) * row_scale.index_select(0, src)[:, None]
        return p.view(tokens, k, -1).sum(dim=1)

    out = {}
    for kernel, case, call, plain, eager, nbytes in (
            (SILU_MUL, f"{rows}x{gu.shape[1]} [g | u] bf16 ->bf16 SiLU(g)·u",
             lambda: moe.silu_mul(gu), lambda: moe.silu_mul_plain(gu), eager_silu_mul,
             2 * gu.numel() + gu.numel()),
            (COMBINE, f"{rows}x{n} bf16 ->{tokens}x{n} f32, ·weight summed over k = {k}",
             lambda: moe.combine(y, row_scale, src, k),
             lambda: moe.combine_plain(y, row_scale, src, k), eager_combine,
             2 * y.numel() + 4 * tokens * n + 12 * rows)):
        got, again, want, chain = call(), call(), plain(), eager()
        err = float((got.float() - want.float()).abs().max())
        gap = (got.float() - chain.float()).abs()
        if kernel is SILU_MUL:
            chain_ok = torch.equal(got, chain)
            chain_note = f"equal to the eager chain {chain_ok}"
        else:
            terms = (y.index_select(0, src).float() * row_scale.index_select(0, src)[:, None])
            nu = (k - 1) * 2.0 ** -24
            limit = 2 * nu / (1 - nu) * terms.abs().view(tokens, k, n).sum(1)
            chain_ok = bool((gap <= limit).all())
            chain_note = (f"max|diff| from the eager chain {float(gap.max()):.3e}, "
                          f"{float((gap / limit.clamp_min(1e-30)).max()):.3f} of the reassociation "
                          f"bound (ok {chain_ok})")
            del terms, limit
        print(f"[experts] {kernel.name}: equal bits twice {torch.equal(got, again)}, "
              f"{chain_note}", flush=True)
        if not (torch.equal(got, again) and torch.equal(got, want) and chain_ok):
            raise AssertionError(f"[experts] {kernel.name}: two calls differ, or the kernel "
                                 "differs from its plain version or the eager chain")
        del got, again, want, chain, gap
        out[kernel.name] = [_report(kernel, case, err, 0.0, time_ms(call), time_ms(plain),
                                    roofline(nbytes, 0.0, "bf16"), library_ms=time_ms(eager))]

    def layer(eager: bool):
        if not eager:
            return moe.grouped_down(moe.grouped_swiglu(a, w_gu, plan), w_down, plan, row_scale,
                                    order, top_k=k)
        gu_ = torch._grouped_mm(a, w_gu, offs=plan.offs)
        y_ = torch._grouped_mm(eager_silu_mul(gu_), w_down, offs=plan.offs)
        src_ = torch.empty_like(order).scatter_(0, order, torch.arange(rows, device=order.device))
        return eager_combine(y_, src_)

    fused_ms, eager_ms = time_ms(lambda: layer(False)), time_ms(lambda: layer(True))
    print(f"[experts] a routed layer call (both products and their epilogues): kernels "
          f"{fused_ms:.4f} ms, eager chains {eager_ms:.4f} ms, saved {eager_ms - fused_ms:.4f} "
          f"ms", flush=True)
    return out


@torch.no_grad()
def _dit_weights(module: torch.nn.Module, dev, seed: int) -> dict:
    """Seeded weights on the card in each tensor's dtype: every projection
    and expert weight and every bias U(±1/sqrt(fan_in)), RMSNorm scales
    1 + 0.2·U(±1), correction biases 0.1·U(±1)."""
    state = module.state_dict()
    gen = torch.Generator(device=dev).manual_seed(seed)
    out = {}
    for name, t in state.items():
        u = torch.rand(t.shape, generator=gen, device=dev, dtype=t.dtype).mul_(2).sub_(1)
        if name.endswith("norm.weight"):
            u.mul_(0.2).add_(1.0)
        elif name.endswith("e_score_correction_bias"):
            u.mul_(0.1)
        else:
            w = state[name[: -len("bias")] + "weight"] if name.endswith(".bias") else t
            u.mul_(w.shape[1] ** -0.5)
        out[name] = u
    return out


def run_dit_phase(dev) -> dict:
    """[dit]: the transformer denoiser of config/dit_moonlight.yaml at its
    published widths, DIT_LAYERS of its 27 blocks, weights drawn on the
    card, through ``SyntheticPatientGenerator.generate_scenarios`` as the
    cell calls it (3 scenarios x 8 patients, DDIM-50 on the scan loop,
    calibrated on the card), with its launch counts set to 0 just before
    and read just after: the two routed epilogue kernels, one launch each
    per routed layer call (``moe.epilogue_fused``; none eager), and no
    other hand-written kernel. Returns those launches."""
    cfg = Config.from_yaml(REPO / "config" / "dit_moonlight.yaml")
    cfg.model.transformer.num_hidden_layers = DIT_LAYERS
    cohort = make_dummy_cohort(100, *DATA_DIMS, seed=0)
    data, conditions, dims = cohort_arrays(cohort, cfg)
    with torch.device("meta"):
        model = ConditionalDiffusion.from_config(cfg, dims)
    model.denoiser.load_state_dict(_dit_weights(model.denoiser, dev, 0), assign=True)
    gen = SyntheticPatientGenerator(model, cfg, dims,
                                    data_stats_from_arrays(data, conditions, dims.mutation_dim),
                                    device=dev)
    scenarios = cfg.generation.scenarios
    gen.generate_scenarios(scenarios, DIT_PATIENTS, seed=1)  # warm-up
    for k in KERNELS:
        k.reset()
    gen_module.SAMPLERS.clear()
    gen_module.CALIBRATIONS.clear()
    counts0 = dict(COUNTERS)
    t0 = time.perf_counter()
    out = gen.generate_scenarios(scenarios, DIT_PATIENTS, seed=2)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k.name: k.launches for k in KERNELS if k.launches}
    grew = {key: COUNTERS[key] - counts0.get(key, 0)
            for key in ("sampler.steps", "moe.epilogue_fused", "moe.epilogue_eager")}
    layer_calls = grew["sampler.steps"] * len(model.denoiser.moe_layers())
    want = {SILU_MUL.name: layer_calls, COMBINE.name: layer_calls}
    samplers, calibrations = dict(gen_module.SAMPLERS), dict(gen_module.CALIBRATIONS)
    print(f"[dit] {DIT_LAYERS} blocks at published widths, {len(scenarios)} x {DIT_PATIENTS} "
          f"patients DDIM-{cfg.generation.sampling_steps} in {seconds:.3f} s; routes {samplers}, "
          f"calibrations {calibrations}; hand-written kernels launched {launches}; routed "
          f"layer calls {layer_calls}, epilogues fused {grew['moe.epilogue_fused']}, eager "
          f"{grew['moe.epilogue_eager']}", flush=True)
    if (launches != want or grew["moe.epilogue_fused"] != layer_calls
            or grew["moe.epilogue_eager"] or not layer_calls):
        raise AssertionError(f"[dit] launches {launches}, epilogues {grew}; want {want}")
    if samplers != {"scan": 1} or calibrations != {"device": 1}:
        raise AssertionError(f"[dit] routes {samplers}, calibrations {calibrations}")
    for s in scenarios:
        got = out[s.name]
        if (got["expression"].shape != (DIT_PATIENTS, DATA_DIMS[1])
                or not np.isfinite(got["expression"]).all()
                or not np.isin(got["mutations"], (0.0, 1.0)).all()):
            raise AssertionError(f"[dit] {s.name}: the cohort's shape or values are wrong")
    del gen, model
    torch.cuda.empty_cache()
    return launches


# The hybrid cell (config/kimi_linear_dit.yaml): 3 scenarios x 2 patients x
# 1,289 tokens a denoiser call, 32 KDA heads of 128.
KIMI_SEQS, KIMI_SEQ, KIMI_HEADS = 6, 1289, 32
KIMI_PATIENTS = 1  # [kimi]: a scenario


def check_kda_kernel(dev) -> dict:
    """[kimi]: the KDA kernel against its plain chunked twin at the hybrid
    cell's shape: unit q and k, v ~ N(0, 1), β ~ U(0, 1), g = −A·softplus(z),
    A ~ U(1, 16) a head, z ~ N(−3, 2) (channels from ≈ e^-0.00004 to ≈
    e^-60 a token). Both f32 in other orders of sums (the kernel's exp2 ≤ 2
    ulp): max|diff| 1e-4 of max(1, max|o|); equal bits twice; timed beside
    the twin and its bound (f32 products at 67 TFLOP/s, or the bytes).
    Returns its [kernel] row."""
    from benchmark.roofline_kda import kda_chunk as kda_cost

    g = torch.Generator(device=dev).manual_seed(0)
    shape = (KIMI_SEQS, KIMI_SEQ, KIMI_HEADS, 128)
    q = F.normalize(torch.randn(shape, generator=g, device=dev), dim=-1)
    k = F.normalize(torch.randn(shape, generator=g, device=dev), dim=-1)
    v = torch.randn(shape, generator=g, device=dev)
    a = 1 + 15 * torch.rand(KIMI_HEADS, generator=g, device=dev)
    decay = -a[:, None] * F.softplus(2 * torch.randn(shape, generator=g, device=dev) - 3)
    beta = torch.rand(shape[:3], generator=g, device=dev)
    scale = 128 ** -0.5
    with torch.no_grad():
        got, again = (kda_ops.kda_chunk(q, k, v, decay, beta, scale) for _ in range(2))
        want = kda_ops.kda_chunk_plain(q, k, v, decay, beta, scale)
        err = float((got - want).abs().max())
        tol = 1e-4 * max(1.0, float(want.abs().max()))
        if not torch.equal(got, again):
            raise AssertionError("[kimi] two calls of the KDA kernel differ")
        heads = {"linear_attn_config": {"num_heads": KIMI_HEADS, "head_dim": 128,
                                        "kda_layers": []}}
        ops, nbytes = kda_cost(heads, KIMI_SEQS, KIMI_SEQ)
        row = _report(KDA, f"{KIMI_SEQS}x{KIMI_SEQ}x{KIMI_HEADS}x128 f32, chunk 64", err, tol,
                      time_ms(lambda: kda_ops.kda_chunk(q, k, v, decay, beta, scale)),
                      time_ms(lambda: kda_ops.kda_chunk_plain(q, k, v, decay, beta, scale),
                              iters=3),
                      roofline(nbytes, ops, "f32"))
    del q, k, v, decay, beta, got, again, want
    torch.cuda.empty_cache()
    return {KDA.name: [row]}


def run_kimi_phase(dev) -> dict:
    """[kimi]: config/kimi_linear_dit.yaml's denoiser at published widths,
    all 27 blocks, weights drawn on the card (``benchmark/kimi_weights.py``:
    KDA's decay as published), through ``generate_scenarios`` (3 x
    KIMI_PATIENTS, DDIM-50, calibrated on the card), launch counts set to
    0 just before and read just after: one KDA launch a KDA layer call, the
    two routed epilogue kernels one launch each a routed layer call, no
    other hand-written kernel; ``kda.chunks`` = steps x KDA layers x
    sequences x heads x 21; the held copies fewer than the routed ones.
    Returns those launches."""
    from benchmark.kimi_weights import seeded_kimi_weights

    cfg = Config.from_yaml(REPO / "config" / "kimi_linear_dit.yaml")
    cohort = make_dummy_cohort(100, *DATA_DIMS, seed=0)
    data, conditions, dims = cohort_arrays(cohort, cfg)
    with torch.device("meta"):
        model = ConditionalDiffusion.from_config(cfg, dims)
    model.denoiser.load_state_dict(seeded_kimi_weights(model.denoiser, 0, dev), assign=True)
    gen = SyntheticPatientGenerator(model, cfg, dims,
                                    data_stats_from_arrays(data, conditions, dims.mutation_dim),
                                    device=dev)
    scenarios = cfg.generation.scenarios
    gen.generate_scenarios(scenarios, KIMI_PATIENTS, seed=1)  # warm-up
    for kern in KERNELS:
        kern.reset()
    gen_module.SAMPLERS.clear()
    gen_module.CALIBRATIONS.clear()
    keys = ("sampler.steps", "kda.chunks", "moe.held_rows", "moe.routed_rows",
            "moe.epilogue_fused", "moe.epilogue_eager")
    counts0 = {key: COUNTERS[key] for key in keys}
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    out = gen.generate_scenarios(scenarios, KIMI_PATIENTS, seed=2)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {kern.name: kern.launches for kern in KERNELS if kern.launches}
    grew = {key: COUNTERS[key] - counts0[key] for key in keys}
    steps = grew["sampler.steps"]
    kda_layers = len(cfg.model.transformer.linear_attn_config["kda_layers"])
    routed = steps * len(model.denoiser.moe_layers())
    seqs = len(scenarios) * KIMI_PATIENTS
    want = {KDA.name: steps * kda_layers, SILU_MUL.name: routed, COMBINE.name: routed}
    chunks = steps * kda_layers * seqs * KIMI_HEADS * -(-model.denoiser.seq_len // 64)
    print(f"[kimi] {len(model.denoiser.layers)} hybrid blocks at published widths, {seqs} x "
          f"{model.denoiser.seq_len} "
          f"tokens, DDIM-{cfg.generation.sampling_steps} in {seconds:.3f} s, peak "
          f"{torch.cuda.max_memory_allocated(dev) / 1e9:.1f} GB; routes "
          f"{dict(gen_module.SAMPLERS)}, calibrations {dict(gen_module.CALIBRATIONS)}; "
          f"hand-written kernels launched {launches}; counters {grew}", flush=True)
    if launches != want or grew["kda.chunks"] != chunks or grew["moe.epilogue_eager"]:
        raise AssertionError(f"[kimi] launches {launches}, counters {grew}; want {want}, "
                             f"kda.chunks {chunks}")
    if not 0 < grew["moe.held_rows"] < grew["moe.routed_rows"]:
        raise AssertionError(f"[kimi] held rows {grew['moe.held_rows']} of "
                             f"{grew['moe.routed_rows']} routed")
    if dict(gen_module.SAMPLERS) != {"scan": 1} or dict(gen_module.CALIBRATIONS) != {"device": 1}:
        raise AssertionError(f"[kimi] routes {dict(gen_module.SAMPLERS)}, calibrations "
                             f"{dict(gen_module.CALIBRATIONS)}")
    for s in scenarios:
        got = out[s.name]
        if (got["expression"].shape != (KIMI_PATIENTS, DATA_DIMS[1])
                or not np.isfinite(got["expression"]).all()
                or not np.isin(got["mutations"], (0.0, 1.0)).all()):
            raise AssertionError(f"[kimi] {s.name}: the cohort's shape or values are wrong")
    del gen, model
    torch.cuda.empty_cache()
    return launches


def step_time(cases: dict, rows: int = BATCH) -> None:
    """The bf16 step's summed kernel time at ``rows`` rows, fused, and with
    each fused product replaced by the pair it replaces; beside it the
    sum of the launches' bounds."""
    at_rows = lambda r: r["case"].startswith(f"{rows}x")  # noqa: E731
    picked = [r for r in cases[GEMM.name] if r["per_step"] and at_rows(r)]
    picked += [r for r in cases[GEMM_GN.name] if r["per_step"] and at_rows(r)]
    picked += [r for r in cases[GEMM_POSTERIOR.name]
               if at_rows(r) and r["case"].endswith("x5142 philox (bits = pair)")]
    launches = sum(r["per_step"] for r in picked)
    fused_launches = sum(r["per_step"] for r in picked if "pair_ms" in r)
    fused = sum(r["per_step"] * r["ms"] for r in picked)
    unfused = sum(r["per_step"] * r.get("pair_ms", r["ms"]) for r in picked)
    bound = sum(r["per_step"] * r["bound_ms"] for r in picked)
    print(f"[kernel] per bf16 DDPM step at {rows} rows: {launches} launches, {fused:.4f} ms "
          f"summed (bound {bound:.4f} ms); with K2 and K3 apart: {launches + fused_launches} "
          f"launches, {unfused:.4f} ms", flush=True)


def _recorded_step(dev, rows: int, quantize: str, head: bool, want: set) -> list:
    """A sampler step recorded at ``rows`` rows (:func:`record_step`); its
    launches must number ``STEP_LAUNCHES[quantize]`` and be those of
    ``want`` (kernel names) alone. Returns its calls."""
    calls, launches = record_step(dev, quantize, head, rows=rows)
    total = sum(sum(m.values()) for m in launches.values())
    kind = "bf16" if quantize == "none" else "int8-" + quantize
    label = f"{'d3pm' if head else kind} at {rows} rows"
    print(f"[kernel] launches per reverse step, {label}: {total} {json.dumps(launches)}",
          flush=True)
    if total != STEP_LAUNCHES[quantize] or set(launches) != want:
        raise AssertionError(f"{label}: {total} launches (want {STEP_LAUNCHES[quantize]}, "
                             f"{sorted(want)} only): {launches}")
    return calls


def check_step_shapes(dev, g, rows: int) -> tuple:
    """K1, K1+GN and K1+posterior at every product of a bf16 step recorded
    at ``rows`` rows (12 launches), each wrapper against its plain version
    on the same inputs with the 333-row checks' tolerances (K1 repeat
    bit-equal, the posterior carry bit-equal to the pair's), timed with
    its bound. The posterior epilogue in every noise mode, without the
    D3PM head. Returns the cases by kernel and the step's recorded calls."""
    calls = _recorded_step(dev, rows, "none", False, {GEMM.name, GEMM_GN.name,
                                                      GEMM_POSTERIOR.name})
    return {GEMM.name: check_gemm(dev, g, calls, extras=False),
            GEMM_GN.name: check_gn_epilogue(dev, g, calls, [])[GEMM_GN.name],
            GEMM_POSTERIOR.name: check_posterior_epilogue(
                dev, g, rows, kinds=("bf16",), muts=(0,))[GEMM_POSTERIOR.name]}, calls


def check_bench_variants(dev, g, rows: int) -> dict:
    """The launches that int8 "out" and the D3PM head change in a step at
    ``rows`` rows (the suite's 32,768), at the shapes of a step recorded at
    that size, each against its plain version with the 333-row checks'
    tolerances: K6 quantizing its own A with the posterior epilogue,
    "philox" (the output product of int8 "out"; its carry bit-equal to K5
    -> K6+posterior, timed beside that pair and beside ``torch._int_mm``
    on the same codes), K1's input product with the 2b-1 prologue on the
    62 bit columns (beside ``addmm``) and K1+posterior D3PM "philox" (its
    carry bit-equal to K1 -> K3). Returns the cases by kernel."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out_calls = _recorded_step(dev, rows, "out", False,
                               {GEMM.name, GEMM_GN.name, GEMM_S8Q_POSTERIOR.name})
    (m, k, n, lda, _), = [sig for name, sig in out_calls if name == "gemm_s8q_posterior"]
    h = _strided(m, k, lda, torch.bfloat16, dev, lambda r, c: 2.0 * torch.randn(r, c, generator=g))
    q, cs = pack_int8((torch.randn(k, n, generator=g) / math.sqrt(k)).numpy())
    qb, cs = kmajor_int8(q).to(dev), cs.to(dev)
    codes = torch.empty(m, qb.shape[1], dtype=torch.int8, device=dev)
    scales = torch.empty(m, device=dev)
    s8q = _quant_posterior_case(dev, g, h, qb, cs, codes, scales, "philox", 0, sms, 1,
                                library=True)
    d3pm_calls = _recorded_step(dev, rows, "none", True,
                                {GEMM.name, GEMM_GN.name, GEMM_POSTERIOR.name})
    if not any(name == "gemm_bf16_f32acc" and sig[-1] == MUT for name, sig in d3pm_calls):
        raise AssertionError(f"d3pm at {rows} rows: the input product has no 2b-1 prologue")
    return {GEMM.name: check_gemm(dev, g, d3pm_calls, extras=False),
            GEMM_POSTERIOR.name: check_posterior_epilogue(
                dev, g, rows, kinds=("bf16",), muts=(MUT,), modes=("philox",))[
                    GEMM_POSTERIOR.name],
            GEMM_S8Q_POSTERIOR.name: [s8q]}


def variant_step_time(cases: dict, variants: dict, rows: int) -> None:
    """The int8 "out" and D3PM DDPM steps' summed kernel time at ``rows``
    rows: the bf16 step's launches (:func:`step_time`), each launch the
    variant changes replaced by its case in ``variants``."""
    at_rows = lambda r: r["case"].startswith(f"{rows}x")  # noqa: E731
    k1_in = [r for r in cases[GEMM.name] if r["per_step"] and at_rows(r)]
    gn = [r for r in cases[GEMM_GN.name] if r["per_step"] and at_rows(r)]
    post = [r for r in cases[GEMM_POSTERIOR.name]
            if at_rows(r) and r["case"].endswith("x5142 philox (bits = pair)")]
    blocks = sum(r["per_step"] * r["ms"] for r in gn)
    bounds = sum(r["per_step"] * r["bound_ms"] for r in gn)
    for label, first, last in (
            ("int8-out", k1_in, variants[GEMM_S8Q_POSTERIOR.name]),
            ("d3pm", variants[GEMM.name], variants[GEMM_POSTERIOR.name])):
        ms = blocks + sum(r["ms"] for r in first + last)
        bound = bounds + sum(r["bound_ms"] for r in first + last)
        bf16 = blocks + sum(r["ms"] for r in k1_in + post)
        print(f"[kernel] per {label} DDPM step at {rows} rows: {ms:.4f} ms summed (bound "
              f"{bound:.4f} ms), bf16 {bf16:.4f} ms: {100.0 * (ms / bf16 - 1.0):+.1f}%",
              flush=True)


def check_serve_shapes(dev, g) -> dict:
    """:func:`check_step_shapes` at the rows of the serving buckets that
    [serve] drives (``SERVE_BUCKETS``: one 64-row tile with one valid row
    and the largest split-K at 1 row, one full tile at 64, 16 tile rows at
    1,024)."""
    out = {GEMM.name: [], GEMM_GN.name: [], GEMM_POSTERIOR.name: []}
    for rows in SERVE_BUCKETS:
        for name, cases in check_step_shapes(dev, g, rows)[0].items():
            out[name] += cases
    return out


def print_plans(dev, calls, rows: int) -> None:
    """The launch plan of each distinct product of a step recorded at
    ``rows`` rows: tiles, rounds of CTAs over the SMs (CTAs that share an
    SM by shared memory counted) and the split-K workspace it needs."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    widths = {"gemm_bf16_f32acc": GEMM_WIDTHS, "gemm_bf16_posterior": POSTERIOR_WIDTHS}
    seen = []
    for name, sig in calls:
        m, k, n = sig[:3]
        if (name, m, k, n) in seen:
            continue
        seen.append((name, m, k, n))
        plan = gemm_plan(m, n, k, sms, "bf16", widths.get(name, gn_widths(n)))
        tiles = -(-m // plan.bm) * -(-n // plan.bn)
        walk = -(-k_tiles(k, "bf16") // plan.splits)
        per_sm = _ctas_per_sm(plan.bn, walk)
        rounds = -(-tiles * plan.splits // (sms * per_sm))
        workspace = tiles * plan.splits * plan.bm * plan.bn * 4 if plan.splits > 1 else 0
        print(f"[kernel] plan at {rows} rows, {name} {m}x{k}.{k}x{n}: {plan.bm}x{plan.bn} "
              f"tiles, {plan.splits} split(s): {tiles} tiles, {per_sm} CTA(s) an SM, {rounds} "
              f"round(s) over {sms} SMs ({tiles * plan.splits / sms:.2f} CTAs an SM); split-K "
              f"workspace {workspace} bytes", flush=True)


def check_kernels(dev) -> dict:
    g = torch.Generator().manual_seed(0)
    POSTERIOR_UPDATE.reset()
    steps = check_step_launches(dev)
    bf16_calls, all_calls = steps[("none", False)], steps[("all", False)]
    cases = {
        GEMM.name: check_gemm(dev, g, bf16_calls),
        **check_gn_epilogue(dev, g, bf16_calls, all_calls),
        **check_posterior_epilogue(dev, g),
        **check_quant_prologue(dev, g, steps),
        GROUPNORM.name: check_groupnorm(dev, g),
        POSTERIOR.name: check_posterior(dev, g),
        RBF.name: check_rbf(dev, g),
        ROWQUANT.name: check_rowquant(dev, g),
        GEMM_S8.name: check_gemm_s8(dev, g),
        **check_latent_step(dev, g),
        POSTERIOR_UPDATE.name: check_posterior_update(dev, g),
    }
    for name, rows in check_serve_shapes(dev, g).items():
        cases[name] += rows
    step_time(cases)
    t0 = time.perf_counter()
    bench_cases, calls = check_step_shapes(dev, g, BENCH_ROWS)
    print_plans(dev, calls, BENCH_ROWS)
    for name, rows in bench_cases.items():
        cases[name] += rows
    step_time(cases, BENCH_ROWS)
    print(f"[kernel] the {BENCH_ROWS}-row cases in {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    variants = check_bench_variants(dev, g, BENCH_ROWS)
    variant_step_time(cases, variants, BENCH_ROWS)
    for name, rows in variants.items():
        cases[name] += rows
    print(f"[kernel] the {BENCH_ROWS}-row int8-out and d3pm cases in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return cases


def prepare_workdir(root: Path, weights: str | None) -> Config:
    """Processed tables of the seeded structured cohort (100 patients,
    62/5054/26) and a checkpoint directory: seeded weights at full width,
    or the exported checkpoint in ``weights``."""
    cfg = Config()
    cohort = make_dummy_cohort(100, *DATA_DIMS, seed=0)
    write_processed(cohort, root / "processed")
    cfg.data.processed_dir = str(root / "processed")
    cfg.output.results_dir = str(root / "results")
    cfg.output.synthetic_data_dir = str(root / "synthetic")
    if weights is not None:
        meta = load_metadata(weights)
        if meta is None or metadata_to_dims(meta).data_dim != D:
            raise ValueError(f"{weights} holds no checkpoint with data dim {D}")
        cfg.training.save_dir = str(weights)
        return cfg
    cfg.training.save_dir = str(seeded_checkpoint(root / "checkpoint", cfg, cohort))
    return cfg


def d3pm_checkpoint(src: str, dst: Path) -> str:
    """The checkpoint in ``src`` with the D3PM mutation head turned on in
    its metadata (the head needs no other weights: its logits come out of
    the same output projection)."""
    dst.mkdir(parents=True, exist_ok=True)
    for path in Path(src).iterdir():
        if path.name != METADATA_FILE and path.is_file():
            shutil.copy(path, dst / path.name)
    meta = load_metadata(src)
    meta["config"]["model"]["diffusion"]["discrete_mutation_head"] = True
    (dst / METADATA_FILE).write_text(json.dumps(meta, indent=2, default=str))
    return str(dst)


def check_outputs(cfg: Config, results: dict, label: str, dims=None) -> np.ndarray:
    """Every synthetic table has the expected shape (``dims``: the data
    widths, DATA_DIMS by default) and finite values; every metric is
    finite; mutations are exactly 0 or 1. Returns the mutation block of
    the whole cohort."""
    per = cfg.generation.num_synthetic_samples // len(cfg.generation.scenarios)
    widths = dict(zip(("mutations", "expression", "pathways"), dims or DATA_DIMS))
    widths["conditions"] = len(cfg.model.condition_on)
    mutations = []
    for scenario in cfg.generation.scenarios:
        for key, width in widths.items():
            path = Path(cfg.output.synthetic_data_dir) / scenario.name / f"{scenario.name}_{key}.csv"
            values = read_matrix_csv(path, index_col=None).values
            if values.shape != (per, width) or not np.isfinite(values).all():
                raise AssertionError(f"{label} {path.name}: shape {values.shape}, "
                                     f"finite {np.isfinite(values).all()}")
            if key == "mutations":
                if not np.isin(values, (0.0, 1.0)).all():
                    raise AssertionError(f"{label} {path.name}: mutation values are not bits")
                mutations.append(values)
    bad = {k: v for k, v in results.items() if not math.isfinite(v)}
    if bad or "mmd" not in results:
        raise AssertionError(f"{label}: non-finite or missing metrics {bad}")
    return np.concatenate(mutations)


def run_step(fn, cfg: Config, dev) -> tuple:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(cfg, device=str(dev))
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


# Each main path: its runs as (D3PM head, generation.fused_quantize,
# sampler), and the (kernel, mode) pairs that must launch during it.
MAIN_PATHS = {
    "continuous": [(False, "none", "ddpm"), (False, "none", "ddim")],
    "d3pm": [(True, "none", "ddpm"), (True, "none", "ddim")],
    "int8": [(False, "out", "ddpm"), (False, "io", "ddim"), (False, "all", "ddim"),
             (True, "all", "ddim")],
}
_COMMON = {GEMM_GN: ["default"], RBF: ["default"]}
REQUIRED = {
    "continuous": {**_COMMON, GEMM: ["bf16"], GEMM_POSTERIOR: ["philox", "none"]},
    "d3pm": {**_COMMON, GEMM: ["mut_prologue"], GEMM_POSTERIOR: ["d3pm_philox", "d3pm_none"]},
    "int8": {**_COMMON, GEMM: ["bf16"], GEMM_S8Q_POSTERIOR: ["philox", "none", "d3pm_none"],
             ROWQUANT: ["plain", "mut_transform"], GEMM_S8: ["bf16_out"], GEMM_S8Q: ["f32_out"],
             GEMM_S8Q_GN: ["default", "accumulate"]},
}
# Kernels that must not launch on any main path: K1's general path, K2
# and K3 apart from a product (their work runs in the epilogues), and K6
# from K5's codes anywhere but the input product (K6 quantizes its own A).
FORBIDDEN = {GEMM: ["unaligned"], GROUPNORM: list(GROUPNORM.modes),
             POSTERIOR: list(POSTERIOR.modes), GEMM_S8: ["f32_out", "accumulate"],
             GEMM_S8_GN: list(GEMM_S8_GN.modes), GEMM_S8_POSTERIOR: list(GEMM_S8_POSTERIOR.modes)}


def check_forbidden(path: str) -> None:
    """Every K1 launch of a main path went through TMA (the sampler's
    buffers are laid out for it), K2 and K3 never ran apart, and the
    standalone K5 ran only before the input product (once for each of
    K6's bf16-out launches)."""
    ran = {f"{k.name}:{m}": k.modes[m] for k, modes in FORBIDDEN.items() for m in modes
           if k.modes[m]}
    if ran:
        raise AssertionError(f"{path}: launches that the main paths must not make: {ran}")
    if ROWQUANT.launches != GEMM_S8.modes["bf16_out"]:
        raise AssertionError(f"{path}: {ROWQUANT.launches} K5 launches against "
                             f"{GEMM_S8.modes['bf16_out']} input products")


def run_path(path: str, runs: list, required: dict, cfg: Config, dev, ckpts: dict,
             dims=None) -> dict:
    """generate -> calibrate -> validate through the port's CLI step
    functions for every run of one path, with its launch counts set to 0
    just before and read just after; every (kernel, mode) of ``required``
    must have launched and none that the main paths forbid. ``dims``: the
    data widths, where they are not DATA_DIMS. Returns the path's launches
    by kernel and the last run's validation metrics."""
    n = cfg.generation.num_synthetic_samples // len(cfg.generation.scenarios) * len(
        cfg.generation.scenarios)
    root = Path(cfg.output.results_dir).parent
    for k in KERNELS:
        k.reset()
    for head, quant, sampler in runs:
        cfg.training.save_dir = ckpts[head]
        cfg.generation.fused_quantize = quant
        cfg.generation.sampler = sampler
        label = " ".join(
            ["DDPM-1000" if sampler == "ddpm" else f"DDIM-{cfg.generation.sampling_steps}"]
            + (["d3pm"] if head else []) + ([f"int8-{quant}"] if quant != "none" else []))
        cfg.output.synthetic_data_dir = str(
            root / f"synthetic_{path}_{label.replace(' ', '_')}")
        gen_module.CALIBRATIONS.clear()
        _, gen_s = run_step(generate_synthetic_patients, cfg, dev)
        calibrations = dict(gen_module.CALIBRATIONS)
        results, val_s = run_step(validate_synthetic_patients, cfg, dev)
        mutations = check_outputs(cfg, results, label, dims)
        print(f"[main] {path} {label}: generate+calibrate {gen_s:.2f} s for {n} patients "
              f"({n / gen_s:.1f} patients/sec end to end), validate {val_s:.2f} s; calibration "
              f"backend by cohort: {json.dumps(calibrations)}", flush=True)
        check_calibrated_on_device(cfg, calibrations, f"{path} {label}")
        print(f"[main] {path} {label} metrics: " + json.dumps(
            {k: round(v, 6) for k, v in results.items()}), flush=True)
        if head:
            print(f"[main] {path} {label} mutation CSVs exactly binary; per-gene "
                  f"frequencies: {json.dumps(np.round(mutations.mean(0), 3).tolist())}",
                  flush=True)
    counts = {k.name: dict(k.modes) for k in KERNELS}
    print(f"[main] {path} kernel launches by mode: {json.dumps(counts)}", flush=True)
    missing = [f"{k.name}:{mode}" for k, modes in required.items()
               for mode in modes if counts[k.name][mode] == 0]
    if missing:
        raise AssertionError(f"{path}: kernels never launched on the main path: {missing}")
    check_forbidden(path)
    return {k.name: k.launches for k in KERNELS}, results


def check_calibrated_on_device(cfg: Config, calibrations: dict, label: str) -> None:
    """Under "auto" on the card every cohort of 256 rows or more (here each
    scenario's 333, or the batched 999) is calibrated on the device."""
    cohorts = 1 if cfg.generation.batch_scenarios else len(cfg.generation.scenarios)
    if cfg.generation.calibration_backend != "auto" or calibrations != {"device": cohorts}:
        raise AssertionError(f"{label}: calibrations {calibrations} under "
                             f"{cfg.generation.calibration_backend!r}; want {cohorts} on the "
                             "device under 'auto'")


def run_main_paths(cfg: Config, dev, ckpts: dict) -> dict:
    """Every run of every main path (:func:`run_path`) on the seeded
    weights. Returns each kernel's launches summed over the paths."""
    totals = {k.name: 0 for k in KERNELS}
    for path, runs in MAIN_PATHS.items():
        launches, _ = run_path(path, runs, REQUIRED[path], cfg, dev, ckpts)
        for name, count in launches.items():
            totals[name] += count
    cfg.training.save_dir, cfg.generation.fused_quantize = ckpts[False], "none"
    return totals


# The train phase: the production settings (config/production.yaml over
# the defaults: batch 16, AdamW 1e-4, constraints on, dropout 0.2, mixup
# 0.2, pathway noise 0.05, 25-epoch blocks) for TRAIN_EPOCHS epochs on the
# seeded cohort, then DDIM-50 from the trained weights on the continuous
# path.
TRAIN_EPOCHS = 100
TRAINED_RUNS = [(False, "none", "ddim")]
TRAINED_REQUIRED = {**_COMMON, GEMM: ["bf16"], GEMM_POSTERIOR: ["none"]}


def run_train_phase(cfg: Config, dev, root: Path) -> dict:
    """The port's CLI train step at full width for TRAIN_EPOCHS epochs:
    finite losses, the best validation loss below epoch 0's, the best and
    a periodic checkpoint written, one more epoch resumed from a copy of
    that periodic checkpoint; then generate -> validate from the trained
    checkpoint with the continuous path's launch accounting. Returns that
    run's launches by kernel and the trained checkpoint's directory."""
    tcfg = copy.deepcopy(cfg)
    tcfg.training.num_epochs = TRAIN_EPOCHS
    tcfg.training.patience = TRAIN_EPOCHS
    tcfg.training.epochs_per_dispatch = 25
    tcfg.training.save_dir = str(root / "checkpoint_trained")
    tcfg.output.results_dir = str(root / "results_trained")
    tc = tcfg.training
    print(f"[train] production settings: batch {tc.batch_size}, AdamW lr {tc.learning_rate} "
          f"wd {tc.weight_decay}, clip {tc.grad_clip_norm}, dropout {tcfg.model.gnn.dropout}, "
          f"mixup {tc.augmentation.mixup_alpha}, pathway noise {tc.augmentation.pathway_noise}, "
          f"constraints {tcfg.model.constraints.enabled}, T {tcfg.model.diffusion.num_steps}, "
          f"hidden {tcfg.model.hidden_dims}, {TRAIN_EPOCHS} epochs", flush=True)
    history, train_s = run_step(train_model, tcfg, dev)
    losses = history.train_loss + history.val_loss
    n_train = len(history.train_loss)
    print(f"[train] {n_train} epochs in {train_s:.2f} s ({train_s / n_train:.4f} s an epoch, "
          f"{history.steps_per_sec:.1f} steps/sec); train loss {history.train_loss[0]:.4f} -> "
          f"{history.train_loss[-1]:.4f}, val loss {history.val_loss[0]:.4f} -> "
          f"{history.val_loss[-1]:.4f} (best {min(history.val_loss):.4f})", flush=True)
    if n_train != TRAIN_EPOCHS or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"[train] {n_train} epochs, finite {np.isfinite(losses).all()}")
    if not min(history.val_loss) < history.val_loss[0]:
        raise AssertionError("[train] the best validation loss is not below epoch 0's")
    save_dir = Path(tc.save_dir)
    latest = latest_epoch(save_dir)
    if not (save_dir / "best_model.npz").exists() or latest is None:
        raise AssertionError(f"[train] no best_model.npz or periodic checkpoint in {save_dir}")

    resumed = root / "checkpoint_resumed"
    shutil.copytree(save_dir, resumed)
    rcfg = copy.deepcopy(tcfg)
    rcfg.training.save_dir = str(resumed)
    rcfg.training.num_epochs = latest + 2
    more, resume_s = run_step(lambda c, device: train_model(c, device=device, resume=True),
                              rcfg, dev)
    if len(more.train_loss) != 1 or not math.isfinite(more.train_loss[0] + more.val_loss[0]):
        raise AssertionError(f"[train] resume from epoch {latest}: {more.as_dict()}")
    print(f"[train] resumed from checkpoint_epoch_{latest}: epoch {latest + 2} train loss "
          f"{more.train_loss[0]:.4f}, val loss {more.val_loss[0]:.4f} ({resume_s:.2f} s)",
          flush=True)

    gcfg = copy.deepcopy(cfg)
    launches, results = run_path("trained", TRAINED_RUNS, TRAINED_REQUIRED, gcfg, dev,
                                 {False: str(save_dir)})
    print(f"[train] trained weights, DDIM-{gcfg.generation.sampling_steps} 3 x {BATCH}: overall "
          f"{results['overall_biological_score']:.4f}, MMD {results['mmd']:.4f} (no gate: "
          f"{TRAIN_EPOCHS} epochs and {3 * BATCH} rows are not its protocol)", flush=True)
    return launches, save_dir


# The variants phase: three models of the JAX package's variants, each
# trained through the CLI with the production settings for VARIANT_EPOCHS
# epochs, then generated 3 x 333 -> calibrated -> validated on the route
# the JAX package's rule gives it: (a) on the kernels, (b) and (c) on the
# scan loop (learned sigma keeps (b) there at guidance 1 too).
VARIANT_EPOCHS = 30
GUIDANCE = 7.5
VARIANTS = {
    "ar-latent": ({"ar_mutation_head": True, "latent_factor_dim": 8}, 0.0,
                  [("ddpm", 1.0), ("ddim", 1.0)], "kernel"),
    "v-sigma-cfg": ({"parameterization": "v", "learn_sigma": True}, 0.1,
                    [("ddpm", GUIDANCE), ("ddim", 1.0)], "scan"),
    "eps-low-rank": ({"parameterization": "epsilon", "low_rank_sigma_dim": 4}, 0.0,
                     [("ddim", 1.0)], "scan"),
}
# The kernel sampler's kernels (every mode): a scan-loop run launches none.
SAMPLER_KERNELS = [GEMM, GEMM_GN, GEMM_POSTERIOR, GROUPNORM, POSTERIOR, ROWQUANT, GEMM_S8,
                   GEMM_S8_GN, GEMM_S8_POSTERIOR, GEMM_S8Q, GEMM_S8Q_GN, GEMM_S8Q_POSTERIOR,
                   GEMM_LATENT, LATENT]
SCAN_TOL = 1e-3  # the scan loop on the card against its CPU run (f32 both)


def _check_variant_launches(label: str, route: str, n_steps: int, cohorts: int) -> None:
    """The kernel route: 12 launches a step (K1, 10 K1+GN, K1+posterior)
    for every step of every cohort and nothing else of the sampler; the
    scan route: no sampler kernel at all."""
    counts = {k.name: k.launches for k in SAMPLER_KERNELS}
    if route == "kernel":
        want = {k.name: 0 for k in SAMPLER_KERNELS}
        want.update({GEMM.name: n_steps * cohorts, GEMM_GN.name: 10 * n_steps * cohorts,
                     GEMM_POSTERIOR.name: n_steps * cohorts})
        if counts != want or GEMM.modes["bf16"] != n_steps * cohorts:
            raise AssertionError(f"[variants] {label}: launches {counts}, want {want} "
                                 f"({STEP_LAUNCHES['none']} a step)")
    elif any(counts.values()):
        raise AssertionError(f"[variants] {label}: the scan loop launched sampler kernels "
                             f"{counts}")


def run_variant(name: str, cfg: Config, dev, root: Path) -> dict:
    """Train one variant through the CLI, then generate -> calibrate ->
    validate each of its runs with the counts set to 0 just before and read
    just after. Returns its launches by kernel and its checkpoint dir."""
    overrides, cfg_drop, runs, route = VARIANTS[name]
    tcfg = copy.deepcopy(cfg)
    for key, value in overrides.items():
        setattr(tcfg.model.diffusion, key, value)
    tcfg.model.cfg_dropout_prob = cfg_drop
    tcfg.training.num_epochs = tcfg.training.patience = VARIANT_EPOCHS
    tcfg.training.save_dir = str(root / f"checkpoint_{name}")
    tcfg.output.results_dir = str(root / f"results_{name}")
    history, train_s = run_step(train_model, tcfg, dev)
    losses = history.train_loss + history.val_loss
    if len(history.train_loss) != VARIANT_EPOCHS or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"[variants] {name}: {len(history.train_loss)} epochs, losses "
                             f"finite {all(math.isfinite(v) for v in losses)}")
    print(f"[variants] {name} ({json.dumps(overrides)}, cfg_dropout_prob {cfg_drop}): "
          f"{VARIANT_EPOCHS} epochs in {train_s:.2f} s ({history.steps_per_sec:.1f} steps/sec); "
          f"train loss {history.train_loss[0]:.4f} -> {history.train_loss[-1]:.4f}, val "
          f"{history.val_loss[0]:.4f} -> {history.val_loss[-1]:.4f}", flush=True)
    totals = {k.name: 0 for k in KERNELS}
    cohorts = len(cfg.generation.scenarios)
    for sampler, guidance in runs:
        gcfg = copy.deepcopy(cfg)
        gcfg.training.save_dir = tcfg.training.save_dir
        gcfg.generation.sampler = sampler
        gcfg.generation.guidance_scale = guidance
        n_steps = cfg.model.diffusion.num_steps if sampler == "ddpm" else (
            gcfg.generation.sampling_steps)
        label = f"{name} {sampler.upper()}-{n_steps} guidance {guidance}"
        gcfg.output.synthetic_data_dir = str(root / f"synthetic_{name}_{sampler}_{guidance}")
        for k in KERNELS:
            k.reset()
        gen_module.CALIBRATIONS.clear()
        gen_module.SAMPLERS.clear()
        _, gen_s = run_step(generate_synthetic_patients, gcfg, dev)
        _check_variant_launches(label, route, n_steps, cohorts)
        samplers, calibrations = dict(gen_module.SAMPLERS), dict(gen_module.CALIBRATIONS)
        results, val_s = run_step(validate_synthetic_patients, gcfg, dev)
        for k in KERNELS:
            totals[k.name] += k.launches
        check_outputs(gcfg, results, label)
        if samplers != {route: cohorts}:
            raise AssertionError(f"[variants] {label}: sampler routes {samplers}, want "
                                 f"{{'{route}': {cohorts}}}")
        check_calibrated_on_device(gcfg, calibrations, f"[variants] {label}")
        print(f"[variants] {label}: route {samplers}, generate+calibrate {gen_s:.2f} s, "
              f"validate {val_s:.2f} s; calibrations {json.dumps(calibrations)}; overall "
              f"{results['overall_biological_score']:.4f}, MMD {results['mmd']:.4f}, "
              f"co-occurrence pattern {results['cooccurrence_pattern_correlation']:.4f} (no gate)",
              flush=True)
        time_variant_parts(label, gcfg, dev)
    return totals, tcfg.training.save_dir


def time_variant_parts(label: str, gcfg: Config, dev) -> None:
    """The parts of one 333-row cohort in process, on the CLI's settings:
    the latent prior's fit (first use), the sampler (warm: the second of
    two calls), calibration with the AR draw, and the AR draw alone."""
    save_dir = gcfg.training.save_dir
    model, mcfg, dims = load_trained_model(save_dir, copy.deepcopy(gcfg))
    gen = SyntheticPatientGenerator(model, mcfg, dims, data_stats=load_data_stats(save_dir),
                                    device=dev)
    cond = gen.create_conditions(BATCH, mcfg.generation.scenarios[0].conditions)
    parts = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        parts[name] = time.perf_counter() - t0
        return out

    if model.latent_factor_dim:
        timed("latent prior fit + draw", lambda: gen._latent_prior_draw(BATCH, seeded_generator(1)))
    for rep in range(2):
        raw = timed("sampler", lambda: gen.sample_raw(cond, seeded_generator(2, rep)))
    out = timed("calibrate (+ AR draw)", lambda: gen._postprocess(raw, cond, seeded_generator(3)))
    if model.ar_head:
        pathways = torch.as_tensor(out["pathways"], device=dev)
        timed("AR draw", lambda: model.ar_sample(pathways, torch.as_tensor(cond, device=dev),
                                                 seeded_generator(4)))
    print(f"[variants] {label} at {BATCH} rows in process: " + ", ".join(
        f"{name} {sec:.4f} s" for name, sec in parts.items()), flush=True)


def check_ar_calibration(cfg: Config, save_dir: str, dev) -> None:
    """The AR cohort skips the joint copula (JAX :484): under "auto" at 333
    rows the generator calibrates on the card with the continuous
    calibrator only, and the bits are the AR draw's."""
    gcfg = copy.deepcopy(cfg)
    gcfg.generation.sampler = "ddim"
    model, gcfg, dims = load_trained_model(save_dir, gcfg)
    gen = SyntheticPatientGenerator(model, gcfg, dims, data_stats=load_data_stats(save_dir),
                                    device=dev)
    out = gen.generate(BATCH, gcfg.generation.scenarios[0].conditions, seeded_generator(0, 0))
    ok = (gen._device_cont_cal is not None and gen._device_joint_cal is None
          and np.isin(out["mutations"], (0.0, 1.0)).all())
    print(f"[variants] ar-latent calibration: continuous calibrator on {gen.device} "
          f"{gen._device_cont_cal is not None}, joint calibrator "
          f"{gen._device_joint_cal is not None}; AR bits binary, per-gene frequency "
          f"{float(out['mutations'].mean()):.4f}: {ok}", flush=True)
    if not ok:
        raise AssertionError("[variants] the AR cohort did not take the continuous calibrator")


def check_variants_against_plain(cfg: Config, ckpts: dict, dev) -> None:
    """(a)'s kernel sampler on its widened [clinical | factors] conditions
    against the plain loop at 333 rows (the bf16-carry tolerance atol 0.15 /
    rtol 0.05), DDPM-20 with the same noise and DDIM-10; the scan loop on the
    card against its own CPU run on the same injected draws at 333 rows
    (f32 compute and carry both sides: 1e-3 of max(1, |ref|)): (b) DDIM-10
    at guidance 1, (c) DDPM-20 with every draw."""
    model = _reference_model(cfg, dev, save_dir=ckpts["ar-latent"])
    g = torch.Generator().manual_seed(23)
    cond = torch.randn(BATCH, model.denoiser.condition_dim, generator=g)
    x_init = torch.randn(BATCH, D, generator=g)
    noise = torch.randn(20, BATCH, D, generator=g)
    for label, ddim in (("DDPM-20", None), ("DDIM-10", 10)):
        got = FusedSampler(model, dev, ddim_steps=ddim).sample(
            cond, g, x_init=x_init, noise=None if ddim else noise)
        ref = (model.sample_ddim(cond, g, 10, x_init=x_init) if ddim
               else model.sample(cond, g, x_init=x_init, noise=noise))
        err = (got - ref).abs()
        ok = bool((err <= 0.15 + 0.05 * ref.abs()).all()) and bool(torch.isfinite(got).all())
        print(f"[reference] ar-latent {label} {BATCH}x{D}, conditions {cond.shape[1]} wide: "
              f"kernel sampler vs plain loop max|diff| {float(err.max()):.4f}, within atol "
              f"0.15 / rtol 0.05: {ok}", flush=True)
        if not ok:
            raise AssertionError(f"ar-latent {label}: kernel sampler disagrees with the plain loop")
    for name, ddim in (("v-sigma-cfg", 10), ("eps-low-rank", None)):
        card = _reference_model(cfg, dev, save_dir=ckpts[name])
        host = _reference_model(cfg, torch.device("cpu"), save_dir=ckpts[name])
        k = card.low_rank_sigma_dim
        draws = {"x_T": torch.randn(BATCH, D, generator=g),
                 "z": torch.randn(19, BATCH, D, generator=g).to(torch.bfloat16).float(),
                 "final_z": torch.randn(BATCH, D, generator=g)}
        if k:
            draws.update(lr_eps=torch.randn(19, BATCH, D, generator=g),
                         lr_epsk=torch.randn(19, BATCH, k, generator=g),
                         final_lr_eps=torch.randn(BATCH, D, generator=g),
                         final_lr_epsk=torch.randn(BATCH, k, generator=g))
        results = []
        # An f32 carry on both sides: a bf16 carry rounds the two runs'
        # 1e-6 differences apart by whole bf16 ulps, which epsilon's
        # 1/sqrt(acp) then amplifies at large t.
        card.sample_dtype = host.sample_dtype = "float32"
        for model in (card, host):
            if ddim:
                results.append(model.scan_sample_ddim(cond[:, :3], num_sampling_steps=ddim,
                                                      draws=draws).cpu())
            else:
                results.append(model.scan_sample(cond[:, :3], draws=draws).cpu())
        got, ref = results
        err = float((got - ref).abs().max())
        bound = SCAN_TOL * max(1.0, float(ref.abs().max()))
        ok = err <= bound and bool(torch.isfinite(got).all())
        print(f"[reference] {name} scan {'DDIM-%d' % ddim if ddim else 'DDPM-20'} {BATCH}x{D}: "
              f"card vs CPU max|diff| {err:.3e} (bound {bound:.3e}): {ok}", flush=True)
        if not ok:
            raise AssertionError(f"{name}: the scan loop on the card disagrees with its CPU run")


def run_variants_phase(cfg: Config, dev, root: Path) -> dict:
    """[variants]: every model of VARIANTS trained, generated, calibrated
    and validated (:func:`run_variant`), the AR cohort's calibration route,
    and the checks against the plain loop and the CPU. Returns the phase's
    launches by kernel (the checks' launches left out)."""
    t0 = time.perf_counter()
    totals = {k.name: 0 for k in KERNELS}
    ckpts = {}
    for name in VARIANTS:
        launches, ckpts[name] = run_variant(name, cfg, dev, root)
        for key, n in launches.items():
            totals[key] += n
    print(f"[variants] kernel launches over the variants' runs: {json.dumps(totals)}", flush=True)
    check_ar_calibration(cfg, ckpts["ar-latent"], dev)
    check_variants_against_plain(cfg, ckpts, dev)
    print(f"[variants] phase {time.perf_counter() - t0:.1f} s", flush=True)
    return totals


# The architectures phase: the cVAE and the flow (model.architecture) at
# the full width of config/config.yaml (hidden 256/512/256, latent 128,
# bf16 products, dropout 0.2, constraints on), each trained through the
# CLI with the production settings for ARCH_EPOCHS epochs, then 3 x 333
# generate -> calibrate (on the card) -> validate, held card against CPU
# and served. Neither samples through a kernel; validation runs K4.
ARCH_EPOCHS = 30
ARCH_ROUTES = {"cvae": "cvae", "flow": "plain"}
ARCH_SAMPLE_TOL = 0.05  # card vs CPU sample (bf16 products): of max(1, max|CPU|)
# The flow's inverse(forward(x)) on the card, of max(1, max|x|): half a bf16
# ulp. Each coupling's net reads its input rounded to bf16, and the inverse
# hands it the previous coupling's reconstruction, whose f32 rounding can
# move that input by one bf16 ulp.
ARCH_ROUND_TRIP_TOL = 2e-3
ARCH_SERVE_REQUESTS = 5


def _profile_train_script():
    """scripts/profile_torch_train.py as a module (its ``make_trainer`` and
    ``run``: steps/sec, launches and device ms a step)."""
    spec = importlib.util.spec_from_file_location(
        "profile_torch_train", REPO / "scripts" / "profile_torch_train.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _arch_train(arch: str, cfg: Config, dev, root: Path) -> Path:
    """The CLI's train step for ARCH_EPOCHS epochs: finite losses, the best
    validation loss below epoch 0's, the cVAE's BatchNorm statistics in
    ``best_model.npz``, one more epoch resumed from a copy of the periodic
    checkpoint; then the train step's steps/sec and launches under the
    profile script. Returns the checkpoint directory."""
    tcfg = copy.deepcopy(cfg)
    tcfg.model.architecture = arch
    tcfg.training.num_epochs = tcfg.training.patience = ARCH_EPOCHS
    tcfg.training.epochs_per_dispatch = 25
    tcfg.training.save_dir = str(root / f"checkpoint_{arch}")
    tcfg.output.results_dir = str(root / f"results_{arch}")
    history, train_s = run_step(train_model, tcfg, dev)
    losses = history.train_loss + history.val_loss
    if len(history.train_loss) != ARCH_EPOCHS or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"[arch] {arch}: {len(history.train_loss)} epochs, losses finite "
                             f"{all(math.isfinite(v) for v in losses)}")
    if not min(history.val_loss) < history.val_loss[0]:
        raise AssertionError(f"[arch] {arch}: the best validation loss is not below epoch 0's")
    save_dir = Path(tcfg.training.save_dir)
    with np.load(save_dir / "best_model.npz") as f:
        keys = list(f.files)
    stats = [k for k in keys if k.startswith("batch_stats/")]
    want = 4 * len(cfg.model.hidden_dims) if arch == "cvae" else 0
    if len(stats) != want or any("num_batches_tracked" in k for k in keys):
        raise AssertionError(f"[arch] {arch}: best_model.npz holds {len(stats)} BatchNorm "
                             f"statistics, want {want}")
    print(f"[arch] {arch}: {ARCH_EPOCHS} epochs in {train_s:.2f} s ({train_s / ARCH_EPOCHS:.4f} s "
          f"an epoch, {history.steps_per_sec:.1f} steps/sec); train loss "
          f"{history.train_loss[0]:.4f} -> {history.train_loss[-1]:.4f}, val "
          f"{history.val_loss[0]:.4f} -> {history.val_loss[-1]:.4f} (best "
          f"{min(history.val_loss):.4f}); best_model.npz {len(keys)} arrays, {len(stats)} "
          f"BatchNorm statistics", flush=True)

    latest = latest_epoch(save_dir)
    resumed = root / f"checkpoint_{arch}_resumed"
    shutil.copytree(save_dir, resumed)
    rcfg = copy.deepcopy(tcfg)
    rcfg.training.save_dir = str(resumed)
    rcfg.training.num_epochs = latest + 2
    more, resume_s = run_step(lambda c, device: train_model(c, device=device, resume=True),
                              rcfg, dev)
    if len(more.train_loss) != 1 or not math.isfinite(more.train_loss[0] + more.val_loss[0]):
        raise AssertionError(f"[arch] {arch}: resume from epoch {latest}: {more.as_dict()}")
    print(f"[arch] {arch}: resumed from checkpoint_epoch_{latest}: epoch {latest + 2} train loss "
          f"{more.train_loss[0]:.4f}, val loss {more.val_loss[0]:.4f} ({resume_s:.2f} s)",
          flush=True)

    profile = _profile_train_script()
    pcfg = copy.deepcopy(tcfg)
    t0 = time.perf_counter()
    prof = profile.run(profile.make_trainer(root / f"profile_{arch}", dev, config=pcfg), epochs=3)
    print(f"[arch] {arch} train step (profile_torch_train.run, {time.perf_counter() - t0:.1f} s): "
          f"{prof['train_steps_per_sec']:.1f} steps/sec, {prof['seconds_per_epoch_median']:.4f} s "
          f"an epoch, {prof['kernel_launches_per_step']:.0f} launches and "
          f"{prof['aten_ops_per_step']:.0f} operator calls a step, device "
          f"{prof['step_device_ms']:.3f} ms of {prof['step_wall_ms']:.3f} ms a step (busy "
          f"{prof['device_busy_share']:.3f}); checkpoint write {prof['checkpoint_write_s']:.2f} s",
          flush=True)
    return save_dir


def _arch_generate(arch: str, cfg: Config, dev, root: Path, save_dir: Path) -> dict:
    """3 x 333 generate -> calibrate -> validate through the CLI with every
    count set to 0 just before generate: the route, no kernel launched
    while generating, every cohort calibrated on the card, K4 launched by
    the validation. Returns the launches by kernel."""
    gcfg = copy.deepcopy(cfg)
    gcfg.training.save_dir = str(save_dir)
    gcfg.output.synthetic_data_dir = str(root / f"synthetic_{arch}")
    gcfg.output.results_dir = str(root / f"results_{arch}")
    label = f"[arch] {arch} 3 x {BATCH}"
    for k in KERNELS:
        k.reset()
    gen_module.CALIBRATIONS.clear()
    gen_module.SAMPLERS.clear()
    _, gen_s = run_step(generate_synthetic_patients, gcfg, dev)
    launched = {k.name: k.launches for k in KERNELS if k.launches}
    samplers, calibrations = dict(gen_module.SAMPLERS), dict(gen_module.CALIBRATIONS)
    cohorts = len(gcfg.generation.scenarios)
    if launched or samplers != {ARCH_ROUTES[arch]: cohorts}:
        raise AssertionError(f"{label}: routes {samplers}, kernels launched while generating "
                             f"{launched}")
    check_calibrated_on_device(gcfg, calibrations, label)
    results, val_s = run_step(validate_synthetic_patients, gcfg, dev)
    if RBF.launches == 0:
        raise AssertionError(f"{label}: the validation launched no K4")
    check_outputs(gcfg, results, label)
    print(f"{label}: route {samplers}, generate+calibrate {gen_s:.2f} s, validate {val_s:.2f} s "
          f"(K4 {RBF.launches} launches, no other kernel: "
          f"{sum(k.launches for k in KERNELS) == RBF.launches}); calibrations "
          f"{json.dumps(calibrations)}; overall {results['overall_biological_score']:.4f}, MMD "
          f"{results['mmd']:.4f}, co-occurrence pattern "
          f"{results['cooccurrence_pattern_correlation']:.4f} (no gate)", flush=True)
    return {k.name: k.launches for k in KERNELS}


def _arch_parts(arch: str, cfg: Config, dev, save_dir: Path) -> None:
    """In process from the trained checkpoint: the sampler at 333 (warm,
    the second of two calls) and 999 rows, the calibration of the 333-row
    cohort; then the card's sample against the CPU's on the same z and
    conditions, and the flow's inverse(forward(x)) on the card."""
    model, mcfg, dims = load_trained_model(save_dir, copy.deepcopy(cfg))
    gen = SyntheticPatientGenerator(model, mcfg, dims, data_stats=load_data_stats(save_dir),
                                    device=dev)
    scenarios = mcfg.generation.scenarios
    cond = gen.create_conditions(BATCH, scenarios[0].conditions)
    cond999 = np.concatenate([gen.create_conditions(BATCH, s.conditions) for s in scenarios])
    parts = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        parts[name] = time.perf_counter() - t0
        return out

    for rep in range(2):
        raw = timed(f"sampler {BATCH}", lambda: gen.sample_raw(cond, seeded_generator(2, rep)))
    timed(f"sampler {3 * BATCH}", lambda: gen.sample_raw(cond999, seeded_generator(3)))
    timed(f"calibrate {BATCH}", lambda: gen._postprocess(raw, cond))
    print(f"[arch] {arch} in process: " + ", ".join(f"{name} {sec:.4f} s"
                                                    for name, sec in parts.items()), flush=True)

    host, _, _ = load_trained_model(save_dir, copy.deepcopy(cfg))
    g = torch.Generator().manual_seed(31)
    width = model.latent_dim if arch == "cvae" else D
    z = torch.randn(BATCH, width, generator=g)
    c = torch.from_numpy(cond)
    card, ref = model.sample(c, z=z).cpu(), host.sample(c, z=z)
    err = float((card - ref).abs().max())
    bound = ARCH_SAMPLE_TOL * max(1.0, float(ref.abs().max()))
    ok = err <= bound and bool(torch.isfinite(card).all())
    line = (f"[reference] {arch} sample {BATCH}x{D}, z injected: card vs CPU max|diff| "
            f"{err:.4e} (bound {bound:.4e})")
    if arch == "flow":
        x = model.sample(c, z=z)
        cd = c.to(dev)
        with torch.no_grad():
            back = model.module.inverse(model.module(x, cd)[0], cd)
        rt = float((back - x).abs().max())
        rt_bound = ARCH_ROUND_TRIP_TOL * max(1.0, float(x.abs().max()))
        ok = ok and rt <= rt_bound
        line += f"; inverse(forward(x)) on the card max|diff| {rt:.3e} (bound {rt_bound:.3e})"
    print(f"{line}: {ok}", flush=True)
    if not ok:
        raise AssertionError(f"[arch] {arch}: the card disagrees with the CPU")


def _arch_serve(arch: str, save_dir: Path, dev) -> None:
    """The port's server on 127.0.0.1 from the checkpoint (warmed at 64
    rows), ARCH_SERVE_REQUESTS requests of 64 rows (JSON), the sampler
    named per request (ignored by these families): p50, no kernel
    launched."""
    t0 = time.perf_counter()
    server = serve(save_dir, host="127.0.0.1", port=0, warmup=(64,), device=str(dev))
    startup = time.perf_counter() - t0
    threading.Thread(target=server.serve_forever, daemon=True).start()
    for k in KERNELS:
        k.reset()
    seconds = []
    try:
        for i in range(ARCH_SERVE_REQUESTS):
            conn = http.client.HTTPConnection("127.0.0.1", server.server_address[1], timeout=300)
            body = {"num_samples": 64, "scenario": {"survival_time": 400 + 100 * i},
                    "sampler": "ddim" if i % 2 else "ddpm"}
            t0 = time.perf_counter()
            conn.request("POST", "/generate", body=json.dumps(body))
            resp = conn.getresponse()
            out = json.loads(resp.read())
            seconds.append(time.perf_counter() - t0)
            conn.close()
            if resp.status != 200 or np.asarray(out["expression"]).shape != (64, DATA_DIMS[1]):
                raise AssertionError(f"[arch] {arch} /generate: status {resp.status}")
    finally:
        server.shutdown()
        server.server_close()
    launched = {k.name: k.launches for k in KERNELS if k.launches}
    print(f"[arch] {arch} served: startup {startup:.2f} s (warmup at 64 rows), "
          f"{ARCH_SERVE_REQUESTS} requests of 64 rows p50 {float(np.median(seconds)):.4f} s, max "
          f"{max(seconds):.4f} s; kernels launched {launched}", flush=True)
    if launched:
        raise AssertionError(f"[arch] {arch}: serving launched kernels {launched}")


def run_arch_phase(cfg: Config, dev, root: Path) -> dict:
    """[arch]: the cVAE and the flow trained, generated, calibrated,
    validated, held card against CPU and served. Returns the launches of
    their generate -> validate runs by kernel (K4's)."""
    t0 = time.perf_counter()
    totals = {k.name: 0 for k in KERNELS}
    for arch in ARCH_ROUTES:
        stages = {}
        t = time.perf_counter()
        save_dir = _arch_train(arch, cfg, dev, root)
        stages["train"] = time.perf_counter() - t
        t = time.perf_counter()
        for name, n in _arch_generate(arch, cfg, dev, root, save_dir).items():
            totals[name] += n
        stages["generate+validate"] = time.perf_counter() - t
        t = time.perf_counter()
        _arch_parts(arch, cfg, dev, save_dir)
        stages["parts+reference"] = time.perf_counter() - t
        t = time.perf_counter()
        _arch_serve(arch, save_dir, dev)
        stages["serve"] = time.perf_counter() - t
        print(f"[arch] {arch} seconds by stage: " + ", ".join(
            f"{k} {v:.1f}" for k, v in stages.items()), flush=True)
    print(f"[arch] phase {time.perf_counter() - t0:.1f} s; kernel launches {json.dumps(totals)}",
          flush=True)
    return totals


def run_bench_latent(tmp: Path, head) -> dict:
    """scripts/bench_latent_torch.py as a user runs it (999 rows,
    DDPM-1000, one timed call after a warm-up), with the probe's head
    (``head`` None) or a fixed one. Its launches are counted in its own
    process, per sampler: K7 must have launched once per latent step and
    call in each of its modes. Returns the bench's report."""
    out = tmp / f"bench_latent_{head or 'probe'}.json"
    cmd = [sys.executable, str(REPO / "scripts" / "bench_latent_torch.py"), "--batch",
           str(LATENT_ROWS), "--steps", "1000", "--reps", "1", "--out", str(out)]
    if head:
        cmd += ["--head", str(head)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"bench_latent_torch.py failed ({proc.returncode}):\n"
                             f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    report = json.loads(out.read_text())
    probe = report["probe"]
    print(f"[latent] bench_latent_torch.py --batch {LATENT_ROWS} --steps 1000"
          f"{f' --head {head}' if head else ''} ({time.perf_counter() - t0:.1f} s): probe head "
          f"{probe['head_steps']} (max|x0_pred| {probe['profile_max']:.3f}, "
          f"{probe['seconds']:.2f} s); running head {report['head_steps']}", flush=True)
    for name, entry in report["timings"].items():
        print(f"[latent]   {name}{' (reference)' if entry.get('role') else ''}: "
              f"{entry['seconds']:.4f} s, {entry['patients_per_sec']:.1f} patients/sec; "
              f"launches {json.dumps(entry['launches'])}", flush=True)
    for name, entry in report["timings"].items():
        ran = {k.name: entry["launches"].get(k.name, {}).get(m, 0) for k, modes in
               FORBIDDEN.items() for m in modes}
        if any(ran.values()):
            raise AssertionError(f"bench {name}: launches that the paths must not make: {ran}")
    entry = report["timings"][f"latent_kernel_head{report['head_steps']}"]
    want = entry["n_lat"] * entry["calls"]
    k7 = entry["launches"].get(LATENT.name, {})
    fused = entry["launches"].get(GEMM_LATENT.name, {})
    if (k7 != ({"draw_philox": entry["calls"]} if entry["n_lat"] else {})
            or fused.get("philox", 0) != want):
        raise AssertionError(f"K7 launched {k7} and the fused step {fused}: want one priming draw "
                             f"a call and {want} fused steps (n_lat {entry['n_lat']} x "
                             f"{entry['calls']} calls), no standalone update")
    return report


def run_latent_path(cfg: Config, dev, tmp: Path) -> dict:
    """The latent-tail path at full width, DDPM-1000: the bench script
    twice (probe head; head 100), then in process on the checkpoint's
    weights, ``LatentFusedSampler`` at 999 rows with head 100 and, where
    the probe says the clip does not bind in the tail and its head is
    longer, with the probe's head too. The in-process launch counts are set
    to 0 just before the latent sampler calls and read just after them:
    K1, K1 with the GN epilogue, K1 with the posterior epilogue (the head)
    and K7 must have launched, K2 and K3 apart never, K7 once per latent
    step in each mode. Then, outside that count, the moment check of the
    hybrid against the data-space kernel sampler (per-feature mean within
    0.2, std within 0.2 + 25%: the bounds of
    tests/test_latent_sampler.py:145-169). Returns the launches of the
    latent sampler calls, those of the bench processes' included."""
    from osteosarcoma_diffusionmodel_torch.generation.generator import load_trained_model

    totals = {k.name: 0 for k in KERNELS}
    for head in (None, LATENT_HEAD):
        for name, entry in run_bench_latent(tmp, head)["timings"].items():
            if name.startswith("latent_kernel_"):
                for kernel, modes in entry["launches"].items():
                    totals[kernel] += sum(modes.values())

    model, _, _ = load_trained_model(cfg.training.save_dir, cfg)
    model.denoiser.to(dev)
    T = model.schedule.num_steps
    cond = torch.zeros(LATENT_ROWS, metadata_to_dims(load_metadata(cfg.training.save_dir)).condition_dim)
    probe_head, profile = calibrate_head_steps(model, cond[:256], torch.Generator(dev).manual_seed(9),
                                               device=dev)
    x_init = torch.randn(LATENT_ROWS, D, generator=torch.Generator(dev).manual_seed(10), device=dev)
    # The moment check needs a head after which the clip does not bind.
    moment_head = None if probe_head >= T - 1 else max(probe_head, LATENT_HEAD)

    for k in KERNELS:
        k.reset()
    calls = []  # (head, n_lat) of each LatentFusedSampler call
    sampler = LatentFusedSampler(model, LATENT_HEAD, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lat = sampler.sample(cond, torch.Generator(dev).manual_seed(11), x_init=x_init)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    calls.append((LATENT_HEAD, sampler.n_lat))
    if lat.shape != (LATENT_ROWS, D) or not bool(torch.isfinite(lat).all()):
        raise AssertionError(f"latent sampler output {tuple(lat.shape)} not finite")
    print(f"[latent] LatentFusedSampler head {LATENT_HEAD} ({sampler.n_lat} latent steps) "
          f"{LATENT_ROWS}x{D}: {seconds:.3f} s ({LATENT_ROWS / seconds:.1f} patients/sec), "
          f"finite, std {float(lat.std()):.3f}", flush=True)
    if moment_head is not None and moment_head != LATENT_HEAD:
        sampler = LatentFusedSampler(model, moment_head, dev)
        lat = sampler.sample(cond, torch.Generator(dev).manual_seed(11), x_init=x_init)
        calls.append((moment_head, sampler.n_lat))
    torch.cuda.synchronize()
    counts = {k.name: dict(k.modes) for k in KERNELS}
    print(f"[main] latent kernel launches by mode: {json.dumps(counts)}", flush=True)
    required = {GEMM: ["bf16"], GEMM_GN: ["default"], GEMM_POSTERIOR: ["philox"],
                LATENT: ["draw_philox"], GEMM_LATENT: ["philox"]}
    missing = [f"{k.name}:{m}" for k, modes in required.items() for m in modes
               if counts[k.name][m] == 0]
    if missing:
        raise AssertionError(f"latent: kernels never launched on the path: {missing}")
    check_forbidden("latent")
    # Each call: its head's data-space steps, one priming draw, the latent
    # steps, the final stack (h0). What remains is the latent steps' share.
    n_lat = sum(n for _, n in calls)
    total = sum(k.launches for k in KERNELS)
    head = sum(STEP_LAUNCHES["none"] * hd + 1 + STACK_LAUNCHES for hd, _ in calls)
    per_step = (total - head) / n_lat
    print(f"[latent] launches per latent step: {per_step:g} (want {LATENT_STEP_LAUNCHES}: "
          f"{STACK_LAUNCHES} in the stack, 1 fused step); {len(calls)} priming draw(s), "
          f"{GEMM_LATENT.launches} fused steps, standalone K7 update {LATENT.modes['update']}",
          flush=True)
    if (per_step != LATENT_STEP_LAUNCHES or LATENT.modes["update"]
            or LATENT.modes["draw_philox"] != len(calls) or GEMM_LATENT.modes["philox"] != n_lat):
        raise AssertionError(f"latent path launches: {counts}; want {LATENT_STEP_LAUNCHES} a "
                             f"latent step ({n_lat}), one priming draw a call ({len(calls)}), "
                             "no standalone K7 update")
    for k in KERNELS:
        totals[k.name] += k.launches

    if moment_head is None:
        print(f"[latent] moment check skipped: the probe's head is {probe_head} = T-1, so the clip "
              f"may bind on every loop row and no latent tail is equivalent; profile: "
              f"{json.dumps(np.round(profile, 3).tolist())}", flush=True)
        return totals
    data = FusedSampler(model, dev).sample(cond, torch.Generator(dev).manual_seed(12),
                                           x_init=x_init)
    dmean = (lat.mean(0) - data.mean(0)).abs()
    dstd = (lat.std(0) - data.std(0)).abs()
    ok_mean = bool((dmean <= 0.2).all())
    ok_std = bool((dstd <= 0.2 + 0.25 * data.std(0)).all())
    print(f"[latent] moments, head {moment_head} (probe head {probe_head}, max|x0_pred| after it "
          f"{float(profile[moment_head:T - 1].max()):.3f} <= {0.5 * model.clip_value}): "
          f"per-feature max |d mean| {float(dmean.max()):.4f} (<= 0.2), max |d std| "
          f"{float(dstd.max()):.4f} (<= 0.2 + 25%), data-space std {float(data.std()):.3f}: "
          f"{ok_mean and ok_std}", flush=True)
    if not (ok_mean and ok_std):
        raise AssertionError("latent sampler moments differ from the data-space sampler's")
    return totals


def check_latent_against_plain(cfg: Config, dev) -> None:
    """The latent kernel sampler against the plain ``LatentTailSampler``
    at full width, 333 rows, a 20-step schedule, head 3, f32 compute, with
    the same x_T and head noise, and zeta = L^-1 K_inᵀ z, eta = Σ v z /
    sqrt(v2) from the same wide noise (so both reproduce one trajectory).
    Both drop the clip in the tail. Tolerance: atol 0.15 / rtol 0.05, the
    bf16-carry bound of tests/test_latent_sampler.py:213-215."""
    model = _reference_model(cfg, dev)
    g = torch.Generator().manual_seed(13)
    head, steps = 3, 20
    cond = torch.randn(BATCH, 3, generator=g)
    x_init = torch.randn(BATCH, D, generator=g).to(torch.bfloat16).float()
    noise = torch.randn(steps, BATCH, D, generator=g).to(dev)
    sampler = LatentFusedSampler(model, head, dev)
    t = sampler.tables
    seg = noise[head: steps - 1].double()
    zeta = (seg @ t.K_in.double()) @ torch.linalg.inv(t.L_T.double())
    eta = torch.einsum("k,kbd->bd", t.v.double(), seg) / math.sqrt(t.v2)
    got = sampler.sample(cond, g, x_init=x_init, noise=noise, zeta=zeta.float(), eta=eta.float())
    ref = LatentTailSampler(model, head, dev).sample(cond, g, x_init=x_init, noise=noise)
    err = (got - ref).abs()
    ok = bool((err <= 0.15 + 0.05 * ref.abs()).all()) and bool(torch.isfinite(got).all())
    print(f"[reference] latent head {head} DDPM-{steps} {BATCH}x{D}: kernel vs plain "
          f"LatentTailSampler max|diff| {float(err.max()):.4f}, within atol 0.15 / rtol 0.05: "
          f"{ok}; std {float(ref.std()):.3f}", flush=True)
    if not ok:
        raise AssertionError("latent kernel sampler disagrees with the plain LatentTailSampler")


def check_d3pm_calibration(cfg: Config, ckpt: str, dev) -> None:
    """With the head on, calibration (copula_joint) returns the sampler's
    bits unchanged and calibrates the continuous block on the device: one
    scenario of 333 patients at DDIM-50."""
    from osteosarcoma_diffusionmodel_torch.generation.generator import (
        SyntheticPatientGenerator,
        load_trained_model,
        seeded_generator,
    )

    model, gcfg, dims = load_trained_model(ckpt, cfg)
    gcfg.generation.sampler = "ddim"
    gen = SyntheticPatientGenerator(model, gcfg, dims, data_stats=load_data_stats(ckpt), device=dev)
    g = seeded_generator(gcfg.training.random_seed, 0)
    cond = gen.create_conditions(BATCH, gcfg.generation.scenarios[0].conditions, g)
    raw = gen.sample_raw(cond, g)  # on the card
    bits = raw[:, :MUT].cpu().numpy()
    gen_module.CALIBRATIONS.clear()
    out = gen._postprocess(raw, cond)
    kept = bool(np.array_equal(out["mutations"], bits))
    binary = bool(np.isin(bits, (0.0, 1.0)).all())
    print(f"[main] d3pm calibration ({gcfg.generation.calibrate_marginals}, backend "
          f"{json.dumps(dict(gen_module.CALIBRATIONS))}): sampler bits binary {binary}, kept "
          f"unchanged {kept}", flush=True)
    if not (kept and binary) or dict(gen_module.CALIBRATIONS) != {"device": 1}:
        raise AssertionError("calibration changed the D3PM head's bits")


def _reference_model(cfg: Config, dev, discrete: bool = False,
                     save_dir: str | None = None) -> ConditionalDiffusion:
    """The weights of the checkpoint in ``save_dir`` (default the config's)
    in a 20-step f32-compute model on ``dev`` (low-rank sigma's per-step
    log-scales taken at 20 evenly spaced steps)."""
    save_dir = save_dir or cfg.training.save_dir
    meta = load_metadata(save_dir)
    small = Config.from_dict(meta["config"])
    small.model.diffusion.num_steps = 20
    small.model.diffusion.discrete_mutation_head = discrete
    small.model.compute_dtype = "float32"
    model = ConditionalDiffusion.from_config(small, metadata_to_dims(meta))
    weights = load_weights(save_dir)
    if "lowrank_logs" in weights:
        logs = weights["lowrank_logs"]
        weights["lowrank_logs"] = logs[torch.linspace(0, len(logs) - 1, 20).round().long()]
    model.denoiser.load_state_dict(weights)
    model.denoiser.to(dev)
    return model


def check_against_plain_loop(cfg: Config, dev) -> None:
    """The kernel sampler against the plain PyTorch loop (the module in
    f32) at the main path's shapes and tiling: 333 patients at full
    width, with a 20-step schedule, the same x_T and noise.
    Tolerances, those of the JAX package's parity tests: continuous
    samplers atol 0.15 / rtol 0.05 (the bf16-carry tolerance); the D3PM
    sampler < 5% flipped bits and at least 80% of the rows within that
    tolerance (a flipped bit changes its row's next denoiser input); the
    int8 samplers elementwise correlation > 0.99, RMS < 8% of the spread
    and per-column mean and std within 0.08."""
    model = _reference_model(cfg, dev)
    g = torch.Generator().manual_seed(7)
    cond = torch.randn(BATCH, metadata_to_dims(load_metadata(cfg.training.save_dir)).condition_dim,
                       generator=g)
    x_init = torch.randn(BATCH, D, generator=g)
    noise = torch.randn(20, BATCH, D, generator=g)
    for label, ddim in (("DDPM-20", None), ("DDIM-10", 10)):
        sampler = FusedSampler(model, dev, ddim_steps=ddim)
        got = sampler.sample(cond, g, x_init=x_init, noise=None if ddim else noise)
        if ddim:
            ref = model.sample_ddim(cond, g, 10, x_init=x_init)
        else:
            ref = model.sample(cond, g, x_init=x_init, noise=noise)
        err = (got - ref).abs()
        bound = 0.15 + 0.05 * ref.abs()
        ok = bool((err <= bound).all()) and bool(torch.isfinite(got).all())
        print(f"[reference] {label} {BATCH}x{D}: kernel sampler vs plain loop max|diff| "
              f"{float(err.max()):.4f}, within atol 0.15 / rtol 0.05: {ok}; "
              f"std {float(ref.std()):.3f}", flush=True)
        if not ok:
            raise AssertionError(f"{label}: kernel sampler disagrees with the plain loop")

    d3pm = _reference_model(cfg, dev, discrete=True)
    u = torch.rand(20, BATCH, D, generator=g)
    unoise = (u - 0.5) * (2.0 * math.sqrt(3.0))
    bits_init = x_init.clone()
    bits_init[:, :MUT] = (torch.rand(BATCH, MUT, generator=g) < 0.5).float()
    got = FusedSampler(d3pm, dev).sample(cond, g, x_init=bits_init, noise=unoise)
    ref = d3pm.sample(cond, g, x_init=bits_init, noise=unoise)
    flips = float((got[:, :MUT] != ref[:, :MUT]).float().mean())
    err = (got[:, MUT:] - ref[:, MUT:]).abs()
    rows = float((err <= 0.15 + 0.05 * ref[:, MUT:].abs()).all(dim=1).float().mean())
    binary = bool(((got[:, :MUT] == 0) | (got[:, :MUT] == 1)).all())
    ok = binary and flips < 0.05 and rows >= 0.8 and bool(torch.isfinite(got).all())
    print(f"[reference] D3PM DDPM-20 buffer {BATCH}x{D}: bits binary {binary}, flipped share "
          f"{flips:.4f}, rows within atol 0.15 / rtol 0.05 {rows:.3f}, continuous max|diff| "
          f"{float(err.max()):.4f}: {ok}", flush=True)
    if not ok:
        raise AssertionError("D3PM: kernel sampler disagrees with the plain loop")

    for mode in ("out", "io", "all"):
        got = FusedSampler(model, dev, quantize=mode).sample(cond, g, x_init=x_init, noise=noise)
        ref = model.sample(cond, g, x_init=x_init, noise=noise, quantize=mode)
        a, b = got.double().flatten(), ref.double().flatten()
        corr = float(torch.corrcoef(torch.stack([a, b]))[0, 1])
        rms = float(((got - ref) ** 2).mean().sqrt())
        dmean = float((got.mean(0) - ref.mean(0)).abs().max())
        dstd = float((got.std(0) - ref.std(0)).abs().max())
        ok = (corr > 0.99 and rms < 0.08 * float(ref.std()) and dmean <= 0.08 and dstd <= 0.08
              and bool(torch.isfinite(got).all()))
        print(f"[reference] int8-{mode} DDPM-20 {BATCH}x{D}: corr {corr:.5f}, rms {rms:.4f} "
              f"(std {float(ref.std()):.3f}), max column |d mean| {dmean:.4f} |d std| "
              f"{dstd:.4f}: {ok}", flush=True)
        if not ok:
            raise AssertionError(f"int8-{mode}: kernel sampler disagrees with the plain loop")


SMALL_ROWS = SERVE_BUCKETS[:2]  # serving's small buckets: 1 and 64 rows


def check_small_batches_against_plain(cfg: Config, dev) -> None:
    """The kernel sampler against the plain loop at serving's small
    batches, 1 and 64 rows (one 64-row tile with 1 or 64 valid rows; the
    largest split-K at one row): continuous DDPM-20 with the same noise and
    DDIM-10, the same x_T, at the bf16-carry tolerance atol 0.15 / rtol
    0.05."""
    model = _reference_model(cfg, dev)
    g = torch.Generator().manual_seed(17)
    cdim = metadata_to_dims(load_metadata(cfg.training.save_dir)).condition_dim
    for rows in SMALL_ROWS:
        cond = torch.randn(rows, cdim, generator=g)
        x_init = torch.randn(rows, D, generator=g)
        noise = torch.randn(20, rows, D, generator=g)
        for label, ddim in (("DDPM-20", None), ("DDIM-10", 10)):
            got = FusedSampler(model, dev, ddim_steps=ddim).sample(
                cond, g, x_init=x_init, noise=None if ddim else noise)
            if ddim:
                ref = model.sample_ddim(cond, g, 10, x_init=x_init)
            else:
                ref = model.sample(cond, g, x_init=x_init, noise=noise)
            err = (got - ref).abs()
            ok = bool((err <= 0.15 + 0.05 * ref.abs()).all()) and bool(torch.isfinite(got).all())
            print(f"[reference] {label} {rows}x{D}: kernel sampler vs plain loop max|diff| "
                  f"{float(err.max()):.4f}, within atol 0.15 / rtol 0.05: {ok}; std "
                  f"{float(ref.std()):.3f}", flush=True)
            if not ok:
                raise AssertionError(f"{label} at {rows} rows: kernel sampler disagrees with the "
                                     "plain loop")


CALIB_ROWS = (BATCH, 1024, 10002)  # dual, dual, primal (D = 5142)
HOST_TIMED_ROWS = (BATCH, 1024)


def _seconds(fn, dev, reps: int = 3) -> tuple:
    """(median seconds of ``reps`` calls after one warm-up call, the last
    result), each call ended by a synchronize."""
    out = fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize(dev)
        times.append(time.perf_counter() - t0)
    return float(np.median(times)), out


def _corr(blocks, dev) -> torch.Tensor:
    x = torch.from_numpy(np.concatenate(blocks, axis=1)).to(dev, torch.float64)
    return torch.corrcoef(x.T)


def check_calibration(cfg: Config, dev) -> list:
    """[calib]: the generator's device calibration (copula_joint, the
    ``DeviceCalibrator``) against its host numpy path on the same raw
    cohorts, the kernel sampler's DDIM-50 output from the seeded weights
    at ``CALIB_ROWS`` rows (kept on the card for the device path, read
    back for the host's). Returns one record per size."""
    from osteosarcoma_diffusionmodel_torch.generation.generator import (
        SyntheticPatientGenerator,
        load_trained_model,
    )
    from osteosarcoma_diffusionmodel_torch.ops.copula_device import _normal_scores, _unit_std

    model, gcfg, dims = load_trained_model(cfg.training.save_dir, copy.deepcopy(cfg))
    gen = SyntheticPatientGenerator(model, gcfg, dims,
                                    data_stats=load_data_stats(cfg.training.save_dir), device=dev)
    gen._joint_fit(MUT)  # the host fit of the target, once per checkpoint, outside the timings
    sampler = FusedSampler(model, dev, ddim_steps=50)
    seed = gen._tie_seed()
    records = []
    for n in CALIB_ROWS:
        g = torch.Generator().manual_seed(n)
        raw = sampler.sample(torch.randn(n, dims.condition_dim, generator=g), g)
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        device_s, (bits, cont) = _seconds(
            lambda: gen._calibrate_device(raw, MUT, "copula_joint"), dev)
        peak_gb = (torch.cuda.max_memory_allocated(dev) - base) / 1e9
        host_raw = raw.cpu().numpy()
        if n in HOST_TIMED_ROWS:
            host_s, (bits_h, cont_h) = _seconds(
                lambda: gen._calibrate(host_raw, MUT, "copula_joint"), dev)
            host_label = "median of 3"
        else:
            t0 = time.perf_counter()
            bits_h, cont_h = gen._calibrate(host_raw, MUT, "copula_joint")
            host_s, host_label = time.perf_counter() - t0, "one run"

        u = _unit_std(_normal_scores(raw, torch.Generator(dev).manual_seed(seed)))
        u64 = u.double()
        gram = u64 @ u64.T / n if n < D else u64.T @ u64 / n
        del u, u64
        eigh_s, _ = _seconds(lambda: torch.linalg.eigh(gram), dev)
        del gram

        counts_equal = bool(np.array_equal(bits.sum(0), bits_h.sum(0)))
        sorted_d, sorted_h = np.sort(cont, axis=0), np.sort(cont_h, axis=0)
        sorted_err = float(np.abs(sorted_d - sorted_h).max())
        sorted_ok = bool((np.abs(sorted_d - sorted_h) <= 1e-4 + 1e-4 * np.abs(sorted_h)).all())
        a, b = _corr([bits, cont], dev), _corr([bits_h, cont_h], dev)
        iu = torch.triu_indices(a.shape[0], a.shape[0], 1, device=dev)
        a, b = a[iu[0], iu[1]], b[iu[0], iu[1]]
        keep = torch.isfinite(a) & torch.isfinite(b)
        a, b = a[keep], b[keep]
        pattern = float(torch.corrcoef(torch.stack([a, b]))[0, 1])
        delta = float((a - b).abs().max())
        del a, b, iu, keep
        branch = "dual N x N" if n < D else "primal D x D"
        rec = {"rows": n, "branch": branch, "device_s": device_s, "host_s": host_s,
               "eigh_s": eigh_s, "eigh_share": eigh_s / device_s, "peak_gb": peak_gb}
        records.append(rec)
        print(f"[calib] {n} rows ({branch} whitening): counts equal {counts_equal}, sorted "
              f"columns max|diff| {sorted_err:.2e} (within 1e-4: {sorted_ok}), correlation "
              f"pattern {pattern:.4f} (max|d| {delta:.4f}); device {device_s:.4f} s (warm, "
              f"median of 3) vs host {host_s:.4f} s ({host_label}), {host_s / device_s:.1f}x; "
              f"float64 eigh {eigh_s:.4f} s ({100 * eigh_s / device_s:.1f}% of the device "
              f"time); device peak {peak_gb:.2f} GB", flush=True)
        if not (counts_equal and sorted_ok and pattern > 0.95 and delta < 0.25):
            raise AssertionError(f"[calib] {n} rows: the device calibration disagrees with the "
                                 "host path")
        del raw
    return records


# [copy]: the cohort cells' downloads, rows of (bits, continuous block):
# DDPM-1000's 16,384-row cohort and DDIM-50's 3 x 3,334.
COPY_ROWS = {"ddpm1000-cohort-16k": 16384, "ddim50-cohort-10k": 10002}
COPY_REPEATS = 5


def check_copy_back(dev) -> dict:
    """[copy]: the calibrated cohort's copy back at the cohort cells'
    download shapes, ``.cpu()`` into fresh pageable memory (the copy back
    before ``copula_device.to_host``) against ``to_host`` (page-locked
    blocks of PyTorch's caching host allocator, reused): GB/s of the whole
    download, the median of ``COPY_REPEATS`` after one warm-up, each
    result dropped before the next; the two results equal bit for bit,
    page-locked, and no new page-locked block after the warm-up. Returns
    the GB/s by cell and path."""
    from osteosarcoma_diffusionmodel_torch.ops.copula_device import to_host
    from osteosarcoma_diffusionmodel_torch.utils.profiling import COUNTERS

    t_phase = time.perf_counter()
    rates = {}
    for label, rows in COPY_ROWS.items():
        g = torch.Generator(dev).manual_seed(rows)
        tensors = (torch.rand(rows, MUT, generator=g, device=dev),
                   torch.randn(rows, D - MUT, generator=g, device=dev))
        nbytes = sum(t.numel() * t.element_size() for t in tensors)
        paths = {"pageable": lambda: tuple(t.cpu().numpy() for t in tensors),
                 "page-locked": lambda: to_host(*tensors)}
        seconds, blocks = {}, {}
        for path, copy_back in paths.items():
            times = []
            for i in range(COPY_REPEATS + 1):
                if i == 1:
                    allocs = COUNTERS["copy.host_allocs"]
                torch.cuda.synchronize(dev)
                t0 = time.perf_counter()
                got = copy_back()
                times.append(time.perf_counter() - t0)
                if i < COPY_REPEATS:
                    del got
            seconds[path] = float(np.median(times[1:]))
            blocks[path] = COUNTERS["copy.host_allocs"] - allocs
            if path == "pageable":
                want = got
        equal = all(np.array_equal(a.view(np.uint32), b.view(np.uint32))
                    for a, b in zip(got, want))
        pinned = all(torch.from_numpy(a).is_pinned() for a in got)
        del got, want, tensors
        rates[label] = {path: nbytes / s / 1e9 for path, s in seconds.items()}
        print(f"[copy] {label}: {rows} x ({MUT} + {D - MUT}) f32, {nbytes / 1e6:.1f} MB: "
              f"pageable .cpu() {rates[label]['pageable']:.2f} GB/s "
              f"({1e3 * seconds['pageable']:.1f} ms), page-locked "
              f"{rates[label]['page-locked']:.2f} GB/s ({1e3 * seconds['page-locked']:.1f} ms), "
              f"{seconds['pageable'] / seconds['page-locked']:.1f}x (median of {COPY_REPEATS} "
              f"after a warm-up); equal bit for bit {equal}, page-locked {pinned}, new "
              f"page-locked blocks after the warm-up {blocks['page-locked']}", flush=True)
        if not (equal and pinned and blocks["page-locked"] == 0):
            raise AssertionError(f"[copy] {label}: the page-locked copy back is wrong or "
                                 "allocates in steady state")
    print(f"[copy] phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    return rates


def run_serve_phase(ckpt: Path, tmp: Path) -> dict:
    """[serve]: scripts/bench_serving_torch.py on the trained checkpoint
    (buckets 1, 64, 1,024 under DDPM and DDIM, ten requests a pair). Its
    launches are counted in its own process over the timed requests, and
    checked as a main path's: K1, K1+GN and K1+posterior (philox and none)
    launched, none that the main paths forbid. Returns them by kernel."""
    out = tmp / "serve.json"
    cmd = [sys.executable, str(REPO / "scripts" / "bench_serving_torch.py"), "--checkpoint-dir",
           str(ckpt), "--requests", "10", "--out", str(out)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"bench_serving_torch.py failed ({proc.returncode}):\n"
                             f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    report = json.loads(out.read_text())
    print(f"[serve] bench_serving_torch.py ({time.perf_counter() - t0:.1f} s): server ready in "
          f"{report['startup_seconds']:.1f} s (kernels loaded, 6 pairs warmed); /health devices "
          f"{report['health']['devices']}", flush=True)
    for key, pair in report["pairs"].items():
        print(f"[serve]   {key} ({pair['format']}): p50 {pair['p50_seconds']:.4f} s, p95 "
              f"{pair['p95_seconds']:.4f} s, max {pair['max_seconds']:.4f} s, payload "
              f"{pair['payload_mb']:.3f} MB; calibrations {json.dumps(pair['calibrations'])}",
              flush=True)
    kind = torch.cuda.get_device_name(0)
    metrics = report["service_metrics"]
    if not any(kind in d for d in report["health"]["devices"]):
        raise AssertionError(f"[serve] /health devices {report['health']['devices']} do not name "
                             f"{kind}")
    if metrics["requests"] != 10 * len(report["pairs"]) or len(report["pairs"]) != 6:
        raise AssertionError(f"[serve] /metrics counts {metrics['requests']} requests over "
                             f"{len(report['pairs'])} pairs; want 60 over 6")
    for key in ("ddpm_b1024", "ddim_b1024"):
        if report["pairs"][key]["calibrations"] != {"device": 10}:
            raise AssertionError(f"[serve] {key} calibrations {report['pairs'][key]['calibrations']}")
    counts = report["launches"]
    print(f"[serve] kernel launches by mode over the timed requests: {json.dumps(counts)}; "
          f"/metrics p50 {metrics['p50_seconds']:.4f} s, p95 {metrics['p95_seconds']:.4f} s, "
          f"p99 {metrics['p99_seconds']:.4f} s", flush=True)
    required = {GEMM: ["bf16"], GEMM_GN: ["default"], GEMM_POSTERIOR: ["philox", "none"]}
    missing = [f"{k.name}:{m}" for k, modes in required.items() for m in modes
               if not counts.get(k.name, {}).get(m)]
    ran = {f"{k.name}:{m}": counts.get(k.name, {}).get(m) for k, modes in FORBIDDEN.items()
           for m in modes if counts.get(k.name, {}).get(m)}
    if missing or ran or counts.get(ROWQUANT.name):
        raise AssertionError(f"[serve] never launched {missing}; launched but forbidden {ran}")
    return {k.name: sum(counts.get(k.name, {}).values()) for k in KERNELS}


# The pipeline phase: raw TARGET-OS-layout files written from the seeded
# structured cohort (a gzipped MAF, one gzipped STAR file a patient over
# PIPELINE_STAR_GENES genes with STAR's N_* rows, the clinical table), then
# the CLI's preprocess -> pathways -> train -> generate -> validate with
# the production training settings: cross-cancer pretraining on a second
# cohort under data_dir/pretrain/<project>/raw (preprocessed by the
# preprocess step), sample-path fine-tuning with config/config.yaml's
# values, DDIM-50 at 3 x 333. The preprocessor keeps the 5000 columns of
# the largest variance, STAR's unnamed N_unmapped row among them, so the
# expression width here is 5000, not 5054.
PIPELINE_PATIENTS = 100
PIPELINE_PRETRAIN = (60, 1)  # the pretraining cohort's patients and seed
PIPELINE_PROJECT = "TARGET-SMOKE"  # a project id, not a directory
PIPELINE_STAR_GENES = 20000  # STAR rows a patient besides its four summary rows
PIPELINE_PRETRAIN_EPOCHS = 20
PIPELINE_EPOCHS = 30
PIPELINE_REQUIRED = TRAINED_REQUIRED
PIPELINE_COOC_ROWS = 3 * BATCH  # the DDIM-50 cohort of the hard co-occurrence loss
FINETUNE_PROFILED_STEPS = 5
# One fine-tuning step on the card against the CPU on the same draws, of
# each loss: bf16 products summed in another order, through eight chain
# steps and the soft bits' 1/tau = 10.
FINETUNE_CARD_RTOL = 5e-2


def write_raw_cohort(raw: Path, cohort, seed: int, drop_mutation=(), drop_expression=(),
                     with_stage: bool = True) -> None:
    """``cohort`` as the GDC download lays it out under ``raw``: a gzipped
    MAF with a protein-altering record for each 1-bit and silent records
    that the filter drops; ``rna_seq/metadata.csv`` and one gzipped STAR
    file a patient (its comment line, the four N_* rows without a gene
    name, the cohort's genes as counts 2^(3 + 1.2 x) and low-count filler
    genes up to PIPELINE_STAR_GENES rows); ``clinical.csv`` with vital
    status, days, age in days, gender and stage strings."""
    rng = np.random.default_rng(seed + 100)
    ids = [f"TARGET-40-{s}" for s in cohort.sample_ids]
    (raw / "mutations").mkdir(parents=True)
    lines = ["#version gdc-1.0.0", "#filedate 20250101",
             "Hugo_Symbol\tEntrez_Gene_Id\tVariant_Classification\tTumor_Sample_Barcode"]
    for i, sid in enumerate(ids):
        for j, gene in enumerate(cohort.mutation_genes):
            if gene in drop_mutation:
                continue
            if cohort.mutations[i, j]:
                cls = PROTEIN_ALTERING_CLASSES[(i + j) % len(PROTEIN_ALTERING_CLASSES)]
                lines.append(f"{gene}\t0\t{cls}\t{sid}-01A")
            elif rng.random() < 0.05:
                lines.append(f"{gene}\t0\tSilent\t{sid}-01A")
    with gzip.open(raw / "mutations" / "cohort.maf.gz", "wt", compresslevel=1) as f:
        f.write("\n".join(lines) + "\n")

    rna = raw / "rna_seq"
    rna.mkdir()
    keep = [j for j, g in enumerate(cohort.expression_genes) if g not in drop_expression]
    names = [cohort.expression_genes[j] for j in keep]
    names += [f"LINC{k:05d}" for k in range(PIPELINE_STAR_GENES - len(names))]
    gene_ids = [f"ENSG{k:011d}.{1 + k % 9}" for k in range(len(names))]
    counts = np.concatenate([
        np.rint(np.exp2(3.0 + 1.2 * cohort.expression[:, keep])).astype(np.int64),
        rng.poisson(2.0, (len(ids), len(names) - len(keep)))], axis=1)
    header = ("gene_id\tgene_name\tgene_type\tunstranded\tstranded_first\tstranded_second\t"
              "tpm_unstranded\tfpkm_unstranded\tfpkm_uq_unstranded")
    meta = ["file_id,file_name,case_id,submitter_id,file_path"]
    for i, sid in enumerate(ids):
        path = rna / f"{sid}.rna_seq.augmented_star_gene_counts.tsv.gz"
        meta.append(f"f{i},{path.name},c{i},{sid},{path}")
        summary = [f"{name}\t\t\t{n}\t{n}\t{n}\t\t\t" for name, n in zip(
            ("N_unmapped", "N_multimapping", "N_noFeature", "N_ambiguous"),
            rng.integers(10 ** 5, 3 * 10 ** 6, 4))]
        body = [f"{gid}\t{name}\tprotein_coding\t{c}\t{c // 2}\t{c - c // 2}\t0\t0\t0"
                for gid, name, c in zip(gene_ids, names, counts[i].tolist())]
        with gzip.open(path, "wt", compresslevel=1) as f:
            f.write("# gene-model: GENCODE v36\n" + header + "\n"
                    + "\n".join(summary + body) + "\n")
    (rna / "metadata.csv").write_text("\n".join(meta) + "\n")

    clin = cohort.clinical
    rows = ["case_id,submitter_id,age_at_diagnosis,gender,tumor_stage,days_to_death,"
            "days_to_last_follow_up,vital_status"]
    for i, sid in enumerate(ids):
        dead = bool(clin["event_occurred"][i])
        days = int(clin["survival_days"][i])
        vital = ("Dead", "DEAD", "dead")[i % 3] if dead else ("Alive", "alive")[i % 2]
        stage = ("Stage IVA" if clin["metastasis_at_diagnosis"][i] else "Stage IIB")
        rows.append(",".join([
            f"c{i}", sid, str(round(float(clin["age_years"][i]) * 365.25)),
            "male" if clin["gender_bin"][i] else "female", stage if with_stage else "",
            str(days) if dead else "", "" if dead else str(days), vital]))
    if not with_stage:  # no stage column at all: the metastasis condition is missing
        rows = [",".join(c for k, c in enumerate(r.split(",")) if k != 4) for r in rows]
    (raw / "clinical.csv").write_text("\n".join(rows) + "\n")


def _hard_cooccurrence(pcfg: Config, model, dims, save_dir: Path, target, dev) -> float:
    """The co-occurrence matching loss of the hard-thresholded mutations of
    a PIPELINE_COOC_ROWS-row DDIM-50 cohort (raw, before calibration)
    against the training rows' correlation."""
    gcfg = copy.deepcopy(pcfg)
    gcfg.generation.sampler, gcfg.generation.sampling_steps = "ddim", 50
    gen = SyntheticPatientGenerator(model, gcfg, dims, data_stats=load_data_stats(save_dir),
                                    device=dev)
    cond = np.concatenate([gen.create_conditions(BATCH, s.conditions)
                           for s in gcfg.generation.scenarios])[:PIPELINE_COOC_ROWS]
    raw = gen.sample_raw(cond, seeded_generator(11))
    bits = (raw[:, :dims.mutation_dim].float() > 0.5).float()
    return float(cooccurrence_matching_loss(bits, target.to(bits.device)))


def _finetune_models(pcfg: Config, save_dir: Path, name: str, devices) -> tuple:
    """The CLI's model (constraint spec included) with the weights
    ``<name>.npz`` on each of ``devices``; and the training rows."""
    arrays, dims = prepare_arrays(pcfg)
    spec = build_constraint_spec(pcfg, arrays)
    state = load_weights(save_dir, name)
    models = []
    for where in devices:
        model = build_model(pcfg, dims, spec)
        model.module.load_state_dict(state)
        model.module.to(where)
        models.append(model)
    train_idx, _ = train_val_split(arrays.n_samples, pcfg.training.val_split,
                                   pcfg.training.random_seed)
    return models, dims, torch.from_numpy(arrays.data[train_idx]), torch.from_numpy(
        arrays.conditions[train_idx])


def _finetune_settings(pcfg: Config) -> dict:
    ftc = pcfg.training.sample_path_finetune
    return dict(ddim_steps=ftc.ddim_steps, sample_batch=ftc.sample_batch,
                learning_rate=ftc.learning_rate, soft_tau=ftc.soft_tau,
                cooccurrence_weight=ftc.cooccurrence_weight, anchor_weight=ftc.anchor_weight)


def check_finetune_step(pcfg: Config, save_dir: Path, dev) -> dict:
    """One fine-tuning step from the backed-up best model on the card and on
    the CPU on the same draws (rows, x_T, the anchor's t and noise): each
    loss within FINETUNE_CARD_RTOL; then FINETUNE_PROFILED_STEPS steps on
    the card timed, and as many under torch.profiler for the launches and
    device time a step."""
    settings = _finetune_settings(pcfg)
    (card, host), dims, data, cond = _finetune_models(
        pcfg, save_dir, "best_model_prefinetune", (dev, torch.device("cpu")))
    g = torch.Generator().manual_seed(5)
    n, D, B = data.shape[0], data.shape[1], settings["sample_batch"]
    draws = [{"rows": torch.randint(0, n, (B,), generator=g),
              "x_T": torch.randn(B, D, generator=g),
              "t": torch.randint(0, pcfg.model.diffusion.num_steps, (n,), generator=g),
              "noise": torch.randn(n, D, generator=g)}]
    got = sample_path_finetune(card, data.to(dev), cond.to(dev), None, steps=1, draws=draws,
                               **settings)
    t0 = time.perf_counter()
    want = sample_path_finetune(host, data, cond, None, steps=1, draws=draws, **settings)
    cpu_s = time.perf_counter() - t0
    errs = {k: abs(got[k][0] - want[k][0]) / max(abs(want[k][0]), 1e-12) for k in want}
    ok = all(e <= FINETUNE_CARD_RTOL for e in errs.values()) and all(
        math.isfinite(got[k][0]) for k in got)
    print(f"[reference] pipeline fine-tune step, card vs CPU on the same draws (CPU "
          f"{cpu_s:.1f} s): " + ", ".join(f"{k} {got[k][0]:.6f} / {want[k][0]:.6f} (rel "
                                          f"{errs[k]:.2e})" for k in want)
          + f"; bound {FINETUNE_CARD_RTOL}: {ok}", flush=True)
    if not ok:
        raise AssertionError("[pipeline] the fine-tuning step on the card disagrees with the CPU")

    gen = torch.Generator(device=dev).manual_seed(77)
    data, cond = data.to(dev), cond.to(dev)
    sample_path_finetune(card, data, cond, gen, steps=1, **settings)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sample_path_finetune(card, data, cond, gen, steps=FINETUNE_PROFILED_STEPS, **settings)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / FINETUNE_PROFILED_STEPS
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        sample_path_finetune(card, data, cond, gen, steps=FINETUNE_PROFILED_STEPS, **settings)
        torch.cuda.synchronize()
    events = prof.key_averages()
    host_keys = {e.key for e in events if e.device_type == torch.autograd.DeviceType.CPU}
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA and e.key not in host_keys]
    launches = sum(e.count for e in kernels) / FINETUNE_PROFILED_STEPS
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / FINETUNE_PROFILED_STEPS
    return {"wall_ms": wall_ms, "launches": launches, "device_ms": device_ms}


def run_pipeline_phase(cfg: Config, dev, root: Path) -> dict:
    """[pipeline]: raw files -> the CLI's preprocess, pathways, train (with
    pretraining and fine-tuning), generate, validate, with the generate
    run's launch accounting; the fine-tuning step card vs CPU; the hard
    co-occurrence before and after fine-tuning. Returns the launches of
    the generate -> validate run by kernel."""
    t_phase = time.perf_counter()
    data_dir = root / "pipeline_data"
    t0 = time.perf_counter()
    primary = make_dummy_cohort(PIPELINE_PATIENTS, *DATA_DIMS, seed=0)
    write_raw_cohort(data_dir / "raw", primary, seed=0)
    n_pre, seed_pre = PIPELINE_PRETRAIN
    second = make_dummy_cohort(n_pre, *DATA_DIMS, seed=seed_pre)
    write_raw_cohort(data_dir / "pretrain" / PIPELINE_PROJECT / "raw", second, seed_pre,
                     drop_mutation=second.mutation_genes[-6:],
                     drop_expression=second.expression_genes[-300:], with_stage=False)
    print(f"[pipeline] raw files: {PIPELINE_PATIENTS} + {n_pre} patients, STAR "
          f"{PIPELINE_STAR_GENES} genes + 4 summary rows each, in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    pcfg = copy.deepcopy(cfg)
    pcfg.data.data_dir = str(data_dir)
    pcfg.data.raw_dir = str(data_dir / "raw")
    pcfg.data.processed_dir = str(data_dir / "processed")
    tc = pcfg.training
    tc.epochs_per_dispatch = 25
    tc.num_epochs = tc.patience = PIPELINE_EPOCHS
    tc.pretrain_epochs = PIPELINE_PRETRAIN_EPOCHS
    tc.save_dir = str(root / "checkpoint_pipeline")
    tc.augmentation.cross_cancer_pretrain = True
    tc.augmentation.pretrain_datasets = [PIPELINE_PROJECT]
    tc.sample_path_finetune.enabled = True
    pcfg.output.results_dir = str(root / "results_pipeline")
    seconds = {}

    def step(name, fn, *args, **kw):
        t = time.perf_counter()
        out = fn(*args, **kw)
        if str(dev) != "cpu":
            torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t
        return out

    processed = step("preprocess", preprocess_data, pcfg)
    pre_dir = data_dir / "pretrain" / PIPELINE_PROJECT / "processed"
    step("pathways", compute_pathway_features, pcfg)
    mut = processed["mutation_matrix"]
    expr = processed["expression_matrix"]
    paths = read_matrix_csv(Path(pcfg.data.processed_dir) / "pathway_scores.csv")
    pre_expr = read_matrix_csv(pre_dir / "expression_matrix_aligned.csv")
    print(f"[pipeline] preprocess {seconds['preprocess']:.2f} s: {len(mut.index)} patients, "
          f"{len(mut.columns)} mutation genes, {len(expr.columns)} expression columns (the "
          f"unnamed N_unmapped among them: {None in expr.columns}); pretraining cohort "
          f"{len(pre_expr.index)} patients; pathways {seconds['pathways']:.2f} s: "
          f"{len(paths.columns)} pathways", flush=True)
    width = min(TOP_EXPRESSION_GENES, PIPELINE_STAR_GENES + 1)  # + the unnamed N_unmapped
    if len(expr.columns) != width or not (pre_dir / "clinical_aligned.csv").exists():
        raise AssertionError(f"[pipeline] expression width {len(expr.columns)}, pretraining "
                             f"cohort processed {pre_dir.exists()}")

    ftc = tc.sample_path_finetune
    print(f"[pipeline] train: {tc.pretrain_epochs} pretraining epochs, {tc.num_epochs} epochs "
          f"in blocks of {tc.epochs_per_dispatch}, batch {tc.batch_size}, fine-tuning "
          f"{ftc.steps} steps of DDIM-{ftc.ddim_steps} on {ftc.sample_batch} rows", flush=True)
    history = step("train", train_model, pcfg, device=str(dev))
    pre, ft = history.pretrain, history.finetune
    save_dir = Path(tc.save_dir)
    losses = history.train_loss + history.val_loss + (
        pre.train_loss + pre.val_loss if pre else []) + sum((ft or {}).values(), [])
    ok = (pre is not None and ft is not None and all(math.isfinite(v) for v in losses)
          and (save_dir / "pretrain" / "best_model.npz").exists()
          and (save_dir / "best_model_prefinetune.npz").exists())
    before, after = load_weights(save_dir, "best_model_prefinetune"), load_weights(save_dir)
    changed = any(not torch.equal(before[k], after[k]) for k in before)
    print(f"[pipeline] train {seconds['train']:.2f} s: pretraining {len(pre.train_loss)} epochs "
          f"{pre.steps_per_sec:.1f} steps/sec (loss {pre.train_loss[0]:.4f} -> "
          f"{pre.train_loss[-1]:.4f}); training {len(history.train_loss)} epochs "
          f"{history.steps_per_sec:.1f} steps/sec (val {history.val_loss[0]:.4f} -> best "
          f"{min(history.val_loss):.4f}); fine-tuning soft co-occurrence "
          f"{ft['cooccurrence'][0]:.6f} -> {ft['cooccurrence'][-1]:.6f}, anchor "
          f"{ft['anchor'][0]:.6f} -> {ft['anchor'][-1]:.6f}; losses finite, pretrain/ and "
          f"best_model_prefinetune.npz written: {ok}; best_model.npz changed: {changed}",
          flush=True)
    if not (ok and changed):
        raise AssertionError("[pipeline] the train step's pretraining or fine-tuning failed")

    gcfg = copy.deepcopy(pcfg)
    gcfg.output.synthetic_data_dir = str(root / "synthetic_pipeline")
    t = time.perf_counter()
    dims = metadata_to_dims(load_metadata(save_dir))
    launches, results = run_path(
        "pipeline", [(False, "none", "ddim")], PIPELINE_REQUIRED, gcfg, dev,
        {False: str(save_dir)}, (dims.mutation_dim, dims.expression_dim, dims.pathway_dim))
    seconds["generate+validate"] = time.perf_counter() - t
    print(f"[pipeline] fine-tuned weights, DDIM-50 3 x {BATCH}: overall "
          f"{results['overall_biological_score']:.4f}, MMD {results['mmd']:.4f}, co-occurrence "
          f"pattern {results['cooccurrence_pattern_correlation']:.4f}, pathway coherence "
          f"(synthetic / real) {results.get('synthetic_pathway_coherence', math.nan):.4f} / "
          f"{results.get('real_pathway_coherence', math.nan):.4f} (no gate)", flush=True)

    prof = check_finetune_step(pcfg, save_dir, dev)
    print(f"[pipeline] fine-tune step on the card: {prof['wall_ms']:.2f} ms a step, "
          f"{prof['launches']:.0f} launches a step, device {prof['device_ms']:.3f} ms a step "
          f"(busy {prof['device_ms'] / prof['wall_ms']:.3f})", flush=True)
    (model_before,), dims, data, _ = _finetune_models(pcfg, save_dir, "best_model_prefinetune",
                                                      (dev,))
    (model_after,), *_ = _finetune_models(pcfg, save_dir, "best_model", (dev,))
    target = torch.from_numpy(mutation_corr_matrix(data[:, :dims.mutation_dim].numpy()))
    hard = [_hard_cooccurrence(pcfg, m, dims, save_dir, target, dev)
            for m in (model_before, model_after)]
    print(f"[pipeline] hard-thresholded co-occurrence loss of a {PIPELINE_COOC_ROWS}-row "
          f"DDIM-50 cohort: {hard[0]:.6f} before fine-tuning, {hard[1]:.6f} after", flush=True)
    print(f"[pipeline] seconds by step: " + ", ".join(f"{k} {v:.2f}" for k, v in seconds.items())
          + f"; phase {time.perf_counter() - t_phase:.1f} s; kernel launches "
          f"{json.dumps({k: v for k, v in launches.items() if v})}", flush=True)
    return launches, gcfg, results


# The report phase, on [pipeline]'s directories: the figures every cohort
# gets where matplotlib is installed (the driver-gene bars only where the
# driver genes are among the mutation columns), the --profile train's
# epochs, the GAT encoder's card-vs-CPU tolerance (of max |out|, f32 with
# TF32 off) and its timed forwards.
REPORT_FIGURES = {"mutation_frequency_scatter.png", "pathway_histograms.png",
                  "cohort_embedding.png", "kaplan_meier.png", "validation_metrics.png"}
PROFILE_EPOCHS = 2
GNN_TOL = 1e-4
GNN_FORWARDS = 20


def _check_report(rcfg: Config, validation: dict) -> None:
    """The report step: the summary graded from the validate step's
    results, the figures written (or skipped without matplotlib), the
    step's and ``embed_2d``'s seconds on the real + synthetic expression."""
    timed = {}
    embed = report_module.embed_2d

    def timed_embed(real, synthetic):
        t = time.perf_counter()
        out = embed(real, synthetic)
        timed.update(seconds=time.perf_counter() - t, shape=real.shape[0] + synthetic.shape[0],
                     width=real.shape[1], out=out)
        return out

    report_module.embed_2d = timed_embed
    try:
        t = time.perf_counter()
        results = analysis_report(rcfg)
        report_s = time.perf_counter() - t
    finally:
        report_module.embed_2d = embed
    overall = results["overall_biological_score"]
    text = (Path(rcfg.output.results_dir) / "summary_report.txt").read_text()
    graded = f"Overall biological score: {overall:.3f} -> {grade(overall)}"
    figures = sorted(p.name for p in Path(rcfg.output.figures_dir).glob("*.png"))
    have_plt = report_module._matplotlib() is not None
    print(f"[report] report {report_s:.2f} s: summary_report.txt written ({graded!r}); "
          + (f"figures {figures}" if have_plt else "matplotlib is not installed: the "
             "figures were skipped, as in the JAX package"), flush=True)
    if not have_plt:
        processed = Path(rcfg.data.processed_dir)
        real = read_matrix_csv(processed / "expression_matrix_aligned.csv")
        synth = [read_matrix_csv(Path(rcfg.output.synthetic_data_dir) / s.name
                                 / f"{s.name}_expression.csv", index_col=None)
                 for s in rcfg.generation.scenarios]
        names = report_module.common_columns(real.columns, synth[0].columns)
        timed_embed(report_module.select(real, names),
                    np.concatenate([report_module.select(m, names) for m in synth]))
    r2, s2 = timed["out"]
    print(f"[report] embed_2d on {timed['shape']} x {timed['width']} expression rows "
          f"(real + synthetic): {timed['seconds']:.2f} s", flush=True)
    same = results.keys() == validation.keys() and all(
        v == validation[k] or (math.isnan(v) and math.isnan(validation[k]))
        for k, v in results.items())
    ok = (graded in text and same and np.isfinite(r2).all()
          and np.isfinite(s2).all() and len(r2) + len(s2) == timed["shape"]
          and (REPORT_FIGURES <= set(figures) if have_plt else not figures))
    if not ok:
        raise AssertionError(f"[report] summary, figures or embedding wrong: {figures}, "
                             f"{results} against {validation}")


def _check_profile(rcfg: Config, dev, root: Path) -> None:
    """``--profile`` on the card: the CLI's train for PROFILE_EPOCHS epochs
    under torch.profiler; the trace parses and holds CUDA kernel events."""
    pcfg = copy.deepcopy(rcfg)
    tc = pcfg.training
    tc.num_epochs = tc.patience = PROFILE_EPOCHS
    tc.epochs_per_dispatch = 1
    tc.augmentation.cross_cancer_pretrain = False
    tc.sample_path_finetune.enabled = False
    tc.save_dir = str(root / "checkpoint_profile")
    pcfg.output.results_dir = str(root / "results_profile")
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    history = train_model(pcfg, device=str(dev), profile=True)
    train_s = time.perf_counter() - t
    traces = sorted((Path(pcfg.output.results_dir) / "profile").glob("*.pt.trace.json"))
    if len(traces) != 1 or not all(math.isfinite(v) for v in history.train_loss):
        raise AssertionError(f"[report] --profile: traces {traces}, history {history.train_loss}")
    events = json.loads(traces[0].read_text())["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    by_name: dict = {}
    for e in kernels:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + float(e.get("dur", 0.0))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    print(f"[report] --profile: train {len(history.train_loss)} epochs in {train_s:.2f} s; "
          f"trace {traces[0].name} {traces[0].stat().st_size / 1e6:.2f} MB, {len(events)} "
          f"events, {len(kernels)} CUDA kernel events; top device operations (ms): "
          + json.dumps([[name[:80], round(us / 1e3, 4)] for name, us in top]), flush=True)
    if not kernels:
        raise AssertionError("[report] --profile: the trace holds no CUDA kernel event")
    stats = device_memory_stats()
    name = torch.cuda.get_device_name(0)
    peaks = {k: v.get("allocated_bytes.all.peak", 0) for k, v in stats.items()}
    shown = {k: f"{v / 2**20:.1f} MiB peak" for k, v in peaks.items()}
    print(f"[report] device_memory_stats: {json.dumps(shown)}", flush=True)
    if not any(name in k and v > 0 for k, v in peaks.items()):
        raise AssertionError(f"[report] device_memory_stats names no card or no peak: {peaks}")


def _check_gnn(rcfg: Config, dev) -> None:
    """The GAT encoder on the pathway step's gene-pathway graph, on the card
    against the same module on the CPU, one graph and two pooled."""
    gpm = read_matrix_csv(Path(rcfg.data.processed_dir) / "gene_pathway_matrix.csv")
    x = torch.from_numpy(gpm.values.astype(np.float32))
    edges = torch.from_numpy(gene_pathway_edges(gpm.values))
    n, e = x.shape[0], edges.shape[1]
    mc = rcfg.model
    hidden = mc.hidden_dims[0]
    enc = PathwayGraphEncoder(x.shape[1], hidden, mc.latent_dim, num_layers=mc.gnn.num_layers,
                              heads=mc.gnn.heads, dropout=mc.gnn.dropout).eval()
    init_flax(enc, torch.Generator().manual_seed(0))
    batch = (torch.arange(n) >= n // 2).long()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad():
            want = [enc(x, edges), enc(x, edges, batch=batch, num_graphs=2)]
            card = copy.deepcopy(enc).to(dev)
            xd, ed, bd = x.to(dev), edges.to(dev), batch.to(dev)
            got = [card(xd, ed), card(xd, ed, batch=bd, num_graphs=2)]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            card(xd, ed)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - base
            ms = time_ms(lambda: card(xd, ed), iters=GNN_FORWARDS)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    errs = [float((g.cpu() - w).abs().max()) / float(w.abs().max()) for g, w in zip(got, want)]
    heads = mc.gnn.heads
    print(f"[report] GAT encoder: N {n} genes x {x.shape[1]} pathways, E {e} edges (self-loops "
          f"included), hidden {hidden}, latent {mc.latent_dim}, {mc.gnn.num_layers} layers, "
          f"{heads} heads; messages E x H x F f32 {e * heads * hidden * 4 / 2**20:.1f} MiB; "
          f"card vs CPU max|diff| / max|out| {errs[0]:.2e} (one graph), {errs[1]:.2e} (two "
          f"pooled, shape {tuple(got[1].shape)}) (tol {GNN_TOL:.0e}); forward {ms:.4f} ms "
          f"(CUDA events over {GNN_FORWARDS}), peak {peak / 2**20:.1f} MiB above the inputs",
          flush=True)
    if not (max(errs) <= GNN_TOL and tuple(got[1].shape) == (2, mc.latent_dim)
            and all(torch.isfinite(g).all() for g in got)):
        raise AssertionError(f"[report] GAT encoder card vs CPU {errs} > {GNN_TOL}")


def run_report_phase(gcfg: Config, validation: dict, dev, root: Path) -> dict:
    """[report]: on [pipeline]'s directories, the CLI's doctor (every entry
    OK) and report steps, ``--profile`` on the card and the GAT encoder on
    the card against the CPU. No kernel of the report's path exists:
    returns the phase's launches, which must all be 0."""
    t_phase = time.perf_counter()
    for k in KERNELS:
        k.reset()
    rcfg = copy.deepcopy(gcfg)
    rcfg.output.figures_dir = str(root / "figures_pipeline")
    entries = doctor(rcfg)
    print(f"[report] doctor: {json.dumps(entries)}", flush=True)
    if not all(v.startswith("OK") for v in entries.values()) or len(entries) != 4:
        raise AssertionError(f"[report] doctor: {entries}")
    _check_report(rcfg, validation)
    _check_profile(rcfg, dev, root)
    _check_gnn(rcfg, dev)
    launches = {k.name: k.launches for k in KERNELS}
    print(f"[report] phase {time.perf_counter() - t_phase:.1f} s; kernel launches "
          f"{json.dumps({k: v for k, v in launches.items() if v})}", flush=True)
    if any(launches.values()):
        raise AssertionError(f"[report] the report's path launched kernels: {launches}")
    return launches


# The multi-device phase ([multi]): the port's parallel/ layer on the card,
# in a child process of its own so that its NCCL communicator never shares
# this process's state. NCCL refuses two ranks on one card, so the card
# runs a world of one rank: a real communicator and real collectives, the
# kernels on the card. The production settings at full width, the seeded
# cohort: data-parallel training against the one-device trainer (MULTI_STEPS
# steps at batch 16 with the constraint losses and dropout on; the cVAE for
# MULTI_CVAE_STEPS, BatchNorm's moments through the collectives),
# sample_sharded against sample at BATCH rows, the sharded generator against
# the unsharded one on host calibration. Then the 4-rank dry run on the CPU
# (gloo), as a user on a one-card machine runs it.
MULTI_STEPS = 20
MULTI_CVAE_STEPS = 10
# One rank: the collectives are copies, the arithmetic the one-device
# trainer's, so the losses agree to 1e-6 relative, and a parameter may
# move by at most 2 lr a step (AdamW's g / (|g| + eps) where rounding flips
# a gradient near 0); all but 1e-3 of them must agree within 1e-6.
MULTI_LOSS_RTOL = 1e-6
MULTI_PARAM_TOL = 1e-6
MULTI_WIDE_SHARE = 1e-3
MULTI_SCORE_TOL = 1e-6  # sharded vs unsharded generator, both calibrated on the host
MULTI_GATHER_ITERS = 50
MULTI_DRYRUN_DEVICES = 4
MULTI_TIMEOUT_S = 420
MULTI_REQUIRED = {GEMM: ["bf16"], GEMM_GN: ["default"],
                  GEMM_POSTERIOR: ["philox", "buffer", "none"], RBF: ["default"]}


def _multi_counted(fn, totals: dict):
    """``fn()`` with every kernel's count set to 0 just before it and read
    just after, added to ``totals`` (by kernel and by mode)."""
    for k in KERNELS:
        k.reset()
    out = fn()
    torch.cuda.synchronize()
    for k in KERNELS:
        totals["launches"][k.name] = totals["launches"].get(k.name, 0) + k.launches
        modes = totals["modes"].setdefault(k.name, {})
        for mode, n in k.modes.items():
            modes[mode] = modes.get(mode, 0) + n
    return out


def _multi_train(cfg: Config, arch: str, steps: int, mesh, dev, root: Path) -> dict:
    """The one-device trainer and the data-parallel one from the same seed,
    ``steps`` steps on the same batches: losses, parameters, ms a step."""
    tcfg = copy.deepcopy(cfg)
    tcfg.model.architecture = arch
    tcfg.training.save_dir = str(root / f"checkpoint_multi_{arch}")
    arrays, dims = prepare_arrays(tcfg)
    spec = build_constraint_spec(tcfg, arrays)
    trainers = [Trainer(build_model(tcfg, dims, spec), arrays, dims, tcfg, dev, mesh=m)
                for m in (None, mesh)]
    one, dp = trainers
    epochs = -(-steps // len(one.epoch_batches(0)))
    batches = [torch.from_numpy(i).to(dev) for e in range(epochs)
               for i in one.epoch_batches(e)][:steps]

    def step(t, idx):
        return t.train_step(t._data[idx], t._cond[idx], t._surv[idx])["loss"]

    losses = [[step(t, batches[0])] for t in trainers]  # first steps: warm-up, not timed
    ms = []
    for t, out in zip(trainers, losses):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out.extend(step(t, idx) for idx in batches[1:])
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3 / (steps - 1))
    la, lb = (torch.stack(v).tolist() for v in losses)
    loss_rel = max(abs(a - b) / max(abs(b), 1e-12) for a, b in zip(lb, la))
    diffs = [(p.detach() - q.detach()).abs() for p, q in zip(dp.params, one.params)]
    max_d = max(float(d.max()) for d in diffs)
    wide = sum(int((d > MULTI_PARAM_TOL).sum()) for d in diffs) / sum(d.numel() for d in diffs)
    lr = tcfg.training.learning_rate
    ok = (loss_rel <= MULTI_LOSS_RTOL and max_d <= 2 * lr * steps and wide <= MULTI_WIDE_SHARE
          and all(math.isfinite(v) for v in la + lb))
    print(f"[multi] {arch} data-parallel training on NCCL at world size 1 (mesh "
          f"{dict(zip(mesh.mesh_dim_names, mesh.shape))}), {steps} steps at batch "
          f"{tcfg.training.batch_size}, constraints {tcfg.model.constraints.enabled}, dropout "
          f"{tcfg.model.gnn.dropout}: loss {lb[0]:.6f} -> {lb[-1]:.6f} (one device "
          f"{la[0]:.6f} -> {la[-1]:.6f}), max rel |dloss| {loss_rel:.2e} (tol "
          f"{MULTI_LOSS_RTOL:.0e}); params max |d| {max_d:.3e}, share above "
          f"{MULTI_PARAM_TOL:.0e} {wide:.2e} (tol {MULTI_WIDE_SHARE:.0e}); "
          f"{ms[0]:.3f} ms a step on one device, {ms[1]:.3f} ms data-parallel "
          f"({100 * (ms[1] / ms[0] - 1):+.1f}%), mean of {steps - 1} after one warm-up step: {ok}",
          flush=True)
    if not ok:
        raise AssertionError(f"[multi] {arch}: the data-parallel trainer disagrees with the "
                             "one-device trainer")
    return {"loss_rel": loss_rel, "param_max": max_d, "wide": wide, "ms_one": ms[0],
            "ms_dp": ms[1]}


def _multi_sampler(cfg: Config, mesh, dev, totals: dict) -> dict:
    """sample_sharded against sample at BATCH rows: DDPM-1000 "buffer" and
    DDIM-50 "none" bit for bit; DDPM-1000 "philox" timed against sample
    (one rank: the same seed, so equal too); the all-gather's ms."""
    from osteosarcoma_diffusionmodel_torch.parallel import axis_group
    from osteosarcoma_diffusionmodel_torch.parallel.batch import all_gather_rows

    model, _, dims = load_trained_model(cfg.training.save_dir, copy.deepcopy(cfg))
    cond = torch.randn(BATCH, dims.condition_dim, generator=torch.Generator().manual_seed(14))
    ddpm, ddim = FusedSampler(model, dev), FusedSampler(model, dev, ddim_steps=50)
    noise = torch.randn((ddpm.n_loop, BATCH, D), generator=torch.Generator(dev).manual_seed(15),
                        device=dev)
    equal = {}
    for label, sampler, kw in ((f"DDPM-{ddpm.n_loop} buffer", ddpm, {"noise": noise}),
                               (f"DDIM-{ddim.n_loop} none", ddim, {})):
        got = _multi_counted(lambda: sampler.sample_sharded(
            mesh, cond, torch.Generator().manual_seed(16), **kw), totals)
        want = sampler.sample(cond, torch.Generator().manual_seed(16), **kw)
        equal[label] = bool(torch.equal(got, want))
    del noise, got, want
    walls = {"sharded": [], "one": []}
    for _ in range(3):  # in turns
        for name in walls:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if name == "sharded":
                out_s = _multi_counted(lambda: ddpm.sample_sharded(
                    mesh, cond, torch.Generator().manual_seed(17)), totals)
            else:
                out_p = ddpm.sample(cond, torch.Generator().manual_seed(17))
            torch.cuda.synchronize()
            walls[name].append(time.perf_counter() - t0)
    equal[f"DDPM-{ddpm.n_loop} philox"] = bool(torch.equal(out_s, out_p))
    moments = {k: (float(v.mean()), float(v.var())) for k, v in (("sharded", out_s),
                                                                 ("one", out_p))}
    finite = bool(torch.isfinite(out_s).all())
    group = axis_group(mesh, "data")
    block = torch.randn(BATCH, D, device=dev)
    gather_ms = time_ms(lambda: all_gather_rows(group, block), iters=MULTI_GATHER_ITERS)
    wall = {k: float(np.median(v)) for k, v in walls.items()}
    print(f"[multi] sample_sharded at {BATCH} rows on NCCL world size 1: bit-equal to sample "
          f"{json.dumps(equal)}; DDPM-{ddpm.n_loop} philox finite {finite}, mean/var sharded "
          f"{moments['sharded'][0]:.5f}/{moments['sharded'][1]:.5f}, one device "
          f"{moments['one'][0]:.5f}/{moments['one'][1]:.5f}; wall (median of 3, in turns) "
          f"sharded {wall['sharded']:.4f} s, sample {wall['one']:.4f} s "
          f"({1e3 * (wall['sharded'] - wall['one']):+.2f} ms); all-gather of {BATCH} x {D} f32 "
          f"({BATCH * D * 4 / 1e6:.2f} MB) {gather_ms:.4f} ms (CUDA events over "
          f"{MULTI_GATHER_ITERS})", flush=True)
    if not (all(equal.values()) and finite):
        raise AssertionError(f"[multi] sample_sharded disagrees with sample: {equal}")
    return {"equal": equal, "wall_sharded_s": wall["sharded"], "wall_one_s": wall["one"],
            "gather_ms": gather_ms, "moments": moments}


def _multi_generate(cfg: Config, mesh, dev, root: Path, totals: dict) -> dict:
    """3 x BATCH DDPM-1000 through the sharded generator (host calibration)
    and the unsharded one with host calibration, each saved and validated
    through the CLI's validate step: equal cohorts, equal scores."""
    out = {}
    for label, m in (("sharded", mesh), ("one device", None)):
        gcfg = copy.deepcopy(cfg)
        gcfg.generation.sampler = "ddpm"
        gcfg.generation.calibration_backend = "auto" if m is not None else "numpy"
        gcfg.output.synthetic_data_dir = str(root / f"synthetic_multi_{label.replace(' ', '_')}")
        model, gcfg, dims = load_trained_model(gcfg.training.save_dir, gcfg)
        gen = SyntheticPatientGenerator(model, gcfg, dims, device=dev, mesh=m,
                                        data_stats=load_data_stats(gcfg.training.save_dir))
        gen_module.CALIBRATIONS.clear()

        def run(gen=gen, gcfg=gcfg):
            synthetic = gen.generate_scenarios(gcfg.generation.scenarios, BATCH)
            processed = Path(gcfg.data.processed_dir)
            names = {"mutation_genes": _header(processed / "mutation_matrix_aligned.csv"),
                     "expression_genes": _header(processed / "expression_matrix_aligned.csv"),
                     "pathway_names": _header(processed / "pathway_scores.csv")}
            for name, cohort in synthetic.items():
                gen.save_synthetic_data(cohort, Path(gcfg.output.synthetic_data_dir) / name,
                                        names, prefix=name)
            return synthetic, validate_synthetic_patients(gcfg, device=str(dev))

        t0 = time.perf_counter()
        synthetic, results = _multi_counted(run, totals) if m is not None else run()
        out[label] = (synthetic, results, dict(gen_module.CALIBRATIONS),
                      time.perf_counter() - t0)
    (syn_s, res_s, cal_s, sec_s), (syn_p, res_p, cal_p, sec_p) = out["sharded"], out["one device"]
    same = all(np.array_equal(syn_s[n][k], syn_p[n][k]) for n in syn_p for k in syn_p[n])
    d_overall = abs(res_s["overall_biological_score"] - res_p["overall_biological_score"])
    d_mmd = abs(res_s["mmd"] - res_p["mmd"])
    ok = (same and d_overall <= MULTI_SCORE_TOL and d_mmd <= MULTI_SCORE_TOL
          and cal_s == cal_p == {"host": 1})
    print(f"[multi] sharded generator, {len(syn_s)} x {BATCH} DDPM-1000 (batched), calibration "
          f"{json.dumps(cal_s)} (one device under 'numpy': {json.dumps(cal_p)}): cohorts equal "
          f"{same}; overall {res_s['overall_biological_score']:.6f} vs "
          f"{res_p['overall_biological_score']:.6f}, MMD {res_s['mmd']:.6f} vs "
          f"{res_p['mmd']:.6f} (tol {MULTI_SCORE_TOL:.0e}); generate+save+validate "
          f"{sec_s:.2f} s vs {sec_p:.2f} s: {ok}", flush=True)
    if not ok:
        raise AssertionError("[multi] the sharded generator disagrees with the unsharded one")
    return {"overall": res_s["overall_biological_score"], "mmd": res_s["mmd"],
            "seconds_sharded": sec_s, "seconds_one": sec_p}


def run_multi_child(out_path: Path, backend: str = "nccl") -> None:
    """The [multi] phase's card part, in its own process: a world of one
    NCCL rank on card 0 (``backend`` "gloo": the CPU, for a rehearsal).
    Writes its launches and numbers to ``out_path``."""
    import torch.distributed as dist

    from osteosarcoma_diffusionmodel_torch.parallel import initialize_distributed, make_mesh

    dev = torch.device("cuda", 0) if backend == "nccl" else torch.device("cpu")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    logging.basicConfig(level=logging.WARNING)
    totals = {"launches": {}, "modes": {}}
    with tempfile.TemporaryDirectory(prefix="osdm_multi_") as tmp:
        root = Path(tmp)
        initialize_distributed(f"file://{root / 'store'}", 1, 0, backend, timeout_s=120)
        try:
            mesh = make_mesh(1)
            print(f"[multi] NCCL {'.'.join(map(str, torch.cuda.nccl.version()))}, backend "
                  f"{dist.get_backend()}, world size {dist.get_world_size()}, mesh "
                  f"{dict(zip(mesh.mesh_dim_names, mesh.shape))} on "
                  f"{torch.cuda.get_device_name(0)}", flush=True)
            cfg = prepare_workdir(root, None)
            cfg.training.epochs_per_dispatch = 25  # config/production.yaml
            cfg.generation.batch_scenarios = True
            records = {"train": _multi_train(cfg, "diffusion", MULTI_STEPS, mesh, dev, root),
                       "cvae": _multi_train(cfg, "cvae", MULTI_CVAE_STEPS, mesh, dev, root),
                       "sampler": _multi_sampler(cfg, mesh, dev, totals),
                       "generate": _multi_generate(cfg, mesh, dev, root, totals)}
        finally:
            dist.destroy_process_group()
    out_path.write_text(json.dumps({**totals, "records": records}))


def run_multi_phase(root: Path) -> dict:
    """[multi]: the child process on the card, then the 4-rank dry run on
    the CPU. Returns the card part's launches by kernel (its sharded
    sampler and generator runs only)."""
    from osteosarcoma_diffusionmodel_torch.parallel.dryrun import dryrun_multichip

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    out = root / "multi.json"
    proc = subprocess.run([sys.executable, str(REPO / "chip_smoke.py"), "--multi-child",
                           str(out)], cwd=str(REPO), timeout=MULTI_TIMEOUT_S)
    if proc.returncode != 0:
        raise AssertionError(f"[multi] the card's child process failed (rc {proc.returncode})")
    res = json.loads(out.read_text())
    child_s = time.perf_counter() - t0
    dry_out, dry_s = dryrun_multichip(MULTI_DRYRUN_DEVICES, timeout_s=300, device="cpu")
    print(f"[multi] dryrun_multichip({MULTI_DRYRUN_DEVICES}) on the CPU: rc 0 in {dry_s:.1f} s: "
          f"{dry_out.strip()}", flush=True)
    missing = [f"{k.name}:{mode}" for k, modes in MULTI_REQUIRED.items() for mode in modes
               if res["modes"].get(k.name, {}).get(mode, 0) == 0]
    print(f"[multi] phase {time.perf_counter() - t0:.1f} s (card child {child_s:.1f} s); sharded "
          f"runs' kernel launches by mode: {json.dumps(res['modes'])}", flush=True)
    if missing or res["modes"].get(GEMM.name, {}).get("unaligned", 0):
        raise AssertionError(f"[multi] the sharded runs did not launch {missing}, or took K1's "
                             "general path")
    return res["launches"]


# The bench phase: the headline's batch, its model at a 20-step schedule
# for the plain loop, and the kernels that the headline must launch.
BENCH_PLAIN_STEPS = 20
BENCH_DDIM_STEPS = 10
BENCH_WIDE_ROWS = 131072  # the suite's widest DDIM-50 batch
BENCH_BUDGET_S = 60
BENCH_REQUIRED = {GEMM: ["bf16"], GEMM_GN: ["default"], GEMM_POSTERIOR: ["philox"]}


def check_bench_against_plain_loop(dev) -> None:
    """The kernel sampler against the plain PyTorch loop (the module in
    f32) at the headline's batch, 32,768 x 5,142: the bench's model (seed-0
    weights, constraints off) with a 20-step schedule, the same x_T,
    conditions and noise, all drawn on the card; DDPM-20 on a noise buffer
    (20 x 32,768 x 5,142 f32, 13.5 GB, freed after use), then DDIM-10; and
    DDIM-10 at the suite's widest batch, 131,072 rows (675 M carry
    elements, a 2.7 GB f32 result: offsets past 2^31 bytes). Tolerance,
    the bf16-carry one of the 333-row check: atol 0.15 / rtol 0.05, and
    finite."""
    cfg = bench_module.bench_config(BENCH_PLAIN_STEPS)
    cfg.model.compute_dtype = "float32"
    model = bench_module.bench_model(cfg, DATA_DIMS, dev)
    g = torch.Generator(device=dev).manual_seed(23)
    cases = ((BENCH_ROWS, f"DDPM-{BENCH_PLAIN_STEPS} buffer", None),
             (BENCH_ROWS, f"DDIM-{BENCH_DDIM_STEPS}", BENCH_DDIM_STEPS),
             (BENCH_WIDE_ROWS, f"DDIM-{BENCH_DDIM_STEPS}", BENCH_DDIM_STEPS))
    for rows, label, ddim in cases:
        t0 = time.perf_counter()
        cond = torch.randn(rows, len(bench_module.CONDITION_NAMES), generator=g, device=dev)
        x_init = torch.randn(rows, D, generator=g, device=dev)
        noise = None if ddim else torch.randn(BENCH_PLAIN_STEPS, rows, D, generator=g,
                                              device=dev)
        got = FusedSampler(model, dev, ddim_steps=ddim).sample(cond, g, x_init=x_init,
                                                               noise=noise)
        if ddim:
            ref = model.sample_ddim(cond, g, ddim, x_init=x_init)
        else:
            ref = model.sample(cond, g, x_init=x_init, noise=noise)
        del noise, x_init
        torch.cuda.empty_cache()
        err = (got - ref).abs()
        ok = bool((err <= 0.15 + 0.05 * ref.abs()).all()) and bool(torch.isfinite(got).all())
        print(f"[bench] {label} {rows}x{D}: kernel sampler vs plain loop max|diff| "
              f"{float(err.max()):.4f} (mean {float(err.mean()):.2e}), within atol 0.15 / rtol "
              f"0.05: {ok}; std {float(ref.std()):.3f}; {time.perf_counter() - t0:.1f} s",
              flush=True)
        if not ok:
            raise AssertionError(f"{label} at {rows} rows: kernel sampler disagrees with the "
                                 "plain loop")
        del got, ref, err
        torch.cuda.empty_cache()


def run_bench_phase(dev) -> dict:
    """[bench] (after every other phase): the kernel sampler against the
    plain loop at 32,768 and 131,072 rows, then the headline of
    ``osteosarcoma_diffusionmodel_torch.bench`` once (DDPM-1000 at 32,768
    rows, one warm-up and the best of three calls, its draws on the card),
    its JSON line printed beside the card's, with its launch counts set to
    0 just before and read just after: K1, K1+GN and K1+posterior
    ("philox") must have launched, nothing the main paths forbid. Returns
    the headline's launches by kernel."""
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    check_bench_against_plain_loop(dev)
    for k in KERNELS:
        k.reset()
    line, stats = bench_module.headline(dev)
    counts = {k.name: dict(k.modes) for k in KERNELS}
    ran = {name: {m: n for m, n in modes.items() if n} for name, modes in counts.items()
           if any(modes.values())}
    print(f"[bench] {card_line()}", flush=True)
    print(f"[bench] {json.dumps(line)}", flush=True)
    print(f"[bench] headline calls at {stats['rows']} rows: best {stats['best']:.4f} s, median "
          f"{stats['median']:.4f} s, spread {stats['spread']:.4f} s; "
          f"{1e3 * stats['best'] / bench_module.NUM_STEPS:.4f} ms a step; launches by mode "
          f"{json.dumps(ran)}", flush=True)
    missing = [f"{k.name}:{mode}" for k, modes in BENCH_REQUIRED.items() for mode in modes
               if counts[k.name][mode] == 0]
    if missing or line["value"] is None:
        raise AssertionError(f"[bench] the headline did not launch {missing}: {line}")
    check_forbidden("bench")
    seconds = time.perf_counter() - t0
    print(f"[bench] phase {seconds:.1f} s (budget {BENCH_BUDGET_S} s)", flush=True)
    if seconds > BENCH_BUDGET_S:
        print(f"[bench] WARNING the phase took {seconds:.1f} s, over its {BENCH_BUDGET_S} s",
              flush=True)
    return {k.name: k.launches for k in KERNELS}


def kernel_report(cases: dict, launches: dict, multi: dict, bench: dict,
                  transformer: dict) -> list:
    """One entry per kernel; times and bounds summed over its ``cases``,
    ``bound_by`` that of its largest bound, ``library_ms`` null where no
    single PyTorch call computes the function; ``multi`` and ``bench``: the
    [multi] and [bench] phases' launches, counted in ``launches`` too;
    ``transformer``: the [dit] and [kimi] phases' launches by phase, each
    counted in ``launches`` too."""
    out = []
    for k in KERNELS:
        rows = cases[k.name]
        libs = [r["library_ms"] for r in rows]
        out.append({
            "name": k.name, "route": k.route, "source": k.source, "replaces": k.replaces,
            "launches": launches[k.name], "multi": multi.get(k.name, 0),
            "bench": bench.get(k.name, 0),
            **{phase: counts.get(k.name, 0) for phase, counts in transformer.items()},
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": sum(r["ms"] for r in rows),
            "plain_ms": sum(r["plain_ms"] for r in rows),
            "bound_ms": sum(r["bound_ms"] for r in rows),
            "bound_by": max(rows, key=lambda r: r["bound_ms"])["bound_by"],
            "library_ms": None if None in libs else sum(libs),
            "cases": len(rows),
        })
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--weights", default=None,
                        help="checkpoint dir written by scripts/export_jax_checkpoint.py")
    parser.add_argument("--multi-child", default=None, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device; none is available")
    if args.multi_child:
        run_multi_child(Path(args.multi_child))
        return 0
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    logging.basicConfig(level=logging.WARNING)

    print(card_line(), flush=True)  # name, power limit: as nvidia-smi prints them
    t0 = time.perf_counter()
    _build.LIBRARY.get()
    print(f"[build] {_build.LIB_NAME} from csrc/ in {time.perf_counter() - t0:.1f} s", flush=True)

    cases = check_kernels(dev)
    k8_launches = POSTERIOR_UPDATE.launches  # no path calls K8: its check's launches
    t0 = time.perf_counter()
    cases.update(check_moe_grouped(dev))
    transformer = {"dit": run_dit_phase(dev)}
    print(f"[dit] phase {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    cases.update(check_kda_kernel(dev))
    transformer["kimi"] = run_kimi_phase(dev)
    print(f"[kimi] phase {time.perf_counter() - t0:.1f} s", flush=True)

    with tempfile.TemporaryDirectory(prefix="osdm_chip_smoke_") as tmp:
        cfg = prepare_workdir(Path(tmp), args.weights)
        check_calibration(cfg, dev)
        check_copy_back(dev)
        trained, trained_ckpt = run_train_phase(cfg, dev, Path(tmp))
        variants = run_variants_phase(cfg, dev, Path(tmp))
        archs = run_arch_phase(cfg, dev, Path(tmp))
        pipeline, pipeline_cfg, pipeline_results = run_pipeline_phase(cfg, dev, Path(tmp))
        reported = run_report_phase(pipeline_cfg, pipeline_results, dev, Path(tmp))
        ckpts = {False: cfg.training.save_dir,
                 True: d3pm_checkpoint(cfg.training.save_dir, Path(tmp) / "checkpoint_d3pm")}
        launches = run_main_paths(cfg, dev, ckpts)
        multi = run_multi_phase(Path(tmp))
        for counts in (trained, variants, archs, pipeline, reported,
                       run_serve_phase(trained_ckpt, Path(tmp)),
                       run_latent_path(cfg, dev, Path(tmp)), multi):
            for name, n in counts.items():
                launches[name] += n
        check_d3pm_calibration(cfg, ckpts[True], dev)
        check_against_plain_loop(cfg, dev)
        check_small_batches_against_plain(cfg, dev)
        check_latent_against_plain(cfg, dev)
        bench = run_bench_phase(dev)
        for name, n in bench.items():
            launches[name] += n
        launches[POSTERIOR_UPDATE.name] = k8_launches
        for counts in transformer.values():  # each phase's own in the report too
            for name, n in counts.items():
                launches[name] = launches.get(name, 0) + n
        print(f"[main] kernel launches over the main paths: {json.dumps(launches)}", flush=True)
        report = kernel_report(cases, launches, multi, bench, transformer)

    print(json.dumps({"kernels": report}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
