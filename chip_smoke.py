"""Smoke test of the PyTorch/H100 port on one NVIDIA card.

    python3 chip_smoke.py [--weights DIR]

Phases (each prints one line; any failure raises and exits non-zero):

1. the card, as nvidia-smi reports its name and power limit;
2. the build of the hand-written CUDA kernels from ``csrc/`` (one nvcc
   per source, in parallel);
3. each kernel (K1-K6, every mode the main paths use) against its plain
   PyTorch version on the card, at the shapes the main paths give it,
   with the stated tolerance and both times;
4. the main paths at full model width (data dims 62/5054/26, hidden
   256/512/256, T = 1000, cosine schedule): the port's CLI step
   functions generate -> calibrate (copula_joint) -> validate on a
   temporary directory holding a seeded structured cohort of 100
   patients, 3 scenarios x 333 patients each:
   - "continuous": DDPM-1000, then DDIM-50;
   - "d3pm": the same with the D3PM mutation head (mutation CSVs exactly
     binary; per-gene frequencies printed; calibration keeps the bits);
   - "int8": fused_quantize "out" with DDPM-1000, "io" and "all" with
     DDIM-50, and "all" with the D3PM head at DDIM-50.
   Every launch count is set to 0 just before a path and read just
   after it; each (kernel, mode) the path runs must have launched;
5. the kernel sampler against the plain PyTorch loop at 333 rows:
   continuous DDPM-20 and DDIM-10, D3PM DDPM-20, and each int8 mode.

The last two lines are the kernel report and
``{"ok": true, "device": {...}}``. There is no CPU branch: without a
CUDA device the script raises.
"""

from __future__ import annotations

import argparse
import json
import logging
import math
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from osteosarcoma_diffusionmodel_torch.cli import (
    generate_synthetic_patients,
    validate_synthetic_patients,
)
from osteosarcoma_diffusionmodel_torch.config import Config
from osteosarcoma_diffusionmodel_torch.data.dummy import (
    cohort_arrays,
    make_dummy_cohort,
    write_processed,
)
from osteosarcoma_diffusionmodel_torch.models.diffusion import ConditionalDiffusion
from osteosarcoma_diffusionmodel_torch.models.networks import init_weights
from osteosarcoma_diffusionmodel_torch.ops import _build
from osteosarcoma_diffusionmodel_torch.ops.fused_sampler import FusedSampler, coefficient_table
from osteosarcoma_diffusionmodel_torch.ops.schedules import DiffusionSchedule
from osteosarcoma_diffusionmodel_torch.ops.pallas_kernels import (
    RBF,
    rbf_kernel_sum,
    rbf_kernel_sum_plain,
)
from osteosarcoma_diffusionmodel_torch.ops.sampler_kernels import (
    GEMM,
    GEMM_S8,
    GROUPNORM,
    POSTERIOR,
    ROWQUANT,
    gemm_bf16_f32acc,
    gemm_bf16_f32acc_plain,
    gemm_s8,
    gemm_s8_plain,
    groupnorm8_silu,
    groupnorm8_silu_plain,
    pack_int8,
    philox_uniform_noise,
    rowquant_s8,
    rowquant_s8_plain,
    x0_posterior_step,
    x0_posterior_step_plain,
)
from osteosarcoma_diffusionmodel_torch.training.checkpoint import (
    METADATA_FILE,
    data_stats_from_arrays,
    load_data_stats,
    load_metadata,
    load_weights,
    metadata_to_dims,
    save_data_stats,
    save_metadata,
    save_weights,
)
from osteosarcoma_diffusionmodel_torch.utils.io import read_matrix_csv

KERNELS = (GEMM, GROUPNORM, POSTERIOR, RBF, ROWQUANT, GEMM_S8)
BATCH = 333  # rows per scenario: 1000 // 3
DATA_DIMS = (62, 5054, 26)
D = sum(DATA_DIMS)
MUT = DATA_DIMS[0]
BF16_ULP = 2.0 ** -7  # one bf16 unit in the last place at 1.0
MAX_BIT_MISMATCH = 1e-4  # K3's D3PM bits against the plain version


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


def _report(kernel, case: str, err: float, tol: float, ms: float, plain_ms: float) -> dict:
    ok = bool(err <= tol)
    print(f"[kernel] {kernel.name} {case}: max|diff| {err:.3e} (tol {tol:.3e}) "
          f"{'ok' if ok else 'FAIL'}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms", flush=True)
    if not ok:
        raise AssertionError(f"{kernel.name} {case}: max|diff| {err} > tol {tol}")
    return {"case": case, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def _with_bits(a: torch.Tensor, g) -> torch.Tensor:
    """``a`` with 0/1 bits in its first MUT columns (the D3PM carry)."""
    a[:, :MUT] = (torch.rand(a.shape[0], MUT, generator=g) < 0.5).to(a.device, a.dtype)
    return a


def check_gemm(dev, g) -> list:
    """K1 at the sampler's product shapes, as the main path calls it: the
    input product with the step's t_add row as bias and c_proj as the row
    add, written in bf16 (also with the D3PM prologue on the first 62
    columns); the block products with a bias, one of them on a row-strided
    view, into f32; the output product into f32.
    Tolerance: both sides sum bf16-exact products in f32, in different
    orders, so an f32 result differs by f32 rounding of the sum, 1e-3
    relative to max(1, |ref|); a bf16 result is the plain f32 result
    rounded once to bf16, and a sum that lands near a rounding boundary
    may round the other way: 2^-7 of max(1, |ref|)."""
    out = []
    cases = [
        ("333x5142.5142x256 +t_add +c_proj ->bf16", 5142, 256, True, True, False,
         torch.bfloat16, 0),
        ("333x5142(2b-1 on 62).5142x256 +t_add +c_proj ->bf16", 5142, 256, True, True, False,
         torch.bfloat16, MUT),
        ("333x1024.1024x256 +bias", 1024, 256, True, False, False, torch.float32, 0),
        ("333x512(view of 1024).512x256 +bias", 512, 256, True, False, True, torch.float32, 0),
        ("333x256.256x5142", 256, 5142, False, False, False, torch.float32, 0),
    ]
    for case, k, n, has_bias, has_row_add, strided, out_dtype, mut in cases:
        if strided:
            base = torch.randn(BATCH, 2 * k, generator=g).to(dev, torch.bfloat16)
            a = base[:, k:]
        else:
            a = torch.randn(BATCH, k, generator=g).to(dev, torch.bfloat16)
        if mut:
            a = _with_bits(a, g)
        w = (torch.randn(k, n, generator=g) / math.sqrt(k)).to(dev, torch.bfloat16)
        bias = torch.randn(n, generator=g).to(dev) if has_bias else None
        row_add = (torch.randn(BATCH, n, generator=g).to(dev, torch.bfloat16).float()
                   if has_row_add else None)
        buf = torch.empty(BATCH, n, dtype=out_dtype, device=dev)
        got = gemm_bf16_f32acc(a, w, out=buf, bias=bias, row_add=row_add, a_mut_cols=mut).float()
        ref = gemm_bf16_f32acc_plain(a, w, bias, row_add, mut).to(out_dtype).float()
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        rel = BF16_ULP if out_dtype == torch.bfloat16 else 1e-3
        tol = rel * max(1.0, float(ref.abs().max()))
        ms = time_ms(lambda: gemm_bf16_f32acc(a, w, out=buf, bias=bias, row_add=row_add,
                                              a_mut_cols=mut))
        plain_ms = time_ms(lambda: gemm_bf16_f32acc_plain(a, w, bias, row_add, mut).to(out_dtype))
        out.append(_report(GEMM, case, err, tol, ms, plain_ms))
    return out


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
        out.append(_report(GROUPNORM, f"333x{f}", err, tol, ms, plain_ms))
    return out


def check_posterior(dev, g) -> list:
    """K3 at 333 x 5142 in its three noise modes, without and with the
    D3PM head (62 bit columns, table columns 4-5 from the discrete
    DDPM table). Tolerance: both sides compute in f32 with the same
    operations in the same order and round once to bf16; 2^-7 of
    max(1, |ref|) on the continuous columns. Bits: the kernel writes the
    plain version's posterior with _rn intrinsics, so a threshold
    u < p_prev sees the same p_prev unless expf differs by an ulp; at
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
            out.append(_report(POSTERIOR, case, err, tol, ms, plain_ms))

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
    """K5 at the shapes the int8 products give it: the 333 x 5142 carry
    with bits on 62 columns quantized as 2b - 1 (the input product), and
    the decoders' [h | skip] halves, 333 x 256 and 333 x 512 row-strided
    views. Tolerance 0: the same f32 operations and round-half-even, so
    the codes and scales equal the plain version's (the error reported is
    the largest code difference plus the largest scale difference)."""
    out = []
    base = (3.0 * torch.randn(BATCH, 1024, generator=g)).to(dev, torch.bfloat16)
    carry = _with_bits(torch.randn(BATCH, D, generator=g).to(dev, torch.bfloat16), g)
    for case, a, mut in (("333x5142 (2b-1 on 62)", carry, MUT),
                         ("333x256 (view of 512)", base[:, 256:512], 0),
                         ("333x512 (view of 1024)", base[:, 512:], 0)):
        q, scale = rowquant_s8(a, mut_cols=mut)
        rq, rs = rowquant_s8_plain(a, mut)
        torch.cuda.synchronize()
        err = float((q.int() - rq.int()).abs().max()) + float((scale - rs).abs().max())
        ms = time_ms(lambda: rowquant_s8(a, out=q, scale=scale, mut_cols=mut))
        plain_ms = time_ms(lambda: rowquant_s8_plain(a, mut))
        out.append(_report(ROWQUANT, case, err, 0.0, ms, plain_ms))
    return out


def check_gemm_s8(dev, g) -> list:
    """K6 on the three kinds of int8 product: the input product
    (333x5152.5152x256 from the quantized carry, + t_add + c_proj, bf16
    out), a decoder fc1's second half (333x512.512x256, accumulated onto
    the first half's f32 result, + bias) and the output product
    (333x256.256x5142, f32). The int32 sums are exact and the epilogue is
    the plain version's f32 operations in its order, so the results agree
    to f32 rounding: 2^-22 of max(1, |ref|) in f32 (two f32 ulps), one
    bf16 rounding (2^-7) for the bf16 output."""
    out = []
    carry = _with_bits(torch.randn(BATCH, D, generator=g).to(dev, torch.bfloat16), g)
    cases = [
        ("333x5152.5152x256 +t_add +c_proj ->bf16", carry, MUT, 256, torch.bfloat16, False),
        ("333x512.512x256 accumulate +bias", None, 0, 256, torch.float32, True),
        ("333x256.256x5142", None, 0, 5142, torch.float32, False),
    ]
    for case, a, mut, n, out_dtype, acc in cases:
        if a is None:
            k = 512 if acc else 256
            a = (3.0 * torch.randn(BATCH, k, generator=g)).to(dev, torch.bfloat16)
        qa, rs = rowquant_s8_plain(a, mut)
        w = torch.randn(a.shape[1], n, generator=g) / math.sqrt(a.shape[1])
        qb, cs = (t.to(dev) for t in pack_int8(w.numpy()))
        bias = torch.randn(n, generator=g).to(dev) if n == 256 else None
        row_add = torch.randn(BATCH, n, generator=g).to(dev) if out_dtype == torch.bfloat16 else None
        start = torch.randn(BATCH, n, generator=g).to(dev) if acc else None
        buf = start.clone() if acc else torch.empty(BATCH, n, dtype=out_dtype, device=dev)
        got = gemm_s8(qa, rs, qb, cs, out=buf, bias=bias, row_add=row_add, accumulate=acc).float()
        ref = gemm_s8_plain(qa, rs, qb, cs, bias, row_add, start).to(out_dtype).float()
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        rel = BF16_ULP if out_dtype == torch.bfloat16 else 2.0 ** -22
        tol = rel * max(1.0, float(ref.abs().max()))
        ms = time_ms(lambda: gemm_s8(qa, rs, qb, cs, out=buf, bias=bias, row_add=row_add,
                                     accumulate=acc))
        plain_ms = time_ms(lambda: gemm_s8_plain(qa, rs, qb, cs, bias, row_add, start).to(out_dtype))
        out.append(_report(GEMM_S8, case, err, tol, ms, plain_ms))
    return out


def check_rbf(dev, g) -> list:
    """K4 at the validate step's shapes (real n = 100, synthetic m = 999,
    d = 5142) against the float64 plain version. Tolerance: f32 cross
    products in the kernel against f64: 1e-5 relative to the sum."""
    x = torch.randn(100, D, generator=g).to(dev)
    y = (torch.randn(999, D, generator=g) * 1.05 + 0.02).to(dev)
    gamma = 1.0 / D
    out = []
    for case, a, b in (("xx 100x100", x, x), ("yy 999x999", y, y), ("xy 100x999", x, y)):
        got = float(rbf_kernel_sum(a, b, gamma))
        ref = float(rbf_kernel_sum_plain(a, b, gamma))
        again = float(rbf_kernel_sum(a, b, gamma))
        if got != again:
            raise AssertionError(f"rbf_kernel_sum not deterministic: {got} vs {again}")
        err = abs(got - ref)
        tol = 1e-5 * abs(ref)
        ms = time_ms(lambda: rbf_kernel_sum(a, b, gamma))
        plain_ms = time_ms(lambda: rbf_kernel_sum_plain(a, b, gamma))
        out.append(_report(RBF, f"{case}x{D}", err, tol, ms, plain_ms))
    return out


def check_kernels(dev) -> dict:
    g = torch.Generator().manual_seed(0)
    return {
        GEMM.name: check_gemm(dev, g),
        GROUPNORM.name: check_groupnorm(dev, g),
        POSTERIOR.name: check_posterior(dev, g),
        RBF.name: check_rbf(dev, g),
        ROWQUANT.name: check_rowquant(dev, g),
        GEMM_S8.name: check_gemm_s8(dev, g),
    }


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def prepare_workdir(root: Path, weights: str | None) -> Config:
    """Processed tables of the seeded structured cohort (100 patients,
    62/5054/26) and a checkpoint directory: seeded weights at full width,
    or the exported checkpoint in ``weights``."""
    cfg = Config()
    cohort = make_dummy_cohort(100, *DATA_DIMS, seed=0)
    write_processed(cohort, root / "processed")
    data, conditions, dims = cohort_arrays(cohort, cfg)
    cfg.data.processed_dir = str(root / "processed")
    cfg.output.results_dir = str(root / "results")
    cfg.output.synthetic_data_dir = str(root / "synthetic")
    if weights is not None:
        meta = load_metadata(weights)
        if meta is None or metadata_to_dims(meta).data_dim != D:
            raise ValueError(f"{weights} holds no checkpoint with data dim {D}")
        cfg.training.save_dir = str(weights)
        return cfg
    ckpt = root / "checkpoint"
    model = ConditionalDiffusion.from_config(cfg, dims)
    init_weights(model.denoiser, torch.Generator().manual_seed(0))
    save_weights(ckpt, model.denoiser.state_dict())
    save_metadata(ckpt, cfg, dims)
    save_data_stats(ckpt, data_stats_from_arrays(data, conditions, dims.mutation_dim))
    cfg.training.save_dir = str(ckpt)
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


def check_outputs(cfg: Config, results: dict, label: str) -> np.ndarray:
    """Every synthetic table has the expected shape and finite values;
    every metric is finite; mutations are exactly 0 or 1. Returns the
    mutation block of the whole cohort."""
    per = cfg.generation.num_synthetic_samples // len(cfg.generation.scenarios)
    widths = dict(zip(("mutations", "expression", "pathways"), DATA_DIMS))
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
_COMMON = {GROUPNORM: ["default"], RBF: ["default"]}
REQUIRED = {
    "continuous": {**_COMMON, GEMM: ["bf16"], POSTERIOR: ["philox", "none"]},
    "d3pm": {**_COMMON, GEMM: ["bf16", "mut_prologue"], POSTERIOR: ["d3pm_philox", "d3pm_none"]},
    "int8": {**_COMMON, GEMM: ["bf16"], POSTERIOR: ["philox", "none", "d3pm_none"],
             ROWQUANT: ["plain", "mut_transform"],
             GEMM_S8: ["f32_out", "bf16_out", "accumulate"]},
}


def run_main_paths(cfg: Config, dev, ckpts: dict) -> dict:
    """generate -> calibrate -> validate through the port's CLI step
    functions for every run of every main path. The launch counts are
    set to 0 just before each path and read just after it. Returns each
    kernel's launches summed over the paths."""
    totals = {k.name: 0 for k in KERNELS}
    n = cfg.generation.num_synthetic_samples // len(cfg.generation.scenarios) * len(
        cfg.generation.scenarios)
    root = Path(cfg.output.results_dir).parent
    for path, runs in MAIN_PATHS.items():
        for k in KERNELS:
            k.reset()
        for head, quant, sampler in runs:
            cfg.training.save_dir = ckpts[head]
            cfg.generation.fused_quantize = quant
            cfg.generation.sampler = sampler
            label = " ".join(
                ["DDPM-1000" if sampler == "ddpm" else f"DDIM-{cfg.generation.sampling_steps}"]
                + (["d3pm"] if head else []) + ([f"int8-{quant}"] if quant != "none" else []))
            cfg.output.synthetic_data_dir = str(root / f"synthetic_{label.replace(' ', '_')}")
            _, gen_s = run_step(generate_synthetic_patients, cfg, dev)
            results, val_s = run_step(validate_synthetic_patients, cfg, dev)
            mutations = check_outputs(cfg, results, label)
            print(f"[main] {path} {label}: generate+calibrate {gen_s:.2f} s for {n} patients "
                  f"({n / gen_s:.1f} patients/sec end to end), validate {val_s:.2f} s", flush=True)
            print(f"[main] {path} {label} metrics: " + json.dumps(
                {k: round(v, 6) for k, v in results.items()}), flush=True)
            if head:
                print(f"[main] {path} {label} mutation CSVs exactly binary; per-gene "
                      f"frequencies: {json.dumps(np.round(mutations.mean(0), 3).tolist())}",
                      flush=True)
        counts = {k.name: dict(k.modes) for k in KERNELS}
        print(f"[main] {path} kernel launches by mode: {json.dumps(counts)}", flush=True)
        missing = [f"{k.name}:{mode}" for k, modes in REQUIRED[path].items()
                   for mode in modes if counts[k.name][mode] == 0]
        if missing:
            raise AssertionError(f"{path}: kernels never launched on the main path: {missing}")
        for k in KERNELS:
            totals[k.name] += k.launches
    cfg.training.save_dir, cfg.generation.fused_quantize = ckpts[False], "none"
    return totals


def check_d3pm_calibration(cfg: Config, ckpt: str, dev) -> None:
    """With the head on, calibration (copula_joint) returns the sampler's
    bits unchanged: one scenario of 333 patients at DDIM-50."""
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
    raw = gen.sample_raw(cond, g)
    out = gen._postprocess(raw, cond)
    kept = bool(np.array_equal(out["mutations"], raw[:, :MUT]))
    binary = bool(np.isin(raw[:, :MUT], (0.0, 1.0)).all())
    print(f"[main] d3pm calibration ({gcfg.generation.calibrate_marginals}): sampler bits binary "
          f"{binary}, kept unchanged {kept}", flush=True)
    if not (kept and binary):
        raise AssertionError("calibration changed the D3PM head's bits")


def _reference_model(cfg: Config, dev, discrete: bool = False) -> ConditionalDiffusion:
    """The checkpoint's weights in a 20-step f32-compute model on ``dev``."""
    meta = load_metadata(cfg.training.save_dir)
    small = Config.from_dict(meta["config"])
    small.model.diffusion.num_steps = 20
    small.model.diffusion.discrete_mutation_head = discrete
    small.model.compute_dtype = "float32"
    model = ConditionalDiffusion.from_config(small, metadata_to_dims(meta))
    model.denoiser.load_state_dict(load_weights(cfg.training.save_dir))
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


def kernel_report(cases: dict, launches: dict) -> list:
    out = []
    for k in KERNELS:
        rows = cases[k.name]
        out.append({
            "name": k.name, "route": k.route, "source": k.source, "replaces": k.replaces,
            "launches": launches[k.name],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": sum(r["ms"] for r in rows),
            "plain_ms": sum(r["plain_ms"] for r in rows),
        })
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--weights", default=None,
                        help="checkpoint dir written by scripts/export_jax_checkpoint.py")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device; none is available")
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    logging.basicConfig(level=logging.WARNING)

    print(card_line(), flush=True)  # name, power limit: as nvidia-smi prints them
    t0 = time.perf_counter()
    _build.LIBRARY.get()
    print(f"[build] {_build.LIB_NAME} from csrc/ in {time.perf_counter() - t0:.1f} s", flush=True)

    cases = check_kernels(dev)

    with tempfile.TemporaryDirectory(prefix="osdm_chip_smoke_") as tmp:
        cfg = prepare_workdir(Path(tmp), args.weights)
        ckpts = {False: cfg.training.save_dir,
                 True: d3pm_checkpoint(cfg.training.save_dir, Path(tmp) / "checkpoint_d3pm")}
        launches = run_main_paths(cfg, dev, ckpts)
        print(f"[main] kernel launches over the main paths: {json.dumps(launches)}", flush=True)
        report = kernel_report(cases, launches)
        check_d3pm_calibration(cfg, ckpts[True], dev)
        check_against_plain_loop(cfg, dev)

    print(json.dumps({"kernels": report}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
