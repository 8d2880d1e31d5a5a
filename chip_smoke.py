"""Smoke test of the PyTorch/H100 port on one NVIDIA card.

    python3 chip_smoke.py [--weights DIR]

Phases (each prints one line; any failure raises and exits non-zero):

1. the card, as nvidia-smi reports its name and power limit;
2. the build of the hand-written CUDA kernels from ``csrc/`` (one nvcc
   per source, in parallel);
3. each kernel (K1-K8, every mode the paths use) against its plain
   PyTorch version on the card, at the shapes the paths give it, with the
   stated tolerance (K1 at every distinct product of the bf16 step, as
   recorded from one sampler step, with its launches per step and its
   summed time per step; K1 and K6 run each case twice and require equal
   bits, split-K included), both times, the least time the card could take for
   the same work (``bound_ms``: bytes over 3.35 TB/s or operations over
   the H100's published peak for their type, whichever is larger) and,
   where one PyTorch call computes the same function, that call's time
   (``library_ms``; the port never calls it);
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
   after it; each (kernel, mode) the path runs must have launched, and
   K1's general ("unaligned") path must not have;
   - "latent": the latent-tail hybrid sampler. ``scripts/bench_latent_torch.py``
     as a subprocess at 999 rows, DDPM-1000, once with the probe's head
     and once with head 100 (its launches counted in that process: K7
     once per latent step in each mode; only the kernel latent sampler's
     launches join the path's); then in process at full width,
     ``LatentFusedSampler`` with head 100 (899 latent steps), its counts
     read right after the latent calls, and, where the probe says the clip
     does not bind in the tail, its per-feature moments against the
     data-space kernel sampler's;
5. the kernel sampler against the plain PyTorch loop at 333 rows:
   continuous DDPM-20 and DDIM-10, D3PM DDPM-20, each int8 mode, and the
   latent kernel sampler against the plain ``LatentTailSampler`` (head 3,
   the same x_T, noise, zeta and eta).

K8 (``posterior_update``) has no caller in either package: its launches
are those of its own check in phase 3.

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
from osteosarcoma_diffusionmodel_torch.ops import _build, fused_sampler
from osteosarcoma_diffusionmodel_torch.ops.fused_sampler import FusedSampler, coefficient_table
from osteosarcoma_diffusionmodel_torch.ops.latent_sampler import (
    LatentFusedSampler,
    LatentTailSampler,
    calibrate_head_steps,
)
from osteosarcoma_diffusionmodel_torch.ops.schedules import DiffusionSchedule
from osteosarcoma_diffusionmodel_torch.ops.pallas_kernels import (
    POSTERIOR_UPDATE,
    RBF,
    gaussian_noise,
    posterior_update,
    posterior_update_plain,
    posterior_update_traced,
    rbf_kernel_sum,
    rbf_kernel_sum_plain,
)
from osteosarcoma_diffusionmodel_torch.ops.sampler_kernels import (
    GEMM,
    GEMM_S8,
    GROUPNORM,
    LATENT,
    POSTERIOR,
    ROWQUANT,
    gemm_bf16_f32acc,
    gemm_bf16_f32acc_plain,
    gemm_plan,
    gemm_s8,
    gemm_s8_plain,
    groupnorm8_silu,
    groupnorm8_silu_plain,
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

KERNELS = (GEMM, GROUPNORM, POSTERIOR, RBF, ROWQUANT, GEMM_S8, LATENT, POSTERIOR_UPDATE)
REPO = Path(__file__).resolve().parent
BATCH = 333  # rows per scenario: 1000 // 3
LATENT_ROWS = 999  # the latent path's rows: three scenarios of 333, batched
LATENT_HEAD = 100  # a fixed head that leaves 899 latent steps at T = 1000
DATA_DIMS = (62, 5054, 26)
D = sum(DATA_DIMS)
MUT = DATA_DIMS[0]
BF16_ULP = 2.0 ** -7  # one bf16 unit in the last place at 1.0
MAX_BIT_MISMATCH = 1e-4  # K3's D3PM bits against the plain version
F32_ULP2 = 2.0 ** -22  # two f32 units in the last place at 1.0

# Published peaks of one H100 SXM (dense, at the 700 W limit), the bound_ms
# yardstick: HBM bytes/s; operations/s by type (bf16 and int8 on the tensor
# cores, f32 on the CUDA cores).
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}


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


def step_products(dev) -> list:
    """K1's launches in one bf16 reverse step of the main path, as the
    sampler makes them: a seeded model at full width (data 62/5054/26,
    hidden 256/512/256), one step of ``FusedSampler.sample`` at 333 rows
    with the sampler's K1 calls recorded (outside every count; the call
    goes through). Returns per call (m, k, n, A's row stride, B's row
    stride, bias, row_add, out dtype, out row stride, a_mut_cols)."""
    cfg = Config()
    dims = cfg.freeze_dims(*DATA_DIMS, list(cfg.model.condition_on))
    model = ConditionalDiffusion.from_config(cfg, dims)
    init_weights(model.denoiser, torch.Generator().manual_seed(0))
    model.denoiser.to(dev)
    sampler = FusedSampler(model, dev)
    calls = []

    def record(a, b, out=None, bias=None, row_add=None, a_mut_cols=0):
        calls.append((a.shape[0], a.shape[1], b.shape[1], a.stride(0), b.stride(0),
                      bias is not None, row_add is not None, out.dtype, out.stride(0), a_mut_cols))
        return gemm_bf16_f32acc(a, b, out=out, bias=bias, row_add=row_add, a_mut_cols=a_mut_cols)

    cond = torch.zeros(BATCH, dims.condition_dim, device=dev)
    fused_sampler.gemm_bf16_f32acc = record
    try:
        sampler.sample(cond, torch.Generator(dev).manual_seed(0), stop_after=1)
    finally:
        fused_sampler.gemm_bf16_f32acc = gemm_bf16_f32acc
    torch.cuda.synchronize()
    return calls


def _strided(rows: int, cols: int, ld: int, dtype, dev, fill) -> torch.Tensor:
    """A (rows, cols) view with row stride ``ld``, values from ``fill``."""
    buf = torch.zeros(rows, ld, dtype=dtype, device=dev)
    view = buf[:, ld - cols:] if ld >= 2 * cols else buf[:, :cols]
    view.copy_(fill(rows, cols))
    return view


def check_gemm(dev, g) -> list:
    """K1 at every distinct product of the main path's bf16 step, with the
    layout the sampler gives it (padded carry, W_out and acc; [h | skip]
    halves as row-strided views; the input product with the step's t_add
    row as bias, c_proj as the row add, bf16 out), plus the input product
    with the D3PM prologue on the first 62 columns and the latent step's
    two 256-wide products at 999 rows. Each case runs twice and the two
    outputs must be equal bit for bit (split-K sums in a fixed order).
    Prints K1's launches per step of each product and its summed time per
    step. No case may take the general ("unaligned") path.
    Tolerance: both sides sum bf16-exact products in f32, in different
    orders, so an f32 result differs by f32 rounding of the sum, 1e-3
    relative to max(1, |ref|); a bf16 result is the plain f32 result
    rounded once to bf16, and a sum that lands near a rounding boundary
    may round the other way: 2^-7 of max(1, |ref|)."""
    calls = step_products(dev)
    per_step = {}
    for c in calls:
        per_step[c] = per_step.get(c, 0) + 1
    cases = [(c, n) for c, n in per_step.items()]
    first = calls[0]
    cases.insert(1, (first[:9] + (MUT,), 0))  # the D3PM step's input product
    # The latent step's products at 999 rows: o_lat = h·M2 + m_b, n_inj = bf16(zeta)·Lᵀ.
    cases += [((LATENT_ROWS, 256, 256, 256, 256, True, False, torch.float32, 256, 0), 0),
              ((LATENT_ROWS, 256, 256, 256, 256, False, False, torch.float32, 256, 0), 0)]
    out, step_ms, step_launches = [], 0.0, 0
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
        step_ms += count * ms
        step_launches += count
    print(f"[kernel] {GEMM.name} per bf16 step at {BATCH} rows: {step_launches} launches, "
          f"{step_ms:.4f} ms summed", flush=True)
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
        limit = roofline(BATCH * f * (4 + 2) + 2 * 4 * f, 10.0 * BATCH * f, "f32")
        out.append(_report(GROUPNORM, f"333x{f}", err, tol, ms, plain_ms, limit))
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
        m, k = a.shape
        limit = roofline(m * k * a.element_size() + q.numel() + 4 * m, 3.0 * m * k, "f32")
        out.append(_report(ROWQUANT, case, err, 0.0, ms, plain_ms, limit))
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
        n, m = a.shape[0], b.shape[0]
        limit = roofline(4 * (n + m) * (D + 1) + 8, 2.0 * n * m * D + 4.0 * n * m, "f32")
        out.append(_report(RBF, f"{case}x{D}", err, tol, ms, plain_ms, limit))
    return out


def check_latent_step(dev, g) -> list:
    """K7 at the latent tail's shapes, 333 x 256 and 999 x 256, in both
    draw modes and the update. Tolerances: the kernel writes the plain
    version's f32 operations with _rn intrinsics, so s, H_acc and xi agree
    to f32 rounding (two ulps of max(1, |ref|), expected 0) and the bf16
    outputs (bf16(zeta), the next stack input) within one bf16 rounding.
    The Philox zeta at 333 x 256 (read back through xi with (w, v) =
    (0, 1) from 0) must equal the plain generator's bit for bit, repeat
    for a repeated seed, stay within +-sqrt3 and have mean ~0 and variance
    ~1 (|mean| < 0.02, |var - 1| < 0.02: six standard errors at 85k
    draws)."""
    h, n_lat = 256, 4
    coeffs = (torch.rand(n_lat, 5, generator=g) + 0.1).to(dev)
    out = []
    for m in (BATCH, LATENT_ROWS):
        hid = torch.randn(m, h, generator=g).to(dev, torch.bfloat16)
        zeta = torch.randn(n_lat, m, h, generator=g).to(dev)
        zbf = torch.empty(m, h, dtype=torch.bfloat16, device=dev)
        for mode in ("philox", "buffer"):
            hacc0 = torch.randn(m, h, generator=g).to(dev)
            xi0 = torch.randn(m, h, generator=g).to(dev)
            hacc, xi = hacc0.clone(), xi0.clone()
            latent_draw(hid, hacc, xi, zbf, coeffs, 2, mode, zeta=zeta, seed=4321)
            rz, rxi, rhacc = latent_draw_plain(hid, hacc0, xi0, coeffs, 2, mode, zeta, 4321)
            torch.cuda.synchronize()
            zerr = float((zbf.float() - rz.float()).abs().max())
            if zerr > BF16_ULP * max(1.0, float(rz.float().abs().max())):
                raise AssertionError(f"K7 draw {mode} {m}x{h}: bf16(zeta) differs by {zerr}")
            err = max(float((xi - rxi).abs().max()), float((hacc - rhacc).abs().max()))
            tol = F32_ULP2 * max(1.0, float(rxi.abs().max()), float(rhacc.abs().max()))
            ms = time_ms(lambda: latent_draw(hid, hacc, xi, zbf, coeffs, 2, mode, zeta=zeta,
                                             seed=4321))
            plain_ms = time_ms(lambda: latent_draw_plain(hid, hacc0, xi0, coeffs, 2, mode, zeta,
                                                         4321))
            moved = m * h * (2 + 8 + 8 + 2 + (4 if mode == "buffer" else 0))
            out.append(_report(LATENT, f"draw {mode} {m}x{h}", err, tol, ms, plain_ms,
                               roofline(moved, 4.0 * m * h, "f32")))

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
        out.append(_report(LATENT, f"update {m}x{h}", err, tol, ms, plain_ms,
                           roofline(m * h * (8 + 4 + 4 + 4 + 2) + 4 * h, 7.0 * m * h, "f32")))

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
    _rn intrinsics; z goes through logf/sqrtf/cosf, which may differ from
    the plain version's by an ulp or two: 2^-19 of max(1, |ref|) (a few f32
    ulps of the largest value). The noise alone (c0 = c1 = 0, sv = 1) must
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
            # five coefficients. Per element: the clip, and with noise
            # Philox, Box-Muller and the affine sum (~15 operations).
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


def check_kernels(dev) -> dict:
    g = torch.Generator().manual_seed(0)
    POSTERIOR_UPDATE.reset()
    return {
        GEMM.name: check_gemm(dev, g),
        GROUPNORM.name: check_groupnorm(dev, g),
        POSTERIOR.name: check_posterior(dev, g),
        RBF.name: check_rbf(dev, g),
        ROWQUANT.name: check_rowquant(dev, g),
        GEMM_S8.name: check_gemm_s8(dev, g),
        LATENT.name: check_latent_step(dev, g),
        POSTERIOR_UPDATE.name: check_posterior_update(dev, g),
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


def check_no_general_path(path: str) -> None:
    """Every K1 launch of a main path went through TMA: the sampler's
    buffers are laid out for it, so the general path never runs there."""
    if GEMM.modes["unaligned"]:
        raise AssertionError(f"{path}: K1 took its general path {GEMM.modes['unaligned']} times")


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
        check_no_general_path(path)
        for k in KERNELS:
            totals[k.name] += k.launches
    cfg.training.save_dir, cfg.generation.fused_quantize = ckpts[False], "none"
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
        if entry["launches"].get(GEMM.name, {}).get("unaligned", 0):
            raise AssertionError(f"bench {name}: K1 took its general path")
    entry = report["timings"][f"latent_kernel_head{report['head_steps']}"]
    want = entry["n_lat"] * entry["calls"]
    k7 = entry["launches"].get(LATENT.name, {})
    if k7.get("draw_philox", 0) != want or k7.get("update", 0) != want:
        raise AssertionError(f"K7 launched {k7}, want {want} per mode (n_lat {entry['n_lat']} "
                             f"x {entry['calls']} calls)")
    return report


def run_latent_path(cfg: Config, dev, tmp: Path) -> dict:
    """The latent-tail path at full width, DDPM-1000: the bench script
    twice (probe head; head 100), then in process on the checkpoint's
    weights, ``LatentFusedSampler`` at 999 rows with head 100 and, where
    the probe says the clip does not bind in the tail and its head is
    longer, with the probe's head too. The in-process launch counts are set
    to 0 just before the latent sampler calls and read just after them:
    K1, K2, K3 (the head) and K7 must have launched, K7 once per latent
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
    calls_n_lat = 0
    sampler = LatentFusedSampler(model, LATENT_HEAD, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lat = sampler.sample(cond, torch.Generator(dev).manual_seed(11), x_init=x_init)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    calls_n_lat += sampler.n_lat
    if lat.shape != (LATENT_ROWS, D) or not bool(torch.isfinite(lat).all()):
        raise AssertionError(f"latent sampler output {tuple(lat.shape)} not finite")
    print(f"[latent] LatentFusedSampler head {LATENT_HEAD} ({sampler.n_lat} latent steps) "
          f"{LATENT_ROWS}x{D}: {seconds:.3f} s ({LATENT_ROWS / seconds:.1f} patients/sec), "
          f"finite, std {float(lat.std()):.3f}", flush=True)
    if moment_head is not None and moment_head != LATENT_HEAD:
        sampler = LatentFusedSampler(model, moment_head, dev)
        lat = sampler.sample(cond, torch.Generator(dev).manual_seed(11), x_init=x_init)
        calls_n_lat += sampler.n_lat
    torch.cuda.synchronize()
    counts = {k.name: dict(k.modes) for k in KERNELS}
    print(f"[main] latent kernel launches by mode: {json.dumps(counts)}", flush=True)
    required = {GEMM: ["bf16"], GROUPNORM: ["default"], POSTERIOR: ["philox"],
                LATENT: ["draw_philox", "update"]}
    missing = [f"{k.name}:{m}" for k, modes in required.items() for m in modes
               if counts[k.name][m] == 0]
    if missing:
        raise AssertionError(f"latent: kernels never launched on the path: {missing}")
    check_no_general_path("latent")
    if not LATENT.modes["draw_philox"] == LATENT.modes["update"] == calls_n_lat:
        raise AssertionError(f"K7 launched {LATENT.modes}, want {calls_n_lat} per mode")
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
    """One entry per kernel; times and bounds summed over its cases,
    ``bound_by`` that of its largest bound, ``library_ms`` null where no
    single PyTorch call computes the function."""
    out = []
    for k in KERNELS:
        rows = cases[k.name]
        libs = [r["library_ms"] for r in rows]
        out.append({
            "name": k.name, "route": k.route, "source": k.source, "replaces": k.replaces,
            "launches": launches[k.name],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": sum(r["ms"] for r in rows),
            "plain_ms": sum(r["plain_ms"] for r in rows),
            "bound_ms": sum(r["bound_ms"] for r in rows),
            "bound_by": max(rows, key=lambda r: r["bound_ms"])["bound_by"],
            "library_ms": None if None in libs else sum(libs),
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
    k8_launches = POSTERIOR_UPDATE.launches  # no path calls K8: its check's launches

    with tempfile.TemporaryDirectory(prefix="osdm_chip_smoke_") as tmp:
        cfg = prepare_workdir(Path(tmp), args.weights)
        ckpts = {False: cfg.training.save_dir,
                 True: d3pm_checkpoint(cfg.training.save_dir, Path(tmp) / "checkpoint_d3pm")}
        launches = run_main_paths(cfg, dev, ckpts)
        for name, n in run_latent_path(cfg, dev, Path(tmp)).items():
            launches[name] += n
        launches[POSTERIOR_UPDATE.name] = k8_launches
        print(f"[main] kernel launches over the main paths: {json.dumps(launches)}", flush=True)
        report = kernel_report(cases, launches)
        check_d3pm_calibration(cfg, ckpts[True], dev)
        check_against_plain_loop(cfg, dev)
        check_latent_against_plain(cfg, dev)

    print(json.dumps({"kernels": report}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
