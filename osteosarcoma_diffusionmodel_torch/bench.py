"""The port's measuring entry point: the headline number and the suite.

    python -m osteosarcoma_diffusionmodel_torch.bench
    python -m osteosarcoma_diffusionmodel_torch.bench --suite [--out BENCH_SUITE_TORCH.json]

Counterpart of the JAX package's root ``bench.py`` (the headline) and
``scripts/bench_suite.py`` (the suite). The headline builds the shipped
default's model as ``bench.py`` does (hidden 256/512/256, cosine schedule,
x0 parameterization, clip, T = 1000, constraints off, data dims
62/5054/26, three clinical conditions) on weights from seed 0, and times
the kernel sampler (``FusedSampler``, DDPM with in-kernel Philox noise) at
32,768 rows of zero conditions: one warm-up call, then the best of three
calls, each closed by a synchronize and a scalar read-back. It prints the
card's line, the three calls' best, median and spread, and last one JSON
line, ``{"metric": "sampled_patients_per_sec_1000step_ddpm", "value": ...,
"unit": "patients/sec", "vs_baseline": ...}``.

``--suite`` times the JAX suite's cases on the port's routes (the scan
samplers, the kernel sampler and its D3PM, int8 and DDIM forms, the flow
and the cVAE, a train step at batch 16 and 256, K4's MMD and the KS test)
and writes them under the JAX suite's keys (``BENCH_SUITE.json``), with
the card's name and power limit under ``device``.

The bench runs on the card. Without one, or if the kernels do not build
or launch, it prints ``bench.py``'s structured error line (``"value":
null`` and ``"error"``) and exits 1; it never falls back to the CPU.
``--device cpu`` (or ``device="cpu"``) runs the kernels' plain versions,
for the tests, which call the functions at tiny sizes.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import statistics
import sys
import time
import traceback
from pathlib import Path
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from .config import Config
from .models.constraints import ConstraintSpec
from .models.cvae import BiologyConstrainedVAE
from .models.diffusion import ConditionalDiffusion
from .models.flow import ConditionalFlow
from .models.networks import init_flax, init_weights
from .ops import _build
from .ops.fused_sampler import FusedSampler
from .ops.pallas_kernels import mmd_rbf, rbf_kernel_sum_plain
from .ops.sampler_kernels import GEMM, GEMM_GN, GEMM_POSTERIOR
from .ops.stats import ks_test_features
from .training.trainer import clip_by_global_norm
from .utils.card import card_line

REPO = Path(__file__).resolve().parent.parent
BASELINE_FILE = REPO / "BASELINE_MEASURED.json"
METRIC = "sampled_patients_per_sec_1000step_ddpm"
UNIT = "patients/sec"
BENCH_DIMS = (62, 5054, 26)  # mutation, expression, pathway (config/config.yaml:27-30)
CONDITION_NAMES = ("survival_days_norm", "event_occurred", "metastasis_at_diagnosis")
NUM_STEPS = 1000
BATCH = 32768
HEADLINE_REPS = 3
# The JAX suite's staggered-interleave cases (bench_suite.py:145-150) are a
# TPU layout of the whole-loop kernel's two half tiles; the port has no
# such layout (ROADMAP's ground rules), so it has no route for them.
OMITTED = {
    "ddpm1000_fused_b32768_staggered": "TPU interleave layout (no port route)",
    "ddpm1000_fused_b32768_staggered_gn_f32": "TPU interleave layout (no port route)",
}
NOTES = {
    "ddpm1000_fused_b32768_gn_f32": "a second run of ddpm1000_fused_patients_per_sec_b32768's "
                                    "sampler: the port has one GroupNorm numerics, f32 "
                                    "statistics (ops/fused_sampler.py)",
}


# Copied from the root bench.py (`reference_baseline`, :114-119): the JAX
# package's reference CPU throughput, or its documented estimate.
def reference_baseline() -> float:
    if BASELINE_FILE.exists():
        with open(BASELINE_FILE) as f:
            return float(json.load(f)["reference_cpu_patients_per_sec"])
    return 1.7  # documented estimate (QUICKSTART.md:202)


def bench_config(num_steps: int = NUM_STEPS, hidden: Optional[Sequence[int]] = None) -> Config:
    """The shipped defaults with ``bench.py``'s overrides: ``num_steps``
    and constraints off (``hidden``: the tests' smaller widths)."""
    cfg = Config()
    cfg.model.diffusion.num_steps = num_steps
    cfg.model.constraints.enabled = False
    if hidden is not None:
        cfg.model.hidden_dims = list(hidden)
    return cfg


def bench_model(cfg: Config, dims: Sequence[int] = BENCH_DIMS,
                device="cuda") -> ConditionalDiffusion:
    """``cfg``'s diffusion model at ``dims`` with the three clinical
    conditions, on weights from seed 0, on ``device``."""
    frozen = cfg.freeze_dims(*dims, list(CONDITION_NAMES))
    model = ConditionalDiffusion.from_config(cfg, frozen)
    init_weights(model.denoiser, torch.Generator().manual_seed(0))
    model.denoiser.to(device)
    return model


def _force(out: torch.Tensor, dev: torch.device) -> None:
    """Waits for ``out``: a synchronize and a scalar read-back."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    float(out.reshape(-1)[-1])


def _card(dev: torch.device) -> str:
    return card_line() if dev.type == "cuda" else "cpu (no card: the kernels' plain versions)"


def headline(device="cuda", batch: int = BATCH, dims: Sequence[int] = BENCH_DIMS,
             num_steps: int = NUM_STEPS, hidden: Optional[Sequence[int]] = None,
             reps: int = HEADLINE_REPS) -> Tuple[dict, dict]:
    """(the headline line, the calls' seconds): the kernel sampler at
    ``batch`` rows of zero conditions, best of ``reps`` calls after one
    warm-up call."""
    dev = torch.device(device)
    sampler = FusedSampler(bench_model(bench_config(num_steps, hidden), dims, dev), dev)
    cond = torch.zeros(batch, len(CONDITION_NAMES), device=dev)

    def call(seed: int) -> float:
        # x_T and the Philox seed come from a generator on the sampler's
        # device, as the JAX bench draws them on its accelerator: the wall
        # holds no host draw and no host-to-card copy of x_T.
        gen = torch.Generator(device=dev).manual_seed(seed)
        t0 = time.perf_counter()
        _force(sampler.sample(cond, gen), dev)
        return time.perf_counter() - t0

    call(1)  # also builds the launch plans, tensor maps and workspaces
    seconds = [call(2 + i) for i in range(reps)]
    best = min(seconds)
    value = batch / best
    line = {"metric": METRIC, "value": round(value, 2), "unit": UNIT,
            "vs_baseline": round(value / reference_baseline(), 2)}
    stats = {"seconds": seconds, "best": best, "median": statistics.median(seconds),
             "spread": max(seconds) - best, "rows": batch}
    return line, stats


def _error_line(exc: BaseException) -> dict:
    return {"metric": METRIC, "value": None, "unit": UNIT, "vs_baseline": None,
            "error": f"{type(exc).__name__}: {exc}"[:500]}


# ----------------------------------------------------------------------
# The suite (scripts/bench_suite.py)
# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class SuiteSizes:
    """The suite's sizes: the JAX suite's by default. A case runs
    ``batch // row_divisor`` rows (at least one) and keeps the JAX key of
    ``batch``; the tests shrink the model and divide the rows."""
    dims: Tuple[int, int, int] = BENCH_DIMS
    hidden: Optional[Tuple[int, ...]] = None
    num_steps: int = NUM_STEPS
    ddim_steps: int = 50
    row_divisor: int = 1


def suite_constraint_spec(m: int, e: int, p: int) -> ConstraintSpec:
    """The JAX suite's spec (bench_suite.py:63-74): 20 pathways of 15
    expression genes from numpy ``default_rng(0)``, one exclusive pair, one
    rule."""
    rng = np.random.default_rng(0)
    mask = np.zeros((e, 20), np.float32)
    for k in range(20):
        mask[rng.choice(e, 15, replace=False), k] = 1.0
    return ConstraintSpec(
        mutation_dim=m, expression_dim=e, pathway_dim=p, pathway_mask=mask,
        exclusive_pairs=np.array([[0, 1]], np.int32),
        rule_mutation_idx=np.array([0], np.int32), rule_pathway_idx=np.array([0], np.int32),
        rule_sign=np.array([-1.0], np.float32))


def best_of(fn: Callable[[], torch.Tensor], dev: torch.device, n: int) -> float:
    """Best seconds of ``n`` calls after one warm-up call (bench_suite.py
    ``timeit``), each closed by a synchronize and a scalar read-back."""
    _force(fn(), dev)
    seconds = []
    for _ in range(n):
        t0 = time.perf_counter()
        _force(fn(), dev)
        seconds.append(time.perf_counter() - t0)
    return min(seconds)


def mmd_plain(x: torch.Tensor, y: torch.Tensor) -> float:
    """:func:`ops.pallas_kernels.mmd_rbf` on K4's plain version (float64)."""
    gamma = 1.0 / x.shape[1]
    n, m = x.shape[0], y.shape[0]
    xx = rbf_kernel_sum_plain(x, x, gamma) / (n * n)
    yy = rbf_kernel_sum_plain(y, y, gamma) / (m * m)
    xy = rbf_kernel_sum_plain(x, y, gamma) / (n * m)
    return float(torch.sqrt(torch.clamp(xx + yy - 2.0 * xy, min=0.0)))


def mmd_case(real: torch.Tensor, synth: torch.Tensor, dev: torch.device) -> Tuple[float, bool]:
    """(best seconds of the validator's MMD on K4, whether it lies within
    1e-3 of the plain version's), as the JAX suite's ``mmd_10k_sec`` and
    ``mmd_10k_pallas_equals_jnp``."""
    seconds = best_of(lambda: torch.tensor(mmd_rbf(real, synth)), dev, 2)
    return seconds, abs(mmd_rbf(real, synth) - mmd_plain(real, synth)) < 1e-3


def run_suite(device="cuda", sizes: SuiteSizes = SuiteSizes()) -> dict:
    """The JAX suite's cases on the port's routes, in its order and under
    its keys, plus ``omitted`` (its keys without a port route, and why),
    ``notes`` and, where a case raised, ``errors`` (its value is then
    None). Every draw comes from a generator on ``device``."""
    dev = torch.device(device)
    results, errors = {}, {}

    def gen(seed: int) -> torch.Generator:
        return torch.Generator(device=dev).manual_seed(seed)

    def rows(batch: int) -> int:
        return max(1, batch // sizes.row_divisor)

    def zeros(batch: int) -> torch.Tensor:
        return torch.zeros(rows(batch), 3, device=dev)

    def case(keys, measure: Callable[[], Sequence[float]]) -> None:
        try:
            values = measure()
        except Exception as exc:  # the case's failure is recorded; the suite goes on
            traceback.print_exc()
            values = [None] * len(keys)
            for key in keys:
                errors[key] = f"{type(exc).__name__}: {exc}"[:500]
        results.update(zip(keys, values))
        print(f"[suite] {', '.join(f'{k} {v}' for k, v in zip(keys, values))}", flush=True)

    cfg = Config()
    cfg.model.diffusion.num_steps = sizes.num_steps
    if sizes.hidden is not None:
        cfg.model.hidden_dims = list(sizes.hidden)
    m, e, p = sizes.dims
    dims = cfg.freeze_dims(m, e, p, ["s", "e", "m"])
    D = dims.data_dim
    model = ConditionalDiffusion.from_config(cfg, dims, suite_constraint_spec(m, e, p))
    init_weights(model.denoiser, torch.Generator().manual_seed(0))
    model.denoiser.to(dev)

    # The train step: loss, clip 1.0, AdamW (lr 1e-4, weight decay 1e-5), on
    # a copy, so that the samplers below run the seed-0 weights as in the
    # JAX suite, whose step leaves its parameters as they were.
    trained = copy.deepcopy(model)
    params = list(trained.denoiser.parameters())
    opt = torch.optim.AdamW(params, lr=1e-4, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-5,
                            capturable=dev.type == "cuda")
    loss_gen = gen(2)

    def train_step(x0, cond):
        opt.zero_grad(set_to_none=True)
        loss, _ = trained.loss(x0, cond, loss_gen)
        loss.backward()
        clip_by_global_norm([q.grad for q in params], 1.0)
        opt.step()
        return loss.detach()

    for batch, keys in ((16, ("train_step_sec_b16_constraints",
                              "train_steps_per_sec_b16_constraints")),
                        (256, ("train_step_sec_b256_constraints", "train_samples_per_sec_b256"))):
        def measure(batch=batch):
            x0 = torch.randn(batch, D, generator=gen(1), device=dev)
            cond = torch.zeros(batch, 3, device=dev)
            dt = best_of(lambda: train_step(x0, cond), dev, 10)
            return dt, (1.0 if batch == 16 else batch) / dt
        case(keys, measure)
    del trained, opt, params

    def rate(batch: int, sample: Callable[[torch.Tensor, torch.Generator], torch.Tensor]):
        cond = zeros(batch)
        return [rows(batch) / best_of(lambda: sample(cond, gen(3)), dev, 2)]

    for batch in (1024, 4096, 8192):  # the scan sampler: JAX's model.sample
        case([f"ddpm1000_patients_per_sec_b{batch}"], lambda b=batch: rate(b, model.scan_sample))

    fused = FusedSampler(model, dev)
    for batch in (4096, 8192, 16384, 32768):
        case([f"ddpm1000_fused_patients_per_sec_b{batch}"], lambda b=batch: rate(b, fused.sample))
    case(["ddpm1000_fused_b32768_gn_f32"], lambda: rate(32768, fused.sample))
    case(["ddpm1000_fused_b32768_int8_out"],
         lambda: rate(32768, FusedSampler(model, dev, quantize="out").sample))

    disc = dataclasses.replace(model, discrete_head=True)
    case(["ddpm1000_discrete_head_patients_per_sec_b4096"], lambda: rate(4096, disc.scan_sample))
    fused_disc = FusedSampler(disc, dev)
    for batch in (4096, 32768):
        case([f"ddpm1000_discrete_fused_patients_per_sec_b{batch}"],
             lambda b=batch: rate(b, fused_disc.sample))

    r1 = dataclasses.replace(model, sample_dtype="float32", noise_type="normal")
    case(["ddpm1000_patients_per_sec_b4096_f32_gaussian"], lambda: rate(4096, r1.scan_sample))
    case(["ddim50_patients_per_sec_b1024"],
         lambda: rate(1024, lambda c, g: model.scan_sample_ddim(c, g, sizes.ddim_steps)))
    fused_ddim = FusedSampler(model, dev, ddim_steps=sizes.ddim_steps)
    for batch in (8192, 32768, 131072):
        case([f"ddim50_fused_patients_per_sec_b{batch}"],
             lambda b=batch: rate(b, fused_ddim.sample))
    del fused, fused_disc, fused_ddim

    # The one-pass samplers of the other two families, seed-0 Flax inits.
    for key, family in (("flow_patients_per_sec_b4096", ConditionalFlow),
                        ("cvae_patients_per_sec_b4096", BiologyConstrainedVAE)):
        def measure(family=family):
            other = family.from_config(cfg, dims)
            init_flax(other.module, torch.Generator().manual_seed(0))
            other.module.to(dev)
            return rate(4096, other.sample)
        case([key], measure)

    # Validation statistics at a 10k cohort: K4's MMD, then the KS test.
    real = torch.randn(100, D, generator=gen(4), device=dev)
    synth = torch.randn(rows(10000), D, generator=gen(5), device=dev)

    case(["mmd_10k_sec", "mmd_10k_pallas_equals_jnp"], lambda: mmd_case(real, synth, dev))
    cols = min(100, D)
    case(["ks100_10k_sec"], lambda: [best_of(
        lambda: torch.from_numpy(ks_test_features(real[:, :cols], synth[:, :cols])[0]), dev, 2)])

    results["device"] = _card(dev)
    results["omitted"] = dict(OMITTED)
    results["notes"] = dict(NOTES)
    if errors:
        results["errors"] = errors
    return results


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--suite", action="store_true",
                        help="time the suite's cases and write them to --out")
    parser.add_argument("--out", default="BENCH_SUITE_TORCH.json")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="cpu: the kernels' plain versions (tests only)")
    args = parser.parse_args(argv)
    try:
        dev = torch.device(args.device)
        if dev.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("no CUDA device is available: the bench runs on the card")
            _build.LIBRARY.get()
        print(_card(dev), flush=True)
        if args.suite:
            results = run_suite(dev)
            Path(args.out).write_text(json.dumps(results, indent=2) + "\n")
            print(json.dumps(results), flush=True)
            return 1 if "errors" in results else 0
        before = [k.launches for k in (GEMM, GEMM_GN, GEMM_POSTERIOR)]
        line, stats = headline(dev)
        launched = [k.launches - n for k, n in zip((GEMM, GEMM_GN, GEMM_POSTERIOR), before)]
        if dev.type == "cuda" and not all(launched):
            raise RuntimeError(f"the headline launched K1, K1+GN, K1+posterior {launched} times")
        print(f"calls at {stats['rows']} rows: best {stats['best']:.4f} s, median "
              f"{stats['median']:.4f} s, spread {stats['spread']:.4f} s "
              f"({', '.join(f'{s:.4f}' for s in stats['seconds'])})", flush=True)
        print(json.dumps(line), flush=True)
        return 0
    except Exception as exc:  # the entry point's boundary: the structured error line
        traceback.print_exc()
        print(json.dumps(_error_line(exc)), flush=True)
        return 1


if __name__ == "__main__":
    sys.exit(main())
