"""Traffic kind "cohort": one client asks the generator for cohorts in a
closed loop, back to back.

The mix (``benchmark/traffic/<name>.json``) sets:

- ``call``: "generate" (``SyntheticPatientGenerator.generate(rows,
  scenario)``, the configured scenarios in turn) or "generate_scenarios"
  (every configured scenario at ``rows`` patients in one request);
- ``rows``: patients per scenario in a request;
- ``check_rows``: cohort rows whose reverse chain the reference reruns.

Request i hands the generator a host generator seeded by (run seed, i),
as the generator's callers do; the program draws x_T and the Philox seed
of its transition noise from it, wherever it draws them. The harness
keeps what the sampler's step loop was given for the judged request (its
x_T and Philox seed, at the one seam where both exist), and the reference
reruns the chain from those. The measured program is the PyTorch port;
the judged request is drawn from the seed among the first three.
"""

from __future__ import annotations

import gc
import inspect
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from benchmark.harness import Cell, Record, _log, program_config, request_seed
from benchmark.reference import cohort as ref_cohort
from benchmark.reference.copula import TIE_SEED_OFFSET, calibrate_joint
from benchmark.reference.sampler import Denoiser, reverse_chain
from benchmark.roofline import macs_per_row
from benchmark.weights import seeded_weights

JUDGED_AMONG = 3  # the judged request is one of the first three
WARM_UP = 10**9  # the warm-up request's index: its own draws, never a window's


@dataclass
class State:
    cell: Cell
    seed: int
    device: torch.device
    cfg: Any
    cohort: Any
    weights: Dict[str, torch.Tensor]
    gen: Any
    scenarios: List[Any]
    judged: int
    traced: bool = False
    current: int = -1
    captured: Optional[torch.Tensor] = None
    judged_raw: Optional[torch.Tensor] = None
    judged_draws: Optional[Tuple[torch.Tensor, int]] = None
    judged_out: Optional[Dict[str, np.ndarray]] = None
    spans: List[Dict[str, Any]] = field(default_factory=list)


def counters() -> Dict[str, int]:
    """The port's launch counters of the step's kernels."""
    from osteosarcoma_diffusionmodel_torch.ops.sampler_kernels import (
        GEMM,
        GEMM_GN,
        GEMM_POSTERIOR,
    )
    return {"k1": GEMM.launches, "k1_gn": GEMM_GN.launches,
            "k1_posterior": GEMM_POSTERIOR.launches}


def _rows(cell: Cell, scenarios: List[Any]) -> int:
    per = int(cell.traffic["rows"])
    return per * len(scenarios) if cell.traffic["call"] == "generate_scenarios" else per


def setup(cell: Cell, seed: int, device, cfg=None) -> State:
    """The training cohort and the weights from the seed, the generator,
    and one request of the cell's shape (its kernels' plans, the copula
    fit and the calibrator built)."""
    from osteosarcoma_diffusionmodel_torch.data.dummy import cohort_arrays, make_dummy_cohort
    from osteosarcoma_diffusionmodel_torch.generation.generator import SyntheticPatientGenerator
    from osteosarcoma_diffusionmodel_torch.models.diffusion import ConditionalDiffusion
    from osteosarcoma_diffusionmodel_torch.ops import _build
    from osteosarcoma_diffusionmodel_torch.training.checkpoint import data_stats_from_arrays

    dev = torch.device(device)
    t0 = time.perf_counter()
    if dev.type == "cuda":
        _build.LIBRARY.get()
    _log(f"set-up: kernels loaded in {time.perf_counter() - t0:.2f} s")
    cfg = cfg if cfg is not None else program_config(cell)
    co = cell.config["cohort"]
    cohort = make_dummy_cohort(co["patients"], co["mutation_genes"], co["expression_genes"],
                               co["pathways"], seed=request_seed(seed, 1) % 2**32)
    data, conditions, dims = cohort_arrays(cohort, cfg)
    stats = data_stats_from_arrays(data, conditions, dims.mutation_dim)
    model = ConditionalDiffusion.from_config(cfg, dims)
    model.denoiser.to(dev)
    weights = seeded_weights(model.denoiser, request_seed(seed, 2), dev)
    model.denoiser.load_state_dict(weights)
    gen = SyntheticPatientGenerator(model, cfg, dims, stats, device=dev)
    _log(f"set-up: cohort, weights and generator in {time.perf_counter() - t0:.2f} s")
    judged = int(np.random.default_rng(request_seed(seed, 3)).integers(JUDGED_AMONG))
    state = State(cell, seed, dev, cfg, cohort, weights, gen, list(cfg.generation.scenarios),
                  judged)
    _wrap_sampler(state)
    _request(state, WARM_UP)  # the cell's one shape
    _log(f"set-up: warm-up request done at {time.perf_counter() - t0:.2f} s")
    return state


def _wrap_sampler(state: State) -> None:
    """Spans around the sampler (closed by a synchronize in a traced
    run), the judged request's raw cohort kept, and the x_T and Philox
    seed that the kernel sampler's step loop (``FusedSampler._run``) is
    given for the judged request kept by reference."""
    sampler = state.gen.sampler()
    run = sampler._run
    signature = inspect.signature(run)

    def _run(*args, **kwargs):
        if state.current == state.judged:
            given = signature.bind(*args, **kwargs).arguments
            state.judged_draws = (given["x_init"], int(given["seed"]))
        return run(*args, **kwargs)

    sampler._run = _run
    inner = state.gen.sample_raw

    def sample_raw(conditions, generator):
        t0 = time.perf_counter()
        with torch.profiler.record_function("bench.sample_raw"):
            out = inner(conditions, generator)
            if state.traced and state.device.type == "cuda":
                torch.cuda.synchronize(state.device)
        state.spans.append(
            {"name": "sample_raw", "req": state.current, "t0": t0, "t1": time.perf_counter()})
        state.captured = out
        return out

    state.gen.sample_raw = sample_raw


def _request_generator(seed: int, i: int) -> torch.Generator:
    return torch.Generator().manual_seed(request_seed(seed, 100, i))


def _request(state: State, i: int) -> Dict[str, np.ndarray]:
    cell, gen = state.cell, state.gen
    rows = int(cell.traffic["rows"])
    state.current = i
    with torch.profiler.record_function("bench.request"):
        if cell.traffic["call"] == "generate":
            scen = state.scenarios[i % len(state.scenarios)]
            return gen.generate(rows, scen.conditions, _request_generator(state.seed, i))
        if cell.traffic["call"] == "generate_scenarios":
            out = gen.generate_scenarios(state.scenarios, rows, seed=request_seed(state.seed, 100, i))
            return {k: np.concatenate([out[s.name][k] for s in state.scenarios])
                    for k in ("mutations", "expression", "pathways", "conditions")}
    raise ValueError(f"unknown call {cell.traffic['call']!r}")


def window(state: State, seconds: float, rec: Record, traced: bool) -> None:
    """Requests back to back from the window's start until ``seconds`` have
    passed (and at least through the judged one)."""
    state.traced = traced
    state.spans = []
    rows = _rows(state.cell, state.scenarios)
    rec.t0 = time.perf_counter()
    end = rec.t0 + seconds
    i = 0
    while time.perf_counter() < end or i <= state.judged:
        t0 = time.perf_counter()
        try:
            out = _request(state, i)
        except Exception as exc:  # a failed request counts; the window goes on
            rec.failed += 1
            rec.errors.append(f"{type(exc).__name__}: {exc}"[:300])
            state.captured = None
            i += 1
            if rec.failed > 3:
                break
            continue
        t1 = time.perf_counter()
        rec.requests.append({"i": i, "t0": t0, "t1": t1, "rows": rows})
        if i == state.judged:
            state.judged_out, state.judged_raw = out, state.captured
        state.captured = None
        i += 1
    rec.t_end = rec.requests[-1]["t1"] if rec.requests else time.perf_counter()
    _log("requests s: " + " ".join(f"{r['t1'] - r['t0']:.3f}" for r in rec.requests))
    spans = {s["req"]: s for s in state.spans}
    for r in rec.requests:
        s = spans.get(r["i"])
        rec.spans.append({"name": "request", "req": r["i"], "t0": r["t0"], "t1": r["t1"]})
        if s is not None:
            rec.spans.append(s)


def end_to_end(state: State, rec: Record) -> Dict[str, Optional[float]]:
    if not rec.requests:
        return {}
    patients = sum(r["rows"] for r in rec.requests)
    return {"cohort_patients_per_s": patients / (rec.t_end - rec.t0)}


def layer_context(state: State, rec: Record) -> Dict[str, Any]:
    cfg = state.cfg
    hidden = list(cfg.model.hidden_dims)
    d = state.gen.dims.data_dim
    ddim = cfg.generation.sampler == "ddim"
    return {"rows": _rows(state.cell, state.scenarios), "hidden": hidden, "data_dim": d,
            "noise": "none" if ddim else "philox", "macs_per_row": macs_per_row(hidden, d)}


def release(state: State) -> None:
    """Frees the program: the generator, its model and samplers."""
    state.gen = None
    gc.collect()
    if state.device.type == "cuda":
        torch.cuda.empty_cache()


# ----------------------------------------------------------------------
# The comparison with the plain reference
# ----------------------------------------------------------------------
def reference_inputs(state: State):
    """The training matrix and the judged request's conditions (N, C),
    worked out again from the raw cohort and the configuration's dict."""
    cell, co = state.cell, state.cohort
    conf = cell.config["config"]
    real = ref_cohort.training_matrix(co.mutations, co.expression, co.pathways)
    surv = ref_cohort.survival_norm(co.clinical["survival_days"])
    cond_on = conf["model"]["condition_on"]
    scenarios = conf["generation"]["scenarios"]
    rows, i = int(cell.traffic["rows"]), state.judged
    if cell.traffic["call"] == "generate":
        cond = ref_cohort.scenario_conditions(scenarios[i % len(scenarios)]["conditions"],
                                              cond_on, rows, surv)
    else:
        cond = np.concatenate([ref_cohort.scenario_conditions(s["conditions"], cond_on, rows, surv)
                               for s in scenarios])
    return real, cond


def reference_rows(state: State, n: int) -> np.ndarray:
    k = min(int(state.cell.traffic["check_rows"]), n)
    return np.sort(np.random.default_rng(request_seed(state.seed, 4)).choice(n, k, replace=False))


def _rel_gaps(p: torch.Tensor, r: torch.Tensor, center: bool) -> Dict[str, float]:
    base = r - r.mean(dim=0, keepdim=True) if center else r
    diff = (p - r).double()
    base = base.double()
    row = diff.norm(dim=1) / base.norm(dim=1).clamp_min(1e-12)
    return {"rel_rms": float(diff.norm() / base.norm().clamp_min(1e-12)),
            "row_gap": float(row.max()), "max_abs": float(diff.abs().max())}


def _col_bias(p: torch.Tensor, r: torch.Tensor) -> float:
    """The per-column mean of the gap over the rows, its rms over the
    columns, relative to the rms of the reference. A rounding flip is as
    often up as down, so this falls with the rows; the error of a coarser
    product on a fixed weight does not."""
    diff = (p - r).double()
    return float(diff.mean(dim=0).pow(2).mean().sqrt() / r.double().pow(2).mean().sqrt())


def _prior_z(x: torch.Tensor) -> float:
    """How far x_T's values stand from a standard normal's, in standard
    errors of n draws: the larger of |mean|·sqrt(n) and |std - 1|·sqrt(2n)
    (float64, over every value). A sound draw reads a half-normal's
    values at any size."""
    x = x.double().flatten()
    n = x.numel()
    return max(abs(float(x.mean())) * n**0.5, abs(float(x.std()) - 1.0) * (2 * n)**0.5)


@torch.no_grad()
def compare(state: State, rec: Record, tf32_calibration: bool = False) -> Dict[str, float]:
    """The judged request against the reference: its sampler rows rerun
    from the x_T and Philox seed the program's step loop was given, that
    x_T against a standard normal, and the calibration of its raw cohort."""
    if state.judged_out is None or state.judged_raw is None or state.judged_draws is None:
        return {}
    conf = state.cell.config["config"]
    dev = state.device
    real, cond = reference_inputs(state)
    x_init, philox_seed = state.judged_draws
    raw = state.judged_raw
    n, m = raw.shape[0], state.cell.config["cohort"]["mutation_genes"]
    out: Dict[str, float] = {"prior_z": _prior_z(x_init)}

    rows = reference_rows(state, n)
    diff = conf["model"]["diffusion"]
    gen_conf = conf["generation"]
    den = Denoiser(state.weights, conf["model"]["hidden_dims"], dev)
    ref_rows = reverse_chain(
        den, x_init[torch.from_numpy(rows).to(x_init.device)].float(),
        torch.from_numpy(cond[rows]), torch.from_numpy(rows),
        schedule=diff["beta_schedule"], num_steps=diff["num_steps"],
        ddim_steps=gen_conf["sampling_steps"] if gen_conf["sampler"] == "ddim" else None,
        clip=diff["denoised_clip_value"], philox_seed=philox_seed)
    del den
    prog_rows = raw[torch.from_numpy(rows).to(dev)].float()
    gaps = _rel_gaps(prog_rows, ref_rows, center=False)
    out.update({f"sampler_{k}": v for k, v in gaps.items()})
    out["sampler_col_bias"] = _col_bias(prog_rows, ref_rows)

    p = state.judged_out
    out["conditions_max_abs"] = float(np.abs(p["conditions"] - cond).max())
    bits, cont = calibrate_joint(raw, real, m, conf["training"]["random_seed"] + TIE_SEED_OFFSET,
                                 tf32=tf32_calibration)
    p_bits = torch.from_numpy(np.asarray(p["mutations"], np.float32)).to(dev)
    p_cont = torch.from_numpy(np.concatenate([p["expression"], p["pathways"]], axis=1)
                              .astype(np.float32)).to(dev)
    out["bits_mismatch"] = float((p_bits != bits).float().mean())
    gaps = _rel_gaps(p_cont, cont, center=True)
    out.update({f"calib_{k}": v for k, v in gaps.items()})
    return out
