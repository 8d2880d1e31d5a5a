"""Traffic kind "dit_cohort": the cohort kind's closed loop (one client,
requests back to back, ``benchmark/traffic/cohort.py``) on the transformer
denoiser (``model.denoiser: moonlight_dit``), judged against the plain
reference of ``benchmark/reference/moonlight_dit.py``.

The mix (``benchmark/traffic/<name>.json``) sets ``call``
("generate_scenarios": every configured scenario in one request), ``rows``
(patients a scenario) and ``check_rows`` (rows the reference reruns, dealt
out over the scenarios).

Set-up builds the model on the meta device and draws its weights on the
card from the seed (``benchmark/dit_weights.py``); a program without the
transformer denoiser fails there, at once, on the import of its module.
The judged request (drawn from the seed among the first three) is read at
three seams of the program:

- ``ConditionalDiffusion._x_prior``'s return: x_T;
- the denoiser's ``forward``: the check rows' input, t and output at the
  first, middle and last DDIM step;
- each routed layer's ``MoEFeedForward.route``: the check rows' expert
  choices at every step.

:func:`compare` then judges x_T's moments (``prior_z``); each recorded call
against the reference given the program's choices (``call_rel_rms``); the
choices against the reference's own biased scores (``route_gap_max``: the
widest tie a choice flipped, :func:`~benchmark.reference.moonlight_dit.route_gaps`);
the 50-step chain of the check rows rerun with the program's recorded
routing (``chain_rel_rms``); and, as the cohort kind does, the conditions
and the calibration of the raw cohort.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from benchmark.harness import Cell, Record, _log, program_config, request_seed
from benchmark.reference.copula import TIE_SEED_OFFSET, calibrate_joint
from benchmark.reference.moonlight_dit import Reference, ddim_chain, route_gaps
from benchmark.traffic import cohort
from benchmark.traffic.cohort import (  # noqa: F401  (the kind's window and end-to-end metric)
    JUDGED_AMONG,
    WARM_UP,
    _prior_z,
    _rel_gaps,
    end_to_end,
    release,
    window,
)

# Above this many parameters the configuration runs on the card only.
CPU_PARAMS = 50_000_000


@dataclass
class DitState(cohort.State):
    check: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    record_at: Tuple[int, ...] = ()
    call: int = 0
    x_T: Optional[torch.Tensor] = None
    calls: Dict[int, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = field(default_factory=dict)
    routes: List[List[torch.Tensor]] = field(default_factory=list)
    denoiser: Any = None


def counters() -> Dict[str, int]:
    """The program's counters of the transformer denoiser."""
    from osteosarcoma_diffusionmodel_torch.utils.profiling import COUNTERS

    return {k: COUNTERS[k] for k in ("dit.tokens", "moe.routed_rows", "moe.max_expert_rows")}


def check_rows(cell: Cell, seed: int, scenarios: int) -> np.ndarray:
    """``check_rows`` rows of the request, the i-th in scenario i mod S,
    each at a row drawn from the seed."""
    per = int(cell.traffic["rows"])
    rng = np.random.default_rng(request_seed(seed, 4))
    k = int(cell.traffic["check_rows"])
    return np.sort(np.array([(i % scenarios) * per + int(rng.integers(per)) for i in range(k)]))


def setup(cell: Cell, seed: int, device, cfg=None) -> DitState:
    """The training cohort, the model with its weights drawn on the device
    from the seed, the generator, and one request of the cell's shape."""
    # A program without the transformer denoiser fails on the first import.
    from osteosarcoma_diffusionmodel_torch.models.dit import MoonlightDiT
    from osteosarcoma_diffusionmodel_torch.data.dummy import cohort_arrays, make_dummy_cohort
    from osteosarcoma_diffusionmodel_torch.generation.generator import SyntheticPatientGenerator
    from osteosarcoma_diffusionmodel_torch.models.diffusion import ConditionalDiffusion
    from osteosarcoma_diffusionmodel_torch.ops import _build
    from osteosarcoma_diffusionmodel_torch.training.checkpoint import data_stats_from_arrays

    from benchmark.dit_weights import seeded_dit_weights

    dev = torch.device(device)
    t0 = time.perf_counter()
    cfg = cfg if cfg is not None else program_config(cell)
    if cell.traffic["call"] != "generate_scenarios":
        raise ValueError(f"the dit_cohort kind takes call generate_scenarios, not "
                         f"{cell.traffic['call']!r}")
    if dev.type == "cuda":
        _build.LIBRARY.get()
    _log(f"set-up: kernels loaded in {time.perf_counter() - t0:.2f} s")
    co = cell.config["cohort"]
    data_cohort = make_dummy_cohort(co["patients"], co["mutation_genes"], co["expression_genes"],
                                    co["pathways"], seed=request_seed(seed, 1) % 2**32)
    data, conditions, dims = cohort_arrays(data_cohort, cfg)
    stats = data_stats_from_arrays(data, conditions, dims.mutation_dim)
    with torch.device("meta"):
        model = ConditionalDiffusion.from_config(cfg, dims)
    if not isinstance(model.denoiser, MoonlightDiT):
        raise ValueError("the dit_cohort kind measures model.denoiser moonlight_dit, the "
                         f"configuration builds {type(model.denoiser).__name__}")
    params = sum(p.numel() for p in model.denoiser.parameters())
    if dev.type != "cuda" and params > CPU_PARAMS:
        raise ValueError(f"{params:,} parameters: the configuration's published widths run on "
                         "the card only")
    weights = seeded_dit_weights(model.denoiser, request_seed(seed, 2), dev)
    model.denoiser.load_state_dict(weights, assign=True)
    gen = SyntheticPatientGenerator(model, cfg, dims, stats, device=dev)
    _log(f"set-up: cohort, {params:,} weights and generator in {time.perf_counter() - t0:.2f} s")
    judged = int(np.random.default_rng(request_seed(seed, 3)).integers(JUDGED_AMONG))
    scenarios = list(cfg.generation.scenarios)
    steps = int(cfg.generation.sampling_steps)
    state = DitState(cell, seed, dev, cfg, data_cohort, weights, gen, scenarios, judged,
                     check=check_rows(cell, seed, len(scenarios)),
                     record_at=(0, steps // 2, steps - 1), denoiser=model.denoiser)
    _wrap(state, model)
    cohort._request(state, WARM_UP)  # the cell's one shape
    _log(f"set-up: warm-up request done at {time.perf_counter() - t0:.2f} s")
    return state


def _wrap(state: DitState, model) -> None:
    """The sampler's span and raw cohort (the cohort kind's), and the
    judged request's x_T, recorded calls and routing."""
    _wrap_sample_raw(state)
    rows = torch.from_numpy(state.check).to(state.device)
    den = model.denoiser
    prior, forward = model._x_prior, den.forward

    def x_prior(*args, **kwargs):
        x = prior(*args, **kwargs)
        state.call = 0
        if state.current == state.judged:
            state.x_T = x.detach().clone()
            state.routes = []
        return x

    def denoise(x, t_norm, *args, **kwargs):
        judged = state.current == state.judged
        if judged:
            state.routes.append([])
        out = forward(x, t_norm, *args, **kwargs)
        if judged and state.call in state.record_at:
            state.calls[state.call] = (x[rows].float().clone(), t_norm[rows].float().clone(),
                                       out[rows].float().clone())
        state.call += 1
        return out

    model._x_prior = x_prior
    den.forward = denoise
    seq = den.seq_len
    for layer in den.moe_layers():
        inner = layer.route

        def route(x, inner=inner):
            choice, weight = inner(x)
            if state.current == state.judged:
                picked = choice.view(-1, seq, choice.shape[1])[rows].reshape(-1, choice.shape[1])
                state.routes[-1].append(picked.to(torch.uint8))
            return choice, weight

        layer.route = route


def _wrap_sample_raw(state: DitState) -> None:
    """A span around ``sample_raw`` (closed by a synchronize in a traced
    run), and the judged request's raw cohort kept."""
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


def layer_context(state: DitState, rec: Record) -> Dict[str, Any]:
    tconf = state.cell.config["config"]["model"]["transformer"]
    batch = int(state.cell.traffic["rows"]) * len(state.scenarios)
    seq = state.denoiser.seq_len
    return {"rows": batch, "seq_len": seq, "tokens_per_call": batch * seq,
            "transformer": dict(tconf), "patches": seq - 2}


def _rel(p: torch.Tensor, r: torch.Tensor) -> float:
    diff = (p.double() - r.double())
    return float(diff.norm() / r.double().norm().clamp_min(1e-12))


@torch.no_grad()
def compare(state: DitState, rec: Record) -> Dict[str, float]:
    """The judged request against the reference: x_T's moments, the
    recorded denoiser calls given the program's routing, the routing
    against the reference's own scores, the check rows' chain rerun with
    the recorded routing, and the calibration of the raw cohort."""
    if (state.judged_out is None or state.judged_raw is None or state.x_T is None
            or len(state.routes) == 0):
        return {}
    conf = state.cell.config["config"]
    tconf = conf["model"]["transformer"]
    co = state.cell.config["cohort"]
    dev = state.device
    blocks = (co["mutation_genes"], co["expression_genes"], co["pathways"])
    real, cond = cohort.reference_inputs(state)
    rows = state.check
    cond_rows = torch.from_numpy(cond[rows]).to(dev)
    ref = Reference(state.weights, tconf, blocks, dev, bf16=conf["model"]["compute_dtype"] == "bfloat16")
    out: Dict[str, float] = {"prior_z": _prior_z(state.x_T)}
    k = int(tconf["num_experts_per_tok"])
    calls, gaps = [], []
    for s, (x, t, y) in sorted(state.calls.items()):
        scores: List[torch.Tensor] = []
        want = ref.forward(x, t, cond_rows, routes=state.routes[s], scores_out=scores)
        calls.append(_rel(y, want))
        gaps += [float(route_gaps(b, c.to(dev), k).max()) for c, b in zip(state.routes[s], scores)]
    out["call_rel_rms"] = max(calls)
    out["route_gap_max"] = max(gaps)
    diff = conf["model"]["diffusion"]
    chain = ddim_chain(ref, state.x_T[torch.from_numpy(rows).to(state.x_T.device)], cond_rows,
                       schedule=diff["beta_schedule"], num_steps=diff["num_steps"],
                       ddim_steps=conf["generation"]["sampling_steps"],
                       clip=diff["denoised_clip_value"], routes=state.routes)
    out["chain_rel_rms"] = _rel(state.judged_raw[torch.from_numpy(rows).to(dev)].float(), chain)
    p = state.judged_out
    raw = state.judged_raw
    out["conditions_max_abs"] = float(np.abs(p["conditions"] - cond).max())
    bits, cont = calibrate_joint(raw, real, co["mutation_genes"],
                                 conf["training"]["random_seed"] + TIE_SEED_OFFSET)
    p_bits = torch.from_numpy(np.asarray(p["mutations"], np.float32)).to(dev)
    p_cont = torch.from_numpy(np.concatenate([p["expression"], p["pathways"]], axis=1)
                              .astype(np.float32)).to(dev)
    out["bits_mismatch"] = float((p_bits != bits).float().mean())
    out.update({f"calib_{key}": v for key, v in _rel_gaps(p_cont, cont, center=True).items()})
    return out
