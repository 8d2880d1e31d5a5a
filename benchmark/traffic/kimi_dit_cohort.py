"""Traffic kind "kimi_dit_cohort": the cohort kind's closed loop (one
client, requests back to back, ``benchmark/traffic/cohort.py``) on the
hybrid transformer denoiser (``model.transformer.linear_attn_config``:
Kimi Delta Attention and MLA layers, an expert share), judged against the
plain reference of ``benchmark/reference/kimi_linear_dit.py``.

The mix (``benchmark/traffic/<name>.json``) sets ``call``
("generate_scenarios"), ``rows`` (patients a scenario) and ``check_rows``
(rows the reference reruns, dealt out over the scenarios), as the
``dit_cohort`` kind's.

Set-up builds the model on the meta device and draws its weights on the
card from the seed (``benchmark/kimi_weights.py``: KDA's decay as
published); a program without KDA fails there, at once, on the import of
its module. The judged request is read at the ``dit_cohort`` kind's
seams (x_T, three denoiser calls, every routed layer's choices over all
routed experts, global ids), and :func:`compare` computes that kind's
numbers against the hybrid reference, which takes the program's expert
share: ``prior_z``, ``call_rel_rms``, ``route_gap_max``, ``chain_rel_rms``
(the reference's KDA a token at a time), the conditions and the
calibration of the raw cohort. One more seam, the KDA kernel's wrapper
(``ops/kda.kda_chunk``) in the first KDA layer of each recorded call,
keeps the check rows' q, k, v, g, β and output: ``kda_rel_rms`` is that
output against the reference's token-by-token recurrence of the same
inputs, the kernel alone, in f32 on both sides.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from benchmark.harness import Cell, Record, _log, program_config, request_seed
from benchmark.reference.copula import TIE_SEED_OFFSET, calibrate_joint
from benchmark.reference.kimi_linear_dit import KimiReference, ddim_chain
from benchmark.reference.moonlight_dit import route_gaps
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
from benchmark.traffic.dit_cohort import (  # noqa: F401  (the DiT kind's seams and context)
    CPU_PARAMS,
    DitState,
    _rel,
    _wrap,
    check_rows,
    layer_context,
)


# The run whose KDA inputs are kept, and whether a recording wrapper is
# already running (a wrapper left under a control's replacement of the
# wrapper function by an earlier run keeps out of the way).
_RECORDING: Dict[str, object] = {"state": None, "inside": False}


def _wrap_kda(state: DitState) -> None:
    """Keep, in the judged request's recorded calls, the first KDA layer's
    kernel inputs and output at the check rows: the model's inputs to
    ``ops/kda.kda_chunk`` and what the function the model calls returned
    (one wrapper a process, pointed at the current run)."""
    from osteosarcoma_diffusionmodel_torch.ops import kda as kda_ops

    _RECORDING["state"] = state
    if getattr(kda_ops.kda_chunk, "recorded_by_bench", False):
        return
    inner = kda_ops.kda_chunk

    def kda_chunk(q, k, v, g, beta, scale):
        if _RECORDING["inside"]:
            return inner(q, k, v, g, beta, scale)
        _RECORDING["inside"] = True
        try:
            out = inner(q, k, v, g, beta, scale)
        finally:
            _RECORDING["inside"] = False
        st = _RECORDING["state"]
        if (st is not None and st.current == st.judged and st.call in st.record_at
                and st.call not in st.kda_calls):
            rows = torch.from_numpy(st.check).to(q.device)
            st.kda_calls[st.call] = tuple(t[rows].clone() for t in (q, k, v, g, beta, out)) + (
                scale,)
        return out

    kda_chunk.recorded_by_bench = True
    kda_ops.kda_chunk = kda_chunk


def counters() -> Dict[str, int]:
    """The program's counters of the hybrid denoiser and the KDA kernel's
    launches."""
    from osteosarcoma_diffusionmodel_torch.ops.kda import KDA
    from osteosarcoma_diffusionmodel_torch.utils.profiling import COUNTERS

    out = {k: COUNTERS[k] for k in ("dit.tokens", "moe.routed_rows", "moe.held_rows",
                                    "moe.max_expert_rows", "kda.chunks")}
    out["kda.launches"] = KDA.launches
    return out


def setup(cell: Cell, seed: int, device, cfg=None) -> DitState:
    """The training cohort, the model with its weights drawn on the device
    from the seed, the generator, and one request of the cell's shape."""
    # A program without KDA fails on the first import.
    from osteosarcoma_diffusionmodel_torch.models.kda import KimiDeltaAttention
    from osteosarcoma_diffusionmodel_torch.data.dummy import cohort_arrays, make_dummy_cohort
    from osteosarcoma_diffusionmodel_torch.generation.generator import SyntheticPatientGenerator
    from osteosarcoma_diffusionmodel_torch.models.diffusion import ConditionalDiffusion
    from osteosarcoma_diffusionmodel_torch.ops import _build
    from osteosarcoma_diffusionmodel_torch.training.checkpoint import data_stats_from_arrays

    from benchmark.kimi_weights import seeded_kimi_weights

    dev = torch.device(device)
    t0 = time.perf_counter()
    cfg = cfg if cfg is not None else program_config(cell)
    if cell.traffic["call"] != "generate_scenarios":
        raise ValueError(f"the kimi_dit_cohort kind takes call generate_scenarios, not "
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
    if not any(isinstance(m, KimiDeltaAttention) for m in model.denoiser.modules()):
        raise ValueError("the kimi_dit_cohort kind measures a denoiser with KDA layers "
                         "(model.transformer.linear_attn_config); the configuration builds none")
    params = sum(p.numel() for p in model.denoiser.parameters())
    if dev.type != "cuda" and params > CPU_PARAMS:
        raise ValueError(f"{params:,} parameters: the configuration's published widths run on "
                         "the card only")
    weights = seeded_kimi_weights(model.denoiser, request_seed(seed, 2), dev)
    model.denoiser.load_state_dict(weights, assign=True)
    gen = SyntheticPatientGenerator(model, cfg, dims, stats, device=dev)
    _log(f"set-up: cohort, {params:,} weights and generator in {time.perf_counter() - t0:.2f} s")
    judged = int(np.random.default_rng(request_seed(seed, 3)).integers(JUDGED_AMONG))
    scenarios = list(cfg.generation.scenarios)
    steps = int(cfg.generation.sampling_steps)
    state = DitState(cell, seed, dev, cfg, data_cohort, weights, gen, scenarios, judged,
                     check=check_rows(cell, seed, len(scenarios)),
                     record_at=(0, steps // 2, steps - 1), denoiser=model.denoiser)
    state.kda_calls = {}
    _wrap(state, model)
    _wrap_kda(state)
    cohort._request(state, WARM_UP)  # the cell's one shape
    _log(f"set-up: warm-up request done at {time.perf_counter() - t0:.2f} s")
    return state


@torch.no_grad()
def compare(state: DitState, rec: Record) -> Dict[str, float]:
    """The judged request against the hybrid reference: x_T's moments, the
    recorded denoiser calls given the program's routing, the routing
    against the reference's own scores over every routed expert, the
    check rows' chain rerun with the recorded routing, and the
    calibration of the raw cohort."""
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
    ref = KimiReference(state.weights, tconf, blocks, dev,
                        bf16=conf["model"]["compute_dtype"] == "bfloat16")
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
    out["kda_rel_rms"] = max(_rel(o, KimiReference.delta_rule(q, k, v, g, beta, scale))
                             for q, k, v, g, beta, o, scale in state.kda_calls.values())
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
