#!/usr/bin/env python3
"""The readings that the transformer cell's limits are set from, in one
process.

    python3 benchmark/dit_readings.py --workload moonlight-dit-ddim50-3x8 --seeds 1,2,3 \
        [--variants program,fp8-experts,top5,no-shared,no-bias] [--out FILE.jsonl]

For each seed and variant: the cell's set-up from that seed, its timed
path up to the judged request, the program freed, and every number the
comparison computes (``benchmark/traffic/dit_cohort.py``). Variants:

- ``program``: the program as the configuration states it (sound runs:
  the lower readings);
- ``fp8-experts``: the routed experts' products on operands rounded to
  fp8 (e4m3, a scale a row of the activations and a scale an expert's
  weight), the precision below the configuration's bfloat16 (the
  control);
- ``top5``: one expert a token fewer than the configuration's six;
- ``no-shared``: the shared experts left out;
- ``no-bias``: the router's choice without ``e_score_correction_bias``.

Each reading is one JSON line (cell, seed, variant, numbers, seconds).
Not part of a benchmark run; it runs on the card unless ``--device cpu``.
"""

import argparse
import contextlib
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

VARIANTS = ("program", "fp8-experts", "top5", "no-shared", "no-bias")
FP8_MAX = 448.0  # the largest e4m3 value


def fp8_round(x, dim):
    """``x`` rounded to e4m3 under one absmax scale along ``dim``, back in
    its own dtype."""
    import torch

    amax = x.float().abs().amax(dim=dim, keepdim=True).clamp_min(1e-12)
    scale = FP8_MAX / amax
    return ((x.float() * scale).to(torch.float8_e4m3fn).float() / scale).to(x.dtype)


@contextlib.contextmanager
def fault(variant: str):
    """The program changed as ``variant`` says, for the block (``top5`` is
    a change of configuration: :func:`program_config`)."""
    import torch

    from osteosarcoma_diffusionmodel_torch.models import dit
    from osteosarcoma_diffusionmodel_torch.ops import moe

    saved = {}

    def patch(owner, name, value):
        saved[(owner, name)] = getattr(owner, name)
        setattr(owner, name, value)

    if variant == "fp8-experts":
        swiglu, down = moe.grouped_swiglu, moe.grouped_down

        def grouped_swiglu(a, w, plan, **kw):
            return swiglu(fp8_round(a, 1), fp8_round(w, (1, 2)), plan, **kw)

        def grouped_down(h, w, plan, *args, **kw):
            return down(fp8_round(h, 1), fp8_round(w, (1, 2)), plan, *args, **kw)

        patch(moe, "grouped_swiglu", grouped_swiglu)
        patch(moe, "grouped_down", grouped_down)
    elif variant == "no-shared":
        forward = dit.MoEFeedForward.forward

        def without_shared(self, x):
            self.shared.forward = lambda m: torch.zeros(m.shape[0], m.shape[1], device=m.device)
            try:
                return forward(self, x)
            finally:
                del self.shared.forward

        patch(dit.MoEFeedForward, "forward", without_shared)
    elif variant == "no-bias":
        route = dit.MoEFeedForward.route

        def unbiased(self, x):
            bias = self.e_score_correction_bias
            self.e_score_correction_bias = torch.zeros_like(bias)
            try:
                return route(self, x)
            finally:
                self.e_score_correction_bias = bias

        patch(dit.MoEFeedForward, "route", unbiased)
    elif variant not in ("program", "top5"):
        raise ValueError(f"unknown variant {variant!r}")
    try:
        yield
    finally:
        for (owner, name), value in saved.items():
            setattr(owner, name, value)


def program_config(cell, variant: str):
    """The program's ``Config`` of the cell, ``top5`` with one routed
    expert a token fewer."""
    from benchmark import harness

    cfg = harness.program_config(cell)
    if variant == "top5":
        cfg.model.transformer.num_experts_per_tok -= 1
    return cfg


def reading(cell, seed: int, variant: str, device) -> dict:
    """One seed's numbers under one variant."""
    import torch

    from benchmark import harness
    from benchmark.traffic import dit_cohort

    t0 = time.perf_counter()
    with fault(variant):
        state = dit_cohort.setup(cell, seed, device, cfg=program_config(cell, variant))
        rec = harness.Record()
        dit_cohort.window(state, 0.0, rec, traced=False)
    dit_cohort.release(state)
    numbers = dit_cohort.compare(state, rec)
    del state
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return {"cell": cell.name, "seed": seed, "variant": variant, "numbers": numbers,
            "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--variants", default="program")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    from benchmark import harness

    cell = harness.load_cell(args.workload)
    device = harness.check_device(cell.chips) if args.device == "cuda" else args.device
    variants = args.variants.split(",")
    unknown = set(variants) - set(VARIANTS)
    if unknown:
        raise SystemExit(f"unknown variants {sorted(unknown)}")
    out = open(args.out, "a") if args.out else None
    try:
        for seed in (int(s) for s in args.seeds.split(",")):
            for variant in variants:
                line = json.dumps(reading(cell, seed, variant, device))
                print(line, flush=True)
                if out:
                    out.write(line + "\n")
                    out.flush()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
