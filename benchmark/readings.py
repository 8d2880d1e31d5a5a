#!/usr/bin/env python3
"""The readings that a cohort cell's limits are set from, in one process.

    python3 benchmark/readings.py --workload <cell> --seeds 1,2,3 \
        [--variants program,...] [--out FILE.jsonl]

For each seed and variant: the cell's set-up from that seed, its timed
path (the requests up to the judged one), the program freed, and every
number the comparison computes. Variants:

- ``program``: the program as the configuration states it (sound runs:
  the lower readings);
- ``int8-out``, ``int8-io``, ``int8-all``: the program with its own int8
  path (``generation.fused_quantize``), the precision below the
  configuration's bfloat16 (the control);
- ``tf32-calibration``: the reference's calibration with TF32 products
  in the program's place, judged against the reference at float32 with
  TF32 off (the calibration's control);
- ``prior-uniform``: a fault, x_T drawn uniform on [0, 1) instead of
  standard normal.

Each reading is one JSON line (cell, seed, variant, numbers, seconds).
Not part of a benchmark run; it runs on the card unless ``--device cpu``.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

VARIANTS = ("program", "int8-out", "int8-io", "int8-all", "tf32-calibration", "prior-uniform")


def reading(cell, seed: int, variant: str, device) -> dict:
    """One seed's numbers under one variant."""
    import torch

    from benchmark import harness
    from benchmark.reference.copula import TIE_SEED_OFFSET, calibrate_joint
    from benchmark.traffic import cohort
    from osteosarcoma_diffusionmodel_torch.ops import fused_sampler

    t0 = time.perf_counter()
    cfg = harness.program_config(cell)
    if variant.startswith("int8-"):
        cfg.generation.fused_quantize = variant.split("-", 1)[1]
    prior = fused_sampler.x_prior
    if variant == "prior-uniform":
        fused_sampler.x_prior = lambda batch, d, m, gen: torch.rand((batch, d), generator=gen,
                                                                    device=gen.device)
    try:
        state = cohort.setup(cell, seed, device, cfg=cfg)
        rec = harness.Record()
        cohort.window(state, 0.0, rec, traced=False)
    finally:
        fused_sampler.x_prior = prior
    cohort.release(state)
    numbers = cohort.compare(state, rec)
    if variant == "tf32-calibration":
        conf = cell.config["config"]
        real = cohort.reference_inputs(state)[0]
        m = cell.config["cohort"]["mutation_genes"]
        tie = conf["training"]["random_seed"] + TIE_SEED_OFFSET
        bits, cont = calibrate_joint(state.judged_raw, real, m, tie, tf32=False)
        bits32, cont32 = calibrate_joint(state.judged_raw, real, m, tie, tf32=True)
        numbers = {"bits_mismatch": float((bits32 != bits).float().mean())}
        numbers.update({f"calib_{k}": v
                        for k, v in cohort._rel_gaps(cont32, cont, center=True).items()})
    del state
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
