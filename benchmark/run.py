#!/usr/bin/env python3
"""Run one cell of the benchmark of the PyTorch/CUDA port on this machine.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cells, their configurations, mixes and metrics are in BENCHMARK.json
at the root of the checkout. The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones), ``device``
(with ``--trace 1`` also ``busy_s`` and ``window_s``), with ``--trace 1``
``breakdown``, and last ``checks``: each number compared with the plain
reference beside its limit, which also end standard error. It exits 3
without printing a result where no CUDA device (or fewer than the cell
asks for) is seen, and 4 where JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# The port builds its kernels once, into a fixed directory of its own inside
# the checkout (osteosarcoma_diffusionmodel_torch/_build). Libraries that
# could load JAX are told not to.
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from benchmark import harness

    cell = harness.load_cell(args.workload)
    try:
        harness.check_device(cell.chips)
    except harness.NoCard as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 3
    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"error: modules loaded in the run: {', '.join(found)}", file=sys.stderr)
        return 4
    for key, v in result["checks"].items():
        print(f"check {key} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
