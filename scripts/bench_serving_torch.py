#!/usr/bin/env python3
"""Serving latency of the PyTorch port on one NVIDIA card.

    python3 scripts/bench_serving_torch.py [--out SERVING_SLA_TORCH.json] \
        [--checkpoint-dir DIR] [--requests 20]

The port's counterpart of scripts/bench_serving.py (which stays the JAX
package's script and its SERVING_SLA.json). It starts the port's server
(``serving/server.py``) in this process on 127.0.0.1 at an ephemeral
port, from ``--checkpoint-dir`` or, without one, from weights made from
seed 0 at full width (data 62/5054/26, hidden 256/512/256, T = 1000) with
the seeded structured cohort's data statistics: latency does not depend
on training. The server builds the kernels and warms every (bucket,
sampler) pair, buckets 1, 64 and 1,024 under DDPM and DDIM, before its
socket opens. Then, per pair, ``--requests``
POST /generate requests of exactly the bucket's rows, one at a time from
an HTTP client: JSON up to 64 rows, npz above (the JSON cap is 1,024
rows). Per pair it records p50, p95 and max of the client's seconds
(request sent to the last byte read), the response's size, and the
calibration backend the requests took. It reads /health and /metrics
back, and the kernels' launches by kernel and mode during the timed
requests (the counts are set to 0 after the warmup). The result names
the card and its power limit as nvidia-smi prints them.

Two booleans are computed from the pairs and named for what they test:
``every_pair_p95_under_1s`` and ``pairs_up_to_64_rows_p95_under_1s``. No
latency is a target taken from another device. The bench runs on the
card; without one it raises.
"""

from __future__ import annotations

import argparse
import http.client
import io
import json
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from osteosarcoma_diffusionmodel_torch.config import Config  # noqa: E402
from osteosarcoma_diffusionmodel_torch.data.dummy import make_dummy_cohort  # noqa: E402
from osteosarcoma_diffusionmodel_torch.generation import generator as gen_module  # noqa: E402
from osteosarcoma_diffusionmodel_torch.serving.server import serve  # noqa: E402
from osteosarcoma_diffusionmodel_torch.utils.card import (  # noqa: E402
    KERNELS,
    SERVE_BUCKETS,
    card_line,
    seeded_checkpoint,
)

DATA_DIMS = (62, 5054, 26)
SAMPLERS = ("ddpm", "ddim")
JSON_ROWS_MAX = 64  # larger buckets ask for npz
SCENARIO = {"survival_time": 800, "event_occurred": 0, "metastasis_at_diagnosis": 0}


def _get(conn, route: str) -> dict:
    conn.request("GET", route)
    resp = conn.getresponse()
    body = resp.read()
    if resp.status != 200:
        raise RuntimeError(f"GET {route}: {resp.status} {body[:200]!r}")
    return json.loads(body)


def _generate(conn, rows: int, sampler: str, fmt: str) -> tuple:
    """One POST /generate; (seconds, response bytes). The response is
    decoded and its shape checked outside the timed span."""
    body = json.dumps({"num_samples": rows, "scenario": SCENARIO, "sampler": sampler,
                       "format": fmt})
    t0 = time.perf_counter()
    conn.request("POST", "/generate", body=body, headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    payload = resp.read()
    seconds = time.perf_counter() - t0
    if resp.status != 200:
        raise RuntimeError(f"POST /generate {rows} {sampler} {fmt}: {resp.status} "
                           f"{payload[:200]!r}")
    if fmt == "npz":
        with np.load(io.BytesIO(payload)) as f:
            out = {k: f[k] for k in f.files}
    else:
        out = {k: np.asarray(v) for k, v in json.loads(payload).items() if k != "num_samples"}
    width = sum(out[k].shape[1] for k in ("mutations", "expression", "pathways"))
    if out["expression"].shape[0] != rows or not np.isfinite(out["expression"]).all():
        raise RuntimeError(f"{sampler} b{rows}: expression {out['expression'].shape}, finite "
                           f"{np.isfinite(out['expression']).all()}")
    if not np.isin(out["mutations"], (0.0, 1.0)).all():
        raise RuntimeError(f"{sampler} b{rows}: mutations are not bits")
    return seconds, len(payload), width


def run(checkpoint_dir: Path, requests: int) -> dict:
    t0 = time.perf_counter()
    server = serve(checkpoint_dir, host="127.0.0.1", port=0, warmup=list(SERVE_BUCKETS),
                   warmup_samplers=list(SAMPLERS))
    startup = time.perf_counter() - t0
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", server.server_address[1], timeout=600)
        health = _get(conn, "/health")
        for k in KERNELS:
            k.reset()
        gen_module.CALIBRATIONS.clear()
        pairs = {}
        for sampler in SAMPLERS:
            for rows in SERVE_BUCKETS:
                fmt = "json" if rows <= JSON_ROWS_MAX else "npz"
                before = dict(gen_module.CALIBRATIONS)
                times, size, width = [], 0, 0
                for _ in range(requests):
                    seconds, size, width = _generate(conn, rows, sampler, fmt)
                    times.append(seconds)
                took = {b: n - before.get(b, 0) for b, n in gen_module.CALIBRATIONS.items()
                        if n - before.get(b, 0)}
                pairs[f"{sampler}_b{rows}"] = {
                    "rows": rows, "sampler": sampler, "format": fmt, "width": width,
                    "p50_seconds": float(np.percentile(times, 50)),
                    "p95_seconds": float(np.percentile(times, 95)),
                    "max_seconds": float(np.max(times)),
                    "payload_mb": size / 2**20,
                    "calibrations": took,
                }
        torch.cuda.synchronize()
        launches = {k.name: {m: n for m, n in k.modes.items() if n} for k in KERNELS if k.launches}
        metrics = _get(conn, "/metrics")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    small = [p for p in pairs.values() if p["rows"] <= JSON_ROWS_MAX]
    return {
        "device": {"kind": torch.cuda.get_device_name(0), "nvidia_smi": card_line(),
                   "torch": torch.__version__},
        "protocol": (f"scripts/bench_serving_torch.py: {requests} HTTP requests a pair, one at "
                     f"a time, after the warmup; JSON up to {JSON_ROWS_MAX} rows, npz above"),
        "requests_per_pair": requests,
        "startup_seconds": startup,
        "health": health,
        "pairs": pairs,
        "service_metrics": metrics,
        "launches": launches,
        "every_pair_p95_under_1s": all(p["p95_seconds"] < 1.0 for p in pairs.values()),
        "pairs_up_to_64_rows_p95_under_1s": all(p["p95_seconds"] < 1.0 for p in small),
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", default="SERVING_SLA_TORCH.json")
    parser.add_argument("--checkpoint-dir", default=None,
                        help="a port checkpoint (default: seeded weights at full width)")
    parser.add_argument("--requests", type=int, default=20)
    args = parser.parse_args(argv)
    with tempfile.TemporaryDirectory(prefix="osdm_serve_bench_") as tmp:
        ckpt = Path(args.checkpoint_dir) if args.checkpoint_dir else seeded_checkpoint(
            Path(tmp) / "checkpoint", Config(), make_dummy_cohort(100, *DATA_DIMS, seed=0))
        report = run(ckpt, args.requests)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(report, indent=1) + "\n")
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
