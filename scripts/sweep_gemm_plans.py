"""Device time of K1 and K6 at the sampler's product shapes under every
launch plan, beside ``gemm_plan``'s choice, on one NVIDIA card.

    python scripts/sweep_gemm_plans.py [--out FILE]

For each shape (333 and 999 rows: the input product, the output product,
the block products) and each plan (block width 64/128/256, 1-8 K splits)
the kernel's result is held to its plain version (K1: 1e-3, K6: 2^-22 of
max(1, |ref|)), then timed with CUDA events over 50 launches behind a
device sleep. Prints one line per shape: the automatic plan and its time,
then the eight fastest plans. The tool for tuning ``gemm_plan``'s model.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from osteosarcoma_diffusionmodel_torch.ops import _build  # noqa: E402
from osteosarcoma_diffusionmodel_torch.ops import sampler_kernels as sk  # noqa: E402

SHAPES = ((333, 5142, 256), (333, 256, 5142), (999, 256, 5142), (333, 256, 256),
          (333, 1024, 256), (999, 5142, 256))


def time_ms(fn, iters: int = 50) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    _build.LIBRARY.get()
    g = torch.Generator().manual_seed(0)

    def padded(m, n, dtype):
        return torch.zeros(m, sk.pad16(n), dtype=dtype, device=dev)[:, :n]

    report = {"card": card, "shapes": []}
    for kind in ("bf16", "int8"):
        for m, k, n in SHAPES:
            out = padded(m, n, torch.float32)
            if kind == "bf16":
                a = padded(m, k, torch.bfloat16)
                a.copy_(torch.randn(m, k, generator=g))
                w = padded(k, n, torch.bfloat16)
                w.copy_(torch.randn(k, n, generator=g) / math.sqrt(k))
                kk = k
                run = lambda p: sk.gemm_bf16_f32acc(a, w, out=out, plan=p)  # noqa: E731
                ref, rel = sk.gemm_bf16_f32acc_plain(a, w), 1e-3
            else:
                qa, rs = sk.rowquant_s8_plain(torch.randn(m, k, generator=g).to(dev))
                q, cs = sk.pack_int8(torch.randn(k, n, generator=g).numpy())
                qb, cs = sk.kmajor_int8(q).to(dev), cs.to(dev)
                kk = qa.shape[1]
                run = lambda p: sk.gemm_s8(qa, rs, qb, cs, out=out, plan=p)  # noqa: E731
                ref, rel = sk.gemm_s8_plain(qa, rs, qb, cs), 2.0 ** -22
            tol = rel * max(1.0, float(ref.abs().max()))
            times = []
            for bn in sk.GEMM_WIDTHS:
                for splits in (1, 2, 3, 4, 5, 8):
                    if splits > sk.k_tiles(kk, kind):
                        continue
                    plan = sk.GemmPlan(sk.GEMM_BM, bn, splits)
                    run(plan)
                    torch.cuda.synchronize()
                    err = float((out - ref).abs().max())
                    if err > tol:
                        raise AssertionError(f"{kind} {m}x{k}x{n} {plan}: max|diff| {err} > {tol}")
                    times.append((time_ms(lambda: run(plan)), bn, splits))
            times.sort()
            auto = sk.gemm_plan(m, n, kk, sms, kind)
            entry = {"kind": kind, "shape": [m, k, n], "auto": [auto.bn, auto.splits],
                     "auto_ms": time_ms(lambda: run(None)),
                     "best": [[bn, sp, t] for t, bn, sp in times[:8]]}
            report["shapes"].append(entry)
            print(f"{kind} {m}x{k}x{n}: auto {auto.bn}/{auto.splits} {entry['auto_ms']:.4f} ms; "
                  "fastest " + " ".join(f"{bn}/{sp} {t:.4f}" for t, bn, sp in times[:8]),
                  flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1))


if __name__ == "__main__":
    main()
