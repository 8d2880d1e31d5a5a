"""Device time of K1 and K6 at the sampler's product shapes under every
launch plan, beside ``gemm_plan``'s choice, on one NVIDIA card.

    python scripts/sweep_gemm_plans.py [--out FILE]

For each shape (333 and 999 rows: the input product, the output product,
the block products) and each plan (block width 64/128/256, 1-8 K splits)
the kernel's result is held to its plain version (K1: 1e-3, K6: 2^-22 of
max(1, |ref|)), then timed with CUDA events over 50 launches behind a
device sleep. Prints one line per shape: the automatic plan and its time,
then the eight fastest plans. Then the same for the fused epilogues: the
block products with GroupNorm+SiLU (every width that holds whole groups;
2^-7 of max(1, |ref|)) and the output product with the posterior step in
"philox" mode (every width it is built at; the continuous carry within
2^-7 of the plain composition). The tool for tuning ``gemm_plan``'s model
and the widths the posterior epilogue is built at.
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
# The block products of a step at 333 rows (hidden 256/512/256) and the
# latent stack's at 999; the output product at both row counts.
GN_SHAPES = ((333, 256, 512), (333, 512, 512), (333, 512, 256), (333, 256, 256),
             (333, 1024, 256), (999, 256, 512), (999, 1024, 256))
POSTERIOR_SHAPES = ((333, 256, 5142), (999, 256, 5142))
SPLITS = (1, 2, 3, 4, 5, 8)


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


def sweep(run, check, kind: str, k: int, widths, auto) -> dict:
    """Every plan of ``widths`` x SPLITS that K allows: run once and
    checked by ``check(plan)``, then timed."""
    times = []
    for bn in widths:
        for splits in SPLITS:
            if splits > sk.k_tiles(k, kind):
                continue
            plan = sk.GemmPlan(sk.GEMM_BM, bn, splits)
            check(plan)
            times.append((time_ms(lambda: run(plan)), bn, splits))
    times.sort()
    return {"auto": [auto.bn, auto.splits], "auto_ms": time_ms(lambda: run(None)),
            "best": [[bn, sp, t] for t, bn, sp in times[:8]]}


def _line(label: str, entry: dict) -> str:
    auto = entry["auto"]
    return (f"{label}: auto {auto[0]}/{auto[1]} {entry['auto_ms']:.4f} ms; fastest "
            + " ".join(f"{bn}/{sp} {t:.4f}" for bn, sp, t in entry["best"]))


def sweep_fused(dev, sms: int, g) -> list:
    """The GN and posterior epilogues of K1 and K6 under every plan they take."""
    out = []

    def operands(kind, m, k, n):
        a = torch.randn(m, k, generator=g).to(dev, torch.bfloat16)
        if kind == "bf16":
            w = torch.zeros(k, sk.pad16(n), dtype=torch.bfloat16, device=dev)[:, :n]
            w.copy_(torch.randn(k, n, generator=g) / math.sqrt(k))
            return (a, w), sk.gemm_bf16_f32acc_plain(a, w), k
        qa, rs = sk.rowquant_s8_plain(a)
        q, cs = sk.pack_int8((torch.randn(k, n, generator=g) / math.sqrt(k)).numpy())
        ops = (qa, rs, sk.kmajor_int8(q).to(dev), cs.to(dev))
        return ops, sk.gemm_s8_plain(*ops), qa.shape[1]

    for kind in ("bf16", "int8"):
        gn = sk.gemm_bf16_gn_silu if kind == "bf16" else sk.gemm_s8_gn_silu
        post = sk.gemm_bf16_posterior if kind == "bf16" else sk.gemm_s8_posterior
        for m, k, n in GN_SHAPES:
            ops, acc, kk = operands(kind, m, k, n)
            bias, scale, shift = (torch.randn(n, generator=g).to(dev) for _ in range(3))
            res = torch.empty(m, n, dtype=torch.bfloat16, device=dev)
            ref = sk.groupnorm8_silu_plain(acc + bias, scale, shift).to(torch.bfloat16).float()
            tol = 2.0 ** -7 * max(1.0, float(ref.abs().max()))

            def run(p, ops=ops, bias=bias, scale=scale, shift=shift, res=res):
                gn(*ops, bias, scale, shift, out=res, plan=p)

            def check(p, ref=ref, tol=tol, res=res, run=run):
                run(p)
                torch.cuda.synchronize()
                err = float((res.float() - ref).abs().max())
                if err > tol:
                    raise AssertionError(f"{kind} GN {m}x{k}x{n} {p}: max|diff| {err} > {tol}")

            widths = sk.gn_widths(n)
            entry = sweep(run, check, kind, kk, widths, sk.gemm_plan(m, n, kk, sms, kind, widths))
            entry.update(kind=kind, epilogue="gn_silu", shape=[m, k, n])
            out.append(entry)
            print(_line(f"{kind}+gn_silu {m}x{k}x{n}", entry), flush=True)
        for m, k, n in POSTERIOR_SHAPES:
            ops, acc, kk = operands(kind, m, k, n)
            x0 = torch.zeros(m, sk.pad16(n), dtype=torch.bfloat16, device=dev)[:, :n]
            x0.copy_(torch.randn(m, n, generator=g))
            x = x0.clone()
            b_out = torch.randn(n, generator=g).to(dev)
            coeffs = (torch.rand(3, 6, generator=g) + 0.1).to(dev)
            step = dict(b_out=b_out, coeffs=coeffs, step=1, mode="philox", seed=7)
            ref = sk.x0_posterior_step_plain(acc, x0, b_out, coeffs, 1, "philox", seed=7).float()
            tol = 2.0 ** -7 * max(1.0, float(ref.abs().max()))

            def run(p, ops=ops, x=x, step=step):
                post(*ops, x, **step, plan=p)

            def check(p, ref=ref, tol=tol, x=x, x0=x0, run=run):
                x.copy_(x0)  # the step updates the carry in place
                run(p)
                torch.cuda.synchronize()
                err = float((x.float() - ref).abs().max())
                if err > tol:
                    raise AssertionError(f"{kind} posterior {m}x{k}x{n} {p}: max|diff| {err}")

            widths = sk.POSTERIOR_WIDTHS
            entry = sweep(run, check, kind, kk, widths, sk.gemm_plan(m, n, kk, sms, kind, widths))
            entry.update(kind=kind, epilogue="posterior philox", shape=[m, k, n])
            out.append(entry)
            print(_line(f"{kind}+posterior {m}x{k}x{n}", entry), flush=True)
    return out


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

            def check(plan, out=out, ref=ref, tol=tol, run=run):
                run(plan)
                torch.cuda.synchronize()
                err = float((out - ref).abs().max())
                if err > tol:
                    raise AssertionError(f"{kind} {m}x{k}x{n} {plan}: max|diff| {err} > {tol}")

            entry = sweep(run, check, kind, kk, sk.GEMM_WIDTHS, sk.gemm_plan(m, n, kk, sms, kind))
            entry.update(kind=kind, shape=[m, k, n])
            report["shapes"].append(entry)
            print(_line(f"{kind} {m}x{k}x{n}", entry), flush=True)
    report["fused"] = sweep_fused(dev, sms, g)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1))


if __name__ == "__main__":
    main()
