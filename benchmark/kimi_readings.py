#!/usr/bin/env python3
"""The readings that the hybrid cell's limits are set from, in one process.

    python3 benchmark/kimi_readings.py --workload kimi-linear-dit-ddim50-3x2 --seeds 1,2,3 \
        [--variants program,scalar-decay,no-delta,bf16-state,rope-mla,top8-held,fp8-experts] \
        [--out FILE.jsonl]

For each seed and variant: the cell's set-up from that seed, its timed
path up to the judged request, the program freed, and every number the
comparison computes (``benchmark/traffic/kimi_dit_cohort.py``). Variants:

- ``program``: the program as the configuration states it (sound runs);
- ``scalar-decay``: KDA's decay one value a head (the mean of g over the
  head's channels) in place of one a key channel;
- ``no-delta``: the delta correction dropped (``β k kᵀ`` left out: a gated
  linear attention, ``S_t = Diag(exp g_t) S_{t−1} + β_t k_t v_tᵀ``);
- ``bf16-state``: the KDA state carried from chunk to chunk in bf16;
- ``rope-mla``: RoPE applied in the MLA layers (``mla_use_nope`` ignored);
- ``top8-held``: the router's top 8 taken over the 64 held experts only;
- ``fp8-experts``: the routed experts' products on operands rounded to fp8
  (``benchmark/dit_readings.py``'s control).

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

VARIANTS = ("program", "scalar-decay", "no-delta", "bf16-state", "rope-mla", "top8-held",
            "fp8-experts")


def chunked_variant(q, k, v, g, beta, scale, delta: bool = True, state_dtype=None,
                    chunk: int = 64):
    """The chunked algebra of ``ops/kda.kda_chunk_plain`` in f32, without the
    delta correction (``delta`` false: no ``(I + A)⁻¹`` and no ``− W S``),
    or with the state rounded to ``state_dtype`` after every chunk."""
    import torch
    import torch.nn.functional as F

    b, length, heads, dk = q.shape
    dv = v.shape[-1]
    n = -(-length // chunk)
    pad = n * chunk - length

    def chunks(x):
        x = F.pad(x.float(), (0, 0) * (x.dim() - 2) + (0, pad))
        x = x.view(b, n, chunk, heads, *x.shape[3:])
        return x.permute(0, 3, 1, 2, *range(4, x.dim()))

    qc, kc, vc, bc = chunks(q), chunks(k), chunks(v), chunks(beta)
    gamma = chunks(g).cumsum(dim=3)
    lower = torch.ones(chunk, chunk, dtype=torch.bool, device=q.device).tril()
    eye = torch.eye(chunk, device=q.device)
    state = q.new_zeros(b, heads, dk, dv, dtype=torch.float32)
    outs = []
    for c in range(n):
        qi, ki, vi, bi, gi = qc[:, :, c], kc[:, :, c], vc[:, :, c], bc[:, :, c], gamma[:, :, c]
        e = torch.exp((gi[..., :, None, :] - gi[..., None, :, :]).masked_fill(~lower[..., None],
                                                                              float("-inf")))
        ke = ki[..., None, :, :] * e
        p = (qi[..., :, None, :] * ke).sum(-1) * scale
        decay = torch.exp(gi)
        if delta:
            a = ((ki[..., :, None, :] * ke).sum(-1) * bi[..., :, None]).masked_fill(
                ~lower.tril(-1), 0.0)
            rhs = torch.cat([bi[..., None] * ki * decay, bi[..., None] * vi], dim=-1)
            w, u = torch.linalg.solve_triangular(eye + a, rhs, upper=False,
                                                 unitriangular=True).split([dk, dv], dim=-1)
            u = u - w @ state
        else:
            u = bi[..., None] * vi
        outs.append((qi * decay * scale) @ state + p @ u)
        end = gi[..., -1, :]
        state = (torch.exp(end)[..., :, None] * state
                 + (ki * torch.exp(end[..., None, :] - gi)).transpose(-1, -2) @ u)
        if state_dtype is not None:
            state = state.to(state_dtype).float()
    o = torch.stack(outs, dim=2)
    return o.permute(0, 2, 3, 1, 4).reshape(b, n * chunk, heads, dv)[:, :length].contiguous()


@contextlib.contextmanager
def fault(variant: str):
    """The program changed as ``variant`` says, for the block."""
    import torch

    from benchmark import dit_readings
    from osteosarcoma_diffusionmodel_torch.models import dit
    from osteosarcoma_diffusionmodel_torch.ops import kda as kda_ops

    saved = {}

    def patch(owner, name, value):
        saved[(owner, name)] = getattr(owner, name)
        setattr(owner, name, value)

    inner = kda_ops.kda_chunk
    if variant == "scalar-decay":
        def scalar(q, k, v, g, beta, scale):
            return inner(q, k, v, g.mean(-1, keepdim=True).expand_as(g).contiguous(), beta, scale)

        patch(kda_ops, "kda_chunk", scalar)
    elif variant == "no-delta":
        patch(kda_ops, "kda_chunk",
              lambda q, k, v, g, beta, scale: chunked_variant(q, k, v, g, beta, scale, delta=False))
    elif variant == "bf16-state":
        patch(kda_ops, "kda_chunk",
              lambda q, k, v, g, beta, scale: chunked_variant(q, k, v, g, beta, scale,
                                                              state_dtype=torch.bfloat16))
    elif variant == "rope-mla":
        forward = dit.MLAttention.forward

        def rotary(self, a, rope):
            self.rotary = True
            try:
                return forward(self, a, rope)
            finally:
                self.rotary = False

        patch(dit.MLAttention, "forward", rotary)
    elif variant == "top8-held":
        route = dit.MoEFeedForward.route

        def held_only(self, x):
            bias = self.e_score_correction_bias
            kept = torch.full_like(bias, float("-inf"))
            kept[self.first:self.first + self.held] = bias[self.first:self.first + self.held]
            self.e_score_correction_bias = kept
            try:
                return route(self, x)
            finally:
                self.e_score_correction_bias = bias

        patch(dit.MoEFeedForward, "route", held_only)
    elif variant not in ("program", "fp8-experts"):
        raise ValueError(f"unknown variant {variant!r}")
    with dit_readings.fault("fp8-experts" if variant == "fp8-experts" else "program"):
        try:
            yield
        finally:
            for (owner, name), value in saved.items():
                setattr(owner, name, value)


def reading(cell, seed: int, variant: str, device) -> dict:
    """One seed's numbers under one variant."""
    import torch

    from benchmark import harness
    from benchmark.traffic import kimi_dit_cohort

    t0 = time.perf_counter()
    with fault(variant):
        state = kimi_dit_cohort.setup(cell, seed, device)
        rec = harness.Record()
        kimi_dit_cohort.window(state, 0.0, rec, traced=False)
    kimi_dit_cohort.release(state)
    numbers = kimi_dit_cohort.compare(state, rec)
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
