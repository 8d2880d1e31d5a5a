#!/usr/bin/env python3
"""The FVSBN (AR mutation head) ceiling study on the PyTorch port.

    [DEMO_N=400] [AR_L2=1e-5,1e-4,...] [AR_CTX_L2=0,1e-2,...] [AR_SEEDS=0,1,2,3,4] \
        python3 scripts/replay_ar_torch.py [--out REPLAY_AR_TORCH.json] [--device cpu]

Counterpart of scripts/replay_ar.py: the AR head's parameterization
(strictly-lower-triangular couplings W, a bias and a context MLP whose
output layer starts at zero; models/networks.py's ``ar_*`` parameters) fit
directly by full-batch Adam at 1e-2, in 100-step chunks, on the 320-row
train split of the ``DEMO_N`` = 400 structured cohort, and sampled
sequentially at 10,002 rows. It asks whether a joint run's co-occurrence
pattern correlation is the statistical ceiling of an L2-shrunk FVSBN at
this n, or a loss of the joint training.

The protocol is the JAX script's: the cohort of ``data/dummy.py`` (seed 0,
62/5054/26) through the pathways step and ``prepare_arrays``, the split
``train_val_split(n, 0.2, seed)``, the validator's metric (Yates chi-square
over the seeded 50-gene pair sample, correlated real against synthetic),
the objective CE + ``l2``·ΣW² (+ ``ctx_l2``·(Σc1² + Σc2²)). Contexts are
bootstrap-resampled real [pathways | conditions] rows, or none; the
baselines are a bootstrap of the real bits (the metric's noise ceiling) and
independent Bernoulli bits at the real frequencies (its floor). The cells
sweep ``AR_L2`` × ``AR_CTX_L2`` × context; a four-case ablation prices
the joint training's conditions (mixup 0.2, minibatch 32, the context's
L2). ``AR_SEEDS`` runs only the production setting (l2 1e-5, ctx_l2 1e-2,
mixup 0.2, batch 32) over fit and sampling seeds.

The record (the JAX record's keys with ``device``, the card's name and
power limit) goes to ``--out``: by default REPLAY_AR_TORCH.json, or
REPLAY_AR_SEEDS_TORCH.json under ``AR_SEEDS``, at the repo's root. The
study runs on the card; ``--device cpu`` runs it on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from pathlib import Path
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from osteosarcoma_diffusionmodel_torch.cli import (  # noqa: E402
    compute_pathway_features,
    default_device,
)
from osteosarcoma_diffusionmodel_torch.config import Config  # noqa: E402
from osteosarcoma_diffusionmodel_torch.data.dataset import (  # noqa: E402
    prepare_arrays,
    train_val_split,
)
from osteosarcoma_diffusionmodel_torch.data.dummy import (  # noqa: E402
    make_dummy_cohort,
    write_processed,
)
from osteosarcoma_diffusionmodel_torch.ops.discrete import bernoulli_cross_entropy  # noqa: E402
from osteosarcoma_diffusionmodel_torch.ops.stats import (  # noqa: E402
    chi2_binary_pairs,
    pearson_corr,
)
from osteosarcoma_diffusionmodel_torch.utils.quality import DIMS, device_stamp  # noqa: E402

M = 62  # mutation genes
N_GEN = 10002  # rows sampled a cell
CHUNK = 100  # Adam steps a chunk; chunk i draws its batches from seed 1000 + i
Params = Dict[str, torch.Tensor]


def validator_pairs(n_genes: int, max_genes: int = 50,
                    seed: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """The pair sample of ``BiologicalValidator`` (validation/validator.py:92-96)."""
    rng = np.random.default_rng(seed)
    n_sample = min(max_genes, n_genes)
    idx = rng.choice(n_genes, size=n_sample, replace=False)
    pi = [int(idx[i]) for i in range(n_sample) for j in range(i + 1, n_sample)]
    pj = [int(idx[j]) for i in range(n_sample) for j in range(i + 1, n_sample)]
    return torch.as_tensor(pi), torch.as_tensor(pj)


def chi2_corr(real_bits: np.ndarray, synth_bits: np.ndarray, pi: torch.Tensor,
              pj: torch.Tensor) -> float:
    return pearson_corr(
        chi2_binary_pairs(torch.as_tensor(np.asarray(real_bits, np.float32)), pi, pj),
        chi2_binary_pairs(torch.as_tensor(np.asarray(synth_bits, np.float32)), pi, pj))


def freq_corr(real_bits: np.ndarray, synth_bits: np.ndarray) -> float:
    return float(np.corrcoef(real_bits.mean(0), synth_bits.mean(0))[0, 1])


def init_params(generator: torch.Generator, ctx_dim: int, hidden: int = 64) -> Params:
    """The FVSBN's parameters on ``generator``'s device: W ~ 0.01·N(0, 1), a
    zero bias, the context MLP's first layer ~ N(0, 1/ctx_dim) and its
    output layer at zero (the context starts silent)."""
    dev = generator.device
    return {
        "W": 0.01 * torch.randn((M, M), generator=generator, device=dev),
        "b": torch.zeros(M, device=dev),
        "c1": torch.randn((ctx_dim, hidden), generator=generator, device=dev) / np.sqrt(ctx_dim),
        "c1b": torch.zeros(hidden, device=dev),
        "c2": torch.zeros((hidden, M), device=dev),
        "c2b": torch.zeros(M, device=dev),
    }


def _context_logits(params: Params, ctx: torch.Tensor) -> torch.Tensor:
    h = torch.nn.functional.silu(ctx @ params["c1"] + params["c1b"])
    return h @ params["c2"] + params["c2b"]


def ar_logits(params: Params, bits: torch.Tensor, ctx: torch.Tensor) -> torch.Tensor:
    """Teacher-forced logits (B, M): gene i sees the bits of genes < i."""
    w = torch.tril(params["W"], -1)
    return bits @ w.T + params["b"] + _context_logits(params, ctx)


def ce_loss(params: Params, bits: torch.Tensor, ctx: torch.Tensor, l2: float,
            ctx_l2: float = 0.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(CE + l2·ΣW² + ctx_l2·(Σc1² + Σc2²), CE); the L2 on the whole W, as in
    the JAX study."""
    ce = torch.mean(bernoulli_cross_entropy(ar_logits(params, bits, ctx), bits))
    reg = l2 * torch.sum(params["W"] ** 2) + ctx_l2 * (
        torch.sum(params["c1"] ** 2) + torch.sum(params["c2"] ** 2))
    return ce + reg, ce


def fit(bits_tr: torch.Tensor, ctx_tr: torch.Tensor, bits_va: torch.Tensor,
        ctx_va: torch.Tensor, l2: float, ctx_l2: float = 0.0, lr: float = 1e-2,
        steps: int = 6000, seed: int = 0, mixup_alpha: float = 0.0, batch: int = 0,
        params: Optional[Params] = None) -> Tuple[Params, float, float]:
    """Adam at ``lr`` for ``steps`` steps from ``init_params`` of seed
    ``seed`` (or from ``params``); returns the FINAL parameters and their
    train and validation CE (no best-validation snapshot: joint training
    gives the AR branch its constant-rate steps to the end). ``batch``
    rows a step without replacement (0: the whole split); ``mixup_alpha``
    mixes each step's rows, bits included, with one Beta(α, α) lambda and
    a permutation, as the trainer's mixup does. Chunk i of 100 steps draws
    from seed 1000 + i (the batches from a generator on the data's
    device, lambda from numpy), whatever ``seed`` is."""
    dev = bits_tr.device
    if params is None:
        params = init_params(torch.Generator(dev).manual_seed(seed), ctx_tr.shape[1])
    params = {k: v.detach().clone().to(dev).requires_grad_(True) for k, v in params.items()}
    opt = torch.optim.Adam(list(params.values()), lr=lr, betas=(0.9, 0.999), eps=1e-8)
    n_tr = bits_tr.shape[0]
    for chunk in range(steps // CHUNK):
        gen = torch.Generator(dev).manual_seed(1000 + chunk)
        rng = np.random.default_rng(1000 + chunk)
        for _ in range(CHUNK):
            b, c = bits_tr, ctx_tr
            if batch:
                idx = torch.randperm(n_tr, generator=gen, device=dev)[:batch]
                b, c = b[idx], c[idx]
            if mixup_alpha > 0:
                lam = float(np.float32(rng.beta(mixup_alpha, mixup_alpha)))
                perm = torch.randperm(b.shape[0], generator=gen, device=dev)
                b = lam * b + (1.0 - lam) * b[perm]
                c = lam * c + (1.0 - lam) * c[perm]
            opt.zero_grad(set_to_none=True)
            ce_loss(params, b, c, l2, ctx_l2)[0].backward()
            opt.step()
    params = {k: v.detach() for k, v in params.items()}
    with torch.no_grad():
        tr_ce = float(ce_loss(params, bits_tr, ctx_tr, 0.0)[1])
        va_ce = float(ce_loss(params, bits_va, ctx_va, 0.0)[1])
    return params, tr_ce, va_ce


@torch.no_grad()
def sample(params: Params, ctx: torch.Tensor, generator: Optional[torch.Generator] = None,
           uniforms: Optional[torch.Tensor] = None) -> np.ndarray:
    """The sequential FVSBN draw (``ConditionalDiffusion.ar_sample``'s
    loop): gene i's bits are ``u[:, i] < sigmoid(logit_i)`` with
    ``uniforms`` (B, M), or uniforms drawn from ``generator``."""
    dev = params["W"].device
    w = torch.tril(params["W"], -1)
    ctx_logits = _context_logits(params, ctx.to(dev))
    rows = ctx.shape[0]
    if uniforms is None:
        uniforms = torch.rand((rows, M), generator=generator, device=generator.device)
    u = uniforms.to(dev, torch.float32)
    bits = torch.zeros((rows, M), device=dev)
    for i in range(M):
        logit = bits @ w[i] + params["b"][i] + ctx_logits[:, i]
        bits[:, i] = (u[:, i] < torch.sigmoid(logit)).float()
    return bits.cpu().numpy()


def cohort(n: int, dims: Tuple[int, int, int] = DIMS) -> Tuple[np.ndarray, np.ndarray]:
    """(bits, [pathways | conditions] context) of the seed-0 structured
    cohort after the pathways step and ``prepare_arrays``."""
    with tempfile.TemporaryDirectory(prefix="osdm_replay_ar_") as tmp:
        cfg = Config()
        cfg.data.processed_dir = str(Path(tmp) / "processed")
        write_processed(make_dummy_cohort(n, *dims, seed=0), cfg.data.processed_dir)
        compute_pathway_features(cfg)
        arrays, adims = prepare_arrays(cfg)
    data = np.asarray(arrays.data, np.float32)  # [mut | expr | pathways]
    conds = np.asarray(arrays.conditions, np.float32)
    return data[:, :M], np.concatenate([data[:, -adims.pathway_dim:], conds], axis=1)


def _cell(bits, ctx, tr_idx, va_idx, pi, pj, boot, device, sample_seed, **kw) -> dict:
    """Fit on the train rows, sample at the bootstrap's contexts, score."""
    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    params, tr_ce, va_ce = fit(t(bits[tr_idx]), t(ctx[tr_idx]), t(bits[va_idx]), t(ctx[va_idx]),
                               **kw)
    synth = sample(params, t(ctx[boot]), torch.Generator(device).manual_seed(sample_seed))
    return {"train_ce": tr_ce, "val_ce": va_ce, "chi2_corr": chi2_corr(bits, synth, pi, pj),
            "freq_corr": freq_corr(bits, synth)}


def run(device: str, n: int = 400, env: Mapping[str, str] = os.environ,
        dims: Tuple[int, int, int] = DIMS, steps: int = 6000) -> dict:
    """The study on ``device``; returns the record. ``env`` holds AR_L2,
    AR_CTX_L2 and AR_SEEDS."""
    t0 = time.time()
    bits, ctx_full = cohort(n, dims)
    tc = Config().training
    tr_idx, va_idx = train_val_split(n, tc.val_split, tc.random_seed)
    pi, pj = validator_pairs(M)
    boot = np.random.default_rng(7).integers(0, n, size=N_GEN)
    results = {"device": device_stamp(device), "n": n, "train_rows": len(tr_idx)}
    results["bootstrap_real_chi2_corr"] = chi2_corr(bits, bits[boot], pi, pj)
    indep = (np.random.default_rng(11).random((N_GEN, M)) < bits.mean(0)[None, :]).astype(
        np.float32)
    results["independent_chi2_corr"] = chi2_corr(bits, indep, pi, pj)
    common = dict(bits=bits, tr_idx=tr_idx, va_idx=va_idx, pi=pi, pj=pj, boot=boot,
                  device=device, steps=steps)

    if "AR_SEEDS" in env:  # the production setting over fit and sampling seeds
        seeds = [int(s) for s in env["AR_SEEDS"].split(",")]
        ccs = []
        for s in seeds:
            cell = _cell(ctx=ctx_full, sample_seed=100 + s, l2=1e-5, ctx_l2=1e-2,
                         mixup_alpha=0.2, batch=32, seed=s, **common)
            ccs.append(cell["chi2_corr"])
            print(f"seed {s}: chi2_corr={cell['chi2_corr']:.3f} "
                  f"freq_corr={cell['freq_corr']:.3f}", flush=True)
        results["seed_sweep"] = {"seeds": seeds, "chi2_corrs": ccs,
                                 "mean": float(np.mean(ccs)), "sd": float(np.std(ccs))}
        print(f"seed sweep: mean={np.mean(ccs):.3f} sd={np.std(ccs):.3f}")
        results["elapsed_sec"] = time.time() - t0
        return results

    l2s = [float(x) for x in env.get("AR_L2", "1e-5,1e-4,1e-3,3e-3").split(",")]
    ctx_l2s = [float(x) for x in env.get("AR_CTX_L2", "0,1e-3,1e-2,1e-1").split(",")]
    cells = {}
    for mode in ("pathways", "none"):
        ctx = ctx_full if mode == "pathways" else np.zeros((n, 1), np.float32)
        for l2 in l2s:
            for ctx_l2 in ctx_l2s if mode != "none" else [0.0]:
                cell = _cell(ctx=ctx, sample_seed=3, l2=l2, ctx_l2=ctx_l2, **common)
                cells[f"{mode}/l2={l2:g}/ctx_l2={ctx_l2:g}"] = cell
                print(f"{mode:9s} l2={l2:<8g} ctx_l2={ctx_l2:<8g} "
                      f"train_ce={cell['train_ce']:.4f} val_ce={cell['val_ce']:.4f} "
                      f"chi2_corr={cell['chi2_corr']:.3f} "
                      f"freq_corr={cell['freq_corr']:.3f}", flush=True)
    results["cells"] = cells

    # What each condition of the joint training costs: (a) as the trainer
    # runs (mixup 0.2, batch 32, an unregularized context MLP), (b) + the
    # context's L2, (c) without mixup, (d) both.
    ablate = {}
    for name, kw in {
        "joint_faithful": dict(mixup_alpha=0.2, batch=32, ctx_l2=0.0),
        "fix_ctx_l2": dict(mixup_alpha=0.2, batch=32, ctx_l2=1e-2),
        "fix_mixup": dict(mixup_alpha=0.0, batch=32, ctx_l2=0.0),
        "fix_both": dict(mixup_alpha=0.0, batch=32, ctx_l2=1e-2),
    }.items():
        ablate[name] = _cell(ctx=ctx_full, sample_seed=3, l2=1e-5, **kw, **common)
        print(f"ablate {name:16s} train_ce={ablate[name]['train_ce']:.4f} "
              f"val_ce={ablate[name]['val_ce']:.4f} chi2_corr={ablate[name]['chi2_corr']:.3f} "
              f"freq_corr={ablate[name]['freq_corr']:.3f}", flush=True)
    results["joint_condition_ablation"] = ablate
    results["elapsed_sec"] = time.time() - t0
    print(f"bootstrap ceiling={results['bootstrap_real_chi2_corr']:.3f} "
          f"independence floor={results['independent_chi2_corr']:.3f}")
    return results


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", default=None, help="the record's path (default: "
                        "REPLAY_AR_TORCH.json, or REPLAY_AR_SEEDS_TORCH.json under AR_SEEDS)")
    parser.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = parser.parse_args(argv)
    device = args.device or default_device()
    out = Path(args.out or REPO / ("REPLAY_AR_SEEDS_TORCH.json" if "AR_SEEDS" in os.environ
                                  else "REPLAY_AR_TORCH.json"))
    results = run(device, n=int(os.environ.get("DEMO_N", 400)))
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(results, indent=2) + "\n")
    print(f"wrote {out} in {results['elapsed_sec']:.0f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
