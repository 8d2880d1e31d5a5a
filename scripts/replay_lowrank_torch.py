#!/usr/bin/env python3
"""The low-rank correlated-sigma diagnosis, replayed on a demo's work
directory with the PyTorch port.

    python3 scripts/replay_lowrank_torch.py WORKDIR [--out REPLAY.json] [--device cpu]

Counterpart of scripts/replay_lowrank.py. ``WORKDIR`` is one that
``DEMO_LOWRANK_K=8 DEMO_LOWRANK_SCOPE=mutations
scripts/demo_full_scale_torch.py`` made (it prints ``workdir: <path>``):
its ``processed/`` tables and the port's ``ckpt/best_model.npz``. The
script

1. freezes the trained mean model and fits only the covariance
   parameters (``lowrank_U``, ``lowrank_logdiag``, ``lowrank_logs``) by the
   natural-scale Woodbury NLL (``lowrank_sigma_nll`` x data dim of
   ``ConditionalDiffusion.loss`` in eval mode, constraints off) with plain
   Adam at 3e-2 for 3,001 full-batch steps: the fit the trainer's is
   judged against;
2. prints the fitted factors' geometry: U's row norms and s(t) at t = 0,
   10, 100, 500, 999 (small at low t, large at high t where the residual
   is the bits');
3. samples 5,000 rows (the cohort's conditions tiled) by the DDPM scan
   loop with the loadings scaled by alpha in {1, 2, 4, 8} and prints the
   co-occurrence pattern correlation (the cohort's mutation correlation
   matrix against the thresholded bits', upper triangles) and the
   frequency correlation: the ceiling of the noise-injection channel,
   whatever the fit.

The lines are the JAX script's; ``--out`` also writes the numbers as JSON
with the card's name and power limit. It runs on the card; ``--device
cpu`` runs it on the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from osteosarcoma_diffusionmodel_torch.cli import default_device  # noqa: E402
from osteosarcoma_diffusionmodel_torch.config import Config  # noqa: E402
from osteosarcoma_diffusionmodel_torch.data.dataset import prepare_arrays  # noqa: E402
from osteosarcoma_diffusionmodel_torch.models.constraints import (  # noqa: E402
    mutation_corr_matrix,
)
from osteosarcoma_diffusionmodel_torch.models.diffusion import ConditionalDiffusion  # noqa: E402
from osteosarcoma_diffusionmodel_torch.training.checkpoint import load_weights  # noqa: E402
from osteosarcoma_diffusionmodel_torch.utils.quality import device_stamp  # noqa: E402

STEPS = 3001
LR = 3e-2
LOG_EVERY = 500
S_STEPS = (0, 10, 100, 500, 999)
ALPHAS = (1.0, 2.0, 4.0, 8.0)
ROWS = 5000


def covariance_optimizer(model: ConditionalDiffusion, lr: float = LR) -> torch.optim.Adam:
    """Plain Adam over the ``lowrank_*`` parameters; every other parameter
    is frozen (no gradient, no update, no weight decay)."""
    cov = []
    for name, p in model.denoiser.named_parameters():
        p.requires_grad_(name.startswith("lowrank"))
        if name.startswith("lowrank"):
            cov.append(p)
    return torch.optim.Adam(cov, lr=lr, betas=(0.9, 0.999), eps=1e-8)


def fit_step(model: ConditionalDiffusion, opt: torch.optim.Optimizer, x0: torch.Tensor,
             cond: torch.Tensor, data_dim: int, generator: Optional[torch.Generator] = None,
             **draws: torch.Tensor) -> torch.Tensor:
    """One Adam step on ``lowrank_sigma_nll`` x ``data_dim``; ``draws`` (t,
    noise) replace the loss's draws from ``generator``. Returns the loss
    before the step."""
    opt.zero_grad(set_to_none=True)
    _, metrics = model.loss(x0, cond, generator, **draws)
    loss = metrics["lowrank_sigma_nll"] * data_dim
    loss.backward()
    opt.step()
    return loss.detach()


def fit(model: ConditionalDiffusion, x0: torch.Tensor, cond: torch.Tensor, data_dim: int,
        generator: torch.Generator, steps: int = STEPS) -> Dict[int, float]:
    """The covariance fit; prints and returns the loss every 500 steps."""
    opt = covariance_optimizer(model)
    logged = {}
    t0 = time.time()
    for i in range(steps):
        loss = fit_step(model, opt, x0, cond, data_dim, generator)
        if i % LOG_EVERY == 0:
            logged[i] = float(loss)
            print(f"step {i} nll {logged[i]:.2f} ({time.time() - t0:.0f}s)", flush=True)
    return logged


def geometry(model: ConditionalDiffusion) -> Tuple[np.ndarray, List[float]]:
    """U's row norms and s(t) = exp(log_s) at ``S_STEPS``."""
    d = model.denoiser
    norms = np.linalg.norm(d.lowrank_U.detach().cpu().numpy(), axis=1)
    s = np.exp(d.lowrank_logs.detach().cpu().numpy())
    return norms, [round(float(s[i]), 3) for i in S_STEPS]


@torch.no_grad()
def boosted_cooccurrence(model: ConditionalDiffusion, mut: np.ndarray, cond: np.ndarray,
                         alpha: float, rows: int = ROWS, seed: int = 9) -> Tuple[float, float]:
    """(co-occurrence pattern corr, frequency corr) of a ``rows``-row DDPM
    cohort sampled with the loadings scaled by ``alpha`` (restored after)."""
    U = model.denoiser.lowrank_U
    kept = U.detach().clone()
    reps = -(-rows // cond.shape[0])
    conds = torch.as_tensor(np.tile(cond, (reps, 1))[:rows])
    try:
        U.mul_(alpha)
        out = model.scan_sample(conds, torch.Generator().manual_seed(seed)).cpu().numpy()
    finally:
        U.copy_(kept)
    m = mut.shape[1]
    bits = (out[:, :m] > 0.5).astype(np.float32)
    iu = np.triu_indices(m, k=1)
    fc = float(np.corrcoef(bits.mean(0), mut.mean(0))[0, 1])
    cc = float(np.corrcoef(mutation_corr_matrix(mut)[iu], mutation_corr_matrix(bits)[iu])[0, 1])
    return cc, fc


def replay(workdir: Path, device: str, steps: int = STEPS, rows: int = ROWS) -> dict:
    cfg = Config()
    cfg.data.processed_dir = str(workdir / "processed")
    cfg.model.constraints.enabled = False
    cfg.model.diffusion.low_rank_sigma_dim = 8
    cfg.model.diffusion.low_rank_sigma_scope = "mutations"
    cfg.generation.calibrate_marginals = False
    arrays, dims = prepare_arrays(cfg)
    model = ConditionalDiffusion.from_config(cfg, dims)
    model.denoiser.load_state_dict(load_weights(workdir / "ckpt"))
    model.denoiser.to(device)
    x0 = torch.as_tensor(arrays.data, device=device)
    cond = torch.as_tensor(arrays.conditions, device=device)
    out = {"device": device_stamp(device), "workdir": str(workdir), "rows": int(x0.shape[0])}
    t0 = time.time()
    out["nll"] = fit(model, x0, cond, dims.data_dim, torch.Generator(device).manual_seed(0), steps)
    out["fit_sec"] = time.time() - t0

    norms, s_t = geometry(model)
    print("U row-norm mean", norms.mean(), "max", norms.max())
    print("s(t) at t=0,10,100,500,999:", s_t)
    out.update(u_row_norm_mean=float(norms.mean()), u_row_norm_max=float(norms.max()),
               s_t=dict(zip(map(str, S_STEPS), s_t)), alphas={})
    mut = arrays.data[:, : dims.mutation_dim]
    for alpha in ALPHAS:
        cc, fc = boosted_cooccurrence(model, mut, arrays.conditions, alpha, rows)
        out["alphas"][str(alpha)] = {"cooccurrence_pattern_corr": cc, "freq_corr": fc}
        print(f"alpha={alpha}: co-occurrence pattern corr {cc:.3f}  freq corr {fc:.3f}",
              flush=True)
    out["elapsed_sec"] = time.time() - t0
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("workdir", type=Path)
    parser.add_argument("--out", default=None, help="also write the numbers as JSON here")
    parser.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = parser.parse_args(argv)
    out = replay(args.workdir, args.device or default_device())
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=2) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
