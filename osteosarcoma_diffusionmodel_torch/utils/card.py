"""What the port's card scripts share (``chip_smoke.py``,
``scripts/bench_serving_torch.py``): the card's line as nvidia-smi prints
it, every kernel's launch counter, and a checkpoint of seeded weights at
full width."""

from __future__ import annotations

import subprocess
from pathlib import Path

import torch

from ..config import Config
from ..data.dummy import DummyCohort, cohort_arrays
from ..models.diffusion import ConditionalDiffusion
from ..models.networks import init_weights
from ..ops.pallas_kernels import POSTERIOR_UPDATE, RBF
from ..ops.sampler_kernels import (
    GEMM,
    GEMM_GN,
    GEMM_LATENT,
    GEMM_POSTERIOR,
    GEMM_S8,
    GEMM_S8_GN,
    GEMM_S8_POSTERIOR,
    GEMM_S8Q,
    GEMM_S8Q_GN,
    GEMM_S8Q_POSTERIOR,
    GROUPNORM,
    LATENT,
    POSTERIOR,
    ROWQUANT,
)
from ..training.checkpoint import (
    data_stats_from_arrays,
    save_data_stats,
    save_metadata,
    save_weights,
)

# Every hand-written kernel's launch counter, in the order of the kernel report.
KERNELS = (GEMM, GEMM_GN, GEMM_POSTERIOR, GROUPNORM, POSTERIOR, RBF, ROWQUANT, GEMM_S8,
           GEMM_S8_GN, GEMM_S8_POSTERIOR, GEMM_S8Q, GEMM_S8Q_GN, GEMM_S8Q_POSTERIOR, LATENT,
           GEMM_LATENT, POSTERIOR_UPDATE)
# The rows of the serving buckets the card scripts drive: one row, the JSON
# bucket of 64 and the 1,024-row bucket that calibrates on the card.
SERVE_BUCKETS = (1, 64, 1024)


def card_line() -> str:
    """The card's name and power limit, as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def seeded_checkpoint(path: Path, cfg: Config, cohort: DummyCohort) -> Path:
    """Weights from seed 0 at ``cfg``'s widths and ``cohort``'s data
    statistics, in the port's checkpoint layout."""
    data, conditions, dims = cohort_arrays(cohort, cfg)
    model = ConditionalDiffusion.from_config(cfg, dims)
    init_weights(model.denoiser, torch.Generator().manual_seed(0))
    save_weights(path, model.denoiser.state_dict())
    save_metadata(path, cfg, dims)
    save_data_stats(path, data_stats_from_arrays(data, conditions, dims.mutation_dim))
    return path
