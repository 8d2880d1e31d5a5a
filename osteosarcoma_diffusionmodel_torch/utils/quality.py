"""What the port's quality protocols share (``scripts/production_run_torch.py``,
``demo_full_scale_torch.py``, ``demo_held_out_torch.py``,
``replay_calibration_torch.py``): the production quality gate, the stamp
of the device a record was measured on, a step timed on the device's
clock, and the ``DEMO_*`` knobs of scripts/demo_full_scale.py (:57-120)
applied to a port ``Config``."""

from __future__ import annotations

import time
from pathlib import Path
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import torch

from ..config import Config
from .card import card_line

# The demos' cohort: mutation genes, expression genes, pathway columns
# (scripts/demo_full_scale.py :62-65), and the patients generated.
DIMS = (62, 5054, 26)
SYNTHETIC = 10002
# The production gate (scripts/demo_full_scale.py `_assert_quality_gate`):
# overall_biological_score >= 0.85 and mmd < 0.15.
GATE = {"overall_biological_score": 0.85, "mmd": 0.15}


def gate_failures(validation: Mapping[str, float]) -> List[str]:
    overall, mmd = validation["overall_biological_score"], validation["mmd"]
    failures = []
    if overall < GATE["overall_biological_score"]:
        failures.append(f"overall_biological_score {overall:.4f} < 0.85")
    if mmd >= GATE["mmd"]:
        failures.append(f"mmd {mmd:.4f} >= 0.15")
    return failures


def apply_gate(validation: Mapping[str, float]) -> int:
    """Print the gate's verdict as the JAX scripts do; 1 where it fails."""
    failures = gate_failures(validation)
    if failures:
        print("QUALITY GATE FAILED: " + "; ".join(failures))
        return 1
    print(f"QUALITY GATE PASSED: overall={validation['overall_biological_score']:.4f} "
          f"mmd={validation['mmd']:.4f}")
    return 0


def device_stamp(device: str) -> dict:
    """The device a record was measured on: its platform, the card's name
    and the nvidia-smi line (name, power limit) on a card, torch's
    version."""
    on_card = device.startswith("cuda")
    return {"platform": torch.device(device).type,
            "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
            "nvidia_smi": card_line() if on_card else None,
            "torch": torch.__version__}


def timed(fn: Callable, device: str) -> Tuple[object, float]:
    """``fn()`` and its seconds, the device synchronized on both sides."""
    sync = torch.cuda.synchronize if device.startswith("cuda") else (lambda: None)
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, time.perf_counter() - t0


def floats(results: Mapping[str, float]) -> Dict[str, float]:
    return {k: float(v) for k, v in results.items()}


def demo_paths(cfg: Config, workdir: Path, processed: Path, epochs: int, synthetic: int,
               ddim_steps: Optional[int] = None) -> Config:
    """The JAX demos' directories, epochs (patience the same), cohort size
    and the batched scenarios; ``ddim_steps``: DDIM over that many steps
    instead of the configured sampler."""
    cfg.data.processed_dir = str(processed)
    cfg.training.num_epochs = epochs
    cfg.training.patience = epochs
    cfg.generation.batch_scenarios = True
    if ddim_steps is not None:
        cfg.generation.sampler, cfg.generation.sampling_steps = "ddim", ddim_steps
    cfg.training.save_dir = str(workdir / "ckpt")
    cfg.generation.num_synthetic_samples = synthetic
    cfg.output.results_dir = str(workdir / "results")
    cfg.output.synthetic_data_dir = str(workdir / "results" / "synthetic")
    return cfg


def _flag(value: str) -> bool:
    """The JAX package's ``env_flag``: '', '0', 'false', 'no', 'off' are off."""
    return value.strip().lower() not in ("", "0", "false", "no", "off")


def apply_demo_knobs(cfg: Config, env: Mapping[str, str]) -> Config:
    """The ``DEMO_*`` model, training and generation knobs of
    scripts/demo_full_scale.py (:71-116), read from ``env`` as that script
    reads them: DEMO_CALIBRATE (a mode, or "false"), DEMO_PARAM,
    DEMO_LEARN_SIGMA, DEMO_DISCRETE, DEMO_FINETUNE (any non-empty value),
    DEMO_LATENT_K, DEMO_LATENT_INPUT, DEMO_LOWRANK_K, DEMO_LOWRANK_SCOPE,
    DEMO_AR (``env_flag``), DEMO_AR_CONTEXT, DEMO_AR_LR, DEMO_AR_L2,
    DEMO_AR_CTX_L2, DEMO_FT_STEPS, DEMO_SAMPLER, DEMO_BLOCK and
    DEMO_SAMPLING_STEPS. The cohort's knobs (DEMO_N, DEMO_SEED,
    DEMO_EPOCHS) are the caller's."""
    diff, gen, train = cfg.model.diffusion, cfg.generation, cfg.training
    if "DEMO_CALIBRATE" in env:  # copula_joint | copula_full | copula | quantile | false
        v = env["DEMO_CALIBRATE"]
        gen.calibrate_marginals = False if v == "false" else v
    if "DEMO_PARAM" in env:
        diff.parameterization = env["DEMO_PARAM"]
    if env.get("DEMO_LEARN_SIGMA"):
        diff.learn_sigma = True
    if env.get("DEMO_DISCRETE"):
        diff.discrete_mutation_head = True
    if "DEMO_LATENT_K" in env:
        diff.latent_factor_dim = int(env["DEMO_LATENT_K"])
    if "DEMO_LATENT_INPUT" in env:
        diff.latent_encoder_input = env["DEMO_LATENT_INPUT"]
    if "DEMO_LOWRANK_K" in env:
        diff.low_rank_sigma_dim = int(env["DEMO_LOWRANK_K"])
    if "DEMO_LOWRANK_SCOPE" in env:
        diff.low_rank_sigma_scope = env["DEMO_LOWRANK_SCOPE"]
    if _flag(env.get("DEMO_AR", "")):
        diff.ar_mutation_head = True
    if "DEMO_AR_CONTEXT" in env:
        diff.ar_context = env["DEMO_AR_CONTEXT"]
    if "DEMO_AR_LR" in env:
        diff.ar_lr = float(env["DEMO_AR_LR"])
    if "DEMO_AR_L2" in env:
        diff.ar_l2 = float(env["DEMO_AR_L2"])
    if "DEMO_AR_CTX_L2" in env:
        diff.ar_ctx_l2 = float(env["DEMO_AR_CTX_L2"])
    if env.get("DEMO_FINETUNE"):
        train.sample_path_finetune.enabled = True
        train.sample_path_finetune.steps = int(env.get("DEMO_FT_STEPS", 300))
    if "DEMO_SAMPLER" in env:
        gen.sampler = env["DEMO_SAMPLER"]
    if "DEMO_BLOCK" in env:
        train.epochs_per_dispatch = int(env["DEMO_BLOCK"])
    if "DEMO_SAMPLING_STEPS" in env:
        gen.sampling_steps = int(env["DEMO_SAMPLING_STEPS"])
    return cfg
