"""Export a JAX (Orbax) checkpoint directory as a PyTorch-port checkpoint.

    python scripts/export_jax_checkpoint.py RESULTS/checkpoints OUT_DIR \
        [--name best_model]

Runs where JAX is installed: restores the checkpoint with
``osteosarcoma_diffusionmodel_tpu.generation.generator.load_trained_model``
and writes OUT_DIR with

- ``best_model.npz``: the model's parameters under their flat Flax paths
  (``enc_0/fc1/kernel``, ``encoder/fc_0/kernel``, ...) and the cVAE's
  BatchNorm statistics under ``batch_stats/`` (``batch_stats/encoder/bn_0/
  mean``), which ``osteosarcoma_diffusionmodel_torch.convert`` maps onto the
  port;
- ``metadata.json`` and ``data_stats.npz``, copied unchanged.

The port then loads OUT_DIR as ``training.save_dir`` (its CLI, or
``python3 chip_smoke.py --weights OUT_DIR``) without JAX.
"""

from __future__ import annotations

import argparse
import shutil
import sys
from pathlib import Path
from typing import Any, Dict, Mapping

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from osteosarcoma_diffusionmodel_tpu.training.checkpoint import (  # noqa: E402
    DATA_STATS_FILE,
    METADATA_FILE,
)


def flat_params(params: Mapping[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    flat: Dict[str, np.ndarray] = {}
    for key, value in params.items():
        path = f"{prefix}/{key}" if prefix else key
        if isinstance(value, Mapping):
            flat.update(flat_params(value, path))
        else:
            flat[path] = np.asarray(value, np.float32)
    return flat


def export(checkpoint_dir: str | Path, out_dir: str | Path, name: str = "best_model") -> Path:
    from osteosarcoma_diffusionmodel_tpu.generation.generator import load_trained_model

    checkpoint_dir, out_dir = Path(checkpoint_dir), Path(out_dir)
    _model, params, batch_stats, _config, _dims = load_trained_model(
        checkpoint_dir, checkpoint_name=name)
    out_dir.mkdir(parents=True, exist_ok=True)
    flat = flat_params(params)
    flat.update({f"batch_stats/{k}": v for k, v in flat_params(batch_stats or {}).items()})
    np.savez(out_dir / "best_model.npz", **flat)
    for fname in (METADATA_FILE, DATA_STATS_FILE):
        src = checkpoint_dir / fname
        if not src.exists():
            raise FileNotFoundError(f"{src} is missing; the port needs it")
        shutil.copyfile(src, out_dir / fname)
    return out_dir


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("checkpoint_dir", help="JAX training.save_dir (Orbax checkpoints)")
    parser.add_argument("out_dir", help="directory for the port's checkpoint")
    parser.add_argument("--name", default="best_model", help="checkpoint to export")
    args = parser.parse_args(argv)
    print(export(args.checkpoint_dir, args.out_dir, args.name))


if __name__ == "__main__":
    main()
