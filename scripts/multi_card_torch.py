"""The port's multi-device layer on N ranks: data-parallel training and the
sharded kernel sampler against one device.

    torchrun --nproc-per-node 4 scripts/multi_card_torch.py --out results/multi4.json
    torchrun --nproc-per-node 4 scripts/multi_card_torch.py --device cpu --small   # gloo

One process a card (NCCL), or a gloo rank on the CPU with ``--device
cpu``; each rank joins the group from torchrun's environment. At full
width (62/5054/26, hidden 256/512/256, cosine T = 1000, x0) on the seeded
100-patient cohort with the production settings, every rank:

- trains the diffusion model and the cVAE data-parallel for ``--steps``
  steps at batch 16 (constraints and dropout on) and the one-device
  trainer from the same seed on its own device: the largest relative gap
  of the losses, the parameters' largest gap and the share above 1e-6,
  ms a step of each (mean after one warm-up step);
- samples ``--rows`` rows with ``sample_sharded`` and with ``sample`` on
  the same generator: DDPM-1000 on a noise buffer and DDIM-50 (the
  largest gap; bit-equal where each rank's block takes the kernel plans
  of the whole cohort), and DDPM-1000 on in-kernel noise at ``--rows``
  and ``--big-rows`` rows: wall seconds (median of 3, in turns with rank
  0's one-device run while the others wait; every call's wall too) and
  patients/sec, and each rank's block sampled without the gather, by
  rank 0 alone and by every rank at once;
- times the all-gather of each rank's block (CUDA events);
- runs the CLI as torchrun launches it (``training.num_devices`` = N):
  train for ``--cli-epochs`` epochs, generate 3 x 333 with DDIM-50 on the
  sharded sampler (host calibration on rank 0), validate on rank 0; its
  seconds by step and rank 0's overall score and MMD.

Rank 0 prints one line per part and writes every number with the card's
name and power limit to ``--out``. A non-finite loss or sample exits
non-zero.
"""

from __future__ import annotations

import argparse
import copy
import json
import math
import shutil
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from osteosarcoma_diffusionmodel_torch.cli import build_constraint_spec  # noqa: E402
from osteosarcoma_diffusionmodel_torch.config import Config  # noqa: E402
from osteosarcoma_diffusionmodel_torch.data.dataset import prepare_arrays  # noqa: E402
from osteosarcoma_diffusionmodel_torch.data.dummy import (  # noqa: E402
    make_dummy_cohort,
    write_processed,
)
from osteosarcoma_diffusionmodel_torch.models.networks import init_weights  # noqa: E402
from osteosarcoma_diffusionmodel_torch.ops.fused_sampler import FusedSampler  # noqa: E402
from osteosarcoma_diffusionmodel_torch.parallel import (  # noqa: E402
    DATA_AXIS,
    RowBlock,
    axis_group,
    initialize_distributed,
    make_mesh,
)
from osteosarcoma_diffusionmodel_torch.parallel.batch import all_gather_rows  # noqa: E402
from osteosarcoma_diffusionmodel_torch.training.trainer import Trainer, build_model  # noqa: E402

FULL = {"dims": (62, 5054, 26), "hidden": [256, 512, 256], "steps": 1000, "ddim": 50}
SMALL = {"dims": (10, 40, 14), "hidden": [128, 256, 128], "steps": 20, "ddim": 5}
PATIENTS = 100
GATHER_ITERS = 50


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _card() -> str:
    if not torch.cuda.is_available():
        return "cpu"
    from osteosarcoma_diffusionmodel_torch.utils.card import card_line

    return card_line()


def _config(root: Path, shape: dict) -> Config:
    cfg = Config()
    cfg.model.hidden_dims = list(shape["hidden"])
    cfg.model.diffusion.num_steps = shape["steps"]
    cfg.training.epochs_per_dispatch = 25  # config/production.yaml
    cfg.generation.batch_scenarios = True
    if dist.get_rank() == 0:
        write_processed(make_dummy_cohort(PATIENTS, *shape["dims"], seed=0), root / "processed")
    dist.barrier()
    cfg.data.processed_dir = str(root / "processed")
    return cfg


def train_parts(cfg: Config, arch: str, steps: int, mesh, dev, root: Path) -> dict:
    """The data-parallel trainer against the one-device trainer."""
    tcfg = copy.deepcopy(cfg)
    tcfg.model.architecture = arch
    tcfg.training.save_dir = str(root / f"ckpt_{arch}")
    arrays, dims = prepare_arrays(tcfg)
    spec = build_constraint_spec(tcfg, arrays)
    trainers = [Trainer(build_model(tcfg, dims, spec), arrays, dims, tcfg, dev, mesh=m)
                for m in (None, mesh)]
    epochs = -(-steps // len(trainers[0].epoch_batches(0)))
    batches = [torch.from_numpy(i).to(dev) for e in range(epochs)
               for i in trainers[0].epoch_batches(e)][:steps]

    def step(t, idx):
        return t.train_step(t._data[idx], t._cond[idx], t._surv[idx])["loss"]

    losses = [[step(t, batches[0])] for t in trainers]
    ms = []
    for t, out in zip(trainers, losses):
        dist.barrier()
        _sync(dev)
        t0 = time.perf_counter()
        out.extend(step(t, idx) for idx in batches[1:])
        _sync(dev)
        ms.append((time.perf_counter() - t0) * 1e3 / (steps - 1))
    one, dp = (torch.stack(v).tolist() for v in losses)
    diffs = [(p.detach() - q.detach()).abs() for p, q in zip(trainers[1].params, trainers[0].params)]
    return {
        "loss_first": dp[0], "loss_last": dp[-1], "one_loss_last": one[-1],
        "loss_rel_max": max(abs(a - b) / max(abs(b), 1e-12) for a, b in zip(dp, one)),
        "param_max": max(float(d.max()) for d in diffs),
        "param_share_above_1e-6": sum(int((d > 1e-6).sum()) for d in diffs)
        / sum(d.numel() for d in diffs),
        "ms_one": ms[0], "ms_dp": ms[1],
        "finite": all(math.isfinite(v) for v in one + dp),
    }


def _wall(fn, dev, runs: int = 1) -> tuple:
    _sync(dev)
    t0 = time.perf_counter()
    out = fn()
    _sync(dev)
    return time.perf_counter() - t0, out


def _block_walls(ddpm: FusedSampler, cond: torch.Tensor, dev) -> dict:
    """Where a sharded wall goes: this rank's block sampled by ``sample``
    with no gather, by rank 0 alone while the others wait ("alone") and by
    every rank at once ("concurrent"); medians of 3, rank 0's clock."""
    walls = {"alone": [], "concurrent": []}
    for _ in range(3):
        dist.barrier()
        if dist.get_rank() == 0:
            walls["alone"].append(_wall(lambda: ddpm.sample(
                cond, torch.Generator(dev).manual_seed(17)), dev)[0])
        dist.barrier()
        walls["concurrent"].append(_wall(lambda: ddpm.sample(
            cond, torch.Generator(dev).manual_seed(17)), dev)[0])
    dist.barrier()
    return {"rows": int(cond.shape[0]),
            **{k: float(np.median(v)) if v else None for k, v in walls.items()}}


def sampler_parts(cfg: Config, shape: dict, rows: int, big_rows: int, mesh, dev) -> dict:
    """sample_sharded against sample on the same generator; walls."""
    dims = cfg.freeze_dims(*shape["dims"], ["survival_days_norm", "event_occurred",
                                            "metastasis_at_diagnosis"])
    model = build_model(cfg, dims)
    init_weights(model.denoiser, torch.Generator().manual_seed(0))
    model.denoiser.to(dev)
    ddpm, ddim = FusedSampler(model, dev), FusedSampler(model, dev, ddim_steps=shape["ddim"])
    D = dims.data_dim
    rank = dist.get_rank()
    out = {}
    cond = torch.randn(rows, dims.condition_dim, generator=torch.Generator().manual_seed(14))
    noise = torch.randn((ddpm.n_loop, rows, D), generator=torch.Generator().manual_seed(15)).to(dev)
    for label, sampler, kw in (("buffer", ddpm, {"noise": noise}), ("none", ddim, {})):
        got = sampler.sample_sharded(mesh, cond, torch.Generator().manual_seed(16), **kw)
        want = sampler.sample(cond, torch.Generator().manual_seed(16), **kw)
        out[f"{label}_max_abs"] = float((got - want).abs().max())
        out[f"{label}_equal"] = bool(torch.equal(got, want))
        out["finite"] = out.get("finite", True) and bool(torch.isfinite(got).all())
    del noise
    for n in (rows, big_rows):
        # The walls' conditions, x_T and seeds come from generators on the
        # rank's device, so no wall holds a host draw or a host-to-card copy.
        cond_n = torch.randn(n, dims.condition_dim, generator=torch.Generator(dev).manual_seed(n),
                             device=dev)
        walls = {"sharded": [], "one": []}
        for _ in range(3):
            dist.barrier()
            s, got = _wall(lambda: ddpm.sample_sharded(mesh, cond_n,
                                                       torch.Generator(dev).manual_seed(17)), dev)
            walls["sharded"].append(s)
            dist.barrier()
            if rank == 0:
                s, _ = _wall(lambda: ddpm.sample(cond_n, torch.Generator(dev).manual_seed(17)),
                             dev)
                walls["one"].append(s)
            dist.barrier()
        out["finite"] = out["finite"] and bool(torch.isfinite(got).all())
        med = {k: float(np.median(v)) if v else None for k, v in walls.items()}
        out[f"wall_{n}"] = med
        out[f"walls_{n}"] = walls
        out[f"patients_per_sec_{n}"] = {k: (n / v if v else None) for k, v in med.items()}
        rows_block = RowBlock.of(n, dist.get_world_size(), rank)
        out[f"block_{n}"] = _block_walls(ddpm, rows_block.take(cond_n), dev)
        block = torch.randn(rows_block.count, D, device=dev)
        group = axis_group(mesh, DATA_AXIS)
        if dev.type == "cuda":
            all_gather_rows(group, block)
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            torch.cuda.synchronize(dev)
            start.record()
            for _ in range(GATHER_ITERS):
                all_gather_rows(group, block)
            end.record()
            torch.cuda.synchronize(dev)
            out[f"gather_ms_{n}"] = start.elapsed_time(end) / GATHER_ITERS
        else:
            out[f"gather_ms_{n}"] = None  # a CPU run times no device
    return out


def cli_part(cfg: Config, root: Path, epochs: int, device: str) -> dict:
    """The CLI's train, generate and validate steps on every rank."""
    from osteosarcoma_diffusionmodel_torch import cli

    world = dist.get_world_size()
    path = root / "cli.yaml"
    if dist.get_rank() == 0:
        import yaml

        path.write_text(yaml.safe_dump({
            "data": {"processed_dir": cfg.data.processed_dir},
            "model": {"hidden_dims": cfg.model.hidden_dims,
                      "diffusion": {"num_steps": cfg.model.diffusion.num_steps}},
            "training": {"save_dir": str(root / "cli_ckpt"), "num_epochs": epochs,
                         "num_devices": world, "epochs_per_dispatch": 25},
            "generation": {"sampler": "ddim", "sampling_steps": 50, "batch_scenarios": True},
            "output": {"results_dir": str(root / "cli_results"),
                       "synthetic_data_dir": str(root / "cli_synthetic")}}))
    dist.barrier()
    seconds = {}
    for step in ("train", "generate", "validate"):
        t0 = time.perf_counter()
        cli.main(["--config", str(path), "--steps", step, "--device", device])
        dist.barrier()
        seconds[step] = time.perf_counter() - t0
    out = {"seconds": seconds}
    if dist.get_rank() == 0:
        results = (root / "cli_results" / "validation_results.csv").read_text().splitlines()
        values = dict(zip(results[0].split(","), map(float, results[1].split(","))))
        out.update(overall=values["overall_biological_score"], mmd=values["mmd"],
                   finite=all(math.isfinite(v) for v in values.values()))
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--small", action="store_true",
                        help="10/40/14, hidden 128/256/128, T 20 (a CPU rehearsal)")
    parser.add_argument("--steps", type=int, default=20)
    parser.add_argument("--rows", type=int, default=333)
    parser.add_argument("--big-rows", type=int, default=32768)
    parser.add_argument("--cli-epochs", type=int, default=10)
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    cuda = args.device == "cuda"
    if cuda and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu for a gloo run")
    if not initialize_distributed(backend="nccl" if cuda else "gloo"):
        raise RuntimeError("run under torchrun (MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE)")
    try:
        if not cuda:
            torch.set_num_threads(1)
        dev = torch.device("cuda", torch.cuda.current_device()) if cuda else torch.device("cpu")
        world, rank = dist.get_world_size(), dist.get_rank()
        mesh = make_mesh(world)
        shape = SMALL if args.small else FULL
        # One directory for every rank (the CLI's checkpoint and CSVs are
        # rank 0's, read by all): rank 0 makes it and sends its path.
        box = [tempfile.mkdtemp(prefix="osdm_multi_card_") if rank == 0 else None]
        dist.broadcast_object_list(box, src=0)
        tmp = box[0]
        try:
            cfg = _config(Path(tmp), shape)
            record = {"card": _card(), "world": world, "backend": dist.get_backend(),
                      "nccl": ".".join(map(str, torch.cuda.nccl.version())) if cuda else None,
                      "shape": shape, "train": {}}
            for arch in ("diffusion", "cvae"):
                record["train"][arch] = train_parts(cfg, arch, args.steps, mesh, dev, Path(tmp))
            record["sampler"] = sampler_parts(cfg, shape, args.rows, args.big_rows, mesh, dev)
            record["cli"] = cli_part(cfg, Path(tmp), args.cli_epochs, args.device)
        finally:
            dist.barrier()
            if rank == 0:
                shutil.rmtree(tmp, ignore_errors=True)
        ok = (record["sampler"]["finite"] and all(t["finite"] for t in record["train"].values())
              and record["cli"].get("finite", True))
        if rank == 0:
            print(record["card"], flush=True)
            print(json.dumps(record), flush=True)
            if args.out:
                Path(args.out).parent.mkdir(parents=True, exist_ok=True)
                Path(args.out).write_text(json.dumps(record, indent=2))
        return 0 if ok else 1
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())
