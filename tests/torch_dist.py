"""Worlds of gloo ranks on the CPU for the port's multi-device tests
(tests/test_torch_mesh.py, test_torch_sharded.py, test_torch_trainer_mesh.py).

:func:`spawn` starts ``world`` fresh processes running one of this module's
world functions (``python tests/torch_dist.py <function> <rank> <world>
<workdir> <mode>``). Every spawn has its own rendezvous in its work
directory (a ``FileStore``, or under ``mode`` "launcher" a free localhost
port in the environment that torchrun sets, which the CLI joins itself),
a join timeout of its own, and each process tears its group down. A rank
that fails, or a world that outlives its timeout, stops every rank and
fails the test with that rank's stderr tail.

The world functions import torch and the port only (never JAX): the test
process prepares their inputs (models, draws, arrays, pickled with
``torch.save``) in ``<workdir>/inputs.pt`` and reads each rank's results
from ``<workdir>/rank<r>.pt``.
"""

from __future__ import annotations

import copy
import json
import logging
import os
import socket
import subprocess
import sys
import time
from datetime import timedelta
from pathlib import Path

import torch
import torch.distributed as dist

TESTS = Path(__file__).resolve().parent
REPO = TESTS.parent
JOIN_TIMEOUT_S = 60


def spawn(target: str, world: int, workdir: Path, timeout: float = 180.0,
          mode: str = "store") -> float:
    """Run ``target`` on ``world`` ranks; returns the world's seconds."""
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (str(REPO), str(TESTS),
                                                    env.get("PYTHONPATH", "")) if p)
    env["OMP_NUM_THREADS"] = "1"
    if mode == "launcher":
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE=str(world))
    t0 = time.perf_counter()
    procs, logs = [], []
    for rank in range(world):
        rank_env = dict(env, RANK=str(rank), LOCAL_RANK=str(rank)) if mode == "launcher" else env
        err = open(workdir / f"rank{rank}.err", "w")
        logs.append(err)
        procs.append(subprocess.Popen(
            [sys.executable, str(Path(__file__)), target, str(rank), str(world), str(workdir),
             mode], cwd=str(REPO), env=rank_env, stdout=err, stderr=subprocess.STDOUT))
    deadline = time.monotonic() + timeout
    failed = None
    try:
        while failed is None and any(p.poll() is None for p in procs):
            failed = next((r for r, p in enumerate(procs) if p.poll() not in (None, 0)), None)
            if failed is None and time.monotonic() > deadline:
                failed = "timeout"
            time.sleep(0.05)
        if failed is None:
            failed = next((r for r, p in enumerate(procs) if p.returncode != 0), None)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in logs:
            f.close()
    if failed is not None:
        rank = 0 if failed == "timeout" else failed
        tail = (workdir / f"rank{rank}.err").read_text()[-4000:]
        what = f"timed out after {timeout:.0f} s" if failed == "timeout" else f"rank {rank} failed"
        raise AssertionError(f"{target} on {world} ranks {what}:\n{tail}")
    return time.perf_counter() - t0


def results(workdir: Path, world: int) -> list:
    """Each rank's results dict."""
    return [torch.load(Path(workdir) / f"rank{r}.pt", weights_only=False) for r in range(world)]


def _inputs(workdir: Path) -> dict:
    return torch.load(workdir / "inputs.pt", weights_only=False)


def _save(workdir: Path, rank: int, out: dict) -> None:
    torch.save(out, workdir / f"rank{rank}.pt")


class _Warnings(logging.Handler):
    def __init__(self):
        super().__init__(logging.WARNING)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


# ----------------------------------------------------------------------
# The worlds
# ----------------------------------------------------------------------
def mesh_world(rank: int, world: int, workdir: Path) -> None:
    """The mesh rules, the global batch's mean and gradient, and the
    tensor-parallel train step against the one-device step."""
    from torch import nn

    from osteosarcoma_diffusionmodel_torch.parallel import (
        BatchShard,
        batch_sharding,
        data_shard,
        denoiser_param_sharding,
        make_mesh,
        pad_to_multiple,
        replicated,
        shard_batch,
    )
    from osteosarcoma_diffusionmodel_torch.parallel.dryrun import sharded_train_step
    from osteosarcoma_diffusionmodel_torch.parallel.mesh import full_state_dict

    inputs = _inputs(workdir)
    out = {}
    for name, kw in (("m4", dict(num_devices=4)), ("m22", dict(num_devices=4, model_parallel=2)),
                     ("m2", dict(num_devices=2)), ("all", {})):
        mesh = make_mesh(**kw)
        out[name] = (tuple(mesh.shape), mesh.mesh_dim_names, mesh.get_coordinate())
    for name, kw in (("too_many", dict(num_devices=8)),
                     ("indivisible", dict(num_devices=3, model_parallel=2))):
        try:
            make_mesh(**kw)
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    m4, m22 = make_mesh(4), make_mesh(4, model_parallel=2)
    x = torch.arange(24, dtype=torch.float32).reshape(8, 3)
    out["shard8"] = shard_batch(m4, x)
    out["shard10"] = tuple(shard_batch(m4, torch.zeros(10, 3)).shape)
    out["shard_pair"] = [tuple(t.shape) for t in shard_batch(m22, x, x[:, :1])]
    out["pad"] = (pad_to_multiple(5142, 128), pad_to_multiple(128, 128), pad_to_multiple(1, 8))
    out["placements"] = (batch_sharding(m4), replicated(m4))

    model = inputs["tp_model"]
    out["sharding"] = {n: repr(p) for n, p in denoiser_param_sharding(m22, model.denoiser).items()}
    out["sharding_m4"] = {repr(p) for p in denoiser_param_sharding(m4, model.denoiser).values()}
    small = nn.Sequential(nn.Linear(16, 32), nn.Linear(32, 8))
    out["small"] = {n: repr(p) for n, p in denoiser_param_sharding(m22, small).items()}

    # The global batch: this rank's rows, the global mean and gradient.
    leaf = inputs["x"].clone().requires_grad_()
    shard = data_shard(m4, leaf.shape[0])
    local = shard.take(leaf)
    mean = shard.mean(local, 0)
    loss = shard.mean(local * local)
    (loss / shard.world).backward()
    grad = leaf.grad.clone()
    dist.all_reduce(grad)
    out["global"] = (mean.detach(), loss.detach(), grad, tuple(local.shape))
    out["replicated"] = data_shard(m4, 10) == BatchShard()

    # One train step: (2, 2) mesh (DP x TP) against one device.
    ref, tp = copy.deepcopy(model), copy.deepcopy(model)
    x0, cond = inputs["x0"], inputs["cond"]
    loss_ref = sharded_train_step(None, ref, x0, cond, torch.Generator().manual_seed(0))
    loss_tp = sharded_train_step(m22, tp, x0, cond, torch.Generator().manual_seed(0))
    full = full_state_dict(tp.denoiser)
    want = ref.denoiser.state_dict()
    diffs = {k: (full[k] - v).abs() for k, v in want.items()}
    out["tp"] = (float(loss_ref), float(loss_tp),
                 {k: (float(d.max()), int((d > 2e-6).sum()), d.numel()) for k, d in diffs.items()},
                 sum(isinstance(m, nn.Linear) for m in tp.denoiser.modules()))
    _save(workdir, rank, out)


def sampler_world(rank: int, world: int, workdir: Path) -> None:
    """``FusedSampler.sample_sharded`` in every mode against ``sample``, and
    the sharded generator on each route against the unsharded one, with
    ``OSDM_DUMP_RAW`` set to a path of the rank's own."""
    import numpy as np

    from osteosarcoma_diffusionmodel_torch.generation import generator as gen_module
    from osteosarcoma_diffusionmodel_torch.generation.generator import SyntheticPatientGenerator
    from osteosarcoma_diffusionmodel_torch.ops.fused_sampler import FusedSampler
    from osteosarcoma_diffusionmodel_torch.parallel import make_mesh

    inputs = _inputs(workdir)
    mesh = make_mesh(world)
    model, ddim_steps = inputs["model"], inputs["ddim_steps"]
    ddpm, ddim = FusedSampler(model, "cpu"), FusedSampler(model, "cpu", ddim_steps=ddim_steps)
    out = {}
    for case, (cond, x_init, noise) in inputs["cohorts"].items():
        g = torch.Generator().manual_seed(0)
        out[f"{case}/buffer"] = ddpm.sample_sharded(mesh, cond, g, x_init=x_init, noise=noise)
        out[f"{case}/buffer_ref"] = ddpm.sample(cond, g, x_init=x_init, noise=noise)
        out[f"{case}/none"] = ddim.sample_sharded(mesh, cond, g, x_init=x_init)
        out[f"{case}/none_ref"] = ddim.sample(cond, g, x_init=x_init)
        out[f"{case}/philox"] = ddpm.sample_sharded(mesh, cond, torch.Generator().manual_seed(5),
                                                    keep_bf16=True)
    for name, (gmodel, cfg, dims, stats) in inputs["generators"].items():
        gen_module.SAMPLERS.clear()
        gen_module.CALIBRATIONS.clear()
        gen = SyntheticPatientGenerator(gmodel, cfg, dims, stats, device="cpu", mesh=mesh)
        dump = workdir / f"raw_{name}_rank{rank}.npz"  # OSDM_DUMP_RAW: a path per rank
        os.environ["OSDM_DUMP_RAW"] = str(dump)
        try:
            out[f"gen/{name}"] = gen.generate(inputs["gen_rows"], inputs["scenario"],
                                              torch.Generator().manual_seed(5))
        finally:
            del os.environ["OSDM_DUMP_RAW"]
        out[f"gen/{name}/routes"] = (dict(gen_module.SAMPLERS), dict(gen_module.CALIBRATIONS))
        if dump.exists():
            with np.load(dump) as f:
                out[f"gen/{name}/dump"] = {k: f[k] for k in f.files}
    _save(workdir, rank, out)


def trainer_world(rank: int, world: int, workdir: Path) -> None:
    """The data-parallel Trainer (built from ``training.num_devices``) for
    each case, and one injected-draw step."""
    from osteosarcoma_diffusionmodel_torch.training.trainer import Trainer

    warnings = _Warnings()
    logging.getLogger("osteosarcoma_diffusionmodel_torch").addHandler(warnings)
    inputs = _inputs(workdir)
    out = {}
    for name, (model, arrays, dims, cfg) in inputs["cases"].items():
        cfg.training.save_dir = str(workdir / f"ckpt_{name}")
        warnings.messages.clear()
        trainer = Trainer(model, arrays, dims, cfg, "cpu")
        history = trainer.train()
        out[name] = {"train": history.train_loss, "val": history.val_loss,
                     "state": {k: v.clone() for k, v in trainer.module.state_dict().items()},
                     "mesh": dict(zip(trainer.mesh.mesh_dim_names, trainer.mesh.shape)),
                     "warnings": list(warnings.messages)}
    model, arrays, dims, cfg, state, batch, draws = inputs["step"]
    cfg.training.save_dir = str(workdir / "ckpt_step")
    trainer = Trainer(model, arrays, dims, cfg, "cpu")
    trainer.module.load_state_dict(state)
    metrics = trainer.train_step(*batch, **draws)
    out["step"] = {"metrics": {k: float(v) for k, v in metrics.items()},
                   "state": {k: v.clone() for k, v in trainer.module.state_dict().items()}}
    _save(workdir, rank, out)


def cli_world(rank: int, world: int, workdir: Path) -> None:
    """The CLI under a launcher's environment; records every file or
    directory a rank other than 0 creates or writes under ``workdir``."""
    from osteosarcoma_diffusionmodel_torch import cli

    writes = []
    root = str(workdir)

    def audit(event, args):
        if event == "open" and args and isinstance(args[0], (str, bytes, os.PathLike)):
            path, mode, flags = os.fsdecode(args[0]), args[1], args[2]
            writing = (any(c in mode for c in "wax+") if isinstance(mode, str)
                       else bool(flags & (os.O_WRONLY | os.O_RDWR | os.O_CREAT)))
            if writing and path.startswith(root):
                writes.append(path)
        elif event in ("os.mkdir", "os.rename", "os.remove") and args:
            path = os.fsdecode(args[0]) if isinstance(args[0], (str, bytes, os.PathLike)) else ""
            if path.startswith(root):
                writes.append(path)

    if rank:
        sys.addaudithook(audit)
    cli.main(["--config", str(workdir / "config.yaml"), "--steps", "train", "generate",
              "--device", "cpu"])
    recorded = list(writes)
    (workdir / f"writes{rank}.json").write_text(json.dumps(recorded))


def main(argv) -> None:
    target, rank, world, workdir, mode = argv
    rank, world, workdir = int(rank), int(world), Path(workdir)
    torch.set_num_threads(1)
    if mode == "store":
        dist.init_process_group("gloo", init_method=f"file://{workdir / 'store'}", rank=rank,
                                world_size=world, timeout=timedelta(seconds=JOIN_TIMEOUT_S))
    try:
        globals()[target](rank, world, workdir)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
