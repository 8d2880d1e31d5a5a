"""The multi-device dry run: one full train step and one sharded sample
over an n-device (data, model) mesh.

Counterpart of ``__graft_entry__.dryrun_multichip`` / ``_dryrun_body``
(:43-165 there). The mesh is (n/2, 2) when n >= 4 and n is even, else
(n, 1). The model is the flagship diffusion model at hidden 128/256/128
and dims 8/40/6, constraints off, T = 4, its weights seeded; the
denoiser's wide Linears run column-parallel over ``model``
(:func:`~.mesh.parallelize_denoiser`) and a batch of 4n ones is split
over ``data``. The step is the JAX one: the loss in eval mode, the global
norm clipped at 1.0 (over the whole parameters: the shards' squares summed
over the model axis), AdamW at lr 1e-4 and weight decay 1e-5. Then the
gathered weights sample the batch's conditions through
``FusedSampler.sample_sharded``, and the loss must be finite.

One process per device: with n cards visible, n NCCL processes, one a
card; with fewer, n gloo processes on the CPU (the JAX package's CPU
subprocess route). A failing rank raises with the tail of its stderr; the
run never goes on with fewer ranks.

    python -c "from osteosarcoma_diffusionmodel_torch.parallel.dryrun import dryrun_multichip; dryrun_multichip(4)"
"""

from __future__ import annotations

import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from .batch import all_reduce_grads
from .mesh import (
    MODEL_AXIS,
    axis_group,
    axis_size,
    data_shard,
    full_state_dict,
    initialize_distributed,
    make_mesh,
    parallelize_denoiser,
    sharded_names,
)

DRYRUN_HIDDEN = (128, 256, 128)
DRYRUN_DIMS = (8, 40, 6)
DRYRUN_STEPS = 4
CONDITIONS = ["survival_days_norm", "event_occurred", "metastasis_at_diagnosis"]
REPO = Path(__file__).resolve().parents[2]


def flagship(num_steps: int = DRYRUN_STEPS, hidden=DRYRUN_HIDDEN, data_dims=DRYRUN_DIMS,
             seed: int = 0, compute_dtype: str = "bfloat16"):
    """(config, dims, model): the flagship diffusion model (constraints off,
    products in ``compute_dtype``) with Flax-initialized weights from
    ``seed``, on the CPU."""
    from ..config import Config
    from ..models.diffusion import ConditionalDiffusion
    from ..models.networks import init_flax

    config = Config()
    config.model.hidden_dims = list(hidden)
    config.model.diffusion.num_steps = num_steps
    config.model.constraints.enabled = False
    config.model.compute_dtype = compute_dtype
    dims = config.freeze_dims(*data_dims, CONDITIONS)
    model = ConditionalDiffusion.from_config(config, dims)
    init_flax(model.denoiser, torch.Generator().manual_seed(seed))
    return config, dims, model


def sharded_train_step(mesh, model, x0: torch.Tensor, cond: torch.Tensor,
                       generator: torch.Generator, lr: float = 1e-4,
                       weight_decay: float = 1e-5, max_norm: float = 1.0) -> torch.Tensor:
    """One AdamW step of ``model`` on the global batch (``x0``, ``cond``),
    the denoiser column-parallel over the mesh's model axis and the batch
    split over its data axis (``mesh`` None: one device). Every rank passes
    the same batch and a generator in the same state. Returns the loss."""
    from ..training.trainer import clip_by_global_norm

    d = model.denoiser
    model_group = None
    if mesh is not None and axis_size(mesh, MODEL_AXIS) > 1:
        parallelize_denoiser(mesh, d)
        model_group = axis_group(mesh, MODEL_AXIS)
    shard = data_shard(mesh, x0.shape[0], generator)
    draws = model.loss_draws(x0.shape[0], generator, x0.device)
    opt = torch.optim.AdamW(d.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=weight_decay)
    loss, _ = model.loss(shard.take(x0), shard.take(cond), train=False, shard=shard,
                         **{k: shard.take(v) for k, v in draws.items()})
    (loss / shard.world).backward()
    sharded = sharded_names(d)
    names, grads = zip(*[(n, p.grad) for n, p in d.named_parameters()])
    if shard.group is not None:
        all_reduce_grads(grads, shard.group)
    clip_by_global_norm(list(grads), max_norm, [n in sharded for n in names], model_group)
    opt.step()
    return loss.detach()


def _dryrun_body(n_devices: int, init_method: str, rank: int, device: str) -> None:
    """One rank of the dry run (needs the other n - 1 ranks)."""
    from ..ops.fused_sampler import FusedSampler

    backend = "nccl" if device == "cuda" else "gloo"
    if device == "cuda":
        torch.cuda.set_device(rank)
    else:
        torch.set_num_threads(1)
    initialize_distributed(init_method, n_devices, rank, backend, timeout_s=300)
    try:
        model_parallel = 2 if n_devices >= 4 and n_devices % 2 == 0 else 1
        mesh = make_mesh(n_devices, model_parallel=model_parallel)
        dev = torch.device(device)
        config, dims, model = flagship()
        model.denoiser.to(dev)
        batch = 4 * n_devices
        x0 = torch.ones((batch, dims.data_dim), device=dev)
        cond = torch.zeros((batch, dims.condition_dim), device=dev)
        loss = sharded_train_step(mesh, model, x0, cond, torch.Generator(dev).manual_seed(0))

        _, _, plain = flagship()
        plain.denoiser.load_state_dict(full_state_dict(model.denoiser))
        plain.denoiser.to(dev)
        samples = FusedSampler(plain, dev).sample_sharded(mesh, cond,
                                                          torch.Generator().manual_seed(1))
        if not math.isfinite(float(loss)):
            raise AssertionError(f"training step produced non-finite loss {float(loss)}")
        if tuple(samples.shape) != (batch, dims.data_dim) or not torch.isfinite(samples).all():
            raise AssertionError(f"sharded sample: shape {tuple(samples.shape)} or not finite")
        if rank == 0:
            print(f"[dryrun] {n_devices} ranks on {device} ({backend}), mesh "
                  f"{dict(zip(mesh.mesh_dim_names, mesh.shape))}: loss {float(loss):.6f}, "
                  f"sharded sample {tuple(samples.shape)}", flush=True)
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int, timeout_s: float = 1200.0,
                     device: Optional[str] = None) -> Tuple[str, float]:
    """Run the dry run in ``n_devices`` fresh processes: NCCL on the cards
    where that many are visible, else gloo on the CPU (``device`` forces
    "cuda" or "cpu"). Raises RuntimeError with the failing rank's stderr
    tail, or on ``timeout_s``. Returns (rank 0's output, seconds)."""
    if device is None:
        device = "cuda" if torch.cuda.device_count() >= n_devices else "cpu"
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="osdm_dryrun_") as tmp:
        store = f"file://{Path(tmp) / 'store'}"
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (str(REPO), env.get("PYTHONPATH", "")) if p)
        procs, logs = [], []
        for rank in range(n_devices):
            code = ("from osteosarcoma_diffusionmodel_torch.parallel.dryrun import _dryrun_body; "
                    f"_dryrun_body({int(n_devices)}, {store!r}, {rank}, {device!r})")
            out = open(Path(tmp) / f"rank{rank}.out", "w")
            err = open(Path(tmp) / f"rank{rank}.err", "w")
            logs.append((out, err))
            procs.append(subprocess.Popen([sys.executable, "-c", code], cwd=str(REPO), env=env,
                                          stdout=out, stderr=err))
        deadline = time.monotonic() + timeout_s
        failed = None
        try:
            # A failed rank leaves the others blocked in a collective: poll
            # them all, and stop every one at the first failure.
            while failed is None and any(p.poll() is None for p in procs):
                failed = next((r for r, p in enumerate(procs) if p.poll() not in (None, 0)),
                              None)
                if failed is None and time.monotonic() > deadline:
                    failed = "timeout"
                time.sleep(0.05)
            if failed is None:
                failed = next((r for r, p in enumerate(procs) if p.returncode != 0), None)
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                proc.wait()
            for out, err in logs:
                out.close()
                err.close()
        if failed is not None:
            rank = 0 if failed == "timeout" else failed
            tail = (Path(tmp) / f"rank{rank}.err").read_text()[-4000:]
            what = (f"timed out after {timeout_s:.0f} s" if failed == "timeout"
                    else f"rank {rank} failed (rc={procs[rank].returncode})")
            raise RuntimeError(f"multi-device dry run {what}:\n{tail}")
        return (Path(tmp) / "rank0.out").read_text(), time.perf_counter() - t0
