"""Tracing and timing (counterpart of
osteosarcoma_diffusionmodel_tpu/utils/profiling.py on ``torch.profiler``).

- :class:`StepTimer`: per-step wall-clock meter with throughput summaries
  (a copy of the JAX package's);
- :func:`profile_trace`: a context manager around ``torch.profiler`` that
  writes a Chrome / TensorBoard trace (``*.pt.trace.json``) under
  ``log_dir``: host operators, and on the card also its kernels and
  copies;
- :func:`device_memory_stats`: ``torch.cuda.memory_stats`` of each visible
  card.

The JAX module's ``enable_compilation_cache`` has no counterpart here:
PyTorch compiles nothing per program, and the port's persistent cache is
the kernel build directory of :mod:`..ops._build`
(``osteosarcoma_diffusionmodel_torch/_build/<hash of the sources>/``),
which every later process loads without calling nvcc.
"""

from __future__ import annotations

import contextlib
import logging
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

import torch

logger = logging.getLogger(__name__)


@dataclass
class StepTimer:
    """Accumulates per-step durations; reports rates."""

    name: str = "step"
    durations: List[float] = field(default_factory=list)
    _t0: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.durations.append(time.perf_counter() - self._t0)
        self._t0 = None

    @property
    def total(self) -> float:
        return sum(self.durations)

    @property
    def count(self) -> int:
        return len(self.durations)

    def rate(self, items_per_step: int = 1) -> float:
        """Items (steps, patients, samples) per second."""
        if not self.durations:
            return 0.0
        return self.count * items_per_step / self.total

    def summary(self) -> Dict[str, float]:
        if not self.durations:
            return {"count": 0}
        return {
            "count": self.count,
            "total_s": self.total,
            "mean_s": self.total / self.count,
            "min_s": min(self.durations),
            "max_s": max(self.durations),
            "per_sec": self.rate(),
        }


@contextlib.contextmanager
def profile_trace(log_dir: str | Path, enabled: bool = True,
                  device: str | torch.device = "cuda"):
    """``torch.profiler`` over the block; on leaving it, one
    ``<host>_<pid>.<time>.pt.trace.json`` under ``log_dir`` (Chrome
    tracing, Perfetto or TensorBoard's profiler plugin). CPU and CUDA
    activities on the card, the CPU's alone where ``device`` is the CPU.
    ``enabled=False`` profiles nothing and writes nothing."""
    if not enabled:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    handler = torch.profiler.tensorboard_trace_handler(str(log_dir))
    with torch.profiler.profile(activities=activities, on_trace_ready=handler):
        yield
    logger.info("Profiler trace written to %s", log_dir)


def device_memory_stats() -> Dict[str, Dict[str, int]]:
    """``torch.cuda.memory_stats`` of each visible card, keyed
    ``cuda:<i> <name>``; empty without a card."""
    return {f"cuda:{i} {torch.cuda.get_device_name(i)}": torch.cuda.memory_stats(i)
            for i in range(torch.cuda.device_count())}
