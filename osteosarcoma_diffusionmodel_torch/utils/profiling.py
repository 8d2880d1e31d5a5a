"""Tracing and timing (counterpart of
osteosarcoma_diffusionmodel_tpu/utils/profiling.py on ``torch.profiler``).

- :func:`span`: a named range at a layer boundary of the program, recorded
  only while a ``torch.profiler`` session records (the benchmark's traced
  window, the CLI's ``--profile``): a ``record_function`` range
  ``osdm.<name>`` on the profiler's timeline, and a record in memory (its
  id, the span that caused it, the root span of its request, host times,
  and on a CUDA device a pair of events) that :func:`spans` reads;
- ``COUNTERS``: counts at the same boundaries, always kept;
- :func:`profile_trace`: a context manager around ``torch.profiler`` that
  writes a Chrome / TensorBoard trace (``*.pt.trace.json``) under
  ``log_dir``: host operators and the program's spans, and on the card also
  its kernels and copies;
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
import itertools
import logging
import threading
import time
from collections import Counter, deque
from pathlib import Path
from typing import Any, Dict, List, Optional

import torch

logger = logging.getLogger(__name__)

# Counts at the spans' boundaries since the process started:
# "sampler.steps", the reverse steps ``FusedSampler._run`` enqueued;
# "sampler.prior_device" and "sampler.prior_host", the sampler calls whose
# x_T ``FusedSampler`` drew on a card or on the host;
# "copy.d2h_bytes", the bytes of the arrays ``DeviceCalibrator`` hands
# back to the host; "copy.d2h_pinned" and "copy.d2h_pageable", the arrays
# ``copula_device.to_host`` copied from a card into page-locked blocks or,
# where those could not be had, into pageable memory, and
# "copy.host_allocs", the new page-locked blocks that took; the
# transformer denoiser's (models/dit.py) "dit.tokens", the tokens through
# its calls, "moe.routed_rows", the token copies its routed layers
# dispatched, "moe.max_expert_rows", each routed layer call's largest
# expert, summed (the scan samplers add it after a call), and
# "moe.epilogue_fused" and "moe.epilogue_eager", its routed layer calls
# whose epilogues took the kernels of ops/moe.py (no autograd, bf16) or the
# eager composition.
COUNTERS: Counter = Counter()

# The newest span records; a long profiled session keeps its last ones
# (the transformer denoiser records ~108 spans a call, ~5,400 a DDIM-50
# request, so a traced minute of requests fits).
MAX_SPANS = 1 << 17
_RECORDS: deque = deque(maxlen=MAX_SPANS)
_IDS = itertools.count(1)
_OPEN = threading.local()  # per thread, the spans entered and not yet left
_NOT_RECORDING = contextlib.nullcontext()


class _Span:
    __slots__ = ("name", "device", "id", "parent", "root", "t0", "counts0", "events", "range")

    def __init__(self, name: str, device: Optional[torch.device]):
        self.name = name
        self.device = device

    def __enter__(self):
        stack = getattr(_OPEN, "stack", None)
        if stack is None:
            stack = _OPEN.stack = []
        self.id = next(_IDS)
        self.parent = stack[-1].id if stack else None
        self.root = stack[-1].root if stack else self.id
        stack.append(self)
        self.counts0 = dict(COUNTERS)
        # The host clock is read before the range opens and before it
        # closes, where the profiler reads its own.
        self.t0 = time.perf_counter()
        self.range = torch.profiler.record_function(f"osdm.{self.name}")
        self.range.__enter__()
        self.events = None
        if self.device is not None and self.device.type == "cuda":
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record(torch.cuda.current_stream(self.device))
        return self

    def __exit__(self, *exc):
        if self.events is not None:
            self.events[1].record(torch.cuda.current_stream(self.device))
        t1 = time.perf_counter()
        self.range.__exit__(*exc)
        _OPEN.stack.pop()
        counts = {k: v - self.counts0.get(k, 0) for k, v in COUNTERS.items()
                  if v != self.counts0.get(k, 0)}
        _RECORDS.append({"name": self.name, "id": self.id, "parent": self.parent,
                         "root": self.root, "t0": self.t0, "t1": t1, "counts": counts,
                         "events": self.events})
        return False


def span(name: str, device: Optional[torch.device] = None):
    """A context manager around one layer's work, named ``osdm.<name>`` on
    the profiler's timeline. Outside a recording ``torch.profiler`` session
    it does nothing beyond that one check. Inside one it opens a
    ``record_function`` range and, on leaving, keeps a record: ``name``,
    ``id``, ``parent`` (the id of the span open around it on this thread,
    else None), ``root`` (the outermost such span: the request), ``t0`` /
    ``t1`` (``time.perf_counter``), ``counts`` (how much each of
    ``COUNTERS`` grew inside it) and, where ``device`` is a CUDA device, two
    timing events recorded on its current stream at entry and exit. It
    never synchronizes."""
    if not torch._C._autograd._profiler_enabled():
        return _NOT_RECORDING
    return _Span(name, device)


def _device_ms(events) -> Optional[float]:
    if events is None or not events[1].query():
        return None
    return events[0].elapsed_time(events[1])


def spans(since: Optional[float] = None) -> List[Dict[str, Any]]:
    """The kept records, oldest first, each with ``device_ms``: its
    device time between the two events where both have completed, else
    None. With ``since`` (a ``time.perf_counter`` reading), only the
    records of requests whose root span started at or after it."""
    records = list(_RECORDS)
    if since is not None:
        roots = {r["id"] for r in records if r["parent"] is None and r["t0"] >= since}
        records = [r for r in records if r["root"] in roots]
    out = []
    for r in records:
        rec = {k: v for k, v in r.items() if k != "events"}
        rec["device_ms"] = _device_ms(r["events"])
        out.append(rec)
    return out


def clear() -> None:
    """Forget every kept record."""
    _RECORDS.clear()


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
