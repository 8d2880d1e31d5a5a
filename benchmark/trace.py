"""The traced window: ``torch.profiler`` over the measured window, reduced
to what the per-layer readers and the result line need.

- device time and launches by kernel name (CUDA kernels, memcpy, memset);
- ``busy_s``: the union of the device's intervals; ``window_s``: the host
  time from the profiler's start to its stop, both ends synchronized;
- the ten device operations that took most time, and the ten longest idle
  gaps of the device, each named by the innermost host operation that was
  running at the gap's middle.
"""

from __future__ import annotations

import re
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

# The port's GEMM mainloop instantiations: gemm_kernel<T, BN, kTma, kEpi,
# kQuantA>, kEpi 0 plain, 1 GroupNorm+SiLU, 2 posterior step. Demangled
# and mangled spellings.
_DEMANGLED = re.compile(r"gemm_kernel<\s*([\w:]+)\s*,\s*\d+\s*,\s*(?:true|false)\s*,\s*(\d)\s*,")
_MANGLED = re.compile(r"gemm_kernelI(\w+?)Li\d+ELb[01]ELi(\d)E")
EPILOGUES = {"0": "k1", "1": "k1_gn", "2": "k1_posterior"}


def kernel_class(name: str) -> Optional[str]:
    """"k1", "k1_gn" or "k1_posterior" for the bf16 mainloop's launches
    (K1 and its fused epilogues), None for any other device operation."""
    for pat in (_DEMANGLED, _MANGLED):
        hit = pat.search(name)
        if hit:
            dtype, epi = hit.groups()
            if "bfloat16" not in dtype:
                return None
            return EPILOGUES.get(epi)
    return None


def _union_seconds(starts: np.ndarray, ends: np.ndarray) -> Tuple[float, List[Tuple[int, int]]]:
    """(seconds covered by the intervals, the gaps between them as
    (start, end) ns)."""
    if not len(starts):
        return 0.0, []
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], ends[order]
    run_end = np.maximum.accumulate(e)
    gap_at = np.nonzero(s[1:] > run_end[:-1])[0]
    block_starts = np.concatenate([[s[0]], s[gap_at + 1]])
    block_ends = np.concatenate([run_end[gap_at], [run_end[-1]]])
    gaps = list(zip(run_end[gap_at].tolist(), s[gap_at + 1].tolist()))
    return float((block_ends - block_starts).sum()) / 1e9, gaps


class TracedWindow:
    """Context manager: profiles the block; :meth:`summary` reduces it."""

    def __init__(self, device: torch.device):
        self.device = device
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.window_s = 0.0

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __enter__(self):
        self._sync()
        self.prof.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._sync()
        self.window_s = time.perf_counter() - self._t0
        self.prof.__exit__(*exc)
        return False

    def _events(self):
        results = getattr(self.prof.profiler, "kineto_results", None)
        if results is not None:
            for e in results.events():
                yield (e.name(), e.device_type() == torch.autograd.DeviceType.CUDA,
                       int(e.start_ns()), int(e.duration_ns()))
            return
        for e in self.prof.events():  # older profilers
            yield (e.name, e.device_type == torch.autograd.DeviceType.CUDA,
                   int(e.time_range.start * 1000), int(e.time_range.elapsed_us() * 1000))

    def summary(self, top: int = 10) -> dict:
        events = [e for e in self._events() if e[3] > 0]
        cpu = [e for e in events if not e[1] and not e[0].startswith(("ProfilerStep", "[memory]"))]
        # A host range (``record_function``: the benchmark's spans, the
        # optimizer's step) is mirrored onto the device's timeline under
        # its own name; it is no device work.
        host_names = {e[0] for e in cpu}
        by_name: Dict[str, List[float]] = {}
        dev_s, dev_e = [], []
        for name, _, start, dur in (e for e in events if e[1] and e[0] not in host_names):
            slot = by_name.setdefault(name, [0.0, 0])
            slot[0] += dur / 1e9
            slot[1] += 1
            dev_s.append(start)
            dev_e.append(start + dur)
        cpu_names = [e[0] for e in cpu]
        cpu_s = [e[2] for e in cpu]
        cpu_e = [e[2] + e[3] for e in cpu]
        busy_s, gaps = _union_seconds(np.asarray(dev_s, np.int64), np.asarray(dev_e, np.int64))
        gaps.sort(key=lambda g: g[0] - g[1])
        cs, ce = np.asarray(cpu_s, np.int64), np.asarray(cpu_e, np.int64)
        idle = []
        for g0, g1 in gaps[:top]:
            mid = (g0 + g1) // 2
            hits = np.nonzero((cs <= mid) & (ce >= mid))[0] if len(cs) else []
            label = cpu_names[hits[np.argmax(cs[hits])]] if len(hits) else "host: no operator"
            idle.append([label, (g1 - g0) / 1e9])
        ops = sorted(by_name.items(), key=lambda kv: -kv[1][0])
        return {
            "kernels": {k: {"seconds": v[0], "count": v[1]} for k, v in by_name.items()},
            "busy_s": busy_s,
            "window_s": self.window_s,
            "device_ops": [[k, v[0]] for k, v in ops[:top]],
            "idle_gaps": idle,
        }


def seconds_by_class(kernels: Dict[str, dict]) -> Dict[str, Tuple[float, int]]:
    """(device seconds, launches) of each :func:`kernel_class`."""
    out: Dict[str, List[float]] = {}
    for name, v in kernels.items():
        cls = kernel_class(name)
        if cls is not None:
            slot = out.setdefault(cls, [0.0, 0])
            slot[0] += v["seconds"]
            slot[1] += v["count"]
    return {k: (v[0], int(v[1])) for k, v in out.items()}
