"""What the transformer denoiser's per-layer readers share: the device
milliseconds a request spends in one of the program's ``dit.*`` spans,
and its kernels' device time by name."""

from __future__ import annotations

import re
from statistics import mean
from typing import Dict, Optional, Tuple

# PyTorch's attention kernels, whichever back end runs: FlashAttention,
# the memory-efficient (CUTLASS) kernel, cuDNN's.
ATTENTION = re.compile(r"flash_fwd|fmha|attention|sdpa", re.IGNORECASE)
GROUPED = "moe_grouped_kernel"


def device_ms_per_request(ctx: dict, name: str) -> Optional[float]:
    """Mean over the window's whole requests of the device milliseconds in
    spans named ``name`` (their CUDA events). A request counts where its
    first span (``sampler.prior``) is still kept: the buffer drops the
    oldest records first, so its later ones are kept too."""
    try:
        from osteosarcoma_diffusionmodel_torch.utils.profiling import spans
    except ImportError:  # a program without spans
        return None
    if not ctx.get("requests"):
        return None
    records = spans(since=ctx["requests"][0]["t0"])
    whole = {s["root"] for s in records if s["name"] == "sampler.prior"}
    per: Dict[int, float] = {}
    for s in records:
        if s["name"] == name and s["root"] in whole and s["device_ms"] is not None:
            per[s["root"]] = per.get(s["root"], 0.0) + s["device_ms"]
    return mean(per.values()) if per else None


def kernel_seconds(ctx: dict, pattern) -> Tuple[float, int]:
    """(device seconds, launches) of the traced kernels whose name matches
    ``pattern`` (a substring or a compiled expression)."""
    kernels = (ctx.get("trace") or {}).get("kernels", {})
    seconds, launches = 0.0, 0
    for name, v in kernels.items():
        hit = pattern.search(name) if hasattr(pattern, "search") else pattern in name
        if hit:
            seconds += v["seconds"]
            launches += int(v["count"])
    return seconds, launches
