"""The grouped expert kernel (``moe_grouped_kernel``: the routed experts,
52 launches a denoiser call): the summed bound of its launches over their summed device
time, in percent (``benchmark/roofline_dit.py``)."""

from benchmark.dit_spans import GROUPED, kernel_seconds
from benchmark.roofline_dit import grouped_bound_s, grouped_products


def read(ctx):
    t = ctx.get("transformer")
    if not t or not ctx.get("tokens_per_call"):
        return None
    seconds, launches = kernel_seconds(ctx, GROUPED)
    per_call = len(grouped_products(t, 1))
    if not launches or seconds <= 0 or launches % per_call:
        return None
    return 100.0 * (launches // per_call) * grouped_bound_s(t, ctx["tokens_per_call"]) / seconds
