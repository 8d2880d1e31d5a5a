"""The whole step's share of the card's bf16 peak: the denoiser's FLOPs
(2 x multiply-accumulates a row) of every reverse step completed in the
traced window (K1+posterior launches, one a step), over the window times
989 TFLOP/s, in percent."""

from benchmark.roofline import PEAK_FLOPS


def read(ctx):
    steps = ctx["counters"].get("k1_posterior", 0)
    window = ctx["trace"]["window_s"]
    if not steps or window <= 0:
        return None
    flops = steps * ctx["rows"] * 2.0 * ctx["macs_per_row"]
    return 100.0 * flops / (window * PEAK_FLOPS["bf16"])
