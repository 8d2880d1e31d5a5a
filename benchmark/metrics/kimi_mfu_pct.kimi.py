"""The whole hybrid denoiser step's share of the card's bf16 peak: the
tokens through the window's denoiser calls (the program's counter
``dit.tokens``) times the operations of a token
(``roofline_kda.flops_per_token``: KDA, MLA, the dense layer, the router,
the shared expert and the held experts' expected share), over the window
times 989 TFLOP/s, in percent."""

from benchmark.roofline import PEAK_FLOPS
from benchmark.roofline_kda import flops_per_token


def read(ctx):
    t = ctx.get("transformer")
    tokens = ctx.get("counters", {}).get("dit.tokens", 0)
    window = (ctx.get("trace") or {}).get("window_s", 0.0)
    if not t or not t.get("linear_attn_config") or not tokens or window <= 0:
        return None
    flops = tokens * flops_per_token(t, ctx["seq_len"], ctx["patches"])
    return 100.0 * flops / (window * PEAK_FLOPS["bf16"])
