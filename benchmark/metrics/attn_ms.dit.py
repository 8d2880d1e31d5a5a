"""Mean device milliseconds a request spends in MLA attention: the
program's ``dit.attn`` spans (a block's RMSNorm, projections, RoPE,
attention and output projection), summed over a request's 27 layers and
50 denoiser calls."""

from benchmark.dit_spans import device_ms_per_request


def read(ctx):
    return device_ms_per_request(ctx, "dit.attn")
