"""Mean device milliseconds a request spends in Kimi Delta Attention: the
program's ``dit.kda`` spans (a block's KDA sublayer: the projections, the
short convolutions and gates, the chunked delta-rule kernel, the gated
norm and the output projection), summed over a request's 20 KDA layers
and 50 denoiser calls."""

from benchmark.dit_spans import device_ms_per_request


def read(ctx):
    return device_ms_per_request(ctx, "dit.kda")
