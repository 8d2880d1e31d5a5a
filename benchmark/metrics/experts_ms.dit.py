"""Mean device milliseconds a request spends in the routed experts: the
program's ``dit.experts`` spans (``MoEFeedForward.forward``: the grouped
gate-up and down products and the weighted combine), summed over a
request's 26 routed layers and 50 denoiser calls."""

from benchmark.dit_spans import device_ms_per_request


def read(ctx):
    return device_ms_per_request(ctx, "dit.experts")
