"""Mean device milliseconds a request spends routing: the program's
``dit.router`` spans (the gate product, sigmoid, top 6 of the biased
scores, the weights, the sort by expert and the gather of the rows),
summed over a request's 26 routed layers and 50 denoiser calls."""

from benchmark.dit_spans import device_ms_per_request


def read(ctx):
    return device_ms_per_request(ctx, "dit.router")
