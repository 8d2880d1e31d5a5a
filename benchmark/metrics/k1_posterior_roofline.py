"""K1 with the reverse-step epilogue (the step's output product and
posterior update): the launches' summed bound over their summed device
time, in percent. Shapes: the cell's rows, the last hidden width, the
data width, the cell's noise mode."""

from benchmark.roofline import bound_s, k1_posterior, step_products
from benchmark.trace import seconds_by_class


def read(ctx):
    seconds, launches = seconds_by_class(ctx["trace"]["kernels"]).get("k1_posterior", (0.0, 0))
    if not launches or seconds <= 0:
        return None
    (k, n), = step_products(ctx["hidden"], ctx["data_dim"])["k1_posterior"]
    return 100.0 * launches * bound_s(*k1_posterior(ctx["rows"], k, n, ctx["noise"])) / seconds
