"""K1 with the GroupNorm+SiLU epilogue (the ten block products of a
step): their summed bound over their summed device time, in percent."""

from benchmark.roofline import bound_s, k1_gn, step_products
from benchmark.trace import seconds_by_class


def read(ctx):
    seconds, launches = seconds_by_class(ctx["trace"]["kernels"]).get("k1_gn", (0.0, 0))
    shapes = step_products(ctx["hidden"], ctx["data_dim"])["k1_gn"]
    if not launches or seconds <= 0 or launches % len(shapes):
        return None
    per_step = sum(bound_s(*k1_gn(ctx["rows"], k, n)) for k, n in shapes)
    return 100.0 * (launches // len(shapes)) * per_step / seconds
