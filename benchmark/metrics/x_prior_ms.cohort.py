"""Mean milliseconds a request spends drawing x_T on the host: the
program's ``sampler.prior`` span (``FusedSampler.sample`` around its call
of ``x_prior``), summed over each request of the window."""

from statistics import mean


def read(ctx):
    try:
        from osteosarcoma_diffusionmodel_torch.utils.profiling import spans
    except ImportError:  # a program without spans
        return None
    if not ctx["requests"]:
        return None
    per = {}
    for s in spans(since=ctx["requests"][0]["t0"]):
        if s["name"] == "sampler.prior":
            per[s["root"]] = per.get(s["root"], 0.0) + s["t1"] - s["t0"]
    return 1e3 * mean(per.values()) if per else None
