"""Mean device milliseconds of a request's eigen-whitening: the program's
``calibrate.whiten`` span (``copula_device._whiten_exact``: the f64 Gram,
``eigh`` and the whitening product), timed by its CUDA events, summed over
each request of the window."""

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
        if s["name"] == "calibrate.whiten" and s["device_ms"] is not None:
            per[s["root"]] = per.get(s["root"], 0.0) + s["device_ms"]
    return mean(per.values()) if per else None
