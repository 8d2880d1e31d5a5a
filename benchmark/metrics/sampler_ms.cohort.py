"""Mean milliseconds of a request's sampler call
(``SyntheticPatientGenerator.sample_raw``: the x_T draw, the copy to the
card and the reverse loop), a span closed by a synchronize."""

from statistics import mean


def read(ctx):
    spans = [s["t1"] - s["t0"] for s in ctx["spans"] if s["name"] == "sample_raw"]
    return 1e3 * mean(spans) if spans else None
