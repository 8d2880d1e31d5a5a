"""Mean milliseconds of a request outside its sampler call: the device
calibration, the copy back to the host and the modality split."""

from statistics import mean


def read(ctx):
    inner = {s["req"]: s["t1"] - s["t0"] for s in ctx["spans"] if s["name"] == "sample_raw"}
    rest = [s["t1"] - s["t0"] - inner[s["req"]] for s in ctx["spans"]
            if s["name"] == "request" and s["req"] in inner]
    return 1e3 * mean(rest) if rest else None
