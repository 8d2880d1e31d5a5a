"""GB/s of the calibrated cohort's copy back to the host: the bytes the
device calibrator hands back (``COUNTERS["copy.d2h_bytes"]`` inside its
``calibrate.download`` spans) over those spans' device seconds (their CUDA
events), in the window."""


def read(ctx):
    try:
        from osteosarcoma_diffusionmodel_torch.utils.profiling import spans
    except ImportError:  # a program without spans
        return None
    if not ctx["requests"]:
        return None
    nbytes, ms = 0, 0.0
    for s in spans(since=ctx["requests"][0]["t0"]):
        if s["name"] == "calibrate.download" and s["device_ms"] is not None:
            nbytes += s["counts"].get("copy.d2h_bytes", 0)
            ms += s["device_ms"]
    return nbytes / (1e6 * ms) if nbytes and ms > 0 else None
