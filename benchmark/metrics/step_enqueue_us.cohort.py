"""Host microseconds a reverse step takes to enqueue: the host time of the
program's ``sampler.steps`` spans over the steps they counted
(``COUNTERS["sampler.steps"]`` inside them), in the window. Where the
launch queue fills, it reads the device's pace."""


def read(ctx):
    try:
        from osteosarcoma_diffusionmodel_torch.utils.profiling import spans
    except ImportError:  # a program without spans
        return None
    if not ctx["requests"]:
        return None
    seconds, steps = 0.0, 0
    for s in spans(since=ctx["requests"][0]["t0"]):
        if s["name"] == "sampler.steps":
            seconds += s["t1"] - s["t0"]
            steps += s["counts"].get("sampler.steps", 0)
    return 1e6 * seconds / steps if steps else None
