"""The KDA kernel (``kda_chunk_kernel``, one launch a KDA layer call): the
summed bound of its launches over their summed device time, in percent.
The bound of a launch is the larger of its f32 products over the f32 peak
(67 TFLOP/s: the kernel computes on the CUDA cores, not the tensor cores)
and its bytes over 3.35 TB/s (``benchmark/roofline_kda.py``)."""

from benchmark.dit_spans import kernel_seconds
from benchmark.roofline_kda import kda_chunk_bound_s


def read(ctx):
    t = ctx.get("transformer")
    if not t or not t.get("linear_attn_config") or not ctx.get("seq_len"):
        return None
    seconds, launches = kernel_seconds(ctx, "kda_chunk_kernel")
    if not launches or seconds <= 0:
        return None
    return 100.0 * launches * kda_chunk_bound_s(t, ctx["rows"], ctx["seq_len"]) / seconds
