"""MLA attention's kernel (PyTorch's scaled dot-product attention at qk
192 / v 128, 16 heads, bidirectional, one launch a layer): the summed
bound of its launches over their summed device time, in percent
(``benchmark/roofline_dit.py``)."""

from benchmark.dit_spans import ATTENTION, kernel_seconds
from benchmark.roofline import bound_s
from benchmark.roofline_dit import attention


def read(ctx):
    t = ctx.get("transformer")
    if not t or not ctx.get("seq_len"):
        return None
    seconds, launches = kernel_seconds(ctx, ATTENTION)
    if not launches or seconds <= 0:
        return None
    return 100.0 * launches * bound_s(*attention(t, ctx["rows"], ctx["seq_len"])) / seconds
