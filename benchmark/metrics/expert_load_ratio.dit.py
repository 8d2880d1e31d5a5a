"""How uneven the routing is: the largest expert's rows over the mean
expert's, summed over the window's routed layer calls (the program's
counters ``moe.max_expert_rows`` and ``moe.routed_rows``). 1 is an even
split; the grouped products wait on the largest expert's tiles."""


def read(ctx):
    c = ctx.get("counters", {})
    t = ctx.get("transformer")
    routed, most = c.get("moe.routed_rows", 0), c.get("moe.max_expert_rows", 0)
    if not t or not routed or not most:
        return None
    return most / (routed / int(t["n_routed_experts"]))
