"""The WKV6 backward kernel's share of its roofline over the traced
rounds: the least time of its calls' bytes (one a layer and step; r, k,
v, w and dy read, their gradients written, u, du and the states) over the
device time of wkv6_bwd_kernel."""
from perfbench.bench import readers


def read(ctx):
    nbytes = ctx.adapter.round_kernel_bytes(ctx.cfg, ctx.traffic).get(
        "wkv6_bwd", 0)
    return readers.roofline_pct(ctx, r"\bwkv6_bwd_kernel\b", nbytes)
