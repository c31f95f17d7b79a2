"""The WKV6 forward kernel's share of its roofline over the traced
rounds: the least time of its calls' bytes (one a layer and step; r, k,
v, w read and y written once, u and the states) over the device time of
wkv6_fwd_kernel."""
from perfbench.bench import readers


def read(ctx):
    nbytes = ctx.adapter.round_kernel_bytes(ctx.cfg, ctx.traffic).get(
        "wkv6_fwd", 0)
    return readers.roofline_pct(ctx, r"\bwkv6_fwd_kernel\b", nbytes)
