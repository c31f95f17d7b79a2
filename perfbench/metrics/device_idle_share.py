"""The share of the traced round in which no operation ran on the
device: 100 x (1 - the union of the device's kernels, copies and sets
launched in the round over the round's length), from torch.profiler's
Chrome trace."""
from perfbench.bench import trace


def read(ctx):
    if ctx.trace is None:
        return None
    a, b = ctx.trace_window
    return 100.0 * (1.0 - trace.busy_us(ctx.trace.device) / (b - a))
