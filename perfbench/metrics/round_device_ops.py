"""The device operations (kernels, copies, sets in torch.profiler's
trace) launched inside the traced round's ``hier.round`` span: its
launches, counted through the profiler's correlation ids."""
from perfbench.bench import spans


def read(ctx):
    return spans.mean_device_ops(ctx, "hier.round")
