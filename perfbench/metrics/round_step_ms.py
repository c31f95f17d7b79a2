"""One SGD step of all learners inside the traced round: the device's
busy time (the union of its kernels, copies and sets in torch.profiler's
trace) of what each ``hier.step`` span of ``make_hier_round`` launched,
the mean over the round's steps."""
from perfbench.bench import spans


def read(ctx):
    return spans.mean_device_ms(ctx, "hier.step")
