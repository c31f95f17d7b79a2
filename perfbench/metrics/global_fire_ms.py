"""One fire of the plan's level "global" (its reducer and the learner
mean) alone on the window's last state: the device's busy time (the union
of its kernels, copies and sets in torch.profiler's trace) inside the
fire's annotation, closed behind a synchronize; the median of the traced
run's fires."""


def read(ctx):
    return None if ctx.parts is None else ctx.parts.get("global")
