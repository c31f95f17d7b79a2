"""One fire of the plan's level "local" inside the traced round (its
reducer and the learner mean; the one at the global boundary included):
the device's busy time of what each ``hier.fire.local`` span launched,
the mean over the round's fires."""
from perfbench.bench import spans


def read(ctx):
    return spans.mean_device_ms(ctx, "hier.fire.local")
