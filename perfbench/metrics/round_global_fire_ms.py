"""One fire of the plan's level "global" inside the traced round (its
reducer and the learner mean): the device's busy time of what each
``hier.fire.global`` span launched, the mean over the round's fires."""
from perfbench.bench import spans


def read(ctx):
    return spans.mean_device_ms(ctx, "hier.fire.global")
