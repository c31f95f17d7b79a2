"""The global fire's codec inside the traced round: the device's busy
time of what the ``comm.compress``, ``comm.decompress`` and
``comm.finalize`` spans inside each ``hier.fire.global`` span launched
(the fire without its learner mean and, pipelined, its bucket packing),
the mean over the round's global fires."""
from perfbench.bench import spans


def read(ctx):
    return spans.codec_ms(ctx, "hier.fire.global")
