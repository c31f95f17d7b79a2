"""The qint8 pack and unpack kernels' share of their roofline over the
traced rounds, together: the least time of every qint8 fire's bytes (the
fp32 side and the int8 wire with its scales, once each way) over the
device time of qint8_pack_kernel and qint8_unpack_kernel."""
from perfbench.bench import readers, yardstick


def read(ctx):
    nbytes = yardstick.round_qint8_bytes(readers.leaf_sizes(ctx),
                                         ctx.traffic,
                                         yardstick.learners(ctx.cfg))
    return readers.roofline_pct(ctx, r"\bqint8_(un)?pack_kernel\b", nbytes)
