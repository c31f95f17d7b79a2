"""The top-k kernels' share of their roofline over the traced rounds:
the least time of every top-k fire's bytes (each row of each leaf or
bucket read once, k values and int32 indices a row written) over the
device time of the kernels topk_small, topk_digit and topk_compact."""
from perfbench.bench import readers, yardstick


def read(ctx):
    nbytes = yardstick.round_topk_bytes(readers.leaf_sizes(ctx), ctx.traffic,
                                        yardstick.learners(ctx.cfg))
    return readers.roofline_pct(ctx, r"\btopk_(small|digit|compact)\b",
                                nbytes)
