"""The whole step's share of the chip's fp32 peak (the cells run with
TF32 off, so the tensor cores' rates do not apply): the model's own
operations in the window (2 per multiply-add of the forward pass, x 3
for forward and backward, counted from the configuration's shapes) over
the window's seconds times 67e12, in percent."""
from perfbench.bench import yardstick


def read(ctx):
    flops = 6 * ctx.adapter.macs_per_sample(ctx.cfg, ctx.traffic) \
        * ctx.samples
    return 100.0 * flops / (ctx.window_s * yardstick.PEAKS["fp32_flops"])
