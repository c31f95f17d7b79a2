"""Seconds from the process's start to the window's first round: imports,
the kernels' load (and their build on a checkout's first run), the
weights, the round and its state, and the checked rounds that warm every
shape."""


def read(ctx):
    return ctx.setup_s
