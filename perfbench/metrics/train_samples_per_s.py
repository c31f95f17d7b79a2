"""Samples trained a second: learners x per-learner batch x SGD steps
completed in the window, over the window's seconds (host clock, the
window closed behind a synchronize)."""


def read(ctx):
    return ctx.samples / ctx.window_s
