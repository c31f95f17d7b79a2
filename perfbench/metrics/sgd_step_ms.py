"""One SGD step of all learners (make_sgd_step: the per-learner gradient
under vmap and the update), across a synchronize, mean of 3 after one
warm-up, on the window's last state."""


def read(ctx):
    return None if ctx.parts is None else ctx.parts["step"]
