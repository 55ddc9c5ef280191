"""train_step_s: the window's wall seconds over the optimizer steps
completed in it."""


def read(r):
    steps = r.total("steps")
    return r.window_s / steps if steps else None
