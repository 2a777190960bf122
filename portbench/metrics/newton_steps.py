"""newton_steps: Newton steps an increment (IncrementRecord), mean over
the window."""

import readers


def read(run):
    return readers.mean_of(run, "newton")
