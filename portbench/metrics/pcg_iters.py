"""pcg_iters: PCG iterations a request (an increment's over its Newton
steps), mean over the window."""

import readers


def read(run):
    return readers.mean_of(run, "pcg")
