"""device_idle_share: percent of the traced window in which no operation
ran on the card (profiler timeline)."""

import readers


def read(run):
    return readers.idle_share(run)
