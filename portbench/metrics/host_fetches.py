"""host_fetches: the host's reads of device results a request (the device
loop's batched fetch and the PCG chunks' fetches), mean over the window."""

import readers


def read(run):
    return readers.mean_of(run, "fetches")
