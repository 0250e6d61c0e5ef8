"""wait_ms_per_epoch.train: the host's time waiting on the device per epoch
of the window, in ms: the self time of the program's ``wait.*`` spans (the
epoch's losses, the eval statistics' reads, the sweep's one sync an epoch)
that ended inside the window, over the window's epochs
(``port_bench/spans.py``)."""

from port_bench.spans import window_ms_per_epoch


def read(run):
    return window_ms_per_epoch(run, ("wait.",))
