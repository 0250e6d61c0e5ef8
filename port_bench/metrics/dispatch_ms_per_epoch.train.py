"""dispatch_ms_per_epoch.train: the epoch dispatch's host time per epoch of
the window, in ms: the self time of the program's ``dispatch.*`` spans (an
epoch's steps and eval epochs as the host puts them on the device: seeds,
copies into the graphs' buffers) and ``graph.*`` spans (the graphs'
replays) that ended inside the window, over the window's epochs
(``port_bench/spans.py``)."""

from port_bench.spans import window_ms_per_epoch


def read(run):
    return window_ms_per_epoch(run, ("dispatch.", "graph."))
