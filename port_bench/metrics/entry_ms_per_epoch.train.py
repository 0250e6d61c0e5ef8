"""entry_ms_per_epoch.train: the training entry's own host time per epoch of
the window, in ms: the self time of the program's ``entry.*`` spans (the
driver's shuffle and stacking, put, selection, checkpoint and epoch line;
the sweep's chunk moves, val seeds and selection) that ended inside the
window, over the window's epochs (``port_bench/spans.py``)."""

from port_bench.spans import window_ms_per_epoch


def read(run):
    return window_ms_per_epoch(run, ("entry.",))
