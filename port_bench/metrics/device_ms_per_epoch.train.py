"""device_ms_per_epoch.train: the device's busy time (the union of its
records' intervals in the profiler's trace) per epoch of the traced
stretch, in ms."""


def read(run):
    s, n = run.trace_summary, run.traced_work.get("epochs")
    if s is None or not n or not s["busy_s"]:
        return None
    return s["busy_s"] * 1e3 / n
