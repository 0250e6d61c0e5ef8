"""idle_share.<part> (``idle_share.train``): the device's idle share of the
window, in %: one less the device's busy time per epoch (the union of its
records' intervals in the traced stretch's profiler trace, over the epochs
traced) times the window's epochs, over the window's wall time (host
clock). The traced stretch alone would not do: the profiler slows the host's
launches (each replayed graph's kernels are recorded), so its own idle
share is larger than the window's, while the device's work per epoch is the
same in both."""


def read(run):
    s, traced, done = run.trace_summary, run.traced_work.get("epochs"), run.work.get("epochs")
    if s is None or not s["busy_s"] or not traced or not done or not run.window_s:
        return None
    return 100.0 * (1.0 - s["busy_s"] / traced * done / run.window_s)
