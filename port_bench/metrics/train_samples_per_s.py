"""train_samples_per_s: every real trajectory stepped through a dual step in
the window, times the members that stepped it, over the window's wall time
(host clock). The window holds the epochs' evaluation, selection and host
syncs too."""


def read(run):
    if "trajectories" not in run.work or not run.window_s:
        return None
    return run.work["trajectories"] / run.window_s
