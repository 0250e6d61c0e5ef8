"""host_calls_per_step.train: the host's calls that put work on the card
(CUDA runtime launches, graph launches, copies and sets, from the
profiler's CPU records) in the traced stretch, per step."""


def read(run):
    s, n = run.trace_summary, run.traced_work.get("steps")
    if s is None or not n:
        return None
    return s["host_calls"] / n
