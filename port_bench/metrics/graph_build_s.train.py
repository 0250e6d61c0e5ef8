"""graph_build_s.train: the CUDA graphs' builds in set-up, in s: the self
time of the program's ``graph.warm`` (a graph's eager first call) and
``graph.capture`` spans that ended between the process's start and the
window's open (``port_bench/spans.py``); 0 where the program ran no graph
(off the card)."""

from port_bench.spans import self_ms


def read(run):
    if not run.ticks:
        return None
    ms = self_ms(run.t0, run.ticks[0], ("graph.warm", "graph.capture"))
    return None if ms is None else ms / 1e3
