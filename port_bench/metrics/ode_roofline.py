"""ode_roofline.<part> (``ode_roofline.train``): the ODE kernels' share of
their roofline, in %: over the traced stretch, the least time that every
call of K1, K1-bwd, K2 or K3 needs at the cell's shapes
(``port_bench/counts/kernels.py``, from its bytes and operations against the
H100's peaks), summed, over those kernels' summed device time (K3's partial-
sum reduction included). Nothing where the trace holds no such kernel."""

from port_bench.counts.kernels import call_bound_ms


def read(run):
    s, shapes = run.trace_summary, run.work.get("ode_shapes")
    if s is None or shapes is None:
        return None
    need_ms = spent_s = 0.0
    for name, (count, seconds) in s["kernels"].items():
        bound = call_bound_ms(name, shapes)
        if bound is not None:
            need_ms += count * bound
            spent_s += seconds
    if not spent_s:
        return None
    return 100.0 * need_ms / (spent_s * 1e3)
