"""The frozen counts (port_bench/counts/) return chip_smoke.py's bounds at
the shapes of PERF.md's kernel table, and the table's rounded numbers."""

import pytest

from port_bench.counts import kernels
from port_bench.counts.model_flops import per_trajectory
from port_bench import harness

# (function, arguments, PERF.md's bound in ms): midpoint (S = 2); CVS B = 128,
# T = 86 (85 steps), D = 5; proc B = 36, T = 100, D = 8; challenge B = 32, T = 142
TABLE = [
    ("k1_bound_ms", (85, 128 * 5), 0.00020),
    ("k1_bound_ms", (99, 36 * 8), 0.00010),
    ("k1_bwd_bound_ms", (85, 128 * 5), 0.00033),
    ("k1_bwd_bound_ms", (99, 36 * 8), 0.00017),
    ("k2_bound_ms", (128, 86, 2, 25, 5), 0.00018),
    ("k2_bound_ms", (36, 100, 2, 25, 8), 0.00009),
    ("k3_bound_ms", (128, 86, 2, 25, 5), 0.00054),
    ("k3_bound_ms", (36, 100, 2, 25, 8), 0.00027),
    ("k2_bound_ms", (1280, 86, 2, 25, 5, 10), 0.00179),
    ("k2_bound_ms", (180, 100, 2, 25, 8, 5), 0.00045),
    ("k3_bound_ms", (1280, 86, 2, 25, 5, 10), 0.00536),
    ("k3_bound_ms", (180, 100, 2, 25, 8, 5), 0.00136),
    ("k1_bound_ms", (85, 16411 * 5), 0.02518),
    ("k1_bwd_bound_ms", (85, 16411 * 5), 0.04184),
    ("k2_bound_ms", (16411, 86, 2, 25, 5), 0.02290),
    ("k3_bound_ms", (16411, 86, 2, 25, 5), 0.06871),
]


@pytest.mark.parametrize("fn, args, table_ms", TABLE, ids=lambda x: str(x))
def test_bounds_are_chip_smokes(fn, args, table_ms):
    import chip_smoke

    ours = getattr(kernels, fn)(*args)
    assert ours == getattr(chip_smoke, fn)(*args)
    assert ours[0] == pytest.approx(table_ms, abs=0.5 * 10 ** -(len(f"{table_ms:.5f}") - 2))


@pytest.mark.parametrize("name, shapes, fn, args", [
    ("void affine_scan_fwd_kernel<5>(float const*, float const*)", dict(B=128, T=86, S=2, H=25, D=5, members=1),
     "k1_bound_ms", (85, 640)),
    ("affine_scan_bwd_kernel", dict(B=128, T=86, S=2, H=25, D=5, members=1), "k1_bwd_bound_ms", (85, 640)),
    ("void fused_semilinear_fwd_kernel<0>(float const*)", dict(B=360, T=100, S=2, H=25, D=8, members=10),
     "k2_bound_ms", (360, 100, 2, 25, 8, 10)),
    ("fused_semilinear_bwd_kernel<0>", dict(B=360, T=100, S=2, H=25, D=8, members=10),
     "k3_bound_ms", (360, 100, 2, 25, 8, 10)),
])
def test_a_trace_record_gets_its_kernels_bound(name, shapes, fn, args):
    assert kernels.call_bound_ms(name, shapes) == getattr(kernels, fn)(*args)[0]


def test_other_records_have_no_bound():
    shapes = dict(B=1, T=2, S=2, H=1, D=1, members=1)
    assert kernels.call_bound_ms("reduce_partials", shapes) == 0.0
    assert kernels.call_bound_ms("void at::native::vectorized_elementwise_kernel", shapes) is None


@pytest.mark.parametrize("config", ["cvs", "proc"])
def test_model_flops_grow_with_the_work(config):
    cfg = harness.configuration(harness.benchmark(), config)
    f = per_trajectory(cfg, 100 if config == "proc" else 86)
    assert 0 < f["classify"] <= f["aux"] < f["main"]
    assert f["recon"] < f["main"] and f["dual_step"] == 3 * (f["main"] + f["aux"])
    assert 1e5 < f["dual_step"] < 1e7
