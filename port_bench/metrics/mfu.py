"""mfu.<part> (``mfu.train``): the whole window's share of the H100's float32
peak, in %: the model's floating-point operations that the window completed
(``port_bench/counts/model_flops.py``, from the configuration's shapes and
the model's equations) over the window's wall time (host clock), over 67
TFLOP/s (float32 outside the tensor cores; the program runs float32 with
TF32 off) on each of the run's cards."""

from port_bench.counts.kernels import FP32_FLOPS_PER_S


def read(run):
    flops = run.work.get("model_flops")
    if not flops or not run.window_s:
        return None
    return 100.0 * flops / run.window_s / (run.chips * FP32_FLOPS_PER_S)
