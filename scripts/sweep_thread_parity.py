"""Does a CVS sweep on the card depend on the host's intra-op thread count,
and is a member-sharded sweep rank bit for bit the unsharded sweep run in
member groups of its size?

Runs the four-member CVS sweep of ``chip_smoke.py`` phase 10 (d) (seeds
12..15, one epoch, ``semilinear_fused``, 1,000 generated trajectories) in
member groups of two at 8, 8 again, 4 and 1 intra-op threads, then over
``--ensemble-parallel 2`` on two ranks sharing cuda:0 over gloo at 4 and 1
threads each, and prints, for each pair, whether the best and final params
are bit for bit equal and their worst error over 1e-7 + 1e-5 |ref| (the
JAX package's member-sharded bound). Since ``nn/init.py::orthogonal`` runs
its QR at one thread, every pair must be bit for bit equal: the script
exits 1 where one is not. Needs a CUDA card:

    python3 scripts/sweep_thread_parity.py
"""

import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from structured_latent_odes_tpu_torch import sweep  # noqa: E402
from structured_latent_odes_tpu_torch.data.cvs import make_dataset  # noqa: E402
from structured_latent_odes_tpu_torch.parallel import launch  # noqa: E402
from structured_latent_odes_tpu_torch.utils.device import full_fp32  # noqa: E402
from structured_latent_odes_tpu_torch.utils.tree import tree_leaves  # noqa: E402


def compare(name, got, ref) -> bool:
    pairs = [(x.cpu(), y.cpu()) for x, y in zip(tree_leaves([got.best_params, got.state.params]),
                                                 tree_leaves([ref.best_params, ref.state.params]))]
    equal = all(torch.equal(x, y) for x, y in pairs)
    worst = max(float(((x - y).abs() / (1e-7 + 1e-5 * y.abs())).max()) for x, y in pairs)
    print(f"{name}: bit for bit {equal}, worst error / (1e-7 + 1e-5|ref|) {worst:.3e}", flush=True)
    return equal


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    full_fp32(deterministic=True)
    work = tempfile.mkdtemp(prefix="sweep_thread_parity-")
    data_dir = os.path.join(work, "cvs")
    make_dataset(data_dir, data_size=1000, device="cuda")
    argv = ["cvs", "--seeds", "12..15", "--num-epochs", "1", "--ode-backend", "semilinear_fused", "--data-path",
            data_dir, "--device", "cuda:0"]
    grouped = {}
    for name, threads in (("8", 8), ("8 again", 8), ("4", 4), ("1", 1)):
        torch.set_num_threads(threads)
        grouped[name] = sweep.run(sweep.parse_args(argv + ["--member-group", "2", "--results-root",
                                                           os.path.join(work, f"grouped-{threads}")])).result
    equal = [compare("grouped at 8 threads, run again", grouped["8 again"], grouped["8"])]
    for name in ("4", "1"):
        equal.append(compare(f"grouped at {name} threads against 8", grouped[name], grouped["8"]))
    for threads in (4, 1):
        with launch.RankPool(2, device="cuda:0", backend="gloo", timeout_s=300, threads=threads, quiet=True) as pool:
            got = pool.run(chip_smoke._rank_sweep, argv + ["--ensemble-parallel", "2", "--results-root",
                                                           os.path.join(work, f"ranks-{threads}")])[0]["result"]
        for name in ("8", "4", "1"):
            equal.append(compare(f"ranks at {threads} threads against grouped at {name}", got, grouped[name]))
    print(f"all {len(equal)} pairs bit for bit equal: {all(equal)}", flush=True)
    if not all(equal):
        sys.exit(1)


if __name__ == "__main__":
    main()
