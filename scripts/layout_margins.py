"""How far inside their bounds the rank layouts at proc and challenge sit
on the CPU: runs every case of tests/test_torch_layouts_{proc,challenge}.py
through the same checks (tests/_torch_layouts.py) and prints, per case, the
worst error over its tolerance of each quantity held (0: bit for bit; a
check past 1 fails the script, as it fails the test). Needs JAX (the
time-parallel cases are held against the JAX package) and about three
minutes on a few cores:

    JAX_PLATFORMS=cpu python3 scripts/layout_margins.py [--json F]
"""

import argparse
import json
import os
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [REPO, os.path.join(REPO, "tests")]

import torch  # noqa: E402

import _torch_layouts as layouts  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--json", default=None, help="also write the margins to this file")
    args = p.parse_args(argv)
    torch.set_num_threads(1)  # as the tests: the parent and the ranks it spawns
    out = {}
    with tempfile.TemporaryDirectory() as tmp, layouts.rank_pool() as pool:
        for wl in layouts.WORKLOADS:
            data = layouts.load_workload(wl)
            refs = {}
            for flags, backend, bound in layouts.CLI_CASES:
                if backend not in refs:
                    refs[backend] = layouts.run_cli(wl, os.path.join(tmp, f"{wl}-{backend}"),
                                                    ["--ode-backend", backend])
                name = " ".join(flags) + f" on {backend}"
                got = layouts.run_cli(wl, os.path.join(tmp, f"{wl}-{name.replace(' ', '')}"),
                                      ["--ode-backend", backend] + flags)
                out[f"{wl} cli {name}"] = layouts.assert_cli_matches(wl, got, refs[backend], bound)
            for is_post in (True, False):
                out[f"{wl} eval epoch {'posterior' if is_post else 'prior'}"] = layouts.assert_eval_matches(
                    pool, wl, data, is_post)
            for world in (2, 4):
                out[f"{wl} recurrence time {world}"] = layouts.assert_recurrence_timepar_matches_jax(
                    pool, wl, data, world)
                out[f"{wl} solve time {world}"] = layouts.assert_semilinear_timepar_matches_jax(pool, wl, data, world)
            grouped = layouts.run_sweep(wl, os.path.join(tmp, f"{wl}-sweep-g2"), ["--member-group", "2"])
            if wl == "proc":
                out[f"{wl} sweep ens 2"] = layouts.assert_sweep_bit_equal(
                    layouts.run_sweep(wl, os.path.join(tmp, f"{wl}-sweep-e2"), ["--ensemble-parallel", "2"]), grouped)
            out[f"{wl} sweep ens 2 data 2"] = layouts.assert_sweep_close(
                layouts.run_sweep(wl, os.path.join(tmp, f"{wl}-sweep-e2d2"),
                                  ["--ensemble-parallel", "2", "--ensemble-data-parallel", "2"]), grouped)
            for case in [k for k in out if k.startswith(wl)]:
                print(f"{case}: " + ", ".join(f"{q} {v:.3e}" for q, v in out[case].items()), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps({"worst": max(v for case in out.values() for v in case.values())}))


if __name__ == "__main__":
    main()
