"""A cell's limits from its readings (``port_bench/tools/readings.py``), into
``port_bench/limits/<cell>.json``.

    python3 port_bench/tools/limits.py --cell CELL READINGS.json [...]

Per number: the lower reading is the largest that the program gave over the
seeds; the upper reading is the smallest of the control's (where it is
three times the lower or more) and of each fault's (where it is ten times
the lower or more; a training state left unchanged reads 1 on the moment
and change gaps and needs no run). The limit lies two thirds of the way
from the lower to the upper reading on a log scale, so it has more room
above the lower reading than below the upper. A number that the program
reads as 0 on every seed, with no upper reading above 0, is an exact
comparison: its limit is 0.
"""

from __future__ import annotations

import argparse
import json
import os

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
UNCHANGED = {"grad_gap": 1.0, "change_gap": 1.0, "change_gap_worst": 1.0}  # a training state left unchanged


def limits(rows, training: bool):
    out = {}
    n_seeds = len({r["seed"] for r in rows})
    for name in rows[0]["program"]:
        lower = max(r["program"][name] for r in rows)
        uppers = {}
        for side in (k for k in rows[0] if isinstance(rows[0][k], dict) and not k.startswith("program")):
            if name in rows[0][side]:
                v = min(r[side][name] for r in rows)
                if v >= (3 if side == "control" else 10) * lower and v > 0:
                    uppers[side] = v
        if training and name in UNCHANGED and UNCHANGED[name] >= 3 * lower:
            uppers["state_unchanged"] = UNCHANGED[name]
        if not uppers:
            if lower == 0:
                out[name] = {"limit": 0.0, "lower": 0.0, "upper": None, "exact": True, "seeds": n_seeds}
            continue
        side = min(uppers, key=uppers.get)
        upper = uppers[side]
        out[name] = {"limit": float(f"{lower ** (1 / 3) * upper ** (2 / 3):.2g}"), "lower": lower, "upper": upper,
                     "upper_from": side, "seeds": n_seeds}
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--cell", required=True)
    p.add_argument("readings", nargs="+")
    args = p.parse_args(argv)
    rows, device = [], None
    for path in args.readings:
        d = json.load(open(path))
        rows += d["rows"]
        device = d["device"]
    training = "half_batch" in rows[0]
    numbers = limits(rows, training)
    path = os.path.join(BENCH, "limits", f"{args.cell}.json")
    with open(path, "w") as f:
        json.dump({"cell": args.cell, "device": device, "seeds": sorted({r["seed"] for r in rows}),
                   "numbers": numbers}, f, indent=1)
        f.write("\n")
    print(json.dumps(numbers, indent=1))


if __name__ == "__main__":
    main()
