"""Aggregate-metric evaluation CLI (the JAX package's ``eval/__main__.py``;
the reference notebooks' headline numbers).

Usage:
  python -m structured_latent_odes_tpu_torch.eval cvs results_Mechanistic
  python -m structured_latent_odes_tpu_torch.eval challenge results_Mechanistic
  python -m structured_latent_odes_tpu_torch.eval proc results_Mechanistic
  python -m structured_latent_odes_tpu_torch.eval proc-heldout results_Mechanistic

Consumes the ``.npy`` artifacts dumped at test time (train/artifacts.py) and
prints the same quantities the reference's evaluation notebooks print
(BASELINE.md table). Numpy only; ``--figures`` (matplotlib) is not ported yet
and raises (ROADMAP A11-rest).
"""

import argparse
import json

from structured_latent_odes_tpu_torch.eval.metrics import (
    challenge_outcome_averaged_l1,
    cvs_class_averaged_l1,
    cvs_ground_truth_l1,
    synbio_device_averaged_l1,
    synbio_heldout_l1,
)

METRICS = {
    "cvs": ("class-averaged L1", cvs_class_averaged_l1),
    "challenge": ("outcome-averaged L1", challenge_outcome_averaged_l1),
    "proc": ("device-averaged L1", synbio_device_averaged_l1),
    "proc-heldout": ("heldout zero-shot L1 (200-sample)", synbio_heldout_l1),
}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("dataset", choices=sorted(METRICS))
    p.add_argument("results_dir")
    p.add_argument("--json", action="store_true", help="print one JSON line")
    p.add_argument("--figures", action="store_true",
                   help="render aggregate figures (not ported yet: ROADMAP A11-rest)")
    p.add_argument("--gt", default=None, metavar="CVS_NPZ",
                   help="cvs only: also score vs the NOISE-FREE ground-truth "
                        "test trajectories in the given cvs.npz")
    args = p.parse_args(argv)

    if args.figures:
        raise NotImplementedError("figures are not ported yet (ROADMAP A11-rest)")
    name, fn = METRICS[args.dataset]
    out = {}
    for tag in ("post", "prior"):
        try:
            out[tag] = fn(args.results_dir, tag)
            if args.dataset == "proc-heldout":
                # the notebook's alternate per-condition aggregation
                # (sbio_eval_heldout_final.ipynb cell 8: 11.747) — derived
                # from the already-computed base so the 200-draw sample dump
                # is read once; a failure here must not clobber the base
                from structured_latent_odes_tpu_torch.eval.metrics import (
                    synbio_heldout_l1_per_condition,
                )

                try:
                    out[f"{tag}_per_condition"] = synbio_heldout_l1_per_condition(
                        args.results_dir, tag, base=out[tag]
                    )
                except (FileNotFoundError, KeyError) as e:
                    print(f"[skip {tag}_per_condition] {e}")
        except FileNotFoundError as e:
            out[tag] = None
            print(f"[skip {tag}] missing artifact: {e.filename}")
        except KeyError as e:
            out[tag] = None
            print(
                f"[skip {tag}] artifact {e} not in {args.results_dir} — was this "
                f"directory produced by the {args.dataset} driver?"
            )
    if args.gt and args.dataset == "cvs":
        for tag in ("post", "prior"):
            try:
                out[f"gt_{tag}"] = cvs_ground_truth_l1(args.results_dir, tag, args.gt)
            except (FileNotFoundError, KeyError, ValueError) as e:
                print(f"[skip gt {tag}] {e}")
    if args.json:
        print(json.dumps({"dataset": args.dataset, "metric": name, **out}))
    else:
        for tag, v in out.items():
            if v is not None:
                print(f"{args.results_dir} l1_error_av_{tag}: {v}")
    return out


if __name__ == "__main__":
    main()
