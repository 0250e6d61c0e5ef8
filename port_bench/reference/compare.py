"""The numbers that decide ``correct``, each from what the program produced
and what the reference works out again. Every number is a gap as a share
(0.01 is 1 %) and is held against the cell's limit
(``port_bench/limits/<cell>.json``).

- ``loss_gap``: the widest relative gap of a step's loss (each of the two
  losses of each step followed, each member).
- ``grad_gap``: by the worst leaf, the gap between the norms of the first
  moment that Adam holds after the first step (the first gradient as the
  optimizer got it: (1 - b1) g, or for a leaf both losses step
  b1 (1 - b1) g_main + (1 - b1) g_aux) on the two sides, over the larger of
  the reference's norm of that leaf and of the median leaf.
- ``change_gap_worst``: the same gap of the parameters' change over the
  steps followed, by the worst leaf; leaves whose first gradient in the
  reference is under a thousandth of the median leaf's move by round-off
  alone and are left out. It catches a fault confined to a few leaves (one
  leaf's update skipped, a learning-rate multiplier applied wrongly). Under
  Adam an element whose moment cancels to round-off takes a step of lr whose
  sign the round-off sets, so this widest gap swings from seed to seed (see
  PERF.md), and its limit is set from that swing.
- ``change_gap``: the same gap of the median leaf, steady from seed to seed,
  which catches a fault spread over every leaf at a much smaller size.
- ``eval_gap``: the widest relative gap of a split's statistics (the two
  ELBOs and the recon's L1).
- ``band_gap``: the widest gap of a served band or latent element, over the
  request's largest reference value of that output.
- ``label_flips``: the share of the served labels that the reference
  decides by a margin of at least 1e-4 and the program labels otherwise.
"""

from __future__ import annotations

from typing import Dict, Iterable, List

import torch

Tensor = torch.Tensor


def flatten(tree, prefix: str = "") -> Dict[str, Tensor]:
    """A nested tree of dicts and lists as a flat dict by path."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(flatten(tree[k], f"{prefix}{k}/"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(flatten(v, f"{prefix}{i}/"))
        return out
    return {prefix[:-1]: tree}


def relative_gap(prog: Iterable[float], ref: Iterable[float]) -> float:
    return max(abs(p - r) / max(abs(r), 1e-30) for p, r in zip(prog, ref))


def _norms(leaves: Dict[str, Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in leaves.items()}


def leaf_gaps(prog: Dict[str, Tensor], ref: Dict[str, Tensor]) -> Dict[str, float]:
    """Per leaf: |norm(prog) - norm(ref)| over max(norm(ref), the median
    leaf's norm(ref))."""
    pn, rn = _norms(prog), _norms({k: ref[k] for k in prog})
    median = float(torch.tensor(sorted(rn.values()), dtype=torch.float64).median())
    return {k: abs(pn[k] - rn[k]) / max(rn[k], median, 1e-30) for k in prog}


def leaf_gap(prog: Dict[str, Tensor], ref: Dict[str, Tensor]) -> float:
    """:func:`leaf_gaps` by the worst leaf."""
    return max(leaf_gaps(prog, ref).values())


def median_leaf_gap(prog: Dict[str, Tensor], ref: Dict[str, Tensor]) -> float:
    """:func:`leaf_gaps` of the median leaf (the lower median)."""
    gaps = sorted(leaf_gaps(prog, ref).values())
    return gaps[(len(gaps) - 1) // 2]


def worst_leaves(prog: Dict[str, Tensor], ref: Dict[str, Tensor], n: int = 3):
    """The ``n`` leaves of :func:`leaf_gap`'s largest gaps: (gap, leaf, the
    reference's norm, the leaf's size)."""
    pn, rn = _norms(prog), _norms(ref)
    median = float(torch.tensor(sorted(rn.values()), dtype=torch.float64).median())
    return sorted(((abs(pn[k] - rn[k]) / max(rn[k], median, 1e-30), k, rn[k], ref[k].numel()) for k in ref),
                  reverse=True)[:n]


def moving_leaves(first_grad: Dict[str, Tensor]) -> List[str]:
    """The leaves whose first gradient (in the reference) is at least a
    thousandth of the median leaf's."""
    n = _norms(first_grad)
    median = float(torch.tensor(sorted(n.values()), dtype=torch.float64).median())
    return sorted(k for k, v in n.items() if v >= 1e-3 * median)


def band_gap(prog: Dict[str, Tensor], ref: Dict[str, Tensor], keys=("mu_75", "mu_50", "mu_25", "z")) -> float:
    out = 0.0
    for k in keys:
        scale = float(ref[k].abs().max())
        out = max(out, float((prog[k] - ref[k]).abs().max()) / max(scale, 1e-30))
    return out


# a label whose probability lies nearer its decision than this is decided by
# float32 round-off; at or beyond it, the program's label must be the reference's
DECIDED = 1e-4


def label_flips(prog: Dict[str, Tensor], ref: Dict[str, Tensor], margins: Dict[str, Tensor]) -> float:
    """The share of the labels that the reference decides by a margin of at
    least :data:`DECIDED` and that the program labels otherwise (an exact
    comparison); continuous labels (margin 0) are not labels to flip."""
    flips = n = 0.0
    for k, m in margins.items():
        decided = m >= DECIDED
        flips += float(((prog[k] != ref[k]) & decided).sum())
        n += float(decided.sum())
    return flips / max(n, 1.0)


def training_gaps(prog: Dict, ref: Dict, init: Dict[str, Tensor]) -> Dict[str, float]:
    """The training numbers of one model: ``prog`` and ``ref`` each hold the
    followed steps' ``losses`` (one list), the ``first_moments`` and the
    ``params`` after the steps (flat dicts), and optionally an eval epoch's
    ``stats``; ``init`` holds the params both started from."""
    keep = moving_leaves(ref["first_moments"])
    change = ({p: prog["params"][p] - init[p] for p in keep}, {p: ref["params"][p] - init[p] for p in keep})
    out = {
        "loss_gap": relative_gap(prog["losses"], ref["losses"]),
        "grad_gap": leaf_gap(prog["first_moments"], ref["first_moments"]),
        "change_gap": median_leaf_gap(*change),
        "change_gap_worst": leaf_gap(*change),
    }
    if "stats" in ref:
        out["eval_gap"] = relative_gap(prog["stats"], ref["stats"])
    return out


def nearest_training_gaps(prog: Dict, follow, init: Dict[str, Tensor]):
    """:func:`training_gaps` against one reference: of ``follow(flips)``
    with its round-off-undecided decisions (``reference.train.undecided``:
    quantile bands and the decoder's ReLU gates) taken each way, the one
    that fits the program best, by the largest of its numbers (the first,
    with no decision turned, on a tie). An element whose target lies on a
    band within round-off is decided by the rounding, on either side; its
    side changes its gradient by a whole quantile weight but its loss by a
    round-off's worth; a ReLU pre-activation within round-off of zero turns
    its unit's gradient on or off and its value by a round-off's worth. So
    a decision of the last step followed shows in the params' change alone,
    and the fit is taken over every number, not the losses alone. Every
    number is judged against that one reference. Returns the gaps and the
    reference."""
    from port_bench.reference.train import undecided

    ref = follow(frozenset())
    gaps = training_gaps(prog, ref, init)
    for flips in undecided(ref["near"]):
        other = follow(flips)
        other_gaps = training_gaps(prog, other, init)
        if max(other_gaps.values()) < max(gaps.values()):
            ref, gaps = other, other_gaps
    return gaps, ref
