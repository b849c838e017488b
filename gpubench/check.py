"""The comparison that decides ``correct`` for a training cell.

Both sides give the readings of the first ``check_steps`` steps (the
program's from its own train state, through the window's step and feed;
the reference's from ``reference.run``). Four numbers are compared, each
with its limit from ``limits/<cell>.json``:

- ``loss_gap``: the largest relative gap |loss - ref| / |ref| over the steps;
- ``grad_norm_gap``: the worst leaf's gap between the norms of the first
  step's gradient (before clipping), |n - n_ref| over the larger of
  n_ref and the median leaf's n_ref;
- ``grad_sample_err``: the first step's gradient itself, on a seeded
  sample of each leaf's elements (``weights.sample``): ||g - g_ref|| over
  ||g_ref|| on the samples of all leaves. Gaps between norms hardly see
  precision (a rounding error changes a norm only to second order), so at
  the Mistral cells' sizes they read the float8 control only 2-3x above
  the program; this number is the one that tells them apart;
- ``update_norm_gap``: the same of each leaf's change ||p - p_0|| after the
  last step, leaving out leaves whose first gradient in the reference is
  under a thousandth of the median leaf's (they move by round-off alone);
- ``update_sample_err``: that change itself on the same sample of
  elements, as ``grad_sample_err`` reads the gradient, over the same
  leaves. Adam's first steps move each element by about the learning rate
  whatever its gradient's size, so the norms of the change hardly see what
  the update was; an update of the wrong sign, or on the wrong elements,
  reads about 2 here (a state left unchanged reads 1).
"""

from __future__ import annotations

import math
from typing import Dict, List

NAMES = ("loss_gap", "grad_norm_gap", "grad_sample_err", "update_norm_gap", "update_sample_err")
QUIET = 1e-3    # a leaf whose gradient is under this share of the median leaf's


def median(values: List[float]) -> float:
    v = sorted(values)
    n = len(v)
    return v[n // 2] if n % 2 else 0.5 * (v[n // 2 - 1] + v[n // 2])


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], keep=None) -> List[float]:
    """Each leaf's |n - n_ref| over the larger of n_ref and the median leaf's."""
    names = [n for n in ref if keep is None or n in keep]
    if set(prog) != set(ref):
        return [math.inf]
    floor = median([ref[n] for n in names])
    return [abs(prog[n] - ref[n]) / max(ref[n], floor, 1e-30) for n in names]


def sample_err(prog: Dict[str, List[float]], ref: Dict[str, List[float]], keep=None) -> float:
    """||s - s_ref|| / ||s_ref|| over the samples of the leaves in ``keep``
    (all when None)."""
    if set(prog) != set(ref):
        return math.inf
    names = [n for n in ref if keep is None or n in keep]
    diff = sum((a - b) ** 2 for n in names for a, b in zip(prog[n], ref[n]))
    return math.sqrt(diff / max(sum(b * b for n in names for b in ref[n]), 1e-300))


def gaps(prog: dict, ref: dict) -> Dict[str, float]:
    """The compared numbers for the program's readings against the reference's."""
    losses = list(zip(prog["losses"], ref["losses"]))
    if len(losses) != len(ref["losses"]) or not all(map(math.isfinite, prog["losses"])):
        loss_gap = math.inf
    else:
        loss_gap = max(abs(a - b) / abs(b) for a, b in losses)
    g = ref["grad_norms"]
    floor = median(list(g.values()))
    moving = {n for n, v in g.items() if v >= QUIET * floor}
    out = {"loss_gap": loss_gap, "grad_norm_gap": max(leaf_gaps(prog["grad_norms"], g)),
           "grad_sample_err": sample_err(prog["grad_sample"], ref["grad_sample"]),
           "update_norm_gap": max(leaf_gaps(prog["update_norms"], ref["update_norms"], moving)),
           "update_sample_err": sample_err(prog["update_sample"], ref["update_sample"], moving)}
    return {k: (v if math.isfinite(v) else math.inf) for k, v in out.items()}


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, dict]:
    """{name: {"value", "limit", "ok"}} for every compared number: those
    whose limit is not null (a number with no upper reading, from neither
    the control nor a fault, is not compared)."""
    return {n: {"value": numbers[n], "limit": limits[n],
                "ok": bool(numbers[n] <= limits[n])}
            for n in NAMES if limits.get(n) is not None}
