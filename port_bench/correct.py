"""The comparison that decides ``correct``.

Training (the first steps that set-up drives through the measured
loop, followed by the reference from the same weights on the same
rows):

* ``loss``: the largest gap of a step's loss, relative to the
  reference's;
* ``grad``: the first step's gradient as the optimizer got it (Adam's
  first moment after one step over 1 - beta1), by the worst leaf: the
  gap between the two norms of a leaf, over the larger of the
  reference's norm of that leaf and of the median leaf;
  ``grad_median``: the median leaf's gap, which one small leaf's noise
  does not move;
* ``change`` and ``change_median``: the parameters' change over the
  checked steps, by the worst and the median leaf in the same way,
  leaving out the leaves whose reference gradient is under a thousandth
  of the median leaf's (Adam moves those by round-off alone).

Serving (every call of the window against the reference on its batch):
``xyz`` and ``uv``, the largest absolute gap over the largest distance
of a reference keypoint from its hand's first keypoint.  A missing
output, another shape or a value that is not finite reads infinity.

Each number is held to its limit from the configuration's file; the
run is correct when every number is at or under its limit.
"""

from __future__ import annotations

import math
from statistics import median
from typing import Dict, Optional

import numpy as np

GRAD_FLOOR = 1e-3


def _norms(tree: Dict[str, np.ndarray]) -> Dict[str, float]:
    return {k: float(np.linalg.norm(np.asarray(v, np.float64)))
            for k, v in tree.items()}


def leaf_gaps(prog: Dict[str, np.ndarray], ref: Dict[str, np.ndarray],
              skip=()) -> Dict[str, float]:
    """Each leaf's | |prog| - |ref| | / max(|ref|, median |ref|); a
    missing leaf or one that is not finite reads infinity."""
    keys = [k for k in ref if k not in skip]
    if set(prog) != set(ref):
        return {k: math.inf for k in keys}
    pn, rn = _norms({k: prog[k] for k in keys}), _norms({k: ref[k]
                                                        for k in keys})
    med = median(rn.values())
    return {k: abs(pn[k] - rn[k]) / max(rn[k], med, 1e-30)
            if math.isfinite(pn[k]) else math.inf for k in keys}


def train_readings(prog: dict, ref: dict):
    """(numbers, details) of training.  ``prog`` and ``ref`` hold
    ``losses`` (each checked step's), ``grad1`` and ``params`` ({flax
    path: array}); ``ref`` also ``params0``, the weights both started
    from.  The details are what the calibration reads beside the
    numbers: each step's loss gap, the worst and the median leaf."""
    pl, rl = prog["losses"], ref["losses"]
    steps = [abs(a - b) / max(abs(b), 1e-30) if math.isfinite(a)
             else math.inf for a, b in zip(pl, rl)]
    if len(pl) != len(rl):
        steps = [math.inf]
    rg = _norms(ref["grad1"])
    med = median(rg.values())
    skip = {k for k, v in rg.items() if v < GRAD_FLOOR * med}
    change = {side: {k: np.asarray(t["params"][k], np.float64)
                     - np.asarray(ref["params0"][k], np.float64)
                     for k in t["params"]} for side, t in (("prog", prog),
                                                          ("ref", ref))}
    gaps = {"grad": leaf_gaps(prog["grad1"], ref["grad1"]),
            "change": leaf_gaps(change["prog"], change["ref"], skip)}
    numbers = {"loss": max(steps)}
    details = {"loss_steps": steps, "skipped": sorted(skip)}
    for name, g in gaps.items():
        numbers[name] = max(g.values())
        numbers[f"{name}_median"] = median(g.values())
        details[f"{name}_worst_leaf"] = max(g, key=g.get)
    return numbers, details


def _gap(p, r) -> float:
    p, r = np.asarray(p, np.float64), np.asarray(r, np.float64)
    if p.shape != r.shape or not np.isfinite(p).all():
        return math.inf
    spread = np.abs(r - r[:, :1]).max()
    return float(np.abs(p - r).max() / max(spread, 1e-30))


def serve_numbers(outputs, refs) -> Dict[str, float]:
    """``outputs``: (pool index, xyz, uv) of every call; ``refs``: the
    reference's (xyz, uv) of each pool batch."""
    xyz = uv = 0.0
    for i, p_xyz, p_uv in outputs:
        r_xyz, r_uv = refs[i]
        xyz = max(xyz, _gap(p_xyz, r_xyz))
        uv = max(uv, math.inf if p_uv is None else _gap(p_uv, r_uv))
    return {"xyz": xyz, "uv": uv}


def judge(numbers: Dict[str, float], limits: Dict[str, Optional[float]]):
    """(correct, {name: {"value", "limit"}}): correct when every number
    has a limit and is at or under it."""
    checks = {k: {"value": v, "limit": limits.get(k)}
              for k, v in numbers.items()}
    ok = all(c["limit"] is not None and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks
