"""The comparisons that decide ``correct``: what a cell's program
produced against the plain reference, as the numbers its limits hold.

Train cells (each number taken by its worst case): ``loss_gap``, the
relative gap of each of the first checked steps' losses; ``grad_gap``,
the gap between the program's norm of the first step's gradient of a
leaf and the reference's; ``change_gap``, the same of the parameters'
change over the checked steps; ``replay_loss_gap``, the relative gap of
each loss of the last warm-up group, the window's kind of group (on the
card, CUDA graph replays); ``replay_change_gap``, the gap of the
student's and of the teacher's change over that group, leaf by leaf. A
leaf's gap is measured against the reference's norm of that leaf or of
the median leaf, whichever is larger, since some gradients are all but
zero; the leaves whose first gradient in the reference is nought to
rounding count in none.

Infer cells: ``label_error``, over the sampled volumes, the mean over all
voxels of how far the reference's class-1 score lies from 0.5 where the
program labelled the voxel otherwise than the reference (0 where the
labels agree).

Every number goes to standard error, and the result line carries each
with its limit.
"""

from __future__ import annotations

import sys
from typing import Dict, Sequence

import numpy as np
import torch

Leaves = Dict[str, torch.Tensor]


def leaf_gaps(prog: Leaves, ref: Leaves, skip=()) -> Dict[str, float]:
    """Each counted leaf's gap between the program's norm and the
    reference's, against the reference's norm of that leaf or of the
    median leaf, whichever is larger."""
    names = [n for n in ref if n not in skip]
    rn = {n: float(ref[n].double().norm()) for n in names}
    med = float(np.median(list(rn.values())))
    return {n: abs(float(prog[n].double().norm()) - rn[n])
            / max(rn[n], med, 1e-30) for n in names}


def worst(gaps: Dict[str, float], label: str) -> float:
    """The largest gap; the three largest, with their leaves, go to
    standard error."""
    top = sorted(gaps.items(), key=lambda kv: -kv[1])[:3]
    print(f"{label} worst leaves: " + ", ".join(f"{n} {v!r}"
                                                for n, v in top),
          file=sys.stderr)
    return top[0][1] if top else 0.0


def change(states, a: int, b: int, who: int) -> Leaves:
    """The change of the student's (``who`` 0) or the teacher's (1)
    leaves from iteration ``a`` to ``b`` of ``states`` ({it: (student,
    teacher)})."""
    return {n: v.double() - states[a][who][n].double()
            for n, v in states[b][who].items()}


def train_numbers(prog: dict, ref: dict, checked: int,
                  group: Sequence[int]) -> Dict[str, float]:
    """The train numbers (module docstring) of two runs, each ``{"losses":
    {it: loss}, "g1": the first gradients, "states": {it: (student,
    teacher)}}`` with the states at 0, ``checked``, the iteration before
    ``group`` (its iterations) and its last. Leaves whose first gradient
    in the reference is under a thousandth of the median leaf's (a conv
    bias in front of a BatchNorm) are left out of the leaf numbers."""
    def loss_gap(its):
        return max(abs(prog["losses"][i] - ref["losses"][i])
                   / max(abs(ref["losses"][i]), 1e-30) for i in its)

    gnorm = {n: float(g.double().norm()) for n, g in ref["g1"].items()}
    med = float(np.median(list(gnorm.values())))
    skip = {n for n, v in gnorm.items() if v < 1e-3 * med}
    ps, rs = prog["states"], ref["states"]
    a, b = group[0] - 1, group[-1]
    replay = [worst(leaf_gaps(change(ps, a, b, who), change(rs, a, b, who),
                              skip), f"replay_change_gap ({role})")
              for who, role in ((0, "student"), (1, "teacher"))]
    return {
        "loss_gap": loss_gap(range(1, checked + 1)),
        "grad_gap": worst(leaf_gaps(prog["g1"], ref["g1"], skip),
                          "grad_gap"),
        "change_gap": worst(leaf_gaps(change(ps, 0, checked, 0),
                                      change(rs, 0, checked, 0), skip),
                            "change_gap"),
        "replay_loss_gap": loss_gap(group),
        "replay_change_gap": max(replay)}


def label_numbers(prog_labels, ref_scores) -> Dict[str, float]:
    """``label_error`` of the sampled volumes (module docstring); the share
    of voxels labelled otherwise, which depends on how many voxels a
    seed's net leaves near 0.5, goes to standard error only."""
    gaps, total = [], 0
    for lab, p1 in zip(prog_labels, ref_scores):
        diff = torch.from_numpy(lab.astype(bool)).to(p1.device) != (p1 > 0.5)
        total += diff.numel()
        gaps.append((p1[diff] - 0.5).abs().double().cpu())
    gaps = torch.cat(gaps) if gaps else torch.zeros(0)
    print(f"label flip share: {gaps.numel() / max(total, 1)!r}",
          file=sys.stderr)
    return {"label_error": float(gaps.sum()) / max(total, 1)}


def held(nums: Dict[str, float], limits: Dict[str, float]) -> dict:
    """The numbers a cell holds, each with its limit; every number goes to
    standard error."""
    for k, v in nums.items():
        print(f"reading {k}: {v!r}", file=sys.stderr)
    return {k: {"value": nums[k], "limit": lim} for k, lim in limits.items()}
