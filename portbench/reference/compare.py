"""The comparisons that decide ``correct`` for a training cell.

A training cell compares the program's first three steps with the plain
reference's from the same weights, batches and generator seed:

- ``loss_gap``: the largest relative distance between the two sides' losses
  of one step;
- ``grad_gap``: by the worst leaf, the distance between the norms of the
  two sides' first gradients (the program's read from its Adam first moment
  after one step), over the larger of the reference's norm of that leaf and
  the median leaf's;
- ``change_gap``: the same of the parameters' change after the three
  steps, leaving out the leaves whose reference gradient is under a
  thousandth of the median leaf's (round-off moves them under Adam).
"""

from __future__ import annotations

import statistics

NEGLIGIBLE = 1e-3


def _worst(prog: dict, ref: dict, keys) -> float:
    med = statistics.median(ref[k] for k in keys)
    return max(abs(prog[k] - ref[k]) / max(ref[k], med) for k in keys)


def negligible(ref: dict) -> list[str]:
    """The leaves whose reference gradient is under ``NEGLIGIBLE`` times
    the median leaf's."""
    med = statistics.median(ref["grad"].values())
    return sorted(k for k, g in ref["grad"].items() if g < NEGLIGIBLE * med)


def train_numbers(prog: dict, ref: dict) -> dict[str, float]:
    if set(prog["grad"]) != set(ref["grad"]) or len(prog["losses"]) != len(ref["losses"]):
        raise RuntimeError("the program's and the reference's readings cover different leaves or steps")
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"]))
    leaves = sorted(ref["grad"])
    left_out = set(negligible(ref))
    moved = [k for k in leaves if k not in left_out]
    return {"loss_gap": loss_gap, "grad_gap": _worst(prog["grad"], ref["grad"], leaves),
            "change_gap": _worst(prog["change"], ref["change"], moved)}
