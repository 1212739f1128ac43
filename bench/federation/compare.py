"""The numbers that decide ``correct`` in a federation cell: the program's
readings of the window's own call, made once in set-up
(``program.first_call``), against the plain reference's readings of the
same rounds from the same seed (``reference.run``).

* ``init_gap``: the largest absolute difference of the initial G and D
  (both drawn from the seed: exact, limit 0);
* ``loss_gap``: the largest relative gap of a member's D loss in the first
  round (the initial D on its real batch and on ``G(z1)``);
* ``chunk_loss_gap``: the same over the other rounds of the first chunk
  (the rounds that one CUDA graph replays): each round's batch, noise and
  step as the graph indexes them;
* ``step_gap``: the largest difference of a user's Adam step count, or in
  a cohort of the round it last trained in, over all users (exact, limit
  0): the store's gather and scatter of every scheduled row;
* ``state_gap``: the worst leaf's gap between the norms of the state after
  the call, relative to the reference's norm of that leaf or of the median
  leaf of its group, whichever is larger.  The groups: G's and the server
  D's change, and over every user that trained its stored D row's change,
  Adam's ``mu`` and ``nu`` (the gradients as the optimizer holds them) and
  the error-feedback residual.  It holds the top-k mask, the int8 round
  trip, the fold, the re-sync, G's step and the store.

Later rounds are compared through norms alone, at limits set against the
faults: Adam's first step moves every weight by about ``lr`` whatever its
gradient's size, and the top-k mask then chooses among deltas that tie to
the last bit, so a rounding-level difference in a gradient moves some
weights by ``lr`` the other way and some others into or out of the upload.
Leaves whose first gradient in the reference is under a thousandth of the
median leaf's move by round-off alone under Adam; they are left out of
``state_gap`` by that rule (``EXCLUDE``), never by name.
"""

from __future__ import annotations

import statistics

import torch

EXCLUDE = 1e-3
NAMES = ("init_gap", "loss_gap", "chunk_loss_gap", "step_gap", "state_gap")


def _worse(cur: float, new: float) -> float:
    """The larger of the two, a NaN reading as infinitely far."""
    return float("inf") if new != new else max(cur, new)


def _rel(prog_rows, ref_rows) -> float:
    worst = 0.0
    for a_row, b_row in zip(prog_rows, ref_rows, strict=True):
        for a, b in zip(a_row, b_row, strict=True):
            worst = _worse(worst, abs(a - b) / abs(b))
    return worst


def _excluded(ref_grad: dict) -> set:
    """``(model, leaf)`` pairs whose largest first gradient in the
    reference is under ``EXCLUDE`` times its model's median leaf's."""
    top: dict[tuple, float] = {}
    for k, v in ref_grad.items():
        key = ("g" if k.startswith("g.") else "d", k.split(".", 1)[1])
        top[key] = max(top.get(key, 0.0), v)
    out = set()
    for m in ("g", "d"):
        vals = [v for (mm, _), v in top.items() if mm == m]
        med = statistics.median(vals)
        out |= {(mm, k) for (mm, k), v in top.items()
                if mm == m and v < EXCLUDE * med}
    return out


def _state_gap(prog: dict, ref: dict, ref_grad: dict) -> float:
    skip = _excluded(ref_grad)
    groups: dict[str, list] = {}
    for key, v in ref.items():
        groups.setdefault(key.split(".", 1)[0], []).append(v)
    medians = {g: statistics.median(v) for g, v in groups.items()}
    worst = 0.0
    for key, r in ref.items():
        group, leaf = key.split(".", 1)
        if (("g" if group == "g" else "d"), leaf) in skip:
            continue
        if key not in prog:
            return float("inf")
        worst = _worse(worst, abs(prog[key] - r) / max(r, medians[group]))
    return worst


def gaps(prog: dict, ref: dict) -> dict:
    """The numbers of ``correct`` (see the module docstring)."""
    init = 0.0
    for p, r in [(prog["init"]["g"][k], v) for k, v in ref["init"]["g"].items()
                 ] + [(prog["init"]["d_flat"], ref["init"]["d_flat"])]:
        init = _worse(init, float(torch.max(torch.abs(p - r))))
    if prog["members"] != ref["members"]:
        return dict.fromkeys(NAMES, float("inf")) | {"init_gap": init}
    k = prog["chunk"]
    steps = max(abs(a - b) for a, b in zip(prog["steps"], ref["steps"],
                                           strict=True))
    if "last" in prog:
        steps = max(steps, max(abs(a - b) for a, b in
                               zip(prog["last"], ref["last"], strict=True)))
    return {"init_gap": init,
            "loss_gap": _rel(prog["losses"][:1], ref["losses"][:1]),
            "chunk_loss_gap": _rel(prog["losses"][1:k], ref["losses"][1:k]),
            "step_gap": float(steps),
            "state_gap": _state_gap(prog["state"], ref["state"],
                                    ref["grad"])}
