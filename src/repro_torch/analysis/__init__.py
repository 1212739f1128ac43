"""The contract checker of the PyTorch port (``python -m
repro_torch.analysis``; port of the reference's ``analysis/``).

The port's engines promise more than their tests pin: carries and rows
updated in place and never copied, no host sync inside a round, no f64
that outlives the one rounding it serves, one CUDA-graph replay per chunk
holding the kernel launches the round states, and program counts within
the serve and decode bucket ladders.  This package checks those promises
over every registered engine, in two passes:

* **Pass 1 — trace contracts** (:mod:`repro_torch.analysis.tracecheck`):
  runs every engine family of every registered approach on tiny inputs
  (``core.engine.trace_specimens``, ``core.spmd.spmd_trace_specimens``,
  ``multihost.backend.multihost_trace_specimens``) under a dispatch-mode
  census, on the device the carry lives on, plus the serve and decode
  ladders (TRC001-TRC005).
* **Pass 2 — repo-invariant lint** (:mod:`repro_torch.analysis.lint`):
  named AST rules RPR001-RPR006 over the port's tree, with per-line
  ``# repro: allow(RPRxxx): why`` waivers.

The CLI exits 1 on any violation.  Reports read as the reference's, rule
for rule and key for key.
"""

from __future__ import annotations

import dataclasses
import json


@dataclasses.dataclass(frozen=True)
class Violation:
    """One broken contract: ``rule`` names what fired (RPRxxx for lint,
    TRCxxx for trace checks), ``where`` locates it (``path:line`` for
    lint, the specimen/program name for trace checks)."""

    rule: str
    where: str
    message: str

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def render_report(violations, checked: dict) -> str:
    """Human-readable report: one line per violation, grouped by rule,
    plus the coverage footer (what was actually checked — a clean run
    over nothing must not read as a clean run)."""
    lines = []
    if violations:
        lines.append(f"repro.analysis: {len(violations)} violation(s)")
        by_rule: dict[str, list[Violation]] = {}
        for v in violations:
            by_rule.setdefault(v.rule, []).append(v)
        for rule in sorted(by_rule):
            for v in by_rule[rule]:
                lines.append(f"  {rule}  {v.where}  {v.message}")
    else:
        lines.append("repro.analysis: clean")
    for k in sorted(checked):
        lines.append(f"  [checked] {k}: {checked[k]}")
    return "\n".join(lines)


def render_json(violations, checked: dict) -> str:
    return json.dumps({
        "ok": not violations,
        "violations": [v.to_dict() for v in violations],
        "checked": checked,
    }, indent=2, sort_keys=True)


def rule_counts(violations) -> dict[str, int]:
    out: dict[str, int] = {}
    for v in violations:
        out[v.rule] = out.get(v.rule, 0) + 1
    return out
