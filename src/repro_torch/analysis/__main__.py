"""CLI for the contract checker: ``python -m repro_torch.analysis``.

Runs on the card unless given ``--device cpu``.  The SPMD leg runs over 2
gloo ranks (``launch/mesh.py::spawn_users``) sharing the device, where
the reference forces 2 XLA host devices.  Exits 0 when the tree is clean,
1 when any contract is violated (the report names each rule).  ``--json``
emits the machine-readable report.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="two-pass contract checker "
                    "(trace contracts + repo-invariant lint)")
    ap.add_argument("paths", nargs="*",
                    help="files/dirs to lint (default: the port's targets)")
    ap.add_argument("--json", action="store_true",
                    help="emit machine-readable JSON report")
    ap.add_argument("--skip-trace", action="store_true",
                    help="skip Pass 1 (the trace contracts)")
    ap.add_argument("--skip-lint", action="store_true",
                    help="skip Pass 2 (AST lint)")
    ap.add_argument("--no-decode", action="store_true",
                    help="skip the decode-engine ladder check (slowest leg)")
    ap.add_argument("--out", help="also write the JSON report to this path")
    ap.add_argument("--device", default=None,
                    help="device of Pass 1 (default: the card; 'cpu' runs "
                         "the plain versions)")
    args = ap.parse_args(argv)

    violations, checked = [], {}

    if not args.skip_lint:
        from repro_torch.analysis.lint import run_lint
        lv, lc = run_lint(paths=args.paths or None)
        violations.extend(lv)
        checked.update(lc)

    if not args.skip_trace:
        from repro_torch.analysis.tracecheck import run_tracecheck
        tv, tc = run_tracecheck(decode=not args.no_decode,
                                device=args.device)
        violations.extend(tv)
        checked.update(tc)

    from repro_torch.analysis import render_json, render_report
    if args.out:
        with open(args.out, "w", encoding="utf-8") as fh:
            fh.write(render_json(violations, checked) + "\n")
    print(render_json(violations, checked) if args.json
          else render_report(violations, checked))
    return 1 if violations else 0


if __name__ == "__main__":
    sys.exit(main())
