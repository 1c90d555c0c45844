"""plan-lint CLI of the port: ``python -m repro_torch.analysis``.

Runs the three passes —

1. surface contract lint over every registered cost surface, evaluated on
   ``--device``;
2. grid-memo audit: the dynamic probe sweep over the ``"torch"`` and
   ``"cuda"`` backends (the CUDA backend's wrappers on ``--device``) and
   the static memo-key coverage of the backend sources;
3. AST host-sync lint over every ``@hot_path`` function in
   src/repro_torch —

applies inline pragmas, prints the human report, optionally writes the
structured JSON, and exits non-zero when any *unallowed* finding reaches
the ``--fail-on`` threshold.

``--device`` defaults to ``cuda`` and raises without a GPU; ``--device
cpu`` runs the surfaces and the CUDA backend's wrappers on CPU tensors,
where the wrappers take their plain versions.  ``--history`` appends a
flat numeric snapshot (severity counts + the audit table) to
``BENCH_port_plan_lint.json``.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

from repro_torch.analysis.report import (Finding, apply_pragmas, render_report,
                                         severity_at_least, summarize,
                                         write_json)

_REPO_ROOT = Path(__file__).resolve().parents[3]
HISTORY_PATH = _REPO_ROOT / "BENCH_port_plan_lint.json"


def collect(backends: Optional[Sequence[str]] = None,
            skip_audit: bool = False, device="cuda", devices=None):
    """Run all passes on ``device``; returns (findings, audit table,
    table hash).  A CUDA device without a GPU raises."""
    from repro_torch.analysis import (hotpath_lint, recompile_audit,
                                      surface_lint)
    from repro_torch.core.planning_backend import resolve_device

    device = resolve_device(device)
    findings: List[Finding] = []
    findings.extend(surface_lint.lint_registered(device=device))

    table: Dict = {}
    thash = None
    if not skip_audit:
        table, audit_findings = recompile_audit.audit_backends(
            backends, device=device, devices=devices)
        findings.extend(audit_findings)
        thash = recompile_audit.table_hash(table)
    findings.extend(recompile_audit.audit_sources())

    findings.extend(hotpath_lint.lint_tree())

    # apply pragmas globally (idempotent for the hotpath pass, which
    # already applied its own): surface and static findings are anchored
    # to real source lines too and may carry allow() pragmas
    sources: Dict[str, str] = {}
    for f in findings:
        if f.path not in sources:
            p = _REPO_ROOT / f.path
            if p.is_file():
                sources[f.path] = p.read_text()
    apply_pragmas(findings, sources)
    return findings, table, thash


def append_history(findings: List[Finding], table, thash,
                   path: Path = HISTORY_PATH) -> None:
    s = summarize(findings)
    snap = {"ts": time.strftime("%Y-%m-%dT%H:%M:%S"),
            "allowed": float(s["allowed"])}
    for sev, n in s["by_severity"].items():
        snap[sev] = float(n)
    for backend, counts in table.items():
        for count, probes in counts.items():
            for probe, n in probes.items():
                snap[f"audit.{backend}.{count}.{probe}"] = float(n)
    doc = {"bench": "port_plan_lint", "history": []}
    if path.exists():
        try:
            doc = json.loads(path.read_text())
        except (json.JSONDecodeError, OSError):
            pass
    doc.setdefault("history", []).append(snap)
    doc["history"] = doc["history"][-200:]
    doc["audit_counts"] = table
    doc["table_hash"] = thash
    path.write_text(json.dumps(doc, indent=1) + "\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="plan-lint for the port: certify the host-sync, "
                    "cost-surface and grid-memo contracts of the planning "
                    "path")
    ap.add_argument("--fail-on", choices=("info", "warn", "error", "never"),
                    default="warn",
                    help="lowest severity that fails the run (default warn)")
    ap.add_argument("--json", type=Path, default=None, metavar="PATH",
                    help="write the structured findings/summary JSON here")
    ap.add_argument("--backends", default=None,
                    help="comma-separated backend subset for the dynamic "
                         "audit (default: torch,cuda)")
    ap.add_argument("--skip-audit", action="store_true",
                    help="skip the dynamic probe sweep")
    ap.add_argument("--history", action="store_true",
                    help="append a snapshot to BENCH_port_plan_lint.json")
    ap.add_argument("--device", default="cuda",
                    help="device the surfaces and the CUDA backend's "
                         "wrappers run on (default cuda: raises without a "
                         "GPU; cpu takes the wrappers' plain versions)")
    args = ap.parse_args(argv)

    backends = args.backends.split(",") if args.backends else None
    findings, table, thash = collect(backends, skip_audit=args.skip_audit,
                                     device=args.device)

    print(render_report(findings, table or None, thash))
    if args.json is not None:
        write_json(args.json, findings, table or None, thash)
    if args.history:
        append_history(findings, table, thash)

    if args.fail_on == "never":
        return 0
    bad = [f for f in findings
           if not f.allowed and severity_at_least(f.severity, args.fail_on)]
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
