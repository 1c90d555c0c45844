"""plan-lint findings, severities, pragma suppression, and rendering.

The port's copy of ``repro.analysis.report``.  A ``Finding`` is one rule
violation anchored to a source location (repo-relative path + 1-based
line).  Severities order ``info < warn < error``; the CLI exit code
considers only findings that are not *allowed* by an inline pragma:

    # plan-lint: allow(<rule>): <reason>

A pragma suppresses matching findings on its own line and on the line
directly below it (so it can ride at the end of the offending line or on
a comment line immediately above).  ``allow(rule)`` without a reason is
itself a ``pragma-no-reason`` warning — suppressions must say why, that
is the whole point of forcing them through a pragma.

The audit table (``recompile_audit``) is ``{backend: {count: {probe:
n}}}``, two counts a probe: ``grids`` (device grids built) and
``dispatches`` (kernel wrapper calls).
"""
from __future__ import annotations

import dataclasses
import json
import re
from pathlib import Path
from typing import Dict, List, Optional, Tuple

SEVERITIES = ("info", "warn", "error")

PRAGMA_RE = re.compile(
    r"#\s*plan-lint:\s*allow\(\s*([a-z0-9_,\s-]+?)\s*\)\s*(?::\s*(.*?))?\s*$")


@dataclasses.dataclass
class Finding:
    rule: str
    severity: str                      # "info" | "warn" | "error"
    path: str                          # repo-relative where possible
    line: int                          # 1-based; 0 = whole-file/object
    obj: str                           # function/surface the finding is on
    message: str
    allowed: bool = False
    allow_reason: Optional[str] = None

    def __post_init__(self):
        assert self.severity in SEVERITIES, self.severity

    def key(self) -> Tuple:
        return (self.path, self.line, self.rule, self.obj)

    def as_dict(self) -> Dict:
        return dataclasses.asdict(self)

    def render(self) -> str:
        loc = f"{self.path}:{self.line}" if self.line else self.path
        base = f"{self.severity:5s} {self.rule:22s} {loc} [{self.obj}] " \
               f"{self.message}"
        if self.allowed:
            base += f"  (allowed: {self.allow_reason})"
        return base


def severity_at_least(severity: str, threshold: str) -> bool:
    return SEVERITIES.index(severity) >= SEVERITIES.index(threshold)


# ------------------------------ pragmas ------------------------------------ #

def parse_pragmas(source: str) -> Dict[int, Tuple[Tuple[str, ...],
                                                  Optional[str]]]:
    """Line (1-based) -> (allowed rule ids, reason) for every line a
    pragma covers: the pragma's own line and the line below it."""
    out: Dict[int, Tuple[Tuple[str, ...], Optional[str]]] = {}
    for i, text in enumerate(source.splitlines(), start=1):
        m = PRAGMA_RE.search(text)
        if not m:
            continue
        rules = tuple(r.strip() for r in m.group(1).split(",") if r.strip())
        reason = (m.group(2) or "").strip() or None
        for line in (i, i + 1):
            out[line] = (rules, reason)
    return out


def pragma_findings(path: str, source: str) -> List[Finding]:
    """Reason-less pragmas are themselves findings (``pragma-no-reason``)."""
    out = []
    for i, text in enumerate(source.splitlines(), start=1):
        m = PRAGMA_RE.search(text)
        if m and not (m.group(2) or "").strip():
            out.append(Finding(
                rule="pragma-no-reason", severity="warn", path=path,
                line=i, obj="<pragma>",
                message="plan-lint allow() pragma without a reason — "
                        "state why the finding is acceptable"))
    return out


def apply_pragmas(findings: List[Finding], sources: Dict[str, str]
                  ) -> List[Finding]:
    """Mark findings allowed where a pragma in their file covers their
    line and names their rule.  ``sources`` maps finding.path -> text."""
    cache: Dict[str, Dict] = {}
    for f in findings:
        src = sources.get(f.path)
        if src is None or f.line <= 0:
            continue
        pragmas = cache.setdefault(f.path, parse_pragmas(src))
        hit = pragmas.get(f.line)
        if hit and f.rule in hit[0]:
            f.allowed = True
            f.allow_reason = hit[1] or "(no reason given)"
    return findings


# ------------------------------ rendering ---------------------------------- #

def summarize(findings: List[Finding]) -> Dict:
    by_sev = {s: 0 for s in SEVERITIES}
    by_rule: Dict[str, int] = {}
    allowed = 0
    for f in findings:
        if f.allowed:
            allowed += 1
            continue
        by_sev[f.severity] += 1
        by_rule[f.rule] = by_rule.get(f.rule, 0) + 1
    return {"by_severity": by_sev,
            "by_rule": dict(sorted(by_rule.items())),
            "allowed": allowed,
            "total": len(findings)}


def render_report(findings: List[Finding], audit_table: Optional[Dict] = None,
                  table_hash: Optional[str] = None) -> str:
    lines = ["plan-lint report", "================"]
    if not findings:
        lines.append("no findings")
    for f in sorted(findings, key=lambda f: (f.path, f.line, f.rule)):
        lines.append(f.render())
    s = summarize(findings)
    lines.append("")
    lines.append("summary: " + "  ".join(
        f"{k}={v}" for k, v in s["by_severity"].items())
        + f"  allowed={s['allowed']}")
    if s["by_rule"]:
        lines.append("rules:   " + "  ".join(
            f"{k}={v}" for k, v in s["by_rule"].items()))
    if audit_table:
        lines.append("")
        lines.append("grid-memo audit table"
                     + (f" (hash {table_hash})" if table_hash else ""))
        for backend, counts in sorted(audit_table.items()):
            for count, probes in sorted(counts.items()):
                row = "  ".join(f"{p}={n}"
                                for p, n in sorted(probes.items()))
                lines.append(f"  {backend:5s} {count:10s} {row}")
    return "\n".join(lines)


def write_json(path: Path, findings: List[Finding],
               audit_table: Optional[Dict] = None,
               table_hash: Optional[str] = None) -> None:
    payload = {"findings": [f.as_dict() for f in findings],
               "summary": summarize(findings),
               "audit_counts": audit_table or {},
               "table_hash": table_hash}
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(payload, indent=1) + "\n")
