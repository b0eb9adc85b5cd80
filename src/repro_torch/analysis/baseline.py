"""Findings, stable fingerprints, and the known-good baseline.

A finding's fingerprint deliberately excludes the line number: the
baseline must survive unrelated edits shifting code around.  It hashes
``check | file | function | detail`` — moving an intentional pattern to
a different function (or changing what it does) re-surfaces it, which is
what we want.

The baseline file is JSON, human-edited, with one **justification** per
suppressed finding — review-time documentation of *why* the pattern is
intentional.  Stale entries (fingerprints no longer produced) are
reported as warnings so the file shrinks as fixes land.
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Tuple


@dataclass(frozen=True)
class Finding:
    check: str              # lock-order-cycle | blocking-under-lock | ...
    file: str               # repo-relative path
    function: str           # qualname (or "-" for package-level findings)
    line: int
    detail: str             # stable, human-readable description
    chain: Tuple[str, ...] = ()  # call chain, for propagated findings

    def format(self) -> str:
        loc = f"{self.file}:{self.line}"
        out = f"[{self.check}] {loc} {self.function}: {self.detail}"
        if self.chain:
            out += "\n    via " + " -> ".join(self.chain)
        return out

    def to_dict(self) -> dict:
        return {"check": self.check, "file": self.file,
                "function": self.function, "line": self.line,
                "detail": self.detail, "chain": list(self.chain),
                "fingerprint": fingerprint(self)}


def fingerprint(f: Finding) -> str:
    key = "|".join((f.check, f.file, f.function, f.detail))
    return hashlib.sha1(key.encode()).hexdigest()[:16]


@dataclass
class Baseline:
    entries: Dict[str, str] = field(default_factory=dict)  # fp -> why
    # the raw suppression dicts as loaded, so a scoped rewrite
    # (``--write-baseline --only <check>``) can keep other checkers'
    # entries verbatim instead of dropping them
    raw: List[dict] = field(default_factory=list)

    @classmethod
    def load(cls, path: Path) -> "Baseline":
        if not path.exists():
            return cls()
        data = json.loads(path.read_text())
        raw = list(data.get("suppressions", []))
        entries = {e["fingerprint"]: e.get("justification", "")
                   for e in raw}
        return cls(entries=entries, raw=raw)

    def save(self, path: Path, findings: List[Finding],
             justifications: Dict[str, str] | None = None,
             keep: List[dict] | None = None):
        """Rewrite ``path`` from ``findings``: entries whose finding is
        no longer produced are pruned, existing justifications are kept.
        ``keep`` appends extra suppression dicts verbatim (entries for
        checks excluded from a scoped run)."""
        justifications = justifications or {}
        sup = []
        for f in sorted(findings, key=lambda x: (x.check, x.file, x.line)):
            fp = fingerprint(f)
            sup.append({
                "fingerprint": fp,
                "check": f.check,
                "file": f.file,
                "function": f.function,
                "detail": f.detail,
                "justification": justifications.get(
                    fp, self.entries.get(fp, "TODO: justify or fix")),
            })
        seen = {e["fingerprint"] for e in sup}
        for e in keep or []:
            if e.get("fingerprint") not in seen:
                sup.append(e)
        path.write_text(json.dumps({"suppressions": sup}, indent=2) + "\n")

    def split(self, findings: List[Finding]
              ) -> Tuple[List[Finding], List[Finding], List[str]]:
        """(new, suppressed, stale_fingerprints)."""
        new: List[Finding] = []
        suppressed: List[Finding] = []
        seen = set()
        for f in findings:
            fp = fingerprint(f)
            seen.add(fp)
            (suppressed if fp in self.entries else new).append(f)
        stale = sorted(fp for fp in self.entries if fp not in seen)
        return new, suppressed, stale
