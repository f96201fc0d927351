"""Finding model shared by the graftlint engine, rules and CLI.

A finding is one rule violation at one source location. Findings carry a
stable *fingerprint* (rule + relative path + the stripped source line) so
a baseline file keeps ignoring a pre-existing violation even when the
file around it grows or shrinks.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field

ERROR = "error"
WARNING = "warning"


@dataclass(frozen=True)
class Finding:
    rule: str
    path: str            # repo-relative (or absolute for out-of-tree files)
    line: int            # 1-based
    message: str
    severity: str = ERROR
    source_line: str = field(default="", compare=False)

    def fingerprint(self) -> str:
        key = f"{self.rule}|{self.path}|{self.source_line.strip()}"
        return hashlib.sha1(key.encode("utf-8")).hexdigest()[:16]

    def render(self) -> str:
        return (f"{self.path}:{self.line}: {self.severity}: "
                f"[{self.rule}] {self.message}")
