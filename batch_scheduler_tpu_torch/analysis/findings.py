"""Finding/report plumbing shared by every checker in the suite."""

from __future__ import annotations

from dataclasses import dataclass
from typing import List


@dataclass
class Finding:
    checker: str
    path: str
    line: int
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}: [{self.checker}] {self.message}"


def render_all(findings: List[Finding]) -> str:
    return "\n".join(f.render() for f in findings)
