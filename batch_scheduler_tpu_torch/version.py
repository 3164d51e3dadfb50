"""Build/version stamping: the port's copy of
``batch_scheduler_tpu/version.py`` (the analog of the reference's ldflags
injection of gitVersion/gitCommit/buildDate, reference version.sh:3-38).
Python has no link step, so the stamp is resolved lazily from git.

A checkout without git or without ``.git`` (a ``git archive`` of the
tree, as the card runs) still answers: the commit and the tree state read
``unknown``.
"""

from __future__ import annotations

import datetime
import os
import subprocess
from typing import Dict

__all__ = ["VERSION", "version_info", "version_string"]

VERSION = "0.1.0"
_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _git(*args: str) -> str:
    """``git -C <repo root> args`` stdout, or "" when git is missing, the
    root is no work tree, or the command fails or hangs."""
    try:
        out = subprocess.run(
            ["git", "-C", _REPO_ROOT, *args],
            capture_output=True,
            text=True,
            timeout=5,
        )
        return out.stdout.strip() if out.returncode == 0 else ""
    except (OSError, subprocess.SubprocessError):
        return ""


def version_info() -> Dict[str, str]:
    commit = _git("rev-parse", "HEAD")
    if commit:
        state = "dirty" if _git("status", "--porcelain") else "clean"
    else:
        state = "unknown"
    return {
        "version": VERSION,
        "gitCommit": commit or "unknown",
        "gitTreeState": state,
        "buildDate": datetime.datetime.now(datetime.timezone.utc).strftime(
            "%Y-%m-%dT%H:%M:%SZ"
        ),
    }


def version_string() -> str:
    info = version_info()
    return (
        f"batch-scheduler-tpu-torch v{info['version']} "
        f"({info['gitCommit'][:14]}, {info['gitTreeState']}) {info['buildDate']}"
    )
