"""Build the port's CUDA sources with ``nvcc`` at first use and load them.

Each ``csrc/<name>.cu`` compiles into a shared library with a plain C
interface (``nvcc -gencode arch=compute_90a,code=sm_90a -shared``), loaded
with ``ctypes``. A library of ``VARIANTS`` is another source built with
extra flags (the policy scan is ``assign_scan.cu`` with
``-DBST_POLICY_SCAN``, its own library, so its instantiations compile in
their own ``nvcc`` beside the base kernel's). Libraries land in
``batch_scheduler_tpu_torch/build/`` (gitignored), named by a digest of
the source, the ``csrc/*.cuh`` headers it includes and the flags
(``digest``), so an edited source or header rebuilds and an unchanged one
loads at once: the build directory is the port's compilation cache. Each
library a process gets, built or loaded, lands one entry in the compile
ledger (``utils.profiler.COMPILE_LEDGER``).

Nothing here runs at import time: the CPU tests import every module on a
machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

__all__ = ["BUILD_DIR", "CSRC_DIR", "VARIANTS", "digest", "library"]

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

# library name -> (source stem in csrc/, extra nvcc flags)
VARIANTS = {"assign_policy": ("assign_scan", ("-DBST_POLICY_SCAN=1",))}

_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)

# _lock guards both tables and is held only to read or write them; a
# build holds its library's own entry in _locks, so one library's nvcc
# never waits for another's
_lock = threading.Lock()
_locks: Dict[str, threading.Lock] = {}  # guarded-by: _lock
_libs: Dict[str, ctypes.CDLL] = {}  # guarded-by: _lock


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for candidate in (
        Path(home) / "bin" / "nvcc" if home else None,
        shutil.which("nvcc"),
        Path("/usr/local/cuda/bin/nvcc"),
    ):
        if candidate is not None and Path(candidate).exists():
            return str(candidate)
    raise RuntimeError(
        "nvcc not found: set CUDA_HOME to the CUDA toolkit that builds "
        "the port's kernels"
    )


def digest(src: Path, extra_flags=()) -> str:
    """16 hex digits of sha256 over the source, every header it includes
    with quotes (found beside it, followed into the headers' own includes,
    each once) and the nvcc flags (with ``extra_flags``)."""
    h = hashlib.sha256()
    seen = set()
    todo = [Path(src)]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.add(path)
        text = path.read_bytes()
        h.update(path.name.encode() + b"\0" + text + b"\0")
        todo.extend(path.parent / m.decode() for m in _INCLUDE.findall(text))
    h.update(" ".join(NVCC_FLAGS + tuple(extra_flags)).encode())
    return h.hexdigest()[:16]


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of ``csrc/<name>.cu`` (or of the
    ``VARIANTS`` entry ``name``), built on first use.
    Raises RuntimeError, with the compiler's output, if the build fails.
    Different libraries build concurrently when called from several
    threads. The first call for a library records it in the compile
    ledger."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        lock = _locks.setdefault(name, threading.Lock())
    with lock:
        with _lock:
            lib = _libs.get(name)
        if lib is not None:  # built while this thread waited for the lock
            return lib
        t0 = time.perf_counter()
        stem, extra = VARIANTS.get(name, (name, ()))
        src = CSRC_DIR / f"{stem}.cu"
        key = digest(src, extra)
        out = BUILD_DIR / f"lib{name}_{key}.so"
        built = not out.exists()
        if built:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, *extra, "-o", str(tmp), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"nvcc failed for {src.name}:\n{proc.stdout}")
            os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
        with _lock:
            _libs[name] = lib
    from ..utils.profiler import COMPILE_LEDGER

    COMPILE_LEDGER.record(name, key, time.perf_counter() - t0, built)
    return lib
