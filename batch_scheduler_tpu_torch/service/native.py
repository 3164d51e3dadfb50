"""ctypes bindings for the native (C++) sidecar client in native/.

The C++ library is the embeddable data-plane client (Go via cgo, C++
directly), the stand-in for the Go plugin; these bindings exist so the
tests and ``chip_smoke.py`` drive the SAME native code path end to end
against the port's server — wire compatibility is proven, not assumed. The
port's copy of ``batch_scheduler_tpu/service/native.py``, over the same
unchanged ``native/bsp_client.cpp`` (built by ``make -C native
libbsp_client.so``).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

from ..utils.errors import StaleBatchError
from . import protocol as proto

__all__ = ["NATIVE_DIR", "ensure_built", "NativeOracleClient"]

NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native",
)
_LIB_PATH = os.path.join(NATIVE_DIR, "libbsp_client.so")


def ensure_built() -> Optional[str]:
    """Build the native library if needed; returns its path or None if no
    toolchain is available."""
    if os.path.exists(_LIB_PATH):
        src = os.path.join(NATIVE_DIR, "bsp_client.cpp")
        if os.path.getmtime(_LIB_PATH) >= os.path.getmtime(src):
            return _LIB_PATH
    try:
        subprocess.run(
            ["make", "-C", NATIVE_DIR, "libbsp_client.so"],
            check=True,
            capture_output=True,
        )
    except (OSError, subprocess.CalledProcessError):
        return None
    return _LIB_PATH if os.path.exists(_LIB_PATH) else None


def _load():
    lib = ctypes.CDLL(_LIB_PATH)
    lib.bsp_connect.restype = ctypes.c_void_p
    lib.bsp_connect.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.bsp_close.argtypes = [ctypes.c_void_p]
    lib.bsp_ping.argtypes = [ctypes.c_void_p]
    lib.bsp_last_error.restype = ctypes.c_char_p
    lib.bsp_last_error.argtypes = [ctypes.c_void_p]
    i32p = np.ctypeslib.ndpointer(dtype=np.int32, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(dtype=np.uint8, flags="C_CONTIGUOUS")
    lib.bsp_schedule.argtypes = (
        [
            ctypes.c_void_p,
            ctypes.c_int32,
            ctypes.c_int32,
            ctypes.c_int32,
            ctypes.c_int32,  # mask_rows
        ]
        + [i32p] * 4
        + [u8p, u8p]
        + [i32p] * 4
        + [u8p, i32p]
        + [u8p, u8p, i32p, ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_uint8)]
        + [i32p, i32p, ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
           ctypes.POINTER(ctypes.c_uint32)]
    )
    lib.bsp_row.argtypes = [
        ctypes.c_void_p,
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.c_uint32,
        i32p,
        ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32),
    ]
    return lib


class NativeOracleClient:
    """Same surface as service.client.OracleClient, through the C++ lib."""

    def __init__(self, host: str, port: int):
        if ensure_built() is None:
            raise RuntimeError("native client library unavailable (no toolchain)")
        self._lib = _load()
        self._handle = self._lib.bsp_connect(host.encode(), port)
        if not self._handle:
            raise ConnectionError(f"bsp_connect to {host}:{port} failed")

    def close(self) -> None:
        if self._handle:
            self._lib.bsp_close(self._handle)
            self._handle = None

    def _error(self) -> str:
        return self._lib.bsp_last_error(self._handle).decode(errors="replace")

    def _raise_op_error(self, op: str) -> None:
        """Classify a failed native call like the Python client does:
        stale-batch answers become StaleBatchError so the scorer's row
        reads stay conservative through the C++ transport too, instead of
        a RuntimeError killing the scheduling cycle. (The native client
        does not send DEADLINE frames; deadline propagation is a
        ResilientOracleClient feature.)"""
        message = self._error()
        if proto.is_stale_batch_message(message):
            raise StaleBatchError(message)
        raise RuntimeError(f"{op} failed: {message}")

    def ping(self) -> bool:
        return self._lib.bsp_ping(self._handle) == 0

    def schedule(self, req: proto.ScheduleRequest) -> proto.ScheduleResponse:
        n, r = req.alloc.shape
        g = req.group_req.shape[0]
        k_cap = 128

        def i32(a):
            return np.ascontiguousarray(a, dtype=np.int32)

        def u8(a):
            return np.ascontiguousarray(a, dtype=np.uint8)

        gang_feasible = np.zeros(g, np.uint8)
        placed = np.zeros(g, np.uint8)
        progress = np.zeros(g, np.int32)
        assignment_nodes = np.zeros((g, k_cap), np.int32)
        assignment_counts = np.zeros((g, k_cap), np.int32)
        best = ctypes.c_int32(0)
        best_exists = ctypes.c_uint8(0)
        k_out = ctypes.c_int32(0)
        batch_seq = ctypes.c_uint32(0)

        mask = u8(req.fit_mask)
        rc = self._lib.bsp_schedule(
            self._handle, n, g, r, mask.shape[0],
            i32(req.alloc), i32(req.requested), i32(req.group_req),
            i32(req.remaining), mask, u8(req.group_valid),
            i32(req.order), i32(req.min_member), i32(req.scheduled),
            i32(req.matched), u8(req.ineligible), i32(req.creation_rank),
            gang_feasible, placed, progress,
            ctypes.byref(best), ctypes.byref(best_exists),
            assignment_nodes.reshape(-1), assignment_counts.reshape(-1),
            ctypes.byref(k_out), k_cap, ctypes.byref(batch_seq),
        )
        if rc != 0:
            self._raise_op_error("bsp_schedule")
        k = int(k_out.value)
        return proto.ScheduleResponse(
            gang_feasible=gang_feasible.astype(bool),
            placed=placed.astype(bool),
            progress=progress,
            best=int(best.value),
            best_exists=bool(best_exists.value),
            assignment_nodes=assignment_nodes.reshape(-1)[: g * k].reshape(g, k),
            assignment_counts=assignment_counts.reshape(-1)[: g * k].reshape(g, k),
            batch_seq=int(batch_seq.value),
        )

    def row(self, kind: str, group_index: int, batch_seq: int = 0) -> np.ndarray:
        out = np.zeros(1 << 16, np.int32)
        n_out = ctypes.c_int32(0)
        rc = self._lib.bsp_row(
            self._handle,
            proto.ROW_KINDS.index(kind),
            group_index,
            batch_seq,
            out,
            out.shape[0],
            ctypes.byref(n_out),
        )
        if rc != 0:
            self._raise_op_error("bsp_row")
        return out[: int(n_out.value)].copy()