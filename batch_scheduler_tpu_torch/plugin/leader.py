"""Leader-election lease and the leader-gated controller runner.

Equivalent of the reference's EndpointsLock polling loop
(reference pkg/scheduler/batch/batchscheduler.go:450-502): the PodGroup
controller runs only on the replica currently holding the scheduler lease,
starts when the lease is observed held by us and fresh, and stops on loss.

The lease itself is an abstraction: ``InMemoryLease`` for single-process /
simulated deployments, ``FileLease`` for multi-process single-host
deployments (atomic O_EXCL claim files), and ``APILease`` — the deployment-
grade one — a Lease object living *in the API server* (the analog of the
reference's EndpointsLock in kube-system, batchscheduler.go:458-464), so any
number of scheduler replicas against one API server coordinate through the
same durable object, with optimistic-concurrency updates making claims
race-free.
"""

from __future__ import annotations

import json
import os
import threading
import time
from dataclasses import dataclass
from typing import Callable, Optional

__all__ = [
    "LeaseRecord",
    "InMemoryLease",
    "FileLease",
    "APILease",
    "try_run_controller",
]


@dataclass
class LeaseRecord:
    holder_identity: str = ""
    renew_time: float = 0.0
    lease_duration_seconds: float = 15.0


class InMemoryLease:
    def __init__(self, clock: Callable[[], float] = time.time):
        self._clock = clock
        self._lock = threading.Lock()
        self._record = LeaseRecord()  # guarded-by: _lock

    def get(self) -> Optional[LeaseRecord]:
        with self._lock:
            return LeaseRecord(**vars(self._record))

    def acquire(self, identity: str, duration: float = 15.0) -> bool:
        with self._lock:
            rec = self._record
            now = self._clock()
            expired = now - rec.renew_time > rec.lease_duration_seconds
            if rec.holder_identity in ("", identity) or expired:
                self._record = LeaseRecord(identity, now, duration)
                return True
            return False

    def renew(self, identity: str) -> bool:
        with self._lock:
            if self._record.holder_identity != identity:
                return False
            self._record.renew_time = self._clock()
            return True

    def release(self, identity: str) -> None:
        with self._lock:
            if self._record.holder_identity == identity:
                self._record = LeaseRecord()


class FileLease:
    """Lease in a JSON file. Claims run read-check-write under an flock'd
    sidecar lock file, so two processes racing an expired lease cannot both
    win (the split-brain the lease exists to prevent)."""

    def __init__(self, path: str, clock: Callable[[], float] = time.time):
        self._path = path
        self._clock = clock

    def _locked(self):
        import fcntl
        from contextlib import contextmanager

        @contextmanager
        def guard():
            with open(f"{self._path}.lock", "w") as lk:
                fcntl.flock(lk, fcntl.LOCK_EX)
                try:
                    yield
                finally:
                    fcntl.flock(lk, fcntl.LOCK_UN)

        return guard()

    def _read(self) -> Optional[LeaseRecord]:
        try:
            with open(self._path) as f:
                d = json.load(f)
            return LeaseRecord(
                d.get("holder_identity", ""),
                d.get("renew_time", 0.0),
                d.get("lease_duration_seconds", 15.0),
            )
        except (OSError, ValueError):
            return None

    def get(self) -> Optional[LeaseRecord]:
        return self._read()

    def _write(self, rec: LeaseRecord) -> None:
        tmp = f"{self._path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(vars(rec), f)
        os.replace(tmp, self._path)

    def acquire(self, identity: str, duration: float = 15.0) -> bool:
        with self._locked():
            rec = self._read()
            now = self._clock()
            if (
                rec is None
                or rec.holder_identity in ("", identity)
                or now - rec.renew_time > rec.lease_duration_seconds
            ):
                self._write(LeaseRecord(identity, now, duration))
                return True
            return False

    def renew(self, identity: str) -> bool:
        with self._locked():
            rec = self._read()
            if rec is None or rec.holder_identity != identity:
                return False
            rec.renew_time = self._clock()
            self._write(rec)
            return True

    def release(self, identity: str) -> None:
        with self._locked():
            rec = self._read()
            if rec is not None and rec.holder_identity == identity:
                try:
                    os.unlink(self._path)
                except OSError:
                    pass


class APILease:
    """Lease object stored in the API server (namespace ``kube-system``,
    like the reference's EndpointsLock, batchscheduler.go:458-464).

    Claims are compare-and-swap: the update carries the read
    ``resource_version``, so two replicas racing an expired lease cannot
    both win — the loser's update raises ConflictError and its ``acquire``
    returns False. Works over the in-memory APIServer and the HTTP adapter
    alike (both speak the same interface)."""

    KIND = "Lease"

    def __init__(
        self,
        api,
        name: str = "batch-scheduler",
        namespace: str = "kube-system",
        default_duration: float = 15.0,
        clock: Callable[[], float] = time.time,
    ):
        self._api = api
        self._name = name
        self._ns = namespace
        self._default_duration = default_duration
        self._clock = clock

    @staticmethod
    def _record(d: dict) -> LeaseRecord:
        spec = d.get("spec") or {}
        return LeaseRecord(
            spec.get("holder_identity", ""),
            spec.get("renew_time", 0.0),
            spec.get("lease_duration_seconds", 15.0),
        )

    def get(self) -> Optional[LeaseRecord]:
        from ..client.apiserver import NotFoundError

        try:
            return self._record(self._api.get(self.KIND, self._ns, self._name))
        except NotFoundError:
            return None

    def _spec(self, identity: str, duration: float) -> dict:
        return {
            "holder_identity": identity,
            "renew_time": self._clock(),
            "lease_duration_seconds": duration,
        }

    def acquire(self, identity: str, duration: Optional[float] = None) -> bool:
        from ..client.apiserver import (
            AlreadyExistsError,
            ConflictError,
            NotFoundError,
        )

        duration = self._default_duration if duration is None else duration
        try:
            d = self._api.get(self.KIND, self._ns, self._name)
        except NotFoundError:
            try:
                self._api.create(
                    self.KIND,
                    {
                        "metadata": {"namespace": self._ns, "name": self._name},
                        "spec": self._spec(identity, duration),
                    },
                )
                return True
            except AlreadyExistsError:
                return False  # raced another replica's create; retry next poll
        rec = self._record(d)
        now = self._clock()
        expired = now - rec.renew_time > rec.lease_duration_seconds
        if rec.holder_identity not in ("", identity) and not expired:
            return False
        d["spec"] = self._spec(identity, duration)
        try:
            self._api.update(self.KIND, d)  # CAS on resource_version
            return True
        except (ConflictError, NotFoundError):
            return False

    def renew(self, identity: str) -> bool:
        from ..client.apiserver import ConflictError, NotFoundError

        try:
            d = self._api.get(self.KIND, self._ns, self._name)
        except NotFoundError:
            return False
        rec = self._record(d)
        if rec.holder_identity != identity:
            return False
        d["spec"]["renew_time"] = self._clock()
        try:
            self._api.update(self.KIND, d)
            return True
        except (ConflictError, NotFoundError):
            return False

    def release(self, identity: str) -> None:
        from ..client.apiserver import NotFoundError

        try:
            d = self._api.get(self.KIND, self._ns, self._name)
        except NotFoundError:
            return
        if self._record(d).holder_identity == identity:
            try:
                self._api.delete(self.KIND, self._ns, self._name)
            except NotFoundError:
                pass


def try_run_controller(
    lease,
    identity: str,
    controller,
    workers: int,
    stop_event: threading.Event,
    poll_seconds: float = 1.0,
    clock: Callable[[], float] = time.time,
) -> None:
    """Poll the lease; run the controller only while we hold it
    (reference tryRunController, batchscheduler.go:452-502)."""
    started = False
    controller_stop: Optional[threading.Event] = None
    while not stop_event.wait(poll_seconds):
        record = lease.get()
        if record is None:
            continue
        held = identity and identity in record.holder_identity
        fresh = clock() - record.renew_time < record.lease_duration_seconds
        if held and fresh:
            if not started:
                controller_stop = threading.Event()
                controller.run(workers, controller_stop)
                started = True
        elif started:
            started = False
            controller_stop.set()
            controller.stop()
    if started and controller_stop is not None:
        controller_stop.set()
        controller.stop()
