"""BST_LOCKCHECK=1: the runtime half of the lock-discipline checker.

The static ``guarded-by`` checker (guards.py) is lexical: a closure
defined under ``with self._lock:`` but executed later, or a caller that
ignores a ``# lock-held:`` contract, passes statically and still races.
This module closes exactly those holes: with ``BST_LOCKCHECK=1``, every
class of ``batch_scheduler_tpu_torch`` carrying ``# guarded-by:``
annotations is instrumented so that an access to a guarded attribute
without its lock held, on an instance that another thread has provably
touched, raises ``LockDisciplineError`` carrying BOTH stacks: the
offending access and the most recent access from the other thread.

Detection is by lock ownership, not timing, so violations reproduce
deterministically: thread A touches the attribute (guarded or not),
thread B touches it without the lock, and B raises, every run. Single
-threaded phases (construction, one-shot scripts) never trip it because
the "another thread has touched this instance" predicate stays false.

A guard lock may be a ``Lock``, an ``RLock`` or a ``Condition`` (the
coalescer guards its queue with one): ``_TrackedLock`` forwards
``wait`` / ``notify`` to the wrapped object and asks it for ownership.

The package ``__init__`` calls ``maybe_install()``, so one environment
variable arms the checker for any entry point; the port's lockcheck
tests run their thread storms in a child process with it set. Cost: one
dict probe per attribute access on instrumented classes plus a bounded
stack capture per guarded access. Opt-in only, never on a serving path.
"""

from __future__ import annotations

import os
import sys
import threading
from typing import Dict, List, Optional, Set

ENV = "BST_LOCKCHECK"

# the package whose annotated classes install() instruments
PACKAGE = "batch_scheduler_tpu_torch"

_STACK_LIMIT = 12


def lockcheck_enabled() -> bool:
    """Parse-guarded BST_LOCKCHECK read: only the literal "1" enables."""
    return os.environ.get(ENV, "") == "1"


class LockDisciplineError(RuntimeError):
    """An annotated attribute was accessed without its guard lock while the
    instance was demonstrably shared across threads."""


def _is_lock_like(value) -> bool:
    return hasattr(value, "acquire") and hasattr(value, "release")


class _TrackedLock:
    """Ownership-tracking proxy around Lock/RLock/Condition.

    RLock and Condition expose ``_is_owned`` (used when present); plain
    Lock has no owner concept, so the proxy records the acquiring thread.
    Everything else forwards, so timeouts/waits/notifies behave verbatim.
    """

    def __init__(self, inner):
        object.__setattr__(self, "_inner", inner)
        object.__setattr__(self, "_owners", set())

    def acquire(self, *args, **kwargs):
        got = self._inner.acquire(*args, **kwargs)
        if got:
            self._owners.add(threading.get_ident())
        return got

    def release(self, *args, **kwargs):
        self._owners.discard(threading.get_ident())
        return self._inner.release(*args, **kwargs)

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def held_by_current(self) -> bool:
        is_owned = getattr(self._inner, "_is_owned", None)
        if is_owned is not None:
            try:
                return bool(is_owned())
            except Exception:
                pass
        return threading.get_ident() in self._owners

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def __setattr__(self, name, value):
        setattr(self._inner, name, value)


def _capture_frames(frame) -> tuple:
    """Cheap stack capture: (filename, lineno, funcname) tuples, no source
    lookup, no string formatting — that cost runs on EVERY guarded access,
    so it must stay at raw-frame-walk speed (~1µs); rendering happens only
    on a violation (_render_frames)."""
    out = []
    depth = 0
    while frame is not None and depth < _STACK_LIMIT:
        out.append((frame.f_code.co_filename, frame.f_lineno, frame.f_code.co_name))
        frame = frame.f_back
        depth += 1
    out.reverse()
    return tuple(out)


def _render_frames(frames: tuple) -> str:
    import linecache

    lines = []
    for filename, lineno, funcname in frames:
        lines.append(f'  File "{filename}", line {lineno}, in {funcname}\n')
        src = linecache.getline(filename, lineno).strip()
        if src:
            lines.append(f"    {src}\n")
    return "".join(lines)


def _lock_held_by_frames(obj, cls, lockname: str) -> bool:
    """True if a ``# lock-held: <lockname>`` method of obj's class is on the
    current call stack — the static contract's runtime honoring."""
    lock_held: Dict[str, Set[str]] = getattr(cls, "_lockcheck_lock_held", {})
    if not lock_held:
        return False
    frame = sys._getframe(2)
    depth = 0
    while frame is not None and depth < 30:
        name = frame.f_code.co_name
        locks = lock_held.get(name)
        if locks and lockname in locks and frame.f_locals.get("self") is obj:
            return True
        frame = frame.f_back
        depth += 1
    return False


# side table for __slots__ classes (no per-instance __dict__ to stash the
# access record in); weak keys so instances die normally
_SLOT_STATE: "weakref.WeakKeyDictionary" = None  # type: ignore[assignment]


def _tracking_state(obj) -> Optional[dict]:
    try:
        return object.__getattribute__(obj, "__dict__")
    except AttributeError:
        pass
    global _SLOT_STATE
    if _SLOT_STATE is None:
        import weakref

        _SLOT_STATE = weakref.WeakKeyDictionary()
    try:
        state = _SLOT_STATE.get(obj)
        if state is None:
            state = {}
            _SLOT_STATE[obj] = state
        return state
    except TypeError:
        # slotted AND not weakref-able: nowhere safe to keep history —
        # ownership is still checked below, sharing detection is not
        return None


def _check(obj, cls, attr: str, lockname: str, op: str) -> None:
    d = _tracking_state(obj)
    if d is None:
        return
    try:
        lock = object.__getattribute__(obj, lockname)
    except AttributeError:
        lock = None
    held = False
    if isinstance(lock, _TrackedLock):
        held = lock.held_by_current()
    elif lock is not None and _is_lock_like(lock):
        # pre-instrumentation lock object: best-effort ownership
        is_owned = getattr(lock, "_is_owned", None)
        if is_owned is not None:
            try:
                held = bool(is_owned())
            except Exception:
                held = False
        else:
            held = lock.locked()
    tid = threading.get_ident()
    table = d.get("_lockcheck_access")
    if table is None:
        table = {}
        d["_lockcheck_access"] = table
    threads = d.get("_lockcheck_threads")
    if threads is None:
        threads = set()
        d["_lockcheck_threads"] = threads
    per_attr = table.setdefault(attr, {})
    # the instance is "shared" once any guarded attribute has been touched
    # from a second thread — from then on, EVERY guarded access must hold
    # the lock (the declared contract), not just accesses that happen to
    # collide on one attribute. Deterministic: no timing window involved.
    if not held and any(t != tid for t in threads):
        if not _lock_held_by_frames(obj, cls, lockname) and not _access_suppressed():
            other = next(
                ((t, v) for t, v in per_attr.items() if t != tid), None
            )
            if other is None:
                # another thread touched a different guarded attr; find its
                # most recent record for the report
                for recs in table.values():
                    other = next(
                        ((t, v) for t, v in recs.items() if t != tid), None
                    )
                    if other is not None:
                        break
            here = _render_frames(_capture_frames(sys._getframe(2)))
            other_txt = (
                f"--- most recent guarded-state access by thread "
                f"{other[0]} ({other[1][0]}) ---\n"
                f"{_render_frames(other[1][1])}"
                if other is not None
                else "--- no recorded stack for the other thread ---\n"
            )
            raise LockDisciplineError(
                f"unguarded {op} of {cls.__name__}.{attr} "
                f"(guarded-by {lockname}) on thread {tid} while the "
                f"instance is shared across threads\n"
                f"--- this access (thread {tid}, lock NOT held) ---\n{here}"
                f"{other_txt}"
            )
    threads.add(tid)
    per_attr[tid] = (op, _capture_frames(sys._getframe(2)))


def _instrument_class(cls, guarded: Dict[str, str], lock_held) -> None:
    if cls.__dict__.get("_lockcheck_instrumented"):
        return
    locknames = set(guarded.values())
    orig_setattr = cls.__setattr__
    orig_getattribute = cls.__getattribute__

    def __setattr__(self, name, value):
        if (
            name in locknames
            and _is_lock_like(value)
            and not isinstance(value, _TrackedLock)
        ):
            value = _TrackedLock(value)
        elif name in guarded:
            _check(self, cls, name, guarded[name], "write")
        orig_setattr(self, name, value)

    def __getattribute__(self, name):
        if name in guarded:
            _check(self, cls, name, guarded[name], "read")
        return orig_getattribute(self, name)

    cls.__setattr__ = __setattr__
    cls.__getattribute__ = __getattribute__
    cls._lockcheck_instrumented = True
    cls._lockcheck_lock_held = dict(lock_held)


# abs filename -> line numbers carrying an `analysis: allow(guarded-by)`
# suppression; the runtime checker honors the same escapes the static one
# does (the lock-free cancellation paths are suppressed, not special-cased)
_SUPPRESSED: Dict[str, Set[int]] = {}


def _access_suppressed() -> bool:
    frame = sys._getframe(3)  # the user frame performing the access
    lines = _SUPPRESSED.get(frame.f_code.co_filename)
    if not lines:
        return False
    # trailing on the access line, or standalone on the line above
    return frame.f_lineno in lines or (frame.f_lineno - 1) in lines


_installed = [False]


def install(root: Optional[str] = None, modules: Optional[List[str]] = None) -> List[str]:
    """Instrument every annotated class in the package. Returns the list of
    instrumented ``module:Class`` names. Idempotent."""
    import importlib

    from . import annotations as ann
    from .runner import annotated_sources, package_root

    root = root or package_root()
    instrumented: List[str] = []
    for relpath, source in annotated_sources(root, modules):
        mod_ann = ann.scan_module(relpath, source)
        for s in mod_ann.suppressions:
            if s.checker == "guarded-by":
                _SUPPRESSED.setdefault(
                    os.path.abspath(relpath), set()
                ).add(s.line)
        if not mod_ann.classes:
            continue
        modname = (
            relpath.replace(os.sep, "/")
            .rsplit(".py", 1)[0]
            .replace("/", ".")
        )
        # relpath is rooted at the repo; the import name starts at the package
        idx = modname.find(PACKAGE)
        if idx < 0:
            continue
        modname = modname[idx:]
        try:
            module = importlib.import_module(modname)
        except Exception:
            continue
        for clsname, ca in mod_ann.classes.items():
            if not ca.guarded:
                continue
            cls = getattr(module, clsname, None)
            if cls is None:  # nested / underscore class: search module dict
                cls = next(
                    (
                        v
                        for v in vars(module).values()
                        if isinstance(v, type) and v.__name__ == clsname
                    ),
                    None,
                )
            if cls is None:
                continue
            _instrument_class(cls, ca.guarded, ca.lock_held)
            instrumented.append((cls, set(ca.guarded.values())))
    _wrap_existing_instances(instrumented)
    return [f"{cls.__module__}:{cls.__name__}" for cls, _ in instrumented]


def _wrap_existing_instances(instrumented) -> None:
    """Wrap guard locks on instances created BEFORE instrumentation
    (module singletons like trace.DEFAULT_RECORDER): without this, their
    raw locks fall back to ``lock.locked()`` ownership — true when ANY
    thread holds the lock, so a bare access racing a lock-holding writer
    (the true race moment) would be judged held. One gc sweep at install
    time; best-effort (a lock held across the swap loses its owner record
    until the next acquire, which is why install runs at session start)."""
    import gc
    import warnings

    by_cls = tuple(instrumented)
    if not by_cls:
        return
    classes = tuple(c for c, _ in by_cls)
    locknames = {c: names for c, names in by_cls}
    for obj in gc.get_objects():
        try:
            # an isinstance probe of a deprecated module attribute warns
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                if not isinstance(obj, classes):
                    continue
        except Exception:
            continue
        names = next(
            (locknames[c] for c in type(obj).__mro__ if c in locknames), ()
        )
        for ln in names:
            try:
                lock = object.__getattribute__(obj, ln)
            except AttributeError:
                continue
            if _is_lock_like(lock) and not isinstance(lock, _TrackedLock):
                object.__setattr__(obj, ln, _TrackedLock(lock))


def maybe_install() -> List[str]:
    """Install iff BST_LOCKCHECK=1; called from the package __init__ so one
    env var arms the race detector for any entry point."""
    if not lockcheck_enabled() or _installed[0]:
        return []
    _installed[0] = True
    return install()
