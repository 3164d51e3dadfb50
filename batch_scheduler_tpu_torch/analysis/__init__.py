"""The port's analyzer suite and runtime lock-discipline checker.

``python -m batch_scheduler_tpu_torch.analysis`` runs the four static
checkers (``guarded-by``, ``knobs``, ``wire``, ``metrics``) over the
port's tree; ``BST_LOCKCHECK=1`` arms the runtime race detector
(lockcheck.maybe_install, called from the package __init__). The
annotation grammar is the JAX package's (``docs/static_analysis.md``).

Pure stdlib on purpose: the analyzers parse the tree, they never import
it, so the gate needs no torch and stays fast and side-effect free. An
own copy of the JAX package's ``analysis/``: the port imports nothing of
that package.

Exports resolve lazily (PEP 562): the package __init__'s lockcheck hook
must cost one env probe on every ``import batch_scheduler_tpu_torch``,
not the import of the whole checker suite; only ``lockcheck`` loads
eagerly (os/sys/threading), the rest on first attribute access.
"""

from .lockcheck import LockDisciplineError, lockcheck_enabled, maybe_install  # noqa: F401

_LAZY = {
    "Finding": ("findings", "Finding"),
    "CHECKS": ("runner", "CHECKS"),
    "main": ("runner", "main"),
    "run_all": ("runner", "run_all"),
}

__all__ = [
    "LockDisciplineError",
    "lockcheck_enabled",
    "maybe_install",
    *_LAZY,
]


def __getattr__(name):
    entry = _LAZY.get(name)
    if entry is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    module = importlib.import_module(f".{entry[0]}", __name__)
    value = getattr(module, entry[1])
    globals()[name] = value
    return value
