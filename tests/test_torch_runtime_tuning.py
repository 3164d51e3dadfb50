"""The port's interpreter tuning (``batch_scheduler_tpu_torch/utils/
runtime_tuning.py``) against the JAX package's (``tests/test_runtime_tuning.py``
mirrored): the same ``BST_GC_THRESHOLD`` values give exactly the same GC
thresholds in both packages, malformed ones the same fallback, and the
freeze moves startup objects out of the collector. Every case restores the
thresholds and unfreezes."""

import gc
import importlib

import pytest

PACKAGES = ("batch_scheduler_tpu", "batch_scheduler_tpu_torch")


def _tuning(pkg):
    return importlib.import_module(f"{pkg}.utils.runtime_tuning")


@pytest.fixture
def restore_gc():
    prev = gc.get_threshold()
    yield
    gc.set_threshold(*prev)
    gc.unfreeze()


def _applied(pkg, monkeypatch, raw):
    if raw is None:
        monkeypatch.delenv("BST_GC_THRESHOLD", raising=False)
    else:
        monkeypatch.setenv("BST_GC_THRESHOLD", raw)
    gc.set_threshold(700, 10, 10)
    _tuning(pkg).apply_gc_tuning()
    return gc.get_threshold()


@pytest.mark.parametrize("pkg", PACKAGES)
def test_default_thresholds_applied(restore_gc, monkeypatch, pkg):
    assert _applied(pkg, monkeypatch, None) == _tuning(pkg)._DEFAULT == (50000, 100, 100)
    assert _tuning(PACKAGES[0])._DEFAULT == _tuning(PACKAGES[1])._DEFAULT


@pytest.mark.parametrize("pkg", PACKAGES)
def test_env_override_and_zero_disables(restore_gc, monkeypatch, pkg):
    assert _applied(pkg, monkeypatch, "1234,56,78") == (1234, 56, 78)
    # "0" keeps whatever is set — no change
    assert _applied(pkg, monkeypatch, "0") == (700, 10, 10)


@pytest.mark.parametrize("bad", ["nope", "1,2", "1,2,3,4", "-5,1,1", "0,0,0", " 9,9,x"])
def test_malformed_env_falls_back_to_default(restore_gc, monkeypatch, bad):
    got = [_applied(pkg, monkeypatch, bad) for pkg in PACKAGES]
    assert got[0] == got[1] == (50000, 100, 100)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_freeze_startup_moves_objects_out_of_gc(restore_gc, pkg):
    _tuning(pkg).freeze_startup()
    try:
        assert gc.get_freeze_count() > 0
    finally:
        gc.unfreeze()
    assert gc.get_freeze_count() == 0
