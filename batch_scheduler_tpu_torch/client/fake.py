"""Fake clientset for tests: a clientset over a fresh in-memory API server,
pre-seeded with objects (reference pkg/generated/clientset/versioned/fake/
clientset_generated.go:36-61)."""

from __future__ import annotations

from ..api.types import Node, Pod, PodGroup, to_dict
from .apiserver import APIServer
from .clientset import Clientset

__all__ = ["new_simple_clientset"]


def new_simple_clientset(*objects) -> Clientset:
    api = APIServer()
    cs = Clientset(api)
    for obj in objects:
        if isinstance(obj, PodGroup):
            cs.podgroups(obj.metadata.namespace).create(obj)
        elif isinstance(obj, Pod):
            cs.pods(obj.metadata.namespace).create(obj)
        elif isinstance(obj, Node):
            cs.nodes().create(obj)
        else:
            raise TypeError(f"unsupported seed object: {type(obj)!r}")
    return cs
