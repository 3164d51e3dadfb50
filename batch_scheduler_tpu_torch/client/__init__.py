from .apiserver import (
    AlreadyExistsError,
    APIServer,
    ConflictError,
    NotFoundError,
    WatchEvent,
)
from .clientset import Clientset, NodeInterface, PodGroupInterface, PodInterface
from .fake import new_simple_clientset
from .informers import PodGroupLister, SharedInformer, SharedInformerFactory

__all__ = [
    "AlreadyExistsError",
    "APIServer",
    "ConflictError",
    "NotFoundError",
    "WatchEvent",
    "Clientset",
    "NodeInterface",
    "PodGroupInterface",
    "PodInterface",
    "new_simple_clientset",
    "PodGroupLister",
    "SharedInformer",
    "SharedInformerFactory",
]
