from .apiserver import (
    AlreadyExistsError,
    APIServer,
    ConflictError,
    NotFoundError,
    WatchEvent,
)
from .clientset import Clientset, NodeInterface, PodGroupInterface, PodInterface
from .fake import new_simple_clientset
from .http_apiserver import HTTPAPIServer
from .http_gateway import GatewayServer, serve_gateway
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
    "HTTPAPIServer",
    "GatewayServer",
    "serve_gateway",
    "PodGroupLister",
    "SharedInformer",
    "SharedInformerFactory",
]
