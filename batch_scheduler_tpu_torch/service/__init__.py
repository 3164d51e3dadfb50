"""The oracle sidecar: the wire protocol, the server that runs the port's
batch on its device, and the clients (``OracleClient``,
``ResilientOracleClient``, ``RemoteScorer``)."""

from . import protocol
from .client import OracleClient, RemoteScorer, ResilientOracleClient
from .server import OracleServer, serve_background

__all__ = [
    "protocol",
    "OracleClient",
    "ResilientOracleClient",
    "RemoteScorer",
    "OracleServer",
    "serve_background",
]
