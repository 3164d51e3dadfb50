"""The oracle sidecar: the wire protocol, the server that runs the port's
batch on its device (with the multi-tenant coalescer in front of it when
asked), and the clients (``OracleClient``, ``ResilientOracleClient``,
``RemoteScorer``)."""

from . import protocol
from .client import OracleClient, RemoteScorer, ResilientOracleClient
from .coalescer import CoalesceSaturated, OracleCoalescer
from .server import OracleServer, serve_background

__all__ = [
    "protocol",
    "OracleClient",
    "ResilientOracleClient",
    "RemoteScorer",
    "OracleServer",
    "OracleCoalescer",
    "CoalesceSaturated",
    "serve_background",
]
