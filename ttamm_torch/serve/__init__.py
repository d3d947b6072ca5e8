"""Serving: the port's flat index and retrieval service, and the JAX
package's HTTP front end (stdlib-only and free of JAX), re-exported so the
port's users need one namespace."""

from ttamm_tpu.serve.http_server import make_server, serve_forever, start_in_thread

from .flat_index import FlatIndex, build_flat_index
from .service import RetrievalService

__all__ = [
    "FlatIndex",
    "RetrievalService",
    "build_flat_index",
    "make_server",
    "serve_forever",
    "start_in_thread",
]
