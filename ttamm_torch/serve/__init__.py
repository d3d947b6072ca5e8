"""Serving: the port's flat index, retrieval service and HTTP front end."""

from .flat_index import FlatIndex, build_flat_index
from .http_server import make_server, serve_forever, start_in_thread
from .service import RetrievalService

__all__ = [
    "FlatIndex",
    "RetrievalService",
    "build_flat_index",
    "make_server",
    "serve_forever",
    "start_in_thread",
]
