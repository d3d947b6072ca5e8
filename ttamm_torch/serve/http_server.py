"""Minimal HTTP recommendation service over :class:`RetrievalService`
(the port's copy of ``ttamm_tpu/serve/http_server.py``).

The reference lists an "inference service" only under Next Steps
(ref ``README.md:76-78``); this completes it. Stdlib-only
(``http.server.ThreadingHTTPServer``) so serving needs no extra
dependencies beyond the training image.

Endpoints
---------
- ``GET /healthz`` → ``{"status": "ok", "users": N, "items": N}``
- ``GET /v1/recommend?user_id=<raw id>&k=<int>`` → top-k for a known user
- ``POST /v1/recommend`` with a JSON body of either
  ``{"user_id": "...", "k": 10}`` or (cold-start)
  ``{"embedding": [f, ...], "k": 10}``

Responses are JSON; errors use conventional status codes
(400 malformed, 404 unknown user, 405 wrong method).
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

from .service import RetrievalService

_MAX_BODY_BYTES = 8 << 20


def _recommend_payload(
    service: RetrievalService, user_id: str | None, embedding, k: int, backend: str
) -> dict:
    if user_id is not None:
        recs = service.recommend_for_user(user_id, k=k, backend=backend)
        return {
            "user_id": user_id,
            "items": [{"asin": a, "score": s} for a, s in recs],
        }
    query = np.asarray(embedding, dtype=np.float32)
    if query.ndim != 1 or query.shape[0] != service.index.dim:
        raise ValueError(
            f"embedding must be a flat list of {service.index.dim} floats"
        )
    recs = service.recommend_for_embedding(query, k=k, backend=backend)
    return {"items": [{"asin": a, "score": s} for a, s in recs]}


class _Handler(BaseHTTPRequestHandler):
    # set by make_server()
    service: RetrievalService
    backend: str = "auto"

    def _send_json(self, status: int, payload: dict) -> None:
        body = json.dumps(payload).encode("utf-8")
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt: str, *args) -> None:  # quiet by default
        pass

    def do_GET(self) -> None:  # noqa: N802 (stdlib API name)
        url = urlparse(self.path)
        if url.path == "/healthz":
            self._send_json(
                200,
                {
                    "status": "ok",
                    "users": len(self.service.user_ids),
                    "items": len(self.service.item_ids),
                    "similarity": self.service.similarity,
                },
            )
            return
        if url.path == "/v1/recommend":
            params = parse_qs(url.query)
            user_id = params.get("user_id", [None])[0]
            if user_id is None:
                self._send_json(400, {"error": "missing user_id"})
                return
            try:
                k = int(params.get("k", ["10"])[0])
            except ValueError:
                self._send_json(400, {"error": "k must be an integer"})
                return
            self._handle_recommend(user_id, None, k)
            return
        self._send_json(404, {"error": f"no such path: {url.path}"})

    def do_POST(self) -> None:  # noqa: N802
        url = urlparse(self.path)
        if url.path != "/v1/recommend":
            self._send_json(404, {"error": f"no such path: {url.path}"})
            return
        try:
            length = int(self.headers.get("Content-Length", "0"))
            if length > _MAX_BODY_BYTES:
                self._send_json(400, {"error": "body too large"})
                return
            body = json.loads(self.rfile.read(length) or b"{}")
        except (ValueError, json.JSONDecodeError):
            self._send_json(400, {"error": "malformed JSON body"})
            return
        user_id = body.get("user_id")
        embedding = body.get("embedding")
        if (user_id is None) == (embedding is None):
            self._send_json(
                400, {"error": "provide exactly one of user_id or embedding"}
            )
            return
        k = body.get("k", 10)
        if not isinstance(k, int) or k < 1:
            self._send_json(400, {"error": "k must be a positive integer"})
            return
        self._handle_recommend(user_id, embedding, k)

    def _handle_recommend(self, user_id, embedding, k: int) -> None:
        try:
            payload = _recommend_payload(
                self.service, user_id, embedding, k, self.backend
            )
        except KeyError:
            self._send_json(404, {"error": f"unknown user_id: {user_id}"})
            return
        except (ValueError, TypeError) as exc:
            self._send_json(400, {"error": str(exc)})
            return
        self._send_json(200, payload)


def make_server(
    service: RetrievalService,
    host: str = "127.0.0.1",
    port: int = 0,
    *,
    backend: str = "auto",
) -> ThreadingHTTPServer:
    """Build (but do not start) the HTTP server; ``port=0`` picks a free one."""
    handler = type("BoundHandler", (_Handler,), {"service": service, "backend": backend})
    return ThreadingHTTPServer((host, port), handler)


def serve_forever(
    service: RetrievalService,
    host: str = "127.0.0.1",
    port: int = 8080,
    *,
    backend: str = "auto",
) -> None:
    """Blocking entry point used by ``python -m ttamm_torch.serve --http``."""
    server = make_server(service, host, port, backend=backend)
    try:
        server.serve_forever()
    finally:
        server.server_close()


def start_in_thread(
    service: RetrievalService,
    host: str = "127.0.0.1",
    port: int = 0,
    *,
    backend: str = "auto",
) -> tuple[ThreadingHTTPServer, threading.Thread]:
    """Start the server on a daemon thread (tests / embedding in pipelines)."""
    server = make_server(service, host, port, backend=backend)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server, thread
