"""REST control-plane API, route- and payload-compatible with the reference
(src/api/routes.rs:77-100, src/api/handlers.rs, src/api/auth.rs):

  GET  /api/v1/health              public: {"status": "ok", "version": ...}
  GET  /api/v1/status              protected: running/recording/queue_depth/
                                   model/version
  POST /api/v1/recording/start     protected: {"ok": true, "message": ...}
  POST /api/v1/recording/stop
  POST /api/v1/recording/toggle
  GET  /api/v1/openapi.json        OpenAPI 3 document (utoipa parity)

Auth: X-API-Key compared by SHA-256 hash; open when unconfigured
(development mode, auth.rs:18-50). CORS headers from config. Implemented on
stdlib ThreadingHTTPServer — the control plane is tiny and adding a web
framework dependency would be the only reason to need one.

A copy of openhush_tpu/api/server.py. One difference: the `status` reply
also carries `preprocess_failures` (0 unless the status callback gives
it), the port daemon's count of windows whose preprocess raised, as its
IPC `status` reply does. Every other route, body and header is the
reference's.
"""

from __future__ import annotations

import hashlib
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional

from openhush_tpu_torch import __version__

API_KEY_HEADER = "X-API-Key"


def hash_api_key(key: str) -> str:
    """SHA-256 hex digest (parity: hash_api_key, src/api/auth.rs:52)."""
    return hashlib.sha256(key.encode("utf-8")).hexdigest()


def openapi_document() -> dict:
    sec = [{"api_key": []}]
    return {
        "openapi": "3.0.3",
        "info": {"title": "OpenHush API", "version": __version__},
        "components": {"securitySchemes": {"api_key": {
            "type": "apiKey", "name": API_KEY_HEADER, "in": "header"}}},
        "paths": {
            "/api/v1/health": {"get": {
                "tags": ["Health"], "responses": {"200": {
                    "description": "Server is healthy"}}}},
            "/api/v1/status": {"get": {
                "tags": ["Status"], "security": sec, "responses": {
                    "200": {"description": "Current daemon status"},
                    "401": {"description": "Unauthorized"}}}},
            **{f"/api/v1/recording/{a}": {"post": {
                "tags": ["Recording"], "security": sec, "responses": {
                    "200": {"description": f"Recording {a}"},
                    "401": {"description": "Unauthorized"},
                    "500": {"description": "Command failed"}}}}
               for a in ("start", "stop", "toggle")},
        },
    }


class ApiServer:
    """HTTP control plane bound to daemon callbacks."""

    def __init__(self, *, host: str = "127.0.0.1", port: int = 8765,
                 api_key_hash: str = "",
                 cors_origins: Optional[list[str]] = None,
                 status_fn: Optional[Callable[[], dict]] = None,
                 command_fn: Optional[Callable[[str], bool]] = None):
        self.host = host
        self.port = port
        self.api_key_hash = api_key_hash or None
        self.cors_origins = cors_origins or []
        self.status_fn = status_fn or (lambda: {})
        self.command_fn = command_fn or (lambda action: False)
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle -------------------------------------------------------------

    def start(self) -> None:
        api = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # quiet
                pass

            def _send(self, code: int, payload, content_type="application/json"):
                body = (payload if isinstance(payload, bytes)
                        else json.dumps(payload).encode())
                self.send_response(code)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(body)))
                # CORS restricted by default (parity: src/api/routes.rs:
                # 103-105): no headers at all unless origins are configured;
                # "*" is reflected only when explicitly listed.
                origin = self.headers.get("Origin")
                if origin and api.cors_origins and (
                        origin in api.cors_origins or "*" in api.cors_origins):
                    self.send_header(
                        "Access-Control-Allow-Origin",
                        "*" if ("*" in api.cors_origins
                                and origin not in api.cors_origins)
                        else origin)
                    self.send_header("Access-Control-Allow-Headers",
                                     f"Content-Type, {API_KEY_HEADER}")
                    self.send_header("Access-Control-Allow-Methods",
                                     "GET, POST, OPTIONS")
                self.end_headers()
                self.wfile.write(body)

            def _authorized(self) -> bool:
                if api.api_key_hash is None:
                    return True
                key = self.headers.get(API_KEY_HEADER)
                if key is None:
                    self._send(401, {"ok": False,
                                     "error": f"Missing {API_KEY_HEADER} "
                                              f"header"})
                    return False
                if hash_api_key(key) != api.api_key_hash:
                    self._send(401, {"ok": False,
                                     "error": "Invalid API key"})
                    return False
                return True

            def do_OPTIONS(self):
                self._send(204, b"")

            def do_GET(self):
                if self.path == "/api/v1/health":
                    self._send(200, {"status": "ok",
                                     "version": __version__})
                    return
                if self.path == "/api/v1/openapi.json":
                    self._send(200, openapi_document())
                    return
                if self.path == "/api/v1/status":
                    if not self._authorized():
                        return
                    status = {"running": True, "recording": False,
                              "queue_depth": 0, "model": "",
                              "version": __version__,
                              "preprocess_failures": 0}
                    # The key set of StatusResponse (src/api/handlers.rs:
                    # 19-31), and the port's preprocess_failures.
                    status.update({k: v for k, v in api.status_fn().items()
                                   if k in status})
                    self._send(200, status)
                    return
                self._send(404, {"ok": False, "error": "not found"})

            def do_POST(self):
                parts = self.path.rstrip("/").split("/")
                if (len(parts) == 5 and parts[1] == "api"
                        and parts[2] == "v1" and parts[3] == "recording"
                        and parts[4] in ("start", "stop", "toggle")):
                    if not self._authorized():
                        return
                    action = parts[4]
                    try:
                        ok = api.command_fn(action)
                    except Exception as e:  # noqa: BLE001
                        self._send(500, {
                            "ok": False,
                            "error": f"Failed to send command: {e}"})
                        return
                    if ok:
                        msg = {"start": "Recording started",
                               "stop": "Recording stopped",
                               "toggle": "Recording toggled"}[action]
                        self._send(200, {"ok": True, "message": msg})
                    else:
                        self._send(500, {"ok": False,
                                         "error": f"{action} failed"})
                    return
                self._send(404, {"ok": False, "error": "not found"})

        self._httpd = ThreadingHTTPServer((self.host, self.port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True, name="api-server")
        self._thread.start()

    def stop(self) -> None:
        if self._httpd:
            self._httpd.shutdown()
            self._httpd.server_close()
        if self._thread:
            self._thread.join(timeout=5)
