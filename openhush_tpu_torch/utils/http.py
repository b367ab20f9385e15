"""Tiny HTTP client helpers (urllib-based; no external deps).

A copy of openhush_tpu/utils/http.py.
"""

from __future__ import annotations

import json
import urllib.error
import urllib.request
from typing import Optional


class HttpError(RuntimeError):
    def __init__(self, message: str, status: Optional[int] = None):
        super().__init__(message)
        self.status = status


def request_json(url: str, *, method: str = "GET", payload: Optional[dict] = None,
                 headers: Optional[dict] = None, timeout: float = 30.0) -> dict:
    data = json.dumps(payload).encode() if payload is not None else None
    req = urllib.request.Request(url, data=data, method=method)
    req.add_header("Content-Type", "application/json")
    for k, v in (headers or {}).items():
        req.add_header(k, v)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            body = r.read()
            return json.loads(body) if body else {}
    except urllib.error.HTTPError as e:
        raise HttpError(f"HTTP {e.code}: {e.reason}", e.code) from e
    except (urllib.error.URLError, TimeoutError, OSError) as e:
        raise HttpError(str(e)) from e


def probe(url: str, timeout: float = 3.0) -> bool:
    try:
        request_json(url, timeout=timeout)
        return True
    except HttpError as e:
        return e.status is not None  # server responded at all
