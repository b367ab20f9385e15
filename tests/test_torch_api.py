"""The port's REST control plane (api/server.py) against the JAX package's:
the reference's tests/test_api.py cases on the port's ApiServer, and every
route's exchange (status line, headers but Date, body bytes) compared with
the JAX ApiServer's on the same request and the same callbacks. The one
difference by design: the port's `status` body also carries
`preprocess_failures` (ROADMAP C), which is checked and then dropped
before the comparison. Servers bind 127.0.0.1 at port 0."""

import http.client
import json
import urllib.error
import urllib.request

import pytest

from openhush_tpu.api import server as jax_api
from openhush_tpu_torch.api import server as api
from openhush_tpu_torch.api.server import ApiServer, hash_api_key

KEY = "sekrit"


def _get(port, path, key=None):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}")
    if key:
        req.add_header("X-API-Key", key)
    with urllib.request.urlopen(req, timeout=5) as r:
        return r.status, json.loads(r.read())


def _post(port, path, key=None):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 method="POST", data=b"")
    if key:
        req.add_header("X-API-Key", key)
    with urllib.request.urlopen(req, timeout=5) as r:
        return r.status, json.loads(r.read())


def _exchange(port, method, path, headers):
    """(status, reason, headers without Date, body bytes)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=5)
    try:
        conn.request(method, path, body=b"" if method == "POST" else None,
                     headers=headers)
        r = conn.getresponse()
        body = r.read()
        hdrs = sorted((k, v) for k, v in r.getheaders() if k != "Date")
        return r.status, r.reason, hdrs, body
    finally:
        conn.close()


ROUTES = [("GET", "/api/v1/health"), ("GET", "/api/v1/openapi.json"),
          ("GET", "/api/v1/status"), ("GET", "/api/v1/nope"),
          ("POST", "/api/v1/recording/start"),
          ("POST", "/api/v1/recording/stop"),
          ("POST", "/api/v1/recording/toggle"),
          ("POST", "/api/v1/recording/toggle/"),
          ("POST", "/api/v1/recording/pause"), ("POST", "/api/v1/health"),
          ("OPTIONS", "/api/v1/status")]
HEADERS = {"none": {}, "key": {"X-API-Key": KEY},
           "wrong key": {"X-API-Key": "wrong"},
           "origin": {"Origin": "http://example.com", "X-API-Key": KEY},
           "other origin": {"Origin": "http://evil.com"}}


def _strip_port_status(path, port_reply):
    """Drop the port's preprocess_failures from a status body (after
    checking it) and the Content-Length it changed."""
    status, reason, hdrs, body = port_reply
    if path != "/api/v1/status" or status != 200:
        return port_reply
    data = json.loads(body)
    assert data.pop("preprocess_failures") == 2
    body = json.dumps(data).encode()
    hdrs = [(k, str(len(body)) if k == "Content-Length" else v)
            for k, v in hdrs]
    return status, reason, hdrs, body


@pytest.mark.parametrize("locked,cors", [
    (False, []), (True, ["http://example.com"]), (False, ["*"]),
    (True, ["*", "http://example.com"])],
    ids=["open", "locked-origin", "wildcard", "locked-both"])
def test_every_route_matches_reference(locked, cors):
    calls = {"jax": [], "port": []}

    def command(side):
        def fn(action):
            calls[side].append(action)
            if action == "toggle":
                raise RuntimeError("no server")
            return action == "start"
        return fn

    status = {"recording": True, "queue_depth": 3, "model": "large-v3",
              "model_loaded": True, "preprocess_failures": 2}
    kw = dict(api_key_hash=hash_api_key(KEY) if locked else "",
              cors_origins=cors, status_fn=lambda: dict(status))
    jsrv = jax_api.ApiServer(port=0, command_fn=command("jax"), **kw)
    psrv = ApiServer(port=0, command_fn=command("port"), **kw)
    for s in (jsrv, psrv):
        s.start()
    try:
        for method, path in ROUTES:
            for name, headers in HEADERS.items():
                want = _exchange(jsrv.port, method, path, headers)
                got = _strip_port_status(
                    path, _exchange(psrv.port, method, path, headers))
                assert got == want, (method, path, name)
    finally:
        for s in (jsrv, psrv):
            s.stop()
    assert calls["port"] == calls["jax"] and calls["port"]


def test_openapi_document_matches_reference():
    assert api.openapi_document() == jax_api.openapi_document()
    assert api.API_KEY_HEADER == jax_api.API_KEY_HEADER


@pytest.mark.parametrize("key", ["test", "", "sekrit", "ключ"])
def test_hash_api_key_matches_reference(key):
    assert hash_api_key(key) == jax_api.hash_api_key(key)


def test_status_carries_preprocess_failures():
    """The port's status body: the reference's keys and
    preprocess_failures (0 unless the callback gives it)."""
    for status_fn, failures in ((lambda: {"recording": True}, 0),
                                (lambda: {"preprocess_failures": 5}, 5)):
        srv = ApiServer(port=0, status_fn=status_fn)
        srv.start()
        try:
            _, body = _get(srv.port, "/api/v1/status")
        finally:
            srv.stop()
        assert set(body) == {"running", "recording", "queue_depth", "model",
                             "version", "preprocess_failures"}
        assert body["preprocess_failures"] == failures


# ---------- the reference's cases on the port's server ----------

@pytest.fixture
def open_server():
    calls = []
    srv = ApiServer(port=0, status_fn=lambda: {"recording": True,
                                               "queue_depth": 3,
                                               "model": "large-v3"},
                    command_fn=lambda a: calls.append(a) or True)
    srv.start()
    yield srv, calls
    srv.stop()
    assert not srv._thread.is_alive()


@pytest.fixture
def locked_server():
    srv = ApiServer(port=0, api_key_hash=hash_api_key("sekrit"),
                    command_fn=lambda a: True)
    srv.start()
    yield srv
    srv.stop()


def test_hash_api_key():
    assert hash_api_key("test") == \
        "9f86d081884c7d659a2feaa0c55ad015a3bf4f1b2b0b822cd15d6c15b0f00a08"


def test_health_public(open_server):
    srv, _ = open_server
    status, body = _get(srv.port, "/api/v1/health")
    assert status == 200 and body["status"] == "ok" and "version" in body


def test_status_payload(open_server):
    srv, _ = open_server
    status, body = _get(srv.port, "/api/v1/status")
    assert status == 200
    assert body["recording"] is True and body["queue_depth"] == 3


def test_recording_actions(open_server):
    srv, calls = open_server
    for action, msg in [("start", "Recording started"),
                        ("stop", "Recording stopped"),
                        ("toggle", "Recording toggled")]:
        status, body = _post(srv.port, f"/api/v1/recording/{action}")
        assert status == 200
        assert body == {"ok": True, "message": msg}
    assert calls == ["start", "stop", "toggle"]


def test_auth_required(locked_server):
    srv = locked_server
    assert _get(srv.port, "/api/v1/health")[0] == 200
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(srv.port, "/api/v1/status")
    assert e.value.code == 401
    assert "Missing X-API-Key" in json.loads(e.value.read())["error"]
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(srv.port, "/api/v1/status", key="wrong")
    assert e.value.code == 401
    assert _get(srv.port, "/api/v1/status", key="sekrit")[0] == 200
    assert _post(srv.port, "/api/v1/recording/start", key="sekrit")[0] == 200


def test_unknown_route_404(open_server):
    srv, _ = open_server
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(srv.port, "/api/v1/nope")
    assert e.value.code == 404


def test_cors_headers():
    srv = ApiServer(port=0, cors_origins=["http://example.com"])
    srv.start()
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.port}/api/v1/health")
        req.add_header("Origin", "http://example.com")
        with urllib.request.urlopen(req, timeout=5) as r:
            assert r.headers["Access-Control-Allow-Origin"] == \
                "http://example.com"
        req2 = urllib.request.Request(
            f"http://127.0.0.1:{srv.port}/api/v1/health")
        req2.add_header("Origin", "http://evil.com")
        with urllib.request.urlopen(req2, timeout=5) as r:
            assert r.headers["Access-Control-Allow-Origin"] is None
    finally:
        srv.stop()


def test_cors_restricted_by_default():
    srv = ApiServer(port=0)
    srv.start()
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.port}/api/v1/health")
        req.add_header("Origin", "http://anything.example")
        with urllib.request.urlopen(req, timeout=5) as r:
            assert r.headers["Access-Control-Allow-Origin"] is None
    finally:
        srv.stop()


def test_cors_wildcard_must_be_explicit():
    srv = ApiServer(port=0, cors_origins=["*"])
    srv.start()
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.port}/api/v1/health")
        req.add_header("Origin", "http://some.site")
        with urllib.request.urlopen(req, timeout=5) as r:
            assert r.headers["Access-Control-Allow-Origin"] == "*"
    finally:
        srv.stop()
