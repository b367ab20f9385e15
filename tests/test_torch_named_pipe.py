"""The port's named-pipe IPC (runtime/named_pipe.py) against the JAX
package's: the reference's tests/test_named_pipe.py cases on the port's
module over the POSIX FIFO transport, the frames both modules write and
parse compared byte for byte, and the repaired race: 50 sequential
requests on one stream, each answered (the reference's server thread dies
on a BlockingIOError when a client opens the request FIFO between two of
its reads). Every FIFO lives in the test's tmp_path."""

import os
import select
import threading

import pytest

from openhush_tpu.runtime import named_pipe as jax_pipe
from openhush_tpu_torch.runtime.named_pipe import (NamedPipeClient,
                                                   NamedPipeServer, _frame,
                                                   _parse_line,
                                                   default_pipe_path)


@pytest.mark.parametrize("payload", [
    {"cmd": "status"}, {"cmd": "status", "window": 3},
    {"ok": False, "error": "unknown command 'x'"},
    {"ok": True, "text": "héllo \"quoted\"\n"}])
def test_frames_match_reference(payload):
    assert _frame(payload) == jax_pipe._frame(payload)
    assert _parse_line(_frame(payload)) == payload


@pytest.mark.parametrize("raw", [b"not json\n", b"", b"{}\n",
                                 b'{"cmd": "a"}\n{"cmd": "b"}\n', b"[1, 2"])
def test_parse_line_matches_reference(raw):
    assert _parse_line(raw) == jax_pipe._parse_line(raw)


def test_frame_roundtrip():
    assert _parse_line(_frame({"cmd": "status"})) == {"cmd": "status"}
    assert _parse_line(b"not json\n") == {"_malformed": True}
    assert _parse_line(b"") == {}


def test_default_path_matches_reference(monkeypatch, tmp_path):
    monkeypatch.setenv("XDG_RUNTIME_DIR", str(tmp_path))
    assert default_pipe_path() == jax_pipe.default_pipe_path() == str(
        tmp_path / "openhush.pipe")


def _handler(calls):
    def handler(req):
        calls.append(req)
        if req.get("cmd") == "status":
            return {"ok": True, "version": "test"}
        if req.get("cmd") == "boom":
            raise RuntimeError("kaboom")
        return {"ok": False, "error": "unknown"}
    return handler


@pytest.fixture
def pipe(tmp_path):
    calls = []
    server = NamedPipeServer(_handler(calls), path=str(tmp_path / "oh.pipe"))
    server.start()
    yield server, calls
    server.stop()
    assert not server._thread.is_alive()


def test_request_response(pipe):
    server, calls = pipe
    client = NamedPipeClient(path=server.path, timeout=10)
    r = client.send("status")
    assert r == {"ok": True, "version": "test"}
    assert calls == [{"cmd": "status"}]


def test_fifty_sequential_requests_same_stream(pipe):
    """The repaired race: every request on one stream is answered."""
    server, calls = pipe
    client = NamedPipeClient(path=server.path, timeout=10)
    replies = [client.send("status", n=i) for i in range(50)]
    assert replies == [{"ok": True, "version": "test"}] * 50
    assert calls == [{"cmd": "status", "n": i} for i in range(50)]
    assert server._thread.is_alive()


def test_open_without_write_is_no_data(pipe):
    """A client that opens the request FIFO and writes nothing yet, the
    moment at which the reference's read raises BlockingIOError, leaves
    the server serving."""
    server, _ = pipe
    fd = os.open(server.path + ".req", os.O_WRONLY)
    try:
        client = NamedPipeClient(path=server.path, timeout=10)
        assert client.send("status")["ok"]
    finally:
        os.close(fd)
    assert NamedPipeClient(path=server.path, timeout=10).send("status")["ok"]


def _churn(path, stop):
    """Open and close the request FIFO's write side without writing, as
    fast as possible (non-blocking: once no server reads, it returns)."""
    while not stop.is_set():
        try:
            os.close(os.open(path + ".req", os.O_WRONLY | os.O_NONBLOCK))
        except OSError:
            return


def _churning(path, n=4):
    stop = threading.Event()
    threads = [threading.Thread(target=_churn, args=(path, stop),
                                daemon=True) for _ in range(n)]
    for t in threads:
        t.start()
    return stop, threads


def test_concurrent_openers_do_not_kill_the_server(pipe):
    """Openers that come and go while requests run (the schedule on which
    the reference's server dies): the port's answers every request and
    keeps serving."""
    server, _ = pipe
    stop, threads = _churning(server.path)
    try:
        client = NamedPipeClient(path=server.path, timeout=10)
        assert all(client.send("status")["ok"] for _ in range(20))
        assert server._thread.is_alive()
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=5)
    assert not any(t.is_alive() for t in threads)


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_reference_server_dies_on_the_same_schedule(tmp_path):
    """The fault the port repairs, shown on the JAX package's server: under
    the same openers its thread ends on BlockingIOError (within seconds
    here), after which no request is answered."""
    server = jax_pipe.NamedPipeServer(lambda r: {"ok": True},
                                      path=str(tmp_path / "ref.pipe"))
    server.start()
    stop, threads = _churning(server.path)
    try:
        server._thread.join(timeout=30)
        died = not server._thread.is_alive()
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=5)
        server.stop()
    assert died


def test_extra_fields_pass_through(pipe):
    server, calls = pipe
    client = NamedPipeClient(path=server.path, timeout=10)
    client.send("status", window=3)
    assert calls[-1] == {"cmd": "status", "window": 3}


def test_handler_exception_becomes_error(pipe):
    server, _ = pipe
    client = NamedPipeClient(path=server.path, timeout=10)
    r = client.send("boom")
    assert r["ok"] is False and "kaboom" in r["error"]


def test_malformed_json_rejected(pipe):
    server, _ = pipe
    os.close(os.open(server.path + ".req", os.O_WRONLY))  # no-op open
    fd = os.open(server.path + ".req", os.O_WRONLY)
    os.write(fd, b"this is not json\n")
    os.close(fd)
    # The server answers with an error frame, not dies: read that answer,
    # then a valid request on a fresh exchange.
    rsp = os.open(server.path + ".rsp", os.O_RDONLY | os.O_NONBLOCK)
    buf = b""
    for _ in range(40):
        r, _, _ = select.select([rsp], [], [], 0.25)
        if r:
            buf += os.read(rsp, 4096)
        if b"\n" in buf:
            break
    os.close(rsp)
    assert _parse_line(buf) == {"ok": False, "error": "invalid JSON"}
    client = NamedPipeClient(path=server.path, timeout=10)
    assert client.send("status")["ok"]


def test_client_without_server_raises():
    with pytest.raises(ConnectionError):
        NamedPipeClient(path="/nonexistent/never.pipe").send("status")


def test_daemon_wire_protocol_over_pipe(pipe):
    """The pipe speaks the same {"cmd"}/{"ok"} protocol as the Unix
    socket (src/ipc/mod.rs:45-66) — one control-plane contract."""
    server, _ = pipe
    client = NamedPipeClient(path=server.path, timeout=10)
    assert client.send("nope") == {"ok": False, "error": "unknown"}


def test_stop_removes_the_fifos(tmp_path):
    server = NamedPipeServer(lambda r: {"ok": True},
                             path=str(tmp_path / "x.pipe"))
    server.start()
    assert os.path.exists(server.path + ".req")
    server.stop()
    assert not server._thread.is_alive()
    assert not os.path.exists(server.path + ".req")
    assert not os.path.exists(server.path + ".rsp")
