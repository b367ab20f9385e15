"""The port's D-Bus wire protocol and service (utils/dbus.py) against the
JAX package's: the reference's tests/test_dbus.py cases on the port's
module (a private dbus-daemon, the stock dbus-send and dbus-monitor
tools), marshalled values and whole messages compared byte for byte with
the JAX module's, and the daemon's D-Bus surface: `Daemon.run` registers
org.openhush.Daemon1 on the session bus, a client drives a recording with
StartRecording/StopRecording, two IsRecordingChanged signals arrive, and
the replies equal the JAX daemon's (GetStatus but the port's
preprocess_failures key). The daemons run on a canned server (texts
without a model): this file is about the control surface."""

import json
import os
import queue
import shutil
import subprocess
import threading
import time

import numpy as np
import pytest

from openhush_tpu.runtime import daemon as jax_daemon
from openhush_tpu.utils import config as jax_config
from openhush_tpu.utils import dbus as jax_dbus
from openhush_tpu_torch.runtime import daemon
from openhush_tpu_torch.utils import config
from openhush_tpu_torch.utils import dbus

needs_dbus = pytest.mark.skipif(shutil.which("dbus-daemon") is None,
                                reason="dbus-daemon not installed")


@pytest.fixture(scope="module")
def session_bus():
    proc = subprocess.Popen(
        ["dbus-daemon", "--session", "--print-address", "--nofork"],
        stdout=subprocess.PIPE, text=True)
    address = proc.stdout.readline().strip()
    yield address
    proc.terminate()
    proc.wait(timeout=5)


@pytest.fixture
def service(session_bus):
    state = {"recording": False, "calls": []}

    def handler(member):
        state["calls"].append(member)
        if member in ("StartRecording", "StopRecording", "ToggleRecording",
                      "LoadModel", "UnloadModel"):
            state["recording"] = member == "StartRecording"
            return ("b", True)
        if member == "GetStatus":
            return ("s", json.dumps({"recording": state["recording"]}))
        if member == "GetQueueDepth":
            return ("u", 7)
        if member == "GetVersion":
            return ("s", "0.1.0")
        raise ValueError(f"unknown method {member}")

    svc = dbus.DbusService(handler, address=session_bus)
    yield svc, state
    svc.stop()
    assert not svc._thread.is_alive()


# ---------- marshalling: byte for byte against the reference ----------

VALUES = [("u", 42), ("s", "héllo"), ("b", True), ("b", False), ("i", -7),
          ("o", "/org/openhush/Daemon1"), ("g", "a{sv}"), ("y", 255),
          ("x", -2 ** 40), ("t", 2 ** 63), ("d", 0.1), ("as", ["a", "bc"]),
          ("a{sv}", {"k1": ("s", "v1"), "k2": ("u", 7)}),
          ("(ia{sv}av)", (3, {"label": ("s", "Quit")},
                          [("(ia{sv}av)", (4, {}, []))])),
          ("v", ("s", "variant")), ("ai", [])]


@pytest.mark.parametrize("sig,value", VALUES, ids=[v[0] for v in VALUES])
def test_marshalling_matches_reference(sig, value):
    outs = []
    for mod in (dbus, jax_dbus):
        m = mod.Marshaller()
        m.put("y", 1)                    # an odd start: alignment shows
        m.put(sig, value)
        outs.append(bytes(m.buf))
    assert outs[0] == outs[1]
    u, ju = dbus.Unmarshaller(outs[0]), jax_dbus.Unmarshaller(outs[0])
    assert (u.get("y"), u.get(sig)) == (ju.get("y"), ju.get(sig))


@pytest.mark.parametrize("kind", ["call", "return", "error", "signal"])
def test_messages_match_reference(kind):
    msg_type, fields, sig, args = {
        "call": (dbus.METHOD_CALL,
                 [(dbus.H_PATH, "o", dbus.OBJECT_PATH),
                  (dbus.H_MEMBER, "s", "GetVersion"),
                  (dbus.H_INTERFACE, "s", dbus.INTERFACE),
                  (dbus.H_DESTINATION, "s", dbus.BUS_NAME)], "su",
                 ("hello", 9)),
        "return": (dbus.METHOD_RETURN, [(dbus.H_REPLY_SERIAL, "u", 5),
                                        (dbus.H_DESTINATION, "s", ":1.7")],
                   "s", ('{"recording": true}',)),
        "error": (dbus.ERROR, [(dbus.H_REPLY_SERIAL, "u", 6),
                               (dbus.H_ERROR_NAME, "s",
                                f"{dbus.INTERFACE}.Error")], "s",
                  ("unknown method 'X'",)),
        "signal": (dbus.SIGNAL, [(dbus.H_PATH, "o", dbus.OBJECT_PATH),
                                 (dbus.H_INTERFACE, "s", dbus.INTERFACE),
                                 (dbus.H_MEMBER, "s", "IsRecordingChanged")],
                   "b", (True,))}[kind]
    raw = dbus.build_message(msg_type, 11, fields, sig, args)
    assert raw == jax_dbus.build_message(msg_type, 11, fields, sig, args)
    assert dbus.parse_message(raw) == jax_dbus.parse_message(raw)


def test_constants_match_reference():
    for name in ("BUS_NAME", "OBJECT_PATH", "INTERFACE", "METHOD_CALL",
                 "METHOD_RETURN", "ERROR", "SIGNAL", "_INTROSPECT_XML"):
        assert getattr(dbus, name) == getattr(jax_dbus, name)
    for sig in ("iias", "u(ia{sv}av)", "a(ia{sv})", "sa{sv}as"):
        assert dbus.split_signature(sig) == jax_dbus.split_signature(sig)


def test_marshal_roundtrip():
    m = dbus.Marshaller()
    m.put("u", 42)
    m.put("s", "héllo")
    m.put("b", True)
    u = dbus.Unmarshaller(bytes(m.buf))
    assert u.get("u") == 42 and u.get("s") == "héllo" and u.get("b") is True


# ---------- the reference's live-bus cases on the port's service ----------

@needs_dbus
def test_client_service_roundtrip(service, session_bus):
    svc, state = service
    client = dbus.DbusClient(address=session_bus)
    try:
        assert client.call("GetVersion") == "0.1.0"
        assert client.call("GetQueueDepth") == 7
        assert client.call("StartRecording") is True
        assert json.loads(client.call("GetStatus"))["recording"] is True
        assert client.call("StopRecording") is True
        with pytest.raises(RuntimeError, match="D-Bus error"):
            client.call("NoSuchMethod")
    finally:
        client.close()
    assert "StartRecording" in state["calls"]


@needs_dbus
def test_dbus_send_interop(service, session_bus):
    """The stock dbus-send CLI drives the port's service."""
    env = dict(os.environ, DBUS_SESSION_BUS_ADDRESS=session_bus)
    if shutil.which("dbus-send") is None:
        pytest.skip("dbus-send not installed")
    base = ["dbus-send", "--session", "--print-reply",
            "--dest=org.openhush.Daemon1", "/org/openhush/Daemon1"]
    r = subprocess.run(base + ["org.openhush.Daemon1.GetVersion"],
                       capture_output=True, text=True, timeout=10, env=env)
    assert r.returncode == 0, r.stderr
    assert '"0.1.0"' in r.stdout
    r = subprocess.run(base + ["org.openhush.Daemon1.ToggleRecording"],
                       capture_output=True, text=True, timeout=10, env=env)
    assert r.returncode == 0 and "boolean true" in r.stdout
    r = subprocess.run(
        base + ["org.freedesktop.DBus.Introspectable.Introspect"],
        capture_output=True, text=True, timeout=10, env=env)
    assert "IsRecordingChanged" in r.stdout


@needs_dbus
def test_signal_emission(service, session_bus):
    if shutil.which("dbus-monitor") is None:
        pytest.skip("dbus-monitor not installed")
    svc, _ = service
    env = dict(os.environ, DBUS_SESSION_BUS_ADDRESS=session_bus)
    mon = subprocess.Popen(
        ["dbus-monitor", "--session",
         "type='signal',interface='org.openhush.Daemon1'"],
        stdout=subprocess.PIPE, text=True, env=env)
    try:
        time.sleep(0.3)                  # the monitor subscribes
        svc.emit_recording_changed(True)
        time.sleep(0.5)
        mon.terminate()
        out, _ = mon.communicate(timeout=5)
    finally:
        if mon.poll() is None:
            mon.kill()
        mon.wait(timeout=5)
    assert "IsRecordingChanged" in out


@needs_dbus
def test_signal_subscription_client(service, session_bus):
    svc, _ = service
    client = dbus.DbusClient(address=session_bus)
    try:
        client.subscribe_recording_changed()
        got = []
        t = threading.Thread(
            target=lambda: got.append(client.wait_recording_changed(10)))
        t.start()
        svc.emit_recording_changed(True)
        t.join(timeout=10)
        assert not t.is_alive() and got == [True]
    finally:
        client.close()


# ---------- the daemon's D-Bus surface ----------

class CannedServer:
    """An engine server without a model: each window's result is ready at
    once, its text the window's id."""

    audio_ctx = 1500
    preprocess_failures = 0

    def __init__(self, result_type):
        self._type, self._sid, self._q = result_type, 0, {}

    def open_session(self):
        self._sid += 1
        self._q[self._sid] = queue.Queue()
        return self._sid

    def close_session(self, sid):
        self._q.pop(sid, None)

    def submit_window(self, sid, audio, window_id=0, **kw):
        self._q[sid].put(self._type(
            session_id=sid, window_id=window_id, tokens=[1],
            text=f"w{window_id:x}", avg_logprob=-0.1, no_speech_prob=0.01,
            first_token_latency=0.0, latency=0.0))

    def poll(self, sid, timeout=None):
        try:
            return self._q[sid].get_nowait()
        except (KeyError, queue.Empty):
            return None

    def start(self):
        pass

    def stop(self):
        pass


def _daemon(side, tmp_path, outputs):
    from openhush_tpu.audio.capture import NullSource as JaxNull
    from openhush_tpu.runtime.server import WindowResult as JaxResult
    from openhush_tpu_torch.audio.capture import NullSource
    from openhush_tpu_torch.runtime.server import WindowResult
    cfg = (jax_config if side == "jax" else config).Config()
    cfg.feedback.audio = cfg.feedback.visual = False
    sock = str(tmp_path / f"{side}.sock")
    if side == "jax":
        return jax_daemon.Daemon(cfg, CannedServer(JaxResult), JaxNull(5.0),
                                 output=outputs.append, ipc_path=sock)
    return daemon.Daemon(cfg, CannedServer(WindowResult), NullSource(5.0),
                         output=outputs.append, ipc_path=sock, device="cpu")


@needs_dbus
def test_daemon_dbus_cycle_matches_reference(session_bus, tmp_path,
                                             monkeypatch):
    """Each daemon in turn on the bus (one owner of the name at a time):
    `run` registers the service, a client's StartRecording and
    StopRecording drive a recording whose text is output, two
    IsRecordingChanged signals (True, then False) arrive, and every reply
    equals the JAX daemon's."""
    monkeypatch.setenv("DBUS_SESSION_BUS_ADDRESS", session_bus)
    monkeypatch.setenv("XDG_RUNTIME_DIR", str(tmp_path))
    members = ["GetVersion", "GetStatus", "StartRecording", "GetStatus",
               "StartRecording", "StopRecording", "StopRecording",
               "GetQueueDepth", "LoadModel", "UnloadModel", "GetStatus"]
    got = {}
    for side in ("jax", "port"):
        outputs = []
        d = _daemon(side, tmp_path, outputs)
        t = threading.Thread(target=d.run, kwargs={"max_runtime": 60,
                                                   "enable_tray": False},
                             daemon=True)
        t.start()
        replies, signals = [], []
        try:
            deadline = time.monotonic() + 20
            while getattr(d, "_dbus", None) is None and \
                    time.monotonic() < deadline:
                time.sleep(0.01)
            assert getattr(d, "_dbus", None) is not None, "D-Bus registered"
            client = dbus.DbusClient(address=session_bus)
            listener = dbus.DbusClient(address=session_bus)
            listener.subscribe_recording_changed()
            try:
                for member in members:
                    r = client.call(member)
                    if member == "GetStatus":
                        r = json.loads(r)
                        if side == "port":
                            assert r.pop("preprocess_failures") == 0
                    replies.append(r)
                    if member == "StartRecording" and len(signals) == 0:
                        d.ring.push(np.full(8000, 0.1, np.float32))
                signals = [listener.wait_recording_changed(10)
                           for _ in range(2)]
                deadline = time.monotonic() + 20
                while not outputs and time.monotonic() < deadline:
                    time.sleep(0.01)
            finally:
                client.close()
                listener.close()
        finally:
            d._stop_event.set()
            t.join(timeout=30)
        assert not t.is_alive()
        got[side] = dict(replies=replies, signals=signals, outputs=outputs)
    assert got["port"] == got["jax"]
    port = got["port"]
    assert port["signals"] == [True, False]
    assert port["replies"][2] is True and port["replies"][4] is False
    assert port["replies"][3]["recording"] is True
    assert len(port["outputs"]) == 1
