"""The port's system tray (ui/tray.py, ui/tray_macos.py, ui/tray_windows.py)
against the JAX package's: the reference's tests/test_tray.py,
test_tray_macos.py and test_tray_windows.py cases on the port's modules
(the StatusNotifierItem on a private dbus-daemon with an in-test watcher,
the macOS helper protocol and bridge over a fake helper, the Windows
protocol halves off Windows), and the values both packages produce
compared: the SNI properties and dbusmenu layout a host pulls from each
tray on the same bus, the helper's encoded lines, the menu rows, the
Windows tables, tooltips and struct layouts. Every thread and process a
test starts is joined or waited for."""

import ctypes
import io
import shutil
import socket
import subprocess
import sys
import textwrap
import threading
import time

import pytest

from openhush_tpu.ui import tray as jax_tray
from openhush_tpu.ui import tray_macos as jax_tm
from openhush_tpu.ui import tray_windows as jax_tw
from openhush_tpu_torch.ui import tray_macos as tm
from openhush_tpu_torch.ui import tray_windows as tw
from openhush_tpu_torch.ui.tray import (SniTray, TrayError, TrayEvent,
                                        TrayStatus, MENU_IFACE, MENU_PATH,
                                        ITEM_IFACE, ITEM_PATH, PROPS_IFACE,
                                        ID_PREFS, ID_QUIT, ID_STATUS,
                                        is_tray_supported)
from openhush_tpu_torch.utils import dbus as wire

needs_dbus = pytest.mark.skipif(shutil.which("dbus-daemon") is None,
                                reason="dbus-daemon not installed")


# =============== the SNI tray (the reference's test_tray.py) ===============


@pytest.fixture(scope="module")
def session_bus():
    proc = subprocess.Popen(
        ["dbus-daemon", "--session", "--print-address", "--nofork"],
        stdout=subprocess.PIPE, text=True)
    address = proc.stdout.readline().strip()
    yield address
    proc.terminate()
    proc.wait(timeout=5)


class FakeWatcher:
    """Owns org.kde.StatusNotifierWatcher and records registrations."""

    def __init__(self, address):
        self.conn = wire.DBusConnection(address)
        assert self.conn.request_name(
            "org.kde.StatusNotifierWatcher") in (1, 4)
        self.registered: list[str] = []
        self._running = True
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()

    def _serve(self):
        self.conn.sock.settimeout(0.2)
        while self._running:
            try:
                msg = wire._read_message(self.conn.sock)
            except socket.timeout:
                continue
            except OSError:
                return
            if msg is None:
                return
            if msg["type"] != wire.METHOD_CALL:
                continue
            if msg["fields"].get(wire.H_MEMBER) == \
                    "RegisterStatusNotifierItem":
                self.registered.append(msg["args"][0])
            fields = [(wire.H_REPLY_SERIAL, "u", msg["serial"]),
                      (wire.H_DESTINATION, "s",
                       msg["fields"].get(wire.H_SENDER, ""))]
            self.conn.send(wire.build_message(
                wire.METHOD_RETURN, self.conn.next_serial(), fields))

    def stop(self):
        self._running = False
        self._thread.join(timeout=2)
        self.conn.close()


@pytest.fixture
def watcher(session_bus):
    w = FakeWatcher(session_bus)
    yield w
    w.stop()


@pytest.fixture
def tray(session_bus, watcher):
    t = SniTray(address=session_bus)
    yield t
    t.stop()


# ---------- container marshaling (pure, no bus) ----------

def test_split_signature():
    assert wire.split_signature("iias") == ["i", "i", "as"]
    assert wire.split_signature("u(ia{sv}av)") == ["u", "(ia{sv}av)"]
    assert wire.split_signature("a(ia{sv})") == ["a(ia{sv})"]


def test_container_roundtrip():
    m = wire.Marshaller()
    m.put("as", ["alpha", "beta"])
    m.put("a{sv}", {"k1": ("s", "v1"), "k2": ("u", 7)})
    m.put("(ia{sv}av)", (3, {"label": ("s", "Quit")},
                         [("(ia{sv}av)", (4, {}, []))]))
    u = wire.Unmarshaller(bytes(m.buf))
    assert u.get("as") == ["alpha", "beta"]
    assert u.get("a{sv}") == {"k1": "v1", "k2": 7}
    item = u.get("(ia{sv}av)")
    assert item[0] == 3 and item[1] == {"label": "Quit"}
    assert item[2][0][0] == 4


def test_is_tray_supported_returns_bool():
    assert isinstance(is_tray_supported(), bool)


def test_tray_status_labels_icons():
    # Parity: src/tray/mod.rs:64-82.
    assert TrayStatus.IDLE.icon_name == "audio-input-microphone"
    assert TrayStatus.RECORDING.icon_name == "media-record"
    assert TrayStatus.PROCESSING.icon_name == "view-refresh"
    assert TrayStatus.ERROR.icon_name == "dialog-error"
    assert TrayStatus.RECORDING.label == "Status: Recording..."


# ---------- live bus ----------

@needs_dbus
def test_tray_registers_with_watcher(tray, watcher):
    assert tray.bus_name in watcher.registered


@needs_dbus
def test_tray_requires_watcher(session_bus):
    with pytest.raises(TrayError):
        SniTray(address=session_bus)  # no watcher fixture → must fail


@needs_dbus
def test_host_pulls_sni_properties(tray, session_bus):
    host = wire.DBusConnection(session_bus)
    try:
        (props,) = host.call_blocking(
            tray.bus_name, ITEM_PATH, PROPS_IFACE, "GetAll", "s",
            (ITEM_IFACE,))
        assert props["Id"] == "openhush"
        assert props["IconName"] == "audio-input-microphone"
        assert props["Menu"] == MENU_PATH
        assert props["ToolTip"][0] == "audio-input-microphone"
        (icon,) = host.call_blocking(
            tray.bus_name, ITEM_PATH, PROPS_IFACE, "Get", "ss",
            (ITEM_IFACE, "IconName"))
        assert icon == "audio-input-microphone"
    finally:
        host.close()


@needs_dbus
def test_menu_layout_and_clicks(tray, session_bus):
    host = wire.DBusConnection(session_bus)
    try:
        rev, root = host.call_blocking(
            tray.bus_name, MENU_PATH, MENU_IFACE, "GetLayout", "iias",
            (0, -1, []))
        root_id, root_props, children = root
        assert root_id == 0
        assert root_props["children-display"] == "submenu"
        labels = {cid: props.get("label") for cid, props, _ in children}
        assert labels[ID_PREFS] == "Preferences..."
        assert labels[ID_QUIT] == "Quit"
        assert labels[ID_STATUS] == "Status: Idle"
        seps = [props for _, props, _ in children
                if props.get("type") == "separator"]
        assert len(seps) == 2

        # Click Preferences then Quit, as a dbusmenu host would.
        for item_id in (ID_PREFS, ID_QUIT):
            host.call_blocking(
                tray.bus_name, MENU_PATH, MENU_IFACE, "Event", "isvu",
                (item_id, "clicked", ("i", 0), 0))
        assert tray.try_recv() == TrayEvent.SHOW_PREFERENCES
        assert tray.try_recv() == TrayEvent.QUIT
        assert tray.try_recv() is None
    finally:
        host.close()


@needs_dbus
def test_status_change_updates_icon_and_menu(tray, session_bus):
    host = wire.DBusConnection(session_bus)
    try:
        rev0, _ = host.call_blocking(
            tray.bus_name, MENU_PATH, MENU_IFACE, "GetLayout", "iias",
            (0, -1, []))
        tray.set_status(TrayStatus.RECORDING)
        (icon,) = host.call_blocking(
            tray.bus_name, ITEM_PATH, PROPS_IFACE, "Get", "ss",
            (ITEM_IFACE, "IconName"))
        assert icon == "media-record"
        rev1, root = host.call_blocking(
            tray.bus_name, MENU_PATH, MENU_IFACE, "GetLayout", "iias",
            (0, -1, []))
        assert rev1 > rev0
        status_label = [p.get("label") for cid, p, _ in root[2]
                        if cid == ID_STATUS][0]
        assert status_label == "Status: Recording..."
        # Idempotent set does not bump the revision.
        tray.set_status(TrayStatus.RECORDING)
        rev2, _ = host.call_blocking(
            tray.bus_name, MENU_PATH, MENU_IFACE, "GetLayout", "iias",
            (0, -1, []))
        assert rev2 == rev1
    finally:
        host.close()


@needs_dbus
def test_activate_and_about_to_show(tray, session_bus):
    host = wire.DBusConnection(session_bus)
    try:
        host.call_blocking(tray.bus_name, ITEM_PATH, ITEM_IFACE,
                           "Activate", "ii", (10, 20))
        assert tray.try_recv() == TrayEvent.STATUS_CLICKED
        (shown,) = host.call_blocking(
            tray.bus_name, MENU_PATH, MENU_IFACE, "AboutToShow", "i", (0,))
        assert shown is False
    finally:
        host.close()


# =============== macOS (the reference's test_tray_macos.py) ===============

# -- line codec ---------------------------------------------------------------

@pytest.mark.parametrize("status", list(TrayStatus))
def test_status_command_roundtrip(status):
    cmd = tm.decode_command(tm.encode_status_command(status))
    assert cmd == {"cmd": "status", "status": status}


def test_stop_command_roundtrip():
    assert tm.decode_command(tm.encode_stop_command()) == {"cmd": "stop"}


@pytest.mark.parametrize("line", [
    "", "   ", "not json", "[1,2]", '{"cmd": "nope"}',
    '{"cmd": "status", "status": "NO_SUCH"}', '{"status": "IDLE"}'])
def test_decode_command_rejects_garbage(line):
    assert tm.decode_command(line) is None


@pytest.mark.parametrize("ev", list(TrayEvent))
def test_event_roundtrip(ev):
    assert tm.decode_helper_line(tm.encode_event(ev)) == ("event", ev)


def test_helper_line_kinds():
    assert tm.decode_helper_line(tm.encode_ready()) == ("ready", True)
    assert tm.decode_helper_line(tm.encode_error("boom")) == ("error",
                                                              "boom")
    assert tm.decode_helper_line("stray print")[0] == "noise"
    assert tm.decode_helper_line('{"event": "bogus"}')[0] == "noise"


# -- menu model ----------------------------------------------------------------

def test_menu_rows_parity_with_sni_layout():
    """Same rows as the SNI dbusmenu (tray.py) / src/tray/linux.rs:37-71:
    disabled status label, separator, Preferences..., separator, Quit."""
    rows = tm.menu_rows(TrayStatus.RECORDING)
    assert [r[0] for r in rows] == [TrayStatus.RECORDING.label, "-",
                                    "Preferences...", "-", "Quit"]
    assert rows[0][2] is False          # status row disabled
    assert rows[2][2] and rows[4][2]    # actionable rows enabled
    assert tm.EVENT_FOR_SELECTOR[rows[2][1]] is TrayEvent.SHOW_PREFERENCES
    assert tm.EVENT_FOR_SELECTOR[rows[4][1]] is TrayEvent.QUIT


def test_status_titles_cover_every_status():
    assert set(tm.STATUS_TITLES) == set(TrayStatus)
    assert len({t for t in tm.STATUS_TITLES.values()}) == len(TrayStatus)


# -- helper loop (fake backend) -------------------------------------------------

class FakeBackend:
    def __init__(self, fail_start=False):
        self.fail_start = fail_start
        self.statuses = []
        self.terminated = threading.Event()
        self.emit = None

    def start(self, rows, title, emit):
        if self.fail_start:
            raise RuntimeError("no AppKit here")
        self.rows, self.title, self.emit = rows, title, emit

    def set_status(self, status):
        self.statuses.append(status)

    def terminate(self):
        self.terminated.set()

    def run(self):
        assert self.terminated.wait(timeout=10)


def test_run_helper_serves_commands_and_stops():
    backend = FakeBackend()
    stdin = io.StringIO(tm.encode_status_command(TrayStatus.RECORDING)
                        + "garbage line\n"
                        + tm.encode_status_command(TrayStatus.ERROR)
                        + tm.encode_stop_command())
    stdout = io.StringIO()
    assert tm.run_helper(backend, stdin=stdin, stdout=stdout) == 0
    assert backend.statuses == [TrayStatus.RECORDING, TrayStatus.ERROR]
    assert backend.terminated.is_set()
    assert backend.title == tm.STATUS_TITLES[TrayStatus.IDLE]
    kinds = [tm.decode_helper_line(l)[0]
             for l in stdout.getvalue().splitlines()]
    assert kinds == ["ready"]


def test_run_helper_terminates_on_eof():
    """Parent death (stdin EOF) must tear the helper down — no orphaned
    menu-bar icons."""
    backend = FakeBackend()
    assert tm.run_helper(backend, stdin=io.StringIO(""),
                         stdout=io.StringIO()) == 0
    assert backend.terminated.is_set()


def test_run_helper_emits_menu_events():
    backend = FakeBackend()
    stdout = io.StringIO()
    done = threading.Event()

    class Stdin:
        def __iter__(self):
            # A menu click happens while the loop is serving.
            backend.emit(TrayEvent.SHOW_PREFERENCES)
            yield tm.encode_stop_command()
            done.set()

    assert tm.run_helper(backend, stdin=Stdin(), stdout=stdout) == 0
    lines = stdout.getvalue().splitlines()
    parsed = [tm.decode_helper_line(l) for l in lines]
    assert ("event", TrayEvent.SHOW_PREFERENCES) in parsed


def test_run_helper_reports_start_failure():
    stdout = io.StringIO()
    rc = tm.run_helper(FakeBackend(fail_start=True),
                       stdin=io.StringIO(""), stdout=stdout)
    assert rc == 1
    kind, text = tm.decode_helper_line(stdout.getvalue())
    assert kind == "error" and "no AppKit" in text


# -- parent bridge over a real subprocess ---------------------------------------

FAKE_HELPER = textwrap.dedent("""
    import json, sys
    print(json.dumps({"ready": True}), flush=True)
    for line in sys.stdin:
        msg = json.loads(line)
        if msg.get("cmd") == "stop":
            break
        if msg.get("cmd") == "status":
            # A user clicks Preferences right after each status change.
            print(json.dumps({"event": "show_preferences"}), flush=True)
    sys.exit(0)
""")

FAILING_HELPER = ("import json, sys; "
                  "print(json.dumps({'error': 'AppKit unavailable'})"
                  ".replace(chr(39), chr(34)), flush=True); sys.exit(1)")


def test_mactray_end_to_end_with_fake_helper(tmp_path):
    script = tmp_path / "helper.py"
    script.write_text(FAKE_HELPER)
    tray = tm.MacTray(helper_argv=[sys.executable, str(script)])
    assert tray.status is TrayStatus.IDLE
    tray.set_status(TrayStatus.RECORDING)
    assert tray.status is TrayStatus.RECORDING
    deadline = time.monotonic() + 10
    ev = None
    while ev is None and time.monotonic() < deadline:
        ev = tray.try_recv()
        time.sleep(0.01)
    assert ev is TrayEvent.SHOW_PREFERENCES
    tray.set_status(TrayStatus.RECORDING)   # no-op: same status
    tray.stop()
    assert tray.proc.returncode == 0


def test_mactray_surfaces_helper_failure(tmp_path):
    with pytest.raises(TrayError, match="AppKit unavailable"):
        tm.MacTray(helper_argv=[sys.executable, "-c", FAILING_HELPER])


def test_mactray_bad_spawn_is_tray_error():
    with pytest.raises(TrayError, match="spawn failed"):
        tm.MacTray(helper_argv=["/no/such/binary/anywhere"])


def test_create_tray_routes_macos(monkeypatch):
    """create_tray() must pick the AppKit helper backend on darwin."""
    from openhush_tpu_torch.ui import tray_windows as tw

    calls = []
    monkeypatch.setattr(tm, "MacTray",
                        lambda *a, **k: calls.append("mac") or "tray")
    monkeypatch.setattr(sys, "platform", "darwin")
    assert tw.create_tray() == "tray"
    assert calls == ["mac"]


# =============== Windows (the reference's test_tray_windows.py) ===============

def test_notifyicondata_layout():
    # Fixed-width prefix: cbSize(4) + pad + hWnd(ptr) + uID(4) + uFlags(4)
    # + uCallbackMessage(4) + pad + hIcon(ptr); then szTip 128 WCHARs.
    ptr = ctypes.sizeof(ctypes.c_void_p)
    assert tw.NOTIFYICONDATAW.szTip.size == 128 * ctypes.sizeof(
        ctypes.c_wchar)
    assert tw.NOTIFYICONDATAW.hWnd.offset == max(8, ptr)
    data = tw.NOTIFYICONDATAW()
    data.szTip = "OpenHush"
    assert data.szTip == "OpenHush"


def test_msg_and_point_layout():
    assert ctypes.sizeof(tw.POINT) == 8
    # MSG: hwnd(ptr) message(4) wParam(size_t) lParam(ssize_t) time(4) pt(8)
    assert ctypes.sizeof(tw.MSG) >= 28


def test_status_icon_table_covers_all_states():
    assert set(tw.STATUS_ICONS) == set(TrayStatus)


def test_tooltip_uses_reference_labels():
    tip = tw.tray_tooltip(TrayStatus.RECORDING)
    assert tip.startswith("OpenHush") and "Recording" in tip
    assert len(tip) <= 63                      # szTip budget


def test_menu_command_mapping():
    assert tw.menu_event_for_command(tw.CMD_PREFERENCES) is \
        TrayEvent.SHOW_PREFERENCES
    assert tw.menu_event_for_command(tw.CMD_QUIT) is TrayEvent.QUIT
    assert tw.menu_event_for_command(9999) is None
    labels = [label for _, label in tw.MENU_ITEMS]
    assert labels == ["Preferences", "Quit"]   # reference menu order


def test_mouse_message_mapping():
    assert tw.event_for_mouse_message(tw.WM_RBUTTONUP) == "menu"
    assert tw.event_for_mouse_message(tw.WM_LBUTTONUP) == "clicked"
    assert tw.event_for_mouse_message(0x0200) is None


@pytest.mark.skipif(sys.platform.startswith("win"),
                    reason="constructor would actually start a tray")
def test_windows_tray_degrades_off_windows():
    with pytest.raises(TrayError):
        tw.WindowsTray()


def test_create_tray_dispatch_off_windows(monkeypatch):
    # On Linux create_tray returns the SNI backend (or raises TrayError
    # without a session bus) — never the Win32 one.
    calls = []

    class FakeSni:
        def __init__(self):
            calls.append(1)
    import openhush_tpu_torch.ui.tray as tray_mod
    monkeypatch.setattr(tray_mod, "SniTray", FakeSni)
    out = tw.create_tray()
    assert isinstance(out, FakeSni) and calls == [1]


# =============== the port against the reference ===============

def test_tray_constants_match_reference():
    from openhush_tpu_torch.ui import tray
    for name in ("MENU_IFACE", "MENU_PATH", "ITEM_IFACE", "ITEM_PATH",
                 "PROPS_IFACE", "ID_PREFS", "ID_QUIT", "ID_STATUS"):
        assert getattr(tray, name) == getattr(jax_tray, name)
    assert [(s.name, s.value, s.icon_name, s.label) for s in TrayStatus] \
        == [(s.name, s.value, s.icon_name, s.label)
            for s in jax_tray.TrayStatus]
    assert [(e.name, e.value) for e in TrayEvent] == \
        [(e.name, e.value) for e in jax_tray.TrayEvent]


@pytest.mark.parametrize("status", list(TrayStatus), ids=lambda s: s.name)
def test_macos_codec_and_menu_match_reference(status):
    jstatus = jax_tray.TrayStatus[status.name]
    assert tm.encode_status_command(status) == \
        jax_tm.encode_status_command(jstatus)
    assert [r[0::2] for r in tm.menu_rows(status)] == \
        [r[0::2] for r in jax_tm.menu_rows(jstatus)]
    assert tm.STATUS_TITLES[status] == jax_tm.STATUS_TITLES[jstatus]
    assert tw.tray_tooltip(status) == jax_tw.tray_tooltip(jstatus)
    assert tw.STATUS_ICONS[status] == jax_tw.STATUS_ICONS[jstatus]


def test_macos_lines_match_reference():
    assert tm.encode_stop_command() == jax_tm.encode_stop_command()
    assert tm.encode_ready() == jax_tm.encode_ready()
    assert tm.encode_error("boom") == jax_tm.encode_error("boom")
    for ev in TrayEvent:
        assert tm.encode_event(ev) == jax_tm.encode_event(
            jax_tray.TrayEvent[ev.name])
    for line in ("", "not json", '{"cmd": "stop"}', '{"event": "quit"}',
                 '{"ready": true}', '{"error": "x"}'):
        got, want = tm.decode_helper_line(line), jax_tm.decode_helper_line(
            line)
        assert (got[0], getattr(got[1], "name", got[1])) == \
            (want[0], getattr(want[1], "name", want[1]))


def test_windows_halves_match_reference():
    assert tw.MENU_ITEMS == jax_tw.MENU_ITEMS
    for name in ("CMD_PREFERENCES", "CMD_QUIT", "WM_RBUTTONUP",
                 "WM_LBUTTONUP"):
        assert getattr(tw, name) == getattr(jax_tw, name)
    for cmd in (tw.CMD_PREFERENCES, tw.CMD_QUIT, 9999):
        got, want = (tw.menu_event_for_command(cmd),
                     jax_tw.menu_event_for_command(cmd))
        assert getattr(got, "name", got) == getattr(want, "name", want)
    for msg in (tw.WM_RBUTTONUP, tw.WM_LBUTTONUP, 0x0200):
        assert tw.event_for_mouse_message(msg) == \
            jax_tw.event_for_mouse_message(msg)
    for struct in ("NOTIFYICONDATAW", "MSG", "POINT"):
        assert ctypes.sizeof(getattr(tw, struct)) == ctypes.sizeof(
            getattr(jax_tw, struct))


def _pull(host, bus_name):
    """What an SNI host reads from a tray: every item property and the
    dbusmenu layout."""
    (props,) = host.call_blocking(bus_name, ITEM_PATH, PROPS_IFACE, "GetAll",
                                  "s", (ITEM_IFACE,))
    rev, layout = host.call_blocking(bus_name, MENU_PATH, MENU_IFACE,
                                     "GetLayout", "iias", (0, -1, []))
    return props, rev, layout


@needs_dbus
def test_sni_tray_serves_what_the_reference_serves(session_bus, watcher):
    """Both trays on one bus, pulled by one host, before and after a status
    change: the same properties, revisions and layouts."""
    trays = (jax_tray.SniTray(address=session_bus),
             SniTray(address=session_bus))
    host = wire.DBusConnection(session_bus)
    try:
        before = [_pull(host, t.bus_name) for t in trays]
        trays[0].set_status(jax_tray.TrayStatus.PROCESSING)
        trays[1].set_status(TrayStatus.PROCESSING)
        after = [_pull(host, t.bus_name) for t in trays]
    finally:
        host.close()
        for t in trays:
            t.stop()
    assert before[1] == before[0] and after[1] == after[0]
    assert after[1][0]["IconName"] == "view-refresh"
    assert set(watcher.registered) == {t.bus_name for t in trays}
