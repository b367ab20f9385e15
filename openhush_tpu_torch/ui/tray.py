"""System tray icon + menu via D-Bus StatusNotifierItem (SNI).

Parity: the reference's tray layer (src/tray/mod.rs — TrayStatus/TrayEvent,
src/tray/linux.rs — ksni menu [status label | Preferences... | Quit],
src/tray/icon.rs — freedesktop icon names). The reference rides the ksni
crate; here the SNI *and* com.canonical.dbusmenu interfaces are spoken
directly over the repo's raw wire-protocol stack (utils/dbus.py), so the
tray works on any SNI host (KDE, GNOME w/ extension, waybar, swaybar…)
with zero native dependencies.

Daemon integration mirrors src/daemon.rs:1251-1271: the daemon polls
`try_recv()` for TrayEvent and calls `set_status()` on state changes.

A copy of openhush_tpu/ui/tray.py.
"""

from __future__ import annotations

import enum
import logging
import os
import queue
import socket
import threading
from typing import Optional

from openhush_tpu_torch.utils import dbus as wire

log = logging.getLogger(__name__)

ITEM_PATH = "/StatusNotifierItem"
MENU_PATH = "/MenuBar"
WATCHER = "org.kde.StatusNotifierWatcher"
ITEM_IFACE = "org.kde.StatusNotifierItem"
MENU_IFACE = "com.canonical.dbusmenu"
PROPS_IFACE = "org.freedesktop.DBus.Properties"

# Menu item ids (root=0). Layout parity: src/tray/linux.rs:37-71.
ID_STATUS, ID_SEP1, ID_PREFS, ID_SEP2, ID_QUIT = 1, 2, 3, 4, 5


class TrayError(RuntimeError):
    """Tray could not start (no bus / no SNI watcher)."""


class TrayEvent(enum.Enum):
    SHOW_PREFERENCES = "show_preferences"
    QUIT = "quit"
    STATUS_CLICKED = "status_clicked"


class TrayStatus(enum.Enum):
    """Parity: src/tray/mod.rs:57-82 (labels + freedesktop icon names)."""
    IDLE = ("Status: Idle", "audio-input-microphone")
    RECORDING = ("Status: Recording...", "media-record")
    PROCESSING = ("Status: Processing...", "view-refresh")
    ERROR = ("Status: Error", "dialog-error")

    @property
    def label(self) -> str:
        return self.value[0]

    @property
    def icon_name(self) -> str:
        return self.value[1]


def is_tray_supported() -> bool:
    """Parity: src/tray/mod.rs:86-95 (session bus presence)."""
    return bool(os.environ.get("DBUS_SESSION_BUS_ADDRESS"))


class SniTray:
    """Owns org.kde.StatusNotifierItem-<pid>-<nr> and serves the SNI +
    dbusmenu objects; menu clicks surface as TrayEvent on `events`.

    Init order matters: name + watcher registration happen before the
    serve thread starts, so there is exactly one socket reader at any
    time (call_blocking during init, the serve loop afterwards — the
    tray only *sends* signals once serving)."""

    _instance = 0

    def __init__(self, address: Optional[str] = None,
                 title: str = "OpenHush"):
        self.title = title
        self._status = TrayStatus.IDLE
        self._revision = 1
        self.events: queue.Queue[TrayEvent] = queue.Queue()
        try:
            self.conn = wire.DBusConnection(address)
        except (ConnectionError, OSError) as e:
            raise TrayError(f"no session bus: {e}") from e
        SniTray._instance += 1
        self.bus_name = (f"org.kde.StatusNotifierItem-{os.getpid()}"
                         f"-{SniTray._instance}")
        if self.conn.request_name(self.bus_name) not in (1, 4):
            self.conn.close()
            raise TrayError(f"could not own {self.bus_name}")
        try:
            self.conn.call_blocking(
                WATCHER, "/StatusNotifierWatcher", WATCHER,
                "RegisterStatusNotifierItem", "s", (self.bus_name,),
                timeout=5.0)
        except (RuntimeError, ConnectionError, socket.timeout) as e:
            self.conn.close()
            raise TrayError(f"no StatusNotifierWatcher: {e}") from e
        self._running = True
        self._thread = threading.Thread(target=self._serve, daemon=True,
                                        name="sni-tray")
        self._thread.start()
        log.info("tray registered as %s", self.bus_name)

    # -- public API (parity: TrayManager, src/tray/linux.rs:80-156) ----------

    def try_recv(self) -> Optional[TrayEvent]:
        try:
            return self.events.get_nowait()
        except queue.Empty:
            return None

    def set_status(self, status: TrayStatus) -> None:
        if status is self._status:
            return
        self._status = status
        self._revision += 1
        # Hosts re-pull IconName/ToolTip on these signals; the menu's
        # status row re-pulls on LayoutUpdated.
        self._emit(ITEM_PATH, ITEM_IFACE, "NewIcon")
        self._emit(ITEM_PATH, ITEM_IFACE, "NewToolTip")
        self._emit(MENU_PATH, MENU_IFACE, "LayoutUpdated", "ui",
                   (self._revision, 0))

    @property
    def status(self) -> TrayStatus:
        return self._status

    def stop(self) -> None:
        self._running = False
        self._thread.join(timeout=2)
        self.conn.close()

    # -- wire serving ---------------------------------------------------------

    def _emit(self, path: str, iface: str, member: str,
              sig: str = "", args: tuple = ()) -> None:
        fields = [(wire.H_PATH, "o", path), (wire.H_INTERFACE, "s", iface),
                  (wire.H_MEMBER, "s", member)]
        try:
            self.conn.send(wire.build_message(
                wire.SIGNAL, self.conn.next_serial(), fields, sig, args))
        except OSError:
            pass

    def _serve(self) -> None:
        self.conn.sock.settimeout(0.5)
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
            try:
                self._dispatch(msg)
            except Exception:  # noqa: BLE001 — keep serving
                log.exception("tray dispatch failed")

    def _reply(self, msg: dict, sig: str = "", args: tuple = ()) -> None:
        fields = [(wire.H_REPLY_SERIAL, "u", msg["serial"])]
        sender = msg["fields"].get(wire.H_SENDER, "")
        if sender:
            fields.append((wire.H_DESTINATION, "s", sender))
        self.conn.send(wire.build_message(
            wire.METHOD_RETURN, self.conn.next_serial(), fields, sig, args))

    def _error(self, msg: dict, name: str, text: str) -> None:
        fields = [(wire.H_REPLY_SERIAL, "u", msg["serial"]),
                  (wire.H_ERROR_NAME, "s", name)]
        sender = msg["fields"].get(wire.H_SENDER, "")
        if sender:
            fields.append((wire.H_DESTINATION, "s", sender))
        self.conn.send(wire.build_message(
            wire.ERROR, self.conn.next_serial(), fields, "s", (text,)))

    def _dispatch(self, msg: dict) -> None:
        path = msg["fields"].get(wire.H_PATH, "")
        iface = msg["fields"].get(wire.H_INTERFACE, "")
        member = msg["fields"].get(wire.H_MEMBER, "")
        args = msg["args"]

        if iface == "org.freedesktop.DBus.Peer" and member == "Ping":
            return self._reply(msg)
        if iface == "org.freedesktop.DBus.Introspectable" \
                and member == "Introspect":
            xml = _ITEM_XML if path == ITEM_PATH else _MENU_XML
            return self._reply(msg, "s", (xml,))

        if path == ITEM_PATH:
            if iface == PROPS_IFACE:
                return self._item_props(msg, member, args)
            if iface == ITEM_IFACE:
                if member in ("Activate", "SecondaryActivate"):
                    self.events.put(TrayEvent.STATUS_CLICKED)
                    return self._reply(msg)
                if member in ("ContextMenu", "Scroll"):
                    return self._reply(msg)
        elif path == MENU_PATH:
            if iface == PROPS_IFACE:
                return self._menu_props(msg, member, args)
            if iface == MENU_IFACE:
                return self._menu_call(msg, member, args)
        self._error(msg, "org.freedesktop.DBus.Error.UnknownMethod",
                    f"{iface}.{member} on {path}")

    # -- StatusNotifierItem properties ---------------------------------------

    def _item_properties(self) -> dict:
        s = self._status
        return {
            "Category": ("s", "ApplicationStatus"),
            "Id": ("s", "openhush"),
            "Title": ("s", self.title),
            "Status": ("s", "Active"),
            "WindowId": ("i", 0),
            "IconName": ("s", s.icon_name),
            "IconThemePath": ("s", ""),
            "OverlayIconName": ("s", ""),
            "AttentionIconName": ("s", ""),
            "ToolTip": ("(sa(iiay)ss)",
                        (s.icon_name, [], self.title, s.label)),
            "Menu": ("o", MENU_PATH),
            "ItemIsMenu": ("b", False),
        }

    def _item_props(self, msg, member, args) -> None:
        props = self._item_properties()
        if member == "GetAll":
            return self._reply(msg, "a{sv}", (props,))
        if member == "Get" and len(args) >= 2 and args[1] in props:
            return self._reply(msg, "v", (props[args[1]],))
        self._error(msg, "org.freedesktop.DBus.Error.InvalidArgs",
                    f"unknown property {args!r}")

    # -- dbusmenu -------------------------------------------------------------

    def _menu_items(self) -> list[tuple[int, dict]]:
        """(id, props) rows; parity with the ksni menu built at
        src/tray/linux.rs:37-71."""
        return [
            (ID_STATUS, {"label": ("s", self._status.label),
                         "enabled": ("b", False)}),
            (ID_SEP1, {"type": ("s", "separator")}),
            (ID_PREFS, {"label": ("s", "Preferences...")}),
            (ID_SEP2, {"type": ("s", "separator")}),
            (ID_QUIT, {"label": ("s", "Quit")}),
        ]

    def _menu_props(self, msg, member, args) -> None:
        props = {"Version": ("u", 3), "TextDirection": ("s", "ltr"),
                 "Status": ("s", "normal"), "IconThemePath": ("as", [])}
        if member == "GetAll":
            return self._reply(msg, "a{sv}", (props,))
        if member == "Get" and len(args) >= 2 and args[1] in props:
            return self._reply(msg, "v", (props[args[1]],))
        self._error(msg, "org.freedesktop.DBus.Error.InvalidArgs",
                    f"unknown property {args!r}")

    def _menu_call(self, msg, member, args) -> None:
        if member == "GetLayout":
            children = [("(ia{sv}av)", (mid, props, []))
                        for mid, props in self._menu_items()]
            root = (0, {"children-display": ("s", "submenu")}, children)
            return self._reply(msg, "u(ia{sv}av)", (self._revision, root))
        if member == "GetGroupProperties":
            wanted = set(args[0]) if args and args[0] else None
            rows = [(mid, props) for mid, props in
                    [(0, {"children-display": ("s", "submenu")})]
                    + self._menu_items()
                    if wanted is None or mid in wanted]
            return self._reply(msg, "a(ia{sv})", (rows,))
        if member == "GetProperty":
            item_id, name = args[0], args[1]
            for mid, props in self._menu_items():
                if mid == item_id and name in props:
                    return self._reply(msg, "v", (props[name],))
            return self._error(msg,
                               "org.freedesktop.DBus.Error.InvalidArgs",
                               f"no property {name!r} on item {item_id}")
        if member == "Event":
            item_id, event_id = args[0], args[1]
            if event_id == "clicked":
                if item_id == ID_PREFS:
                    self.events.put(TrayEvent.SHOW_PREFERENCES)
                elif item_id == ID_QUIT:
                    self.events.put(TrayEvent.QUIT)
                elif item_id == ID_STATUS:
                    self.events.put(TrayEvent.STATUS_CLICKED)
            return self._reply(msg)
        if member == "EventGroup":
            return self._reply(msg, "ai", ([],))
        if member == "AboutToShow":
            return self._reply(msg, "b", (False,))
        if member == "AboutToShowGroup":
            return self._reply(msg, "aiai", ([], []))
        self._error(msg, "org.freedesktop.DBus.Error.UnknownMethod",
                    f"{MENU_IFACE}.{member}")


_ITEM_XML = f"""<node>
  <interface name="{ITEM_IFACE}">
    <property name="Category" type="s" access="read"/>
    <property name="Id" type="s" access="read"/>
    <property name="Title" type="s" access="read"/>
    <property name="Status" type="s" access="read"/>
    <property name="IconName" type="s" access="read"/>
    <property name="ToolTip" type="(sa(iiay)ss)" access="read"/>
    <property name="Menu" type="o" access="read"/>
    <property name="ItemIsMenu" type="b" access="read"/>
    <method name="Activate">
      <arg type="i" direction="in"/><arg type="i" direction="in"/>
    </method>
    <signal name="NewIcon"/>
    <signal name="NewToolTip"/>
    <signal name="NewStatus"><arg type="s"/></signal>
  </interface>
</node>"""

_MENU_XML = f"""<node>
  <interface name="{MENU_IFACE}">
    <method name="GetLayout">
      <arg type="i" direction="in"/><arg type="i" direction="in"/>
      <arg type="as" direction="in"/>
      <arg type="u" direction="out"/>
      <arg type="(ia{{sv}}av)" direction="out"/>
    </method>
    <method name="GetGroupProperties">
      <arg type="ai" direction="in"/><arg type="as" direction="in"/>
      <arg type="a(ia{{sv}})" direction="out"/>
    </method>
    <method name="Event">
      <arg type="i" direction="in"/><arg type="s" direction="in"/>
      <arg type="v" direction="in"/><arg type="u" direction="in"/>
    </method>
    <method name="AboutToShow">
      <arg type="i" direction="in"/><arg type="b" direction="out"/>
    </method>
    <signal name="LayoutUpdated"><arg type="u"/><arg type="i"/></signal>
  </interface>
</node>"""
