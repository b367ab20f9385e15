"""Minimal D-Bus (session bus) client/service over the raw wire protocol.

Parity: the reference's Linux control plane is D-Bus —
`org.openhush.Daemon1` at `/org/openhush/Daemon1` with methods
StartRecording/StopRecording/ToggleRecording/LoadModel/UnloadModel/
GetStatus/GetQueueDepth/GetVersion and an `IsRecordingChanged` signal
(src/dbus/service.rs:28-160, interface.rs:35). Python has no baked-in D-Bus
binding in this image, so this module speaks the wire protocol directly
(stdlib only): EXTERNAL auth, Hello/RequestName, method calls/returns/
errors/signals, and marshaling for the types the interface needs
(y b u i s o g v and arrays of header structs).

Interop is tested against the real dbus-daemon + dbus-send.

A copy of openhush_tpu/utils/dbus.py.
"""

from __future__ import annotations

import binascii
import io
import logging
import os
import socket
import struct
import threading
from typing import Callable, Optional

log = logging.getLogger(__name__)

BUS_NAME = "org.openhush.Daemon1"
OBJECT_PATH = "/org/openhush/Daemon1"
INTERFACE = "org.openhush.Daemon1"

METHOD_CALL, METHOD_RETURN, ERROR, SIGNAL = 1, 2, 3, 4

H_PATH, H_INTERFACE, H_MEMBER, H_ERROR_NAME, H_REPLY_SERIAL, \
    H_DESTINATION, H_SENDER, H_SIGNATURE = range(1, 9)

_ALIGN = {"y": 1, "b": 4, "n": 2, "q": 2, "i": 4, "u": 4, "x": 8, "t": 8,
          "d": 8, "s": 4, "o": 4, "g": 1, "v": 1, "a": 4, "(": 8, "{": 8,
          "h": 4}

_FIXED = {"n": ("<h", 2), "q": ("<H", 2), "x": ("<q", 8), "t": ("<Q", 8),
          "d": ("<d", 8), "h": ("<I", 4)}


def _complete_type_end(sig: str, i: int) -> int:
    """Index one past the complete type starting at sig[i]."""
    t = sig[i]
    if t == "a":
        return _complete_type_end(sig, i + 1)
    if t == "(":
        depth, j = 1, i + 1
        while depth:
            if sig[j] == "(":
                depth += 1
            elif sig[j] == ")":
                depth -= 1
            j += 1
        return j
    if t == "{":
        depth, j = 1, i + 1
        while depth:
            if sig[j] == "{":
                depth += 1
            elif sig[j] == "}":
                depth -= 1
            j += 1
        return j
    return i + 1


def split_signature(sig: str) -> list[str]:
    """Split a signature into its complete types."""
    out, i = [], 0
    while i < len(sig):
        j = _complete_type_end(sig, i)
        out.append(sig[i:j])
        i = j
    return out


class Marshaller:
    def __init__(self):
        self.buf = bytearray()

    def pad(self, n: int) -> None:
        while len(self.buf) % n:
            self.buf.append(0)

    def put(self, sig: str, value) -> None:
        t = sig[0]
        if t == "y":
            self.buf.append(value & 0xFF)
        elif t in ("u", "b"):
            self.pad(4)
            self.buf += struct.pack("<I", int(bool(value)) if t == "b"
                                    else value)
        elif t == "i":
            self.pad(4)
            self.buf += struct.pack("<i", value)
        elif t in _FIXED:
            fmt, n = _FIXED[t]
            self.pad(n)
            self.buf += struct.pack(fmt, value)
        elif t in ("s", "o"):
            self.pad(4)
            data = value.encode()
            self.buf += struct.pack("<I", len(data)) + data + b"\0"
        elif t == "g":
            data = value.encode()
            self.buf += bytes([len(data)]) + data + b"\0"
        elif t == "v":
            vsig, vval = value
            self.put("g", vsig)
            self.put(vsig, vval)
        elif t == "a":
            # ARRAY: u32 byte-length (excl. post-length padding), then
            # padding to the element alignment, then elements.
            elem_sig = sig[1:]
            self.pad(4)
            len_pos = len(self.buf)
            self.buf += b"\0\0\0\0"
            self.pad(_ALIGN[elem_sig[0]])
            start = len(self.buf)
            if elem_sig[0] == "{":
                items = value.items() if isinstance(value, dict) else value
                for k, v in items:
                    self.put(elem_sig, (k, v))
            else:
                for item in value:
                    self.put(elem_sig, item)
            struct.pack_into("<I", self.buf, len_pos,
                             len(self.buf) - start)
        elif t == "(":
            self.pad(8)
            for member_sig, member in zip(split_signature(sig[1:-1]),
                                          value):
                self.put(member_sig, member)
        elif t == "{":
            self.pad(8)
            k_sig, v_sig = split_signature(sig[1:-1])
            self.put(k_sig, value[0])
            self.put(v_sig, value[1])
        else:
            raise ValueError(f"unsupported marshal type {t!r}")

    def put_header_fields(self, fields: list[tuple[int, str, object]]):
        """ARRAY of STRUCT(y, v)."""
        self.pad(4)
        len_pos = len(self.buf)
        self.buf += b"\0\0\0\0"
        self.pad(8)
        start = len(self.buf)
        for code, sig, val in fields:
            self.pad(8)
            self.put("y", code)
            self.put("v", (sig, val))
        struct.pack_into("<I", self.buf, len_pos, len(self.buf) - start)


class Unmarshaller:
    def __init__(self, data: bytes, pos: int = 0):
        self.data = data
        self.pos = pos

    def pad(self, n: int) -> None:
        self.pos += (-self.pos) % n

    def get(self, sig: str):
        t = sig[0]
        if t == "y":
            v = self.data[self.pos]
            self.pos += 1
            return v
        if t in ("u", "b"):
            self.pad(4)
            v = struct.unpack_from("<I", self.data, self.pos)[0]
            self.pos += 4
            return bool(v) if t == "b" else v
        if t == "i":
            self.pad(4)
            v = struct.unpack_from("<i", self.data, self.pos)[0]
            self.pos += 4
            return v
        if t in ("s", "o"):
            self.pad(4)
            n = struct.unpack_from("<I", self.data, self.pos)[0]
            self.pos += 4
            v = self.data[self.pos:self.pos + n].decode()
            self.pos += n + 1
            return v
        if t == "g":
            n = self.data[self.pos]
            self.pos += 1
            v = self.data[self.pos:self.pos + n].decode()
            self.pos += n + 1
            return v
        if t == "v":
            vsig = self.get("g")
            return self.get(vsig)
        if t in _FIXED:
            fmt, n = _FIXED[t]
            self.pad(n)
            v = struct.unpack_from(fmt, self.data, self.pos)[0]
            self.pos += n
            return v
        if t == "a":
            elem_sig = sig[1:]
            self.pad(4)
            n = struct.unpack_from("<I", self.data, self.pos)[0]
            self.pos += 4
            self.pad(_ALIGN[elem_sig[0]])
            end = self.pos + n
            if elem_sig[0] == "{":
                out: dict = {}
                while self.pos < end:
                    k, v = self.get(elem_sig)
                    out[k] = v
                return out
            items = []
            while self.pos < end:
                items.append(self.get(elem_sig))
            return items
        if t == "(":
            self.pad(8)
            return tuple(self.get(m) for m in split_signature(sig[1:-1]))
        if t == "{":
            self.pad(8)
            k_sig, v_sig = split_signature(sig[1:-1])
            return (self.get(k_sig), self.get(v_sig))
        raise ValueError(f"unsupported unmarshal type {t!r}")


def build_message(msg_type: int, serial: int,
                  fields: list[tuple[int, str, object]],
                  body_sig: str = "", body_args: tuple = ()) -> bytes:
    body = Marshaller()
    for arg_sig, arg in zip(split_signature(body_sig), body_args):
        body.put(arg_sig, arg)
    body_bytes = bytes(body.buf)
    if body_sig:
        fields = fields + [(H_SIGNATURE, "g", body_sig)]
    m = Marshaller()
    m.buf += struct.pack("<BBBB", ord("l"), msg_type, 0, 1)
    m.buf += struct.pack("<II", len(body_bytes), serial)
    m.put_header_fields(fields)
    m.pad(8)
    return bytes(m.buf) + body_bytes


def parse_message(data: bytes) -> dict:
    endian, msg_type, flags, ver = struct.unpack_from("<BBBB", data, 0)
    body_len, serial = struct.unpack_from("<II", data, 4)
    fields_len = struct.unpack_from("<I", data, 12)[0]
    u = Unmarshaller(data, 16)
    fields = {}
    end = 16 + fields_len
    while u.pos < end:
        u.pad(8)
        if u.pos >= end:
            break
        code = u.get("y")
        val = u.get("v")
        fields[code] = val
    u.pos = end
    u.pad(8)
    body_start = u.pos
    body_sig = fields.get(H_SIGNATURE, "")
    args = []
    bu = Unmarshaller(data, body_start)
    for arg_sig in split_signature(body_sig):
        try:
            args.append(bu.get(arg_sig))
        except Exception:  # noqa: BLE001 — tolerate exotic arg types
            break
    return {"type": msg_type, "serial": serial, "fields": fields,
            "args": args}


def _read_message(sock: socket.socket) -> Optional[dict]:
    head = _read_exact(sock, 16)
    if head is None:
        return None
    body_len = struct.unpack_from("<I", head, 4)[0]
    fields_len = struct.unpack_from("<I", head, 12)[0]
    rest_len = ((16 + fields_len + 7) // 8 * 8 - 16) + body_len
    rest = _read_exact(sock, rest_len)
    if rest is None:
        return None
    return parse_message(head + rest)


def _read_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return buf


class DBusConnection:
    """Authenticated session-bus connection with serial bookkeeping."""

    def __init__(self, address: Optional[str] = None):
        address = address or os.environ.get("DBUS_SESSION_BUS_ADDRESS", "")
        path = None
        for part in address.split(";")[0].split(","):
            if part.startswith("unix:path="):
                path = part[len("unix:path="):]
            elif part.startswith("path="):
                path = part[len("path="):]
        if not path:
            raise ConnectionError(
                f"no unix session bus address ({address!r})")
        self.sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self.sock.connect(path)
        self._auth()
        self._serial = 0
        self._lock = threading.Lock()
        self.unique_name = self.call_blocking(
            "org.freedesktop.DBus", "/org/freedesktop/DBus",
            "org.freedesktop.DBus", "Hello")[0]

    def _auth(self) -> None:
        uid_hex = binascii.hexlify(str(os.getuid()).encode()).decode()
        self.sock.sendall(b"\0AUTH EXTERNAL " + uid_hex.encode() + b"\r\n")
        resp = b""
        while not resp.endswith(b"\r\n"):
            resp += self.sock.recv(256)
        if not resp.startswith(b"OK"):
            raise ConnectionError(f"D-Bus auth failed: {resp!r}")
        self.sock.sendall(b"BEGIN\r\n")

    def next_serial(self) -> int:
        with self._lock:
            self._serial += 1
            return self._serial

    def send(self, data: bytes) -> None:
        with self._lock:
            self.sock.sendall(data)

    def call_blocking(self, dest: str, path: str, iface: str, member: str,
                      sig: str = "", args: tuple = (),
                      timeout: float = 10.0) -> list:
        serial = self.next_serial()
        fields = [(H_PATH, "o", path), (H_DESTINATION, "s", dest),
                  (H_INTERFACE, "s", iface), (H_MEMBER, "s", member)]
        self.send(build_message(METHOD_CALL, serial, fields, sig, args))
        self.sock.settimeout(timeout)
        while True:
            msg = _read_message(self.sock)
            if msg is None:
                raise ConnectionError("bus closed")
            if msg["fields"].get(H_REPLY_SERIAL) == serial:
                if msg["type"] == ERROR:
                    raise RuntimeError(
                        f"D-Bus error: "
                        f"{msg['fields'].get(H_ERROR_NAME)} {msg['args']}")
                return msg["args"]
            # Unrelated message (signal etc.) — skip.

    def request_name(self, name: str) -> int:
        return self.call_blocking(
            "org.freedesktop.DBus", "/org/freedesktop/DBus",
            "org.freedesktop.DBus", "RequestName", "su", (name, 4))[0]

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass


_INTROSPECT_XML = f"""<!DOCTYPE node PUBLIC
 "-//freedesktop//DTD D-BUS Object Introspection 1.0//EN"
 "http://www.freedesktop.org/standards/dbus/1.0/introspect.dtd">
<node>
  <interface name="{INTERFACE}">
    <method name="StartRecording"><arg type="b" direction="out"/></method>
    <method name="StopRecording"><arg type="b" direction="out"/></method>
    <method name="ToggleRecording"><arg type="b" direction="out"/></method>
    <method name="LoadModel"><arg type="b" direction="out"/></method>
    <method name="UnloadModel"><arg type="b" direction="out"/></method>
    <method name="GetStatus"><arg type="s" direction="out"/></method>
    <method name="GetQueueDepth"><arg type="u" direction="out"/></method>
    <method name="GetVersion"><arg type="s" direction="out"/></method>
    <signal name="IsRecordingChanged"><arg type="b"/></signal>
  </interface>
</node>"""


class DbusService:
    """Exports org.openhush.Daemon1; dispatches to a handler callback
    handler(member) -> (signature, value) | None."""

    def __init__(self, handler: Callable[[str], Optional[tuple]],
                 address: Optional[str] = None):
        self.conn = DBusConnection(address)
        result = self.conn.request_name(BUS_NAME)
        if result not in (1, 4):   # PRIMARY_OWNER or ALREADY_OWNER
            raise RuntimeError(f"could not own {BUS_NAME} (code {result})")
        self.handler = handler
        self._running = True
        self._thread = threading.Thread(target=self._serve, daemon=True,
                                        name="dbus-service")
        self._thread.start()

    def _serve(self) -> None:
        self.conn.sock.settimeout(0.5)
        while self._running:
            try:
                msg = _read_message(self.conn.sock)
            except socket.timeout:
                continue
            except OSError:
                return
            if msg is None:
                return
            if msg["type"] != METHOD_CALL:
                continue
            self._dispatch(msg)

    def _dispatch(self, msg: dict) -> None:
        member = msg["fields"].get(H_MEMBER, "")
        sender = msg["fields"].get(H_SENDER, "")
        iface = msg["fields"].get(H_INTERFACE, "")
        reply_fields = [(H_REPLY_SERIAL, "u", msg["serial"])]
        if sender:
            reply_fields.append((H_DESTINATION, "s", sender))
        try:
            if iface == "org.freedesktop.DBus.Introspectable" \
                    and member == "Introspect":
                out = ("s", _INTROSPECT_XML)
            elif iface == "org.freedesktop.DBus.Peer" and member == "Ping":
                out = None
            else:
                out = self.handler(member)
        except Exception as e:  # noqa: BLE001
            self.conn.send(build_message(
                ERROR, self.conn.next_serial(),
                reply_fields + [(H_ERROR_NAME, "s",
                                 f"{INTERFACE}.Error")],
                "s", (str(e),)))
            return
        if out is None:
            self.conn.send(build_message(
                METHOD_RETURN, self.conn.next_serial(), reply_fields))
        else:
            sig, value = out
            self.conn.send(build_message(
                METHOD_RETURN, self.conn.next_serial(), reply_fields,
                sig, (value,)))

    def emit_recording_changed(self, recording: bool) -> None:
        """IsRecordingChanged signal (parity: src/dbus/service.rs:47)."""
        fields = [(H_PATH, "o", OBJECT_PATH), (H_INTERFACE, "s", INTERFACE),
                  (H_MEMBER, "s", "IsRecordingChanged")]
        self.conn.send(build_message(SIGNAL, self.conn.next_serial(),
                                     fields, "b", (recording,)))

    def stop(self) -> None:
        self._running = False
        self._thread.join(timeout=2)
        self.conn.close()


class DbusClient:
    """CLI-side client (parity: DbusClient, src/dbus/service.rs:73-160)."""

    def __init__(self, address: Optional[str] = None):
        self.conn = DBusConnection(address)

    def call(self, member: str):
        args = self.conn.call_blocking(BUS_NAME, OBJECT_PATH, INTERFACE,
                                       member)
        return args[0] if args else None

    def subscribe_recording_changed(self) -> None:
        """Install a match rule for IsRecordingChanged (the signal emitted
        at src/dbus/service.rs:47); follow with wait_recording_changed().
        Lets status-bar scripts block on state flips instead of polling."""
        self.conn.call_blocking(
            "org.freedesktop.DBus", "/org/freedesktop/DBus",
            "org.freedesktop.DBus", "AddMatch", "s",
            (f"type='signal',interface='{INTERFACE}',"
             f"member='IsRecordingChanged'",))

    def wait_recording_changed(self,
                               timeout: float = 60.0) -> Optional[bool]:
        """Block until the next IsRecordingChanged; None on timeout."""
        self.conn.sock.settimeout(timeout)
        try:
            while True:
                msg = _read_message(self.conn.sock)
                if msg is None:
                    return None
                if (msg["type"] == SIGNAL
                        and msg["fields"].get(H_MEMBER)
                        == "IsRecordingChanged" and msg["args"]):
                    return bool(msg["args"][0])
        except socket.timeout:
            return None

    def close(self) -> None:
        self.conn.close()
