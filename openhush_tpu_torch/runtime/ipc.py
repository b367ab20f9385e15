"""Unix-socket JSON IPC — wire-compatible with the reference protocol
(src/ipc/mod.rs:41-110): requests are `{"cmd": "<name>"}` lines, responses
`{"ok": bool, ...optional fields}`. The reference uses this on macOS (D-Bus
on Linux); here it is the universal local control plane, with the D-Bus
method surface (StartRecording/StopRecording/ToggleRecording/LoadModel/
UnloadModel/GetStatus/GetQueueDepth/GetVersion, src/dbus/service.rs:47)
mapped onto the same socket commands.

A copy of openhush_tpu/runtime/ipc.py: on win32 `create_server` and
`IpcClient` route through the port's runtime/named_pipe.py.
"""

from __future__ import annotations

import json
import os
import socket
import sys
import threading
from typing import Callable, Optional

COMMANDS = ("status", "stop", "load_model", "unload_model",
            "start_recording", "stop_recording", "toggle_recording",
            "start_continuous", "queue_depth", "version", "reload")

def create_server(handler: Callable[[dict], dict],
                  path: Optional[str] = None):
    """Platform IPC server: Unix socket on POSIX, named pipe on Windows
    (parity: src/ipc/mod.rs routes unix_socket.rs vs named_pipe.rs)."""
    if sys.platform == "win32":
        from openhush_tpu_torch.runtime.named_pipe import NamedPipeServer
        return NamedPipeServer(handler, path=path)
    return IpcServer(handler, path=path)


def socket_path() -> str:
    runtime = os.environ.get("XDG_RUNTIME_DIR")
    if not runtime:
        # Never a bare, predictable path in shared /tmp: fall back to a
        # per-user 0700 subdirectory so the socket can't be squatted.
        runtime = os.path.join("/tmp", f"openhush-{os.getuid()}")
    return os.path.join(runtime, "openhush.sock")


class IpcServer:
    """Line-delimited JSON over a Unix socket; one handler callback."""

    def __init__(self, handler: Callable[[dict], dict],
                 path: Optional[str] = None):
        self.path = path or socket_path()
        self.handler = handler
        self._sock: Optional[socket.socket] = None
        self._thread: Optional[threading.Thread] = None
        self._running = False

    def start(self) -> None:
        if os.path.exists(self.path):
            os.unlink(self.path)
        parent = os.path.dirname(self.path)
        os.makedirs(parent, mode=0o700, exist_ok=True)
        self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        # bind() under a restrictive umask so there is no window where the
        # socket exists with umask-default permissions before the chmod.
        old_umask = os.umask(0o177)
        try:
            self._sock.bind(self.path)
        finally:
            os.umask(old_umask)
        os.chmod(self.path, 0o600)
        self._sock.listen(8)
        self._sock.settimeout(0.25)
        self._running = True
        self._thread = threading.Thread(target=self._serve, daemon=True,
                                        name="ipc-server")
        self._thread.start()

    def _serve(self) -> None:
        while self._running:
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            threading.Thread(target=self._handle_conn, args=(conn,),
                             daemon=True).start()

    def _handle_conn(self, conn: socket.socket) -> None:
        try:
            conn.settimeout(5)
            buf = b""
            while b"\n" not in buf:
                data = conn.recv(4096)
                if not data:
                    return
                buf += data
            try:
                request = json.loads(buf.split(b"\n", 1)[0])
            except json.JSONDecodeError:
                conn.sendall(json.dumps(
                    {"ok": False, "error": "invalid JSON"}).encode()
                    + b"\n")
                return
            response = self.handler(request)
            conn.sendall(json.dumps(response).encode() + b"\n")
        except OSError:
            pass
        finally:
            conn.close()

    def stop(self) -> None:
        self._running = False
        if self._sock:
            self._sock.close()
        if self._thread:
            self._thread.join(timeout=2)
        if os.path.exists(self.path):
            try:
                os.unlink(self.path)
            except OSError:
                pass


class IpcClient:
    def __new__(cls, path: Optional[str] = None, timeout: float = 10.0):
        if sys.platform == "win32":
            from openhush_tpu_torch.runtime.named_pipe import NamedPipeClient
            return NamedPipeClient(path=path, timeout=timeout)
        return super().__new__(cls)

    def __init__(self, path: Optional[str] = None, timeout: float = 10.0):
        self.path = path or socket_path()
        self.timeout = timeout

    def send(self, cmd: str, **extra) -> dict:
        if not os.path.exists(self.path):
            raise ConnectionError("Daemon not running")
        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        s.settimeout(self.timeout)
        try:
            s.connect(self.path)
            payload = {"cmd": cmd, **extra}
            s.sendall(json.dumps(payload).encode() + b"\n")
            buf = b""
            while b"\n" not in buf:
                data = s.recv(4096)
                if not data:
                    break
                buf += data
            return json.loads(buf.split(b"\n", 1)[0] or b"{}")
        finally:
            s.close()
