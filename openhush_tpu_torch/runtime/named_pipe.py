r"""Named-pipe JSON IPC — the Windows control plane of the reference
(src/ipc/named_pipe.rs: `\\.\pipe\openhush`, line-delimited JSON
requests/responses identical to the Unix-socket protocol).

Two transports behind one framing:

- **Windows** (`sys.platform == 'win32'`): a real Win32 named pipe via
  ctypes (CreateNamedPipeW / ConnectNamedPipe / ReadFile / WriteFile) —
  no extra dependencies. Untested in this repo's Linux CI by nature;
  the framing layer it shares IS tested.
- **POSIX**: a pair of 0600 FIFOs (`<path>.req` / `<path>.rsp`) carrying
  the same frames, used by the tests to pin the protocol (and usable as
  a minimal control plane on hosts without Unix-socket support).

The daemon's primary Linux control planes remain the Unix socket
(runtime/ipc.py) and D-Bus; this module exists so the Windows IPC
surface is protocol-complete per SURVEY.md §2b (src/ipc/mod.rs:45-66).

A copy of openhush_tpu/runtime/named_pipe.py, with the POSIX loop's race
repaired. The reference's server holds the request FIFO's read side open
without a writer, so between requests `select` reports it readable (EOF)
and the loop spins on empty reads; a client that has opened the write side
but not yet written then makes `os.read` raise BlockingIOError, which ends
the server thread, and that client waits out its timeout. Here the server
also holds a write side of its own, so the read side never reaches EOF
and `select` wakes only on data, and a BlockingIOError is read as no data.
"""

from __future__ import annotations

import json
import os
import sys
import threading
from typing import Callable, Optional

PIPE_NAME = r"\\.\pipe\openhush"

WINDOWS = sys.platform == "win32"


def _frame(payload: dict) -> bytes:
    return json.dumps(payload).encode() + b"\n"


def _parse_line(buf: bytes) -> dict:
    try:
        return json.loads(buf.split(b"\n", 1)[0] or b"{}")
    except json.JSONDecodeError:
        return {"_malformed": True}


def default_pipe_path() -> str:
    if WINDOWS:
        return PIPE_NAME
    runtime = os.environ.get("XDG_RUNTIME_DIR")
    if not runtime:
        runtime = os.path.join("/tmp", f"openhush-{os.getuid()}")
    return os.path.join(runtime, "openhush.pipe")


# ---------------------------------------------------------------------------
# Win32 transport (ctypes; mirrors named_pipe.rs's CreateNamedPipe loop)
# ---------------------------------------------------------------------------

if WINDOWS:  # pragma: no cover — exercised only on Windows hosts
    import ctypes
    from ctypes import wintypes

    _k32 = ctypes.windll.kernel32
    PIPE_ACCESS_DUPLEX = 0x3
    PIPE_TYPE_BYTE = 0x0
    PIPE_READMODE_BYTE = 0x0
    PIPE_WAIT = 0x0
    PIPE_UNLIMITED_INSTANCES = 255
    INVALID_HANDLE = wintypes.HANDLE(-1).value
    GENERIC_RW = 0x80000000 | 0x40000000
    OPEN_EXISTING = 3

    def _win_create_pipe(name: str):
        h = _k32.CreateNamedPipeW(
            name, PIPE_ACCESS_DUPLEX,
            PIPE_TYPE_BYTE | PIPE_READMODE_BYTE | PIPE_WAIT,
            PIPE_UNLIMITED_INSTANCES, 65536, 65536, 0, None)
        if h == INVALID_HANDLE:
            raise OSError(f"CreateNamedPipeW failed: "
                          f"{ctypes.get_last_error()}")
        return h

    def _win_read_line(h) -> bytes:
        buf = b""
        chunk = ctypes.create_string_buffer(4096)
        read = wintypes.DWORD(0)
        while b"\n" not in buf:
            ok = _k32.ReadFile(h, chunk, 4096, ctypes.byref(read), None)
            if not ok or read.value == 0:
                break
            buf += chunk.raw[:read.value]
        return buf

    def _win_write(h, data: bytes) -> None:
        written = wintypes.DWORD(0)
        _k32.WriteFile(h, data, len(data), ctypes.byref(written), None)


# ---------------------------------------------------------------------------
# Server
# ---------------------------------------------------------------------------

class NamedPipeServer:
    """Serve `{"cmd": ...}` requests over a named pipe (Windows) or a
    FIFO pair (POSIX). Same handler contract as runtime/ipc.IpcServer."""

    def __init__(self, handler: Callable[[dict], dict],
                 path: Optional[str] = None):
        self.handler = handler
        self.path = path or default_pipe_path()
        self._running = False
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> None:
        self._running = True
        if not WINDOWS:
            self._fifo_setup()
        self._thread = threading.Thread(
            target=self._serve_windows if WINDOWS else self._serve_fifo,
            daemon=True, name="named-pipe-server")
        self._thread.start()

    def stop(self) -> None:
        self._running = False
        if self._thread:
            self._thread.join(timeout=3)
        if not WINDOWS:
            for suffix in (".req", ".rsp"):
                try:
                    os.unlink(self.path + suffix)
                except OSError:
                    pass

    def _respond(self, request: dict) -> dict:
        if request.get("_malformed"):
            return {"ok": False, "error": "invalid JSON"}
        try:
            return self.handler(request)
        except Exception as e:  # noqa: BLE001 — never kill the pipe loop
            return {"ok": False, "error": str(e)}

    # -- Windows loop -------------------------------------------------------

    def _serve_windows(self) -> None:  # pragma: no cover — Windows only
        while self._running:
            h = _win_create_pipe(self.path)
            try:
                if not _k32.ConnectNamedPipe(h, None):
                    continue
                request = _parse_line(_win_read_line(h))
                _win_write(h, _frame(self._respond(request)))
                _k32.FlushFileBuffers(h)
                _k32.DisconnectNamedPipe(h)
            finally:
                _k32.CloseHandle(h)

    # -- POSIX FIFO-pair loop ----------------------------------------------

    def _fifo_setup(self) -> None:
        parent = os.path.dirname(self.path)
        if parent:
            os.makedirs(parent, mode=0o700, exist_ok=True)
        for suffix in (".req", ".rsp"):
            p = self.path + suffix
            if os.path.exists(p):
                os.unlink(p)
            os.mkfifo(p, 0o600)
        # Hold the request FIFO open non-blocking so client open() never
        # blocks, and a write side of our own so that the read side never
        # sees EOF between clients (select then wakes only on data).
        self._req_fd = os.open(self.path + ".req",
                               os.O_RDONLY | os.O_NONBLOCK)
        self._req_hold = os.open(self.path + ".req", os.O_WRONLY)

    def _serve_fifo(self) -> None:
        import select
        buf = b""
        try:
            while self._running:
                r, _, _ = select.select([self._req_fd], [], [], 0.25)
                if not r:
                    continue
                try:
                    data = os.read(self._req_fd, 4096)
                except BlockingIOError:
                    continue   # a client opened the FIFO, not yet written
                if not data:
                    continue
                buf += data
                while b"\n" in buf:
                    line, buf = buf.split(b"\n", 1)
                    response = self._respond(_parse_line(line + b"\n"))
                    # Blocks until the client opens the read side.
                    fd = os.open(self.path + ".rsp", os.O_WRONLY)
                    try:
                        os.write(fd, _frame(response))
                    finally:
                        os.close(fd)
        finally:
            os.close(self._req_fd)
            os.close(self._req_hold)


# ---------------------------------------------------------------------------
# Client
# ---------------------------------------------------------------------------

class NamedPipeClient:
    def __init__(self, path: Optional[str] = None, timeout: float = 10.0):
        self.path = path or default_pipe_path()
        self.timeout = timeout

    def send(self, cmd: str, **extra) -> dict:
        payload = _frame({"cmd": cmd, **extra})
        if WINDOWS:  # pragma: no cover — Windows only
            return self._send_windows(payload)
        return self._send_fifo(payload)

    def _send_windows(self, payload: bytes) -> dict:  # pragma: no cover
        h = _k32.CreateFileW(self.path, GENERIC_RW, 0, None,
                             OPEN_EXISTING, 0, None)
        if h == INVALID_HANDLE:
            raise ConnectionError("Daemon not running (pipe unavailable)")
        try:
            _win_write(h, payload)
            return _parse_line(_win_read_line(h))
        finally:
            _k32.CloseHandle(h)

    def _send_fifo(self, payload: bytes) -> dict:
        req = self.path + ".req"
        if not os.path.exists(req):
            raise ConnectionError("Daemon not running")
        fd = os.open(req, os.O_WRONLY)
        try:
            os.write(fd, payload)
        finally:
            os.close(fd)
        # Server opens the response FIFO write-side only after handling;
        # this open blocks until then.
        import select
        rsp = os.open(self.path + ".rsp", os.O_RDONLY | os.O_NONBLOCK)
        try:
            buf = b""
            import time
            deadline = time.monotonic() + self.timeout
            while b"\n" not in buf:
                if time.monotonic() > deadline:
                    raise TimeoutError("named-pipe response timeout")
                r, _, _ = select.select([rsp], [], [], 0.25)
                if r:
                    # With no writer the FIFO reads as ready (end of file);
                    # the server may open its write side before the read,
                    # which then finds a writer and no data yet.
                    try:
                        data = os.read(rsp, 4096)
                    except BlockingIOError:
                        continue
                    if data:
                        buf += data
            return _parse_line(buf)
        finally:
            os.close(rsp)
