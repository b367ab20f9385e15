"""macOS menu-bar tray via a spawned AppKit helper process.

Parity: src/tray/ with the tray-icon crate backend on macOS
(src/tray/mod.rs — TrayStatus/TrayEvent surface, src/platform/macos.rs —
status item + Preferences/Quit menu). Same public surface as
ui.tray.SniTray / ui.tray_windows.WindowsTray: `events` queue of
TrayEvent, `set_status()`, `try_recv()`, `stop()`.

NSStatusBar requires an AppKit run loop on the PROCESS MAIN THREAD —
which the daemon's own main thread (signal handling, chunk scheduler)
can't give up. So the tray owns a separate process: `MacTray` spawns
`python -m openhush_tpu_torch.ui.tray_macos`, whose main thread runs
[NSApp run] while menu clicks stream back as line-delimited JSON events
on stdout and status updates arrive as JSON commands on stdin. AppKit is
reached through raw ctypes/libobjc (objc_msgSend + a runtime-registered
target class for menu actions) — no PyObjC dependency, the same
zero-native-deps approach as the Win32 tray's ctypes Shell_NotifyIcon.

Testable halves (tests/test_tray_macos.py, run on Linux):
 - the command/event line codec (both directions),
 - the status→menu-bar-title table and menu row model,
 - `run_helper()` — the helper's full stdin→backend→stdout loop against
   a fake backend,
 - `MacTray` end-to-end against a fake helper subprocess.
Only `_AppKitBackend` touches libobjc and raises on any other OS.

A copy of openhush_tpu/ui/tray_macos.py.
"""

from __future__ import annotations

import json
import logging
import queue
import subprocess
import sys
import threading
from typing import Callable, Optional

from .tray import TrayError, TrayEvent, TrayStatus

log = logging.getLogger(__name__)

# Menu-bar button title per status: SF-symbol-free text glyphs render on
# every macOS version; the reference distinguishes states by icon
# (src/tray/icon.rs), here by glyph + tooltip.
STATUS_TITLES = {
    TrayStatus.IDLE: "\N{STUDIO MICROPHONE}",          # 🎙
    TrayStatus.RECORDING: "\N{LARGE RED CIRCLE}",      # 🔴
    TrayStatus.PROCESSING: "\N{HOURGLASS WITH FLOWING SAND}",  # ⏳
    TrayStatus.ERROR: "\N{WARNING SIGN}",              # ⚠
}

# Menu action selector names, registered on the helper's target class.
SEL_STATUS, SEL_PREFS, SEL_QUIT = ("onStatus:", "onPrefs:", "onQuit:")

EVENT_FOR_SELECTOR = {
    SEL_STATUS: TrayEvent.STATUS_CLICKED,
    SEL_PREFS: TrayEvent.SHOW_PREFERENCES,
    SEL_QUIT: TrayEvent.QUIT,
}


def menu_rows(status: TrayStatus) -> list[tuple[str, str, bool]]:
    """(title, action-selector, enabled) rows; '-' title = separator.
    Layout parity with the SNI menu (tray.py ID_* rows) and
    src/tray/linux.rs:37-71."""
    return [
        (status.label, SEL_STATUS, False),
        ("-", "", False),
        ("Preferences...", SEL_PREFS, True),
        ("-", "", False),
        ("Quit", SEL_QUIT, True),
    ]


# -- line codec (both process halves share it) --------------------------------

def encode_status_command(status: TrayStatus) -> str:
    return json.dumps({"cmd": "status", "status": status.name}) + "\n"


def encode_stop_command() -> str:
    return json.dumps({"cmd": "stop"}) + "\n"


def decode_command(line: str) -> Optional[dict]:
    """Parsed command dict, or None for blank/garbage lines (the helper
    must never die on a malformed line)."""
    line = line.strip()
    if not line:
        return None
    try:
        msg = json.loads(line)
    except ValueError:
        return None
    if isinstance(msg, dict) and msg.get("cmd") == "status":
        try:
            msg["status"] = TrayStatus[msg.get("status", "")]
        except KeyError:
            return None
        return msg
    if isinstance(msg, dict) and msg.get("cmd") == "stop":
        return msg
    return None


def encode_event(ev: TrayEvent) -> str:
    return json.dumps({"event": ev.value}) + "\n"


def encode_ready() -> str:
    return json.dumps({"ready": True}) + "\n"


def encode_error(text: str) -> str:
    return json.dumps({"error": text[:500]}) + "\n"


def decode_helper_line(line: str) -> tuple[str, object]:
    """('event', TrayEvent) | ('ready', True) | ('error', str) |
    ('noise', line) — stray prints must not kill the reader."""
    line = line.strip()
    try:
        msg = json.loads(line)
    except ValueError:
        return ("noise", line)
    if isinstance(msg, dict):
        if "event" in msg:
            try:
                return ("event", TrayEvent(msg["event"]))
            except ValueError:
                return ("noise", line)
        if msg.get("ready"):
            return ("ready", True)
        if "error" in msg:
            return ("error", str(msg["error"]))
    return ("noise", line)


# -- helper-process side -------------------------------------------------------

def run_helper(backend, stdin=None, stdout=None) -> int:
    """The helper's whole life: start the backend's status item (menu
    actions call `emit`), then serve stdin commands until stop/EOF.
    `backend` provides start(rows, title, emit), set_status(status),
    run() (blocks in the UI loop), terminate() (callable off-loop).
    Pure I/O + dispatch — tested with a fake backend on Linux."""
    stdin = stdin or sys.stdin
    stdout = stdout or sys.stdout
    status = TrayStatus.IDLE
    out_lock = threading.Lock()

    def emit(line: str) -> None:
        with out_lock:
            stdout.write(line)
            stdout.flush()

    try:
        backend.start(menu_rows(status), STATUS_TITLES[status],
                      lambda ev: emit(encode_event(ev)))
    except Exception as e:  # noqa: BLE001 — parent surfaces it as TrayError
        emit(encode_error(f"{type(e).__name__}: {e}"))
        return 1
    emit(encode_ready())

    def serve_stdin() -> None:
        for line in stdin:
            cmd = decode_command(line)
            if cmd is None:
                continue
            if cmd["cmd"] == "stop":
                break
            if cmd["cmd"] == "status":
                backend.set_status(cmd["status"])
        backend.terminate()   # stop command, EOF (parent died), or error

    t = threading.Thread(target=serve_stdin, daemon=True,
                         name="tray-helper-stdin")
    t.start()
    backend.run()             # blocks in [NSApp run] until terminate()
    return 0


class _AppKitBackend:
    """NSStatusBar item + NSMenu over raw ctypes/libobjc. Only importable
    work happens in __init__; everything else must run with the process
    main thread inside run() (AppKit's threading rule)."""

    def __init__(self):
        import ctypes
        import ctypes.util

        if sys.platform != "darwin":
            raise TrayError("AppKit backend requires macOS")
        self.ct = ctypes
        try:
            self.objc = ctypes.CDLL("/usr/lib/libobjc.A.dylib")
            self.appkit = ctypes.CDLL(
                "/System/Library/Frameworks/AppKit.framework/AppKit")
        except OSError as e:
            raise TrayError(f"AppKit unavailable: {e}") from e
        o = self.objc
        o.objc_getClass.restype = ctypes.c_void_p
        o.objc_getClass.argtypes = [ctypes.c_char_p]
        o.sel_registerName.restype = ctypes.c_void_p
        o.sel_registerName.argtypes = [ctypes.c_char_p]
        o.objc_allocateClassPair.restype = ctypes.c_void_p
        o.objc_allocateClassPair.argtypes = [ctypes.c_void_p,
                                             ctypes.c_char_p,
                                             ctypes.c_size_t]
        o.class_addMethod.restype = ctypes.c_bool
        o.class_addMethod.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                      ctypes.c_void_p, ctypes.c_char_p]
        o.objc_registerClassPair.argtypes = [ctypes.c_void_p]
        self._keep = []        # IMP closures + retained objc objects

    # objc_msgSend must be re-prototyped per call signature (arm64 ABI).
    def send(self, receiver, selector: str, *args, restype=None,
             argtypes=()):
        ct = self.ct
        fn = ct.cast(
            self.objc.objc_msgSend,
            ct.CFUNCTYPE(restype or ct.c_void_p, ct.c_void_p, ct.c_void_p,
                         *argtypes))
        return fn(receiver, self.objc.sel_registerName(selector.encode()),
                  *args)

    def cls(self, name: str):
        return self.objc.objc_getClass(name.encode())

    def nsstring(self, text: str):
        ct = self.ct
        return self.send(self.cls("NSString"), "stringWithUTF8String:",
                         text.encode(), argtypes=(ct.c_char_p,))

    def start(self, rows, title: str,
              emit: Callable[[TrayEvent], None]) -> None:
        ct = self.ct
        self._emit = emit

        # Target class with one IMP per menu action + the main-thread
        # status-apply hop (performSelectorOnMainThread target).
        nsobject = self.cls("NSObject")
        target_cls = self.objc.objc_allocateClassPair(
            nsobject, b"OpenHushTrayTarget", 0)
        IMP = ct.CFUNCTYPE(None, ct.c_void_p, ct.c_void_p, ct.c_void_p)

        def make_imp(sel_name: str):
            def imp(_self, _sel, _sender):
                ev = EVENT_FOR_SELECTOR.get(sel_name)
                if ev is not None:
                    self._emit(ev)
                if sel_name == SEL_QUIT:
                    self._terminate_on_main()
            return IMP(imp)

        for sel_name in (SEL_STATUS, SEL_PREFS, SEL_QUIT):
            f = make_imp(sel_name)
            self._keep.append(f)
            self.objc.class_addMethod(
                target_cls, self.objc.sel_registerName(sel_name.encode()),
                ct.cast(f, ct.c_void_p), b"v@:@")

        def apply_status_imp(_self, _sel, ns_name):
            # Runs on the AppKit main thread (performSelectorOnMainThread).
            name = ct.string_at(self.send(
                ns_name, "UTF8String", restype=ct.c_char_p)).decode()
            status = TrayStatus[name]
            self._set_title(STATUS_TITLES[status])
            self._set_menu(menu_rows(status))

        f = IMP(apply_status_imp)
        self._keep.append(f)
        self.objc.class_addMethod(
            target_cls, self.objc.sel_registerName(b"applyStatus:"),
            ct.cast(f, ct.c_void_p), b"v@:@")

        def do_terminate_imp(_self, _sel, _arg):
            app = self.send(self.cls("NSApplication"), "sharedApplication")
            self.send(app, "terminate:", None, argtypes=(ct.c_void_p,))

        f = IMP(do_terminate_imp)
        self._keep.append(f)
        self.objc.class_addMethod(
            target_cls, self.objc.sel_registerName(b"doTerminate:"),
            ct.cast(f, ct.c_void_p), b"v@:@")
        self.objc.objc_registerClassPair(target_cls)
        self.target = self.send(self.send(target_cls, "alloc"), "init")

        app = self.send(self.cls("NSApplication"), "sharedApplication")
        # NSApplicationActivationPolicyAccessory = 1: menu-bar only, no
        # Dock icon (the daemon helper must not appear as an app).
        self.send(app, "setActivationPolicy:", 1,
                  argtypes=(ct.c_long,), restype=ct.c_bool)

        bar = self.send(self.cls("NSStatusBar"), "systemStatusBar")
        # NSVariableStatusItemLength = -1.0 (CGFloat).
        self.item = self.send(bar, "statusItemWithLength:",
                              ct.c_double(-1.0),
                              argtypes=(ct.c_double,))
        self.send(self.item, "retain")   # bar hands out an autoreleased ref
        self._set_title(title)
        self._set_menu(rows)

    def _set_title(self, title: str) -> None:
        button = self.send(self.item, "button")
        self.send(button, "setTitle:", self.nsstring(title),
                  argtypes=(self.ct.c_void_p,))

    def _set_menu(self, rows) -> None:
        ct = self.ct
        menu = self.send(self.send(self.cls("NSMenu"), "alloc"), "init")
        for title, sel_name, enabled in rows:
            if title == "-":
                sep = self.send(self.cls("NSMenuItem"), "separatorItem")
                self.send(menu, "addItem:", sep, argtypes=(ct.c_void_p,))
                continue
            mi = self.send(
                self.send(self.cls("NSMenuItem"), "alloc"),
                "initWithTitle:action:keyEquivalent:",
                self.nsstring(title),
                self.objc.sel_registerName(sel_name.encode())
                if sel_name else None,
                self.nsstring(""),
                argtypes=(ct.c_void_p, ct.c_void_p, ct.c_void_p))
            self.send(mi, "setTarget:", self.target,
                      argtypes=(ct.c_void_p,))
            self.send(mi, "setEnabled:", enabled,
                      argtypes=(ct.c_bool,))
            self.send(menu, "addItem:", mi, argtypes=(ct.c_void_p,))
        # NSMenuItem validation would re-disable targeted items unless
        # autoenabling is off (the status row is deliberately disabled).
        self.send(menu, "setAutoenablesItems:", False,
                  argtypes=(ct.c_bool,))
        self.send(self.item, "setMenu:", menu,
                  argtypes=(ct.c_void_p,))

    def _on_main(self, selector: str, arg) -> None:
        ct = self.ct
        self.send(self.target,
                  "performSelectorOnMainThread:withObject:waitUntilDone:",
                  self.objc.sel_registerName(selector.encode()), arg,
                  False,
                  argtypes=(ct.c_void_p, ct.c_void_p, ct.c_bool))

    def set_status(self, status: TrayStatus) -> None:
        # Called from the stdin thread: hop to the AppKit main thread,
        # which recomputes title + menu rows from the status name.
        self._on_main("applyStatus:", self.nsstring(status.name))

    def _terminate_on_main(self) -> None:
        self._on_main("doTerminate:", None)

    def terminate(self) -> None:
        self._terminate_on_main()

    def run(self) -> None:
        app = self.send(self.cls("NSApplication"), "sharedApplication")
        self.send(app, "run")


def helper_main() -> int:
    try:
        backend = _AppKitBackend()
    except TrayError as e:
        sys.stdout.write(encode_error(str(e)))
        sys.stdout.flush()
        return 1
    return run_helper(backend)


# -- daemon-process side -------------------------------------------------------

class MacTray:
    """Spawns the AppKit helper and bridges its stdout events into the
    TrayEvent queue. Raises TrayError when the helper can't start (not
    macOS, AppKit missing) so the daemon's tray-optional init degrades
    exactly like the SNI/Win32 backends."""

    def __init__(self, helper_argv: Optional[list[str]] = None):
        self._status = TrayStatus.IDLE
        self.events: queue.Queue[TrayEvent] = queue.Queue()
        argv = helper_argv or [sys.executable, "-m",
                               "openhush_tpu_torch.ui.tray_macos"]
        try:
            self.proc = subprocess.Popen(
                argv, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                text=True, bufsize=1)
        except OSError as e:
            raise TrayError(f"tray helper spawn failed: {e}") from e
        ready = queue.Queue()
        self._thread = threading.Thread(target=self._read, args=(ready,),
                                        daemon=True, name="tray-macos")
        self._thread.start()
        try:
            first = ready.get(timeout=15)
        except queue.Empty:
            self.proc.kill()
            raise TrayError("tray helper did not become ready")
        if first != "ready":
            self.proc.kill()
            raise TrayError(f"tray helper failed: {first}")

    def _read(self, ready: queue.Queue) -> None:
        started = False
        for line in self.proc.stdout:
            kind, val = decode_helper_line(line)
            if kind == "ready" and not started:
                started = True
                ready.put("ready")
            elif kind == "error":
                if not started:
                    ready.put(val)
                    return
                log.warning("tray helper error: %s", val)
            elif kind == "event":
                self.events.put(val)

    # -- public surface (mirrors SniTray) -------------------------------------

    def try_recv(self) -> Optional[TrayEvent]:
        try:
            return self.events.get_nowait()
        except queue.Empty:
            return None

    def set_status(self, status: TrayStatus) -> None:
        if status is self._status:
            return
        self._status = status
        try:
            self.proc.stdin.write(encode_status_command(status))
            self.proc.stdin.flush()
        except (OSError, ValueError):
            log.warning("tray helper pipe closed")

    @property
    def status(self) -> TrayStatus:
        return self._status

    def stop(self) -> None:
        try:
            self.proc.stdin.write(encode_stop_command())
            self.proc.stdin.flush()
        except (OSError, ValueError):
            pass
        try:
            self.proc.wait(timeout=5)
        except subprocess.TimeoutExpired:
            self.proc.kill()
        self._thread.join(timeout=2)


if __name__ == "__main__":
    sys.exit(helper_main())
