"""Windows system tray: Shell_NotifyIcon + popup menu over raw ctypes.

Parity: src/tray/ with the tray-icon crate backend on Windows
(src/platform/windows.rs:152-182 — WindowsSystemTray with status icon +
Preferences/Quit menu events). Same surface as ui.tray.SniTray:
`events` queue of TrayEvent, `set_status()`, `try_recv()`, `stop()`.

Implementation: a message-only window whose WNDPROC receives the
NOTIFYICONDATA callback message; right-click opens a TrackPopupMenu
(TPM_RETURNCMD) with Preferences/Quit, left-click emits STATUS_CLICKED.
The window + pump run on a dedicated thread (Win32 requires the creating
thread to pump its messages).

The protocol half — struct layouts, the state→(tip, icon) table, the
menu command model, and the WNDPROC event mapping — is pure and tested
off-Windows (tests/test_tray_windows.py); only `start()` touches user32/
shell32 and raises TrayError on any other OS.

A copy of openhush_tpu/ui/tray_windows.py.
"""

from __future__ import annotations

import ctypes
import logging
import queue
import threading
from typing import Optional

from .tray import TrayError, TrayEvent, TrayStatus

log = logging.getLogger(__name__)

# -- Win32 constants (winuser.h / shellapi.h) --------------------------------

WM_DESTROY = 0x0002
WM_CLOSE = 0x0010
WM_COMMAND = 0x0111
WM_LBUTTONUP = 0x0202
WM_RBUTTONUP = 0x0205
WM_USER = 0x0400
WM_TRAY_CALLBACK = WM_USER + 1

NIM_ADD, NIM_MODIFY, NIM_DELETE = 0, 1, 2
NIF_MESSAGE, NIF_ICON, NIF_TIP = 0x1, 0x2, 0x4

MF_STRING = 0x0
TPM_RETURNCMD = 0x0100
TPM_NONOTIFY = 0x0080

IDI_APPLICATION = 32512
IDI_EXCLAMATION = 32515
IDI_INFORMATION = 32516

CMD_PREFERENCES = 1001
CMD_QUIT = 1002

MENU_ITEMS = ((CMD_PREFERENCES, "Preferences"), (CMD_QUIT, "Quit"))

# Stock icon per status: colored custom icons need an .ico pipeline; the
# stock set still distinguishes recording (exclamation) and error.
STATUS_ICONS = {
    TrayStatus.IDLE: IDI_APPLICATION,
    TrayStatus.RECORDING: IDI_EXCLAMATION,
    TrayStatus.PROCESSING: IDI_INFORMATION,
    TrayStatus.ERROR: IDI_EXCLAMATION,
}


def tray_tooltip(status: TrayStatus) -> str:
    """Tooltip text (64 WCHAR budget in NOTIFYICONDATA.szTip)."""
    return f"OpenHush — {status.label}"[:63]


def menu_event_for_command(cmd: int) -> Optional[TrayEvent]:
    if cmd == CMD_PREFERENCES:
        return TrayEvent.SHOW_PREFERENCES
    if cmd == CMD_QUIT:
        return TrayEvent.QUIT
    return None


def event_for_mouse_message(msg: int) -> Optional[str]:
    """'menu' (open the popup) or 'clicked' for a tray mouse message."""
    if msg == WM_RBUTTONUP:
        return "menu"
    if msg == WM_LBUTTONUP:
        return "clicked"
    return None


# -- struct layouts (testable off-Windows: ctypes packs identically) ---------

class NOTIFYICONDATAW(ctypes.Structure):
    _fields_ = [
        ("cbSize", ctypes.c_uint32),
        ("hWnd", ctypes.c_void_p),
        ("uID", ctypes.c_uint32),
        ("uFlags", ctypes.c_uint32),
        ("uCallbackMessage", ctypes.c_uint32),
        ("hIcon", ctypes.c_void_p),
        ("szTip", ctypes.c_wchar * 128),
        ("dwState", ctypes.c_uint32),
        ("dwStateMask", ctypes.c_uint32),
        ("szInfo", ctypes.c_wchar * 256),
        ("uVersion", ctypes.c_uint32),
        ("szInfoTitle", ctypes.c_wchar * 64),
        ("dwInfoFlags", ctypes.c_uint32),
    ]


class POINT(ctypes.Structure):
    # Win32 LONG is always 32-bit (unlike Linux c_long on LP64).
    _fields_ = [("x", ctypes.c_int32), ("y", ctypes.c_int32)]


class MSG(ctypes.Structure):
    _fields_ = [("hwnd", ctypes.c_void_p), ("message", ctypes.c_uint32),
                ("wParam", ctypes.c_size_t), ("lParam", ctypes.c_ssize_t),
                ("time", ctypes.c_uint32), ("pt", POINT)]


class WNDCLASSW(ctypes.Structure):
    _fields_ = [("style", ctypes.c_uint32), ("lpfnWndProc", ctypes.c_void_p),
                ("cbClsExtra", ctypes.c_int), ("cbWndExtra", ctypes.c_int),
                ("hInstance", ctypes.c_void_p), ("hIcon", ctypes.c_void_p),
                ("hCursor", ctypes.c_void_p),
                ("hbrBackground", ctypes.c_void_p),
                ("lpszMenuName", ctypes.c_wchar_p),
                ("lpszClassName", ctypes.c_wchar_p)]


class WindowsTray:
    """Shell_NotifyIcon tray. Raises TrayError off-Windows or when any
    Win32 call fails, so the daemon's tray-optional init path degrades
    the same way as with no SNI host (daemon.rs:843-859)."""

    def __init__(self):
        try:
            self._user32 = ctypes.WinDLL("user32")  # type: ignore[attr-defined]
            self._shell32 = ctypes.WinDLL("shell32")  # type: ignore[attr-defined]
            self._kernel32 = ctypes.WinDLL("kernel32")  # type: ignore[attr-defined]
        except (OSError, AttributeError) as e:
            raise TrayError(f"Win32 tray unavailable: {e}") from e
        self._declare_signatures()
        self._status = TrayStatus.IDLE
        self.events: queue.Queue[TrayEvent] = queue.Queue()
        self._hwnd = None
        self._tid = None
        self._ready = threading.Event()
        self._error: Optional[str] = None
        self._thread = threading.Thread(target=self._pump, daemon=True,
                                        name="tray-win32")
        self._thread.start()
        self._ready.wait(timeout=5)
        if self._error:
            raise TrayError(self._error)
        if self._hwnd is None:
            raise TrayError("tray window did not initialize")

    # -- public surface (mirrors SniTray) -----------------------------------

    def try_recv(self) -> Optional[TrayEvent]:
        try:
            return self.events.get_nowait()
        except queue.Empty:
            return None

    def set_status(self, status: TrayStatus) -> None:
        if status is self._status:
            return
        self._status = status
        self._notify_icon(NIM_MODIFY)

    @property
    def status(self) -> TrayStatus:
        return self._status

    def stop(self) -> None:
        if self._hwnd is not None:
            self._notify_icon(NIM_DELETE)
            self._user32.PostMessageW(self._hwnd, WM_CLOSE, 0, 0)
        self._thread.join(timeout=3)

    # -- internals -----------------------------------------------------------

    def _declare_signatures(self) -> None:
        """Explicit restypes/argtypes: ctypes defaults to c_int, which
        truncates 64-bit handles (HWND/HICON/HINSTANCE/LRESULT) — with
        high-entropy ASLR the module base and window handles routinely
        exceed 4 GB on 64-bit Windows."""
        u, k = self._user32, self._kernel32
        vp, ui = ctypes.c_void_p, ctypes.c_uint32
        k.GetModuleHandleW.restype = vp
        k.GetModuleHandleW.argtypes = [ctypes.c_wchar_p]
        u.RegisterClassW.restype = ctypes.c_uint16
        u.CreateWindowExW.restype = vp
        u.CreateWindowExW.argtypes = [
            ui, ctypes.c_wchar_p, ctypes.c_wchar_p, ui,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            vp, vp, vp, vp]
        u.LoadIconW.restype = vp
        u.LoadIconW.argtypes = [vp, ctypes.c_wchar_p]
        u.DefWindowProcW.restype = ctypes.c_ssize_t
        u.DefWindowProcW.argtypes = [vp, ui, ctypes.c_size_t,
                                     ctypes.c_ssize_t]
        u.CreatePopupMenu.restype = vp
        u.AppendMenuW.argtypes = [vp, ui, ctypes.c_size_t,
                                  ctypes.c_wchar_p]
        u.TrackPopupMenu.restype = ctypes.c_int
        u.TrackPopupMenu.argtypes = [vp, ui, ctypes.c_int, ctypes.c_int,
                                     ctypes.c_int, vp, vp]
        u.DestroyMenu.argtypes = [vp]
        u.SetForegroundWindow.argtypes = [vp]
        u.PostMessageW.argtypes = [vp, ui, ctypes.c_size_t,
                                   ctypes.c_ssize_t]
        u.DestroyWindow.argtypes = [vp]
        u.GetCursorPos.argtypes = [ctypes.c_void_p]
        self._shell32.Shell_NotifyIconW.argtypes = [ui, ctypes.c_void_p]

    def _icon_data(self) -> NOTIFYICONDATAW:
        data = NOTIFYICONDATAW()
        data.cbSize = ctypes.sizeof(NOTIFYICONDATAW)
        data.hWnd = self._hwnd
        data.uID = 1
        data.uFlags = NIF_MESSAGE | NIF_ICON | NIF_TIP
        data.uCallbackMessage = WM_TRAY_CALLBACK
        data.hIcon = self._user32.LoadIconW(
            None, ctypes.c_wchar_p(STATUS_ICONS[self._status]))
        data.szTip = tray_tooltip(self._status)
        return data

    def _notify_icon(self, action: int) -> None:
        data = self._icon_data()
        self._shell32.Shell_NotifyIconW(action, ctypes.byref(data))

    def _show_menu(self) -> None:
        menu = self._user32.CreatePopupMenu()
        for cmd, label in MENU_ITEMS:
            self._user32.AppendMenuW(menu, MF_STRING, cmd,
                                     ctypes.c_wchar_p(label))
        pt = POINT()
        self._user32.GetCursorPos(ctypes.byref(pt))
        self._user32.SetForegroundWindow(self._hwnd)
        cmd = self._user32.TrackPopupMenu(
            menu, TPM_RETURNCMD | TPM_NONOTIFY, pt.x, pt.y, 0,
            self._hwnd, None)
        self._user32.DestroyMenu(menu)
        ev = menu_event_for_command(int(cmd))
        if ev is not None:
            self.events.put(ev)

    def _wndproc(self, hwnd, msg, wparam, lparam):
        if msg == WM_TRAY_CALLBACK:
            kind = event_for_mouse_message(int(lparam) & 0xFFFF)
            if kind == "menu":
                self._show_menu()
            elif kind == "clicked":
                self.events.put(TrayEvent.STATUS_CLICKED)
            return 0
        if msg == WM_CLOSE:
            self._user32.DestroyWindow(hwnd)
            return 0
        if msg == WM_DESTROY:
            self._user32.PostQuitMessage(0)
            return 0
        return self._user32.DefWindowProcW(hwnd, msg, wparam, lparam)

    def _pump(self) -> None:
        try:
            WNDPROC = ctypes.WINFUNCTYPE(  # type: ignore[attr-defined]
                ctypes.c_ssize_t, ctypes.c_void_p, ctypes.c_uint32,
                ctypes.c_size_t, ctypes.c_ssize_t)
            self._proc_ref = WNDPROC(self._wndproc)   # keep alive
            hinst = self._kernel32.GetModuleHandleW(None)
            cls = WNDCLASSW()
            cls.lpfnWndProc = ctypes.cast(self._proc_ref, ctypes.c_void_p)
            cls.hInstance = hinst
            cls.lpszClassName = "OpenHushTray"
            if not self._user32.RegisterClassW(ctypes.byref(cls)):
                self._error = "RegisterClassW failed"
                self._ready.set()
                return
            HWND_MESSAGE = ctypes.c_void_p(-3)
            self._hwnd = self._user32.CreateWindowExW(
                0, "OpenHushTray", "OpenHushTray", 0, 0, 0, 0, 0,
                HWND_MESSAGE, None, hinst, None)
            if not self._hwnd:
                self._error = "CreateWindowExW failed"
                self._ready.set()
                return
            self._notify_icon(NIM_ADD)
            self._ready.set()
            msg = MSG()
            while self._user32.GetMessageW(ctypes.byref(msg), None,
                                           0, 0) > 0:
                self._user32.TranslateMessage(ctypes.byref(msg))
                self._user32.DispatchMessageW(ctypes.byref(msg))
        except Exception as e:  # noqa: BLE001 — surface via constructor
            self._error = f"tray pump failed: {e}"
            self._ready.set()


def create_tray():
    """Host-appropriate tray backend: SNI on Linux, Shell_NotifyIcon on
    Windows, and on macOS a spawned AppKit helper process (NSStatusBar
    needs a main-thread run loop the daemon can't give up — the helper
    owns one and bridges events over stdio; ui.tray_macos)."""
    import sys
    if sys.platform.startswith("win"):
        return WindowsTray()
    if sys.platform == "darwin":
        from .tray_macos import MacTray
        return MacTray()
    from .tray import SniTray
    return SniTray()
