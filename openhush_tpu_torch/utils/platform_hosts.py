"""Per-OS host platform backends: clipboard, paste, notify, feedback
sounds, accessibility — one trait, three implementations.

Parity: src/platform/{mod,linux,macos,windows}.rs — the reference defines
a `Platform` trait (TextOutput + Notifier + AudioFeedback + display_server
+ is_tty) with per-OS impls: Linux (notify-rust + wl-copy/xclip tooling),
macOS (arboard clipboard, enigo cmd-V paste, afplay Tink/Pop feedback
sounds, AXIsProcessTrusted accessibility gate, macos.rs:36-253), Windows
(arboard clipboard, enigo ctrl-V paste, PowerShell SystemSounds
Asterisk/Beep, windows.rs:20-151).

Design here: every backend builds its external-command argv (or ctypes
call plan) through PURE functions so the protocol half is unit-testable on
any OS; only the final `run` touches the host. Off-OS construction is
exercised in tests/test_platform_hosts.py; execution degrades to False
with a logged reason, matching the reference's `.ok()` posture.

A copy of openhush_tpu/utils/platform_hosts.py.
"""

from __future__ import annotations

import ctypes
import functools
import logging
import os
import shutil
import subprocess
import sys
from typing import Optional

from . import platform as linux_platform

log = logging.getLogger(__name__)


def _run(argv: list[str], *, input_text: Optional[str] = None,
         timeout: float = 10.0) -> bool:
    """Single choke-point for host command execution (mocked in tests)."""
    try:
        subprocess.run(argv, input=(input_text.encode()
                                    if input_text is not None else None),
                       timeout=timeout, capture_output=True, check=True)
        return True
    except (subprocess.SubprocessError, OSError) as e:
        log.debug("%s failed: %s", argv[0], e)
        return False


# ---------------------------------------------------------------------------
# macOS command plans (pure)
# ---------------------------------------------------------------------------

# Feedback sounds — same system sounds the reference picks
# (macos.rs:222-240: Tink on start, Pop on stop).
MAC_SOUNDS = {
    "start": "/System/Library/Sounds/Tink.aiff",
    "stop": "/System/Library/Sounds/Pop.aiff",
    "error": "/System/Library/Sounds/Basso.aiff",
    "bell": "/System/Library/Sounds/Glass.aiff",
}


def osa_quote(text: str) -> str:
    """Escape a Python string into an AppleScript double-quoted literal."""
    return '"' + text.replace("\\", "\\\\").replace('"', '\\"') + '"'


def macos_notify_argv(summary: str, body: str = "") -> list[str]:
    script = (f"display notification {osa_quote(body)} "
              f"with title {osa_quote('OpenHush')} "
              f"subtitle {osa_quote(summary)}")
    return ["osascript", "-e", script]


def macos_sound_argv(event: str) -> Optional[list[str]]:
    path = MAC_SOUNDS.get(event)
    return ["afplay", path] if path else None


def macos_paste_keystroke_argv() -> list[str]:
    """Inject cmd-V via System Events (reference pastes via enigo cmd-V,
    macos.rs:135-153; System Events is the no-dependency equivalent and
    requires the same Accessibility grant)."""
    return ["osascript", "-e",
            'tell application "System Events" to keystroke "v" '
            "using command down"]


def macos_type_argv(text: str) -> list[str]:
    return ["osascript", "-e",
            'tell application "System Events" to keystroke '
            + osa_quote(text)]


def macos_open_accessibility_argv() -> list[str]:
    """Deep-link into the Accessibility pane (macos.rs:64-71)."""
    return ["open", "x-apple.systempreferences:com.apple.preference"
                    ".security?Privacy_Accessibility"]


def macos_accessibility_status() -> str:
    """'granted' | 'denied' | 'unknown' via AXIsProcessTrusted
    (macos.rs:36-48). 'unknown' when the framework can't be loaded
    (non-mac host or sandbox)."""
    if sys.platform != "darwin":
        return "unknown"
    try:
        appsvc = ctypes.cdll.LoadLibrary(
            "/System/Library/Frameworks/ApplicationServices.framework"
            "/ApplicationServices")
        appsvc.AXIsProcessTrusted.restype = ctypes.c_bool
        return "granted" if appsvc.AXIsProcessTrusted() else "denied"
    except OSError:
        return "unknown"


ACCESSIBILITY_INSTRUCTIONS = """\
OpenHush needs the macOS Accessibility permission to type text and read
the global hotkey:
  1. Open System Settings -> Privacy & Security -> Accessibility
  2. Add (or enable) your terminal app / OpenHush
  3. Restart the daemon: openhush daemon restart
(parity: print_accessibility_instructions, macos.rs:73-96)"""


# ---------------------------------------------------------------------------
# Windows command plans (pure)
# ---------------------------------------------------------------------------

# PowerShell SystemSounds per event — reference windows.rs:115-140 plays
# Asterisk on start, Beep on stop.
WIN_SOUNDS = {"start": "Asterisk", "stop": "Beep", "error": "Hand",
              "bell": "Beep"}


def ps_quote(text: str) -> str:
    """Escape into a PowerShell single-quoted literal."""
    return "'" + text.replace("'", "''") + "'"


def windows_sound_argv(event: str) -> Optional[list[str]]:
    name = WIN_SOUNDS.get(event)
    if not name:
        return None
    return ["powershell", "-NoProfile", "-Command",
            f"[System.Media.SystemSounds]::{name}.Play()"]


def windows_notify_argv(summary: str, body: str = "") -> list[str]:
    """Balloon/toast via a transient NotifyIcon — no module install needed
    (reference uses notify-rust's Windows toast path, windows.rs:101-110).
    """
    script = (
        "Add-Type -AssemblyName System.Windows.Forms;"
        "$n=New-Object System.Windows.Forms.NotifyIcon;"
        "$n.Icon=[System.Drawing.SystemIcons]::Information;"
        "$n.Visible=$true;"
        f"$n.ShowBalloonTip(5000,{ps_quote(summary)},"
        f"{ps_quote(body or ' ')},"
        "[System.Windows.Forms.ToolTipIcon]::Info)")
    return ["powershell", "-NoProfile", "-Command", script]


def windows_clipboard_argv() -> list[str]:
    """Set-Clipboard reading stdin (fallback when ctypes path fails)."""
    return ["powershell", "-NoProfile", "-Command",
            "$input | Set-Clipboard"]


# Win32 SendInput structures — defined unconditionally so layout is
# unit-testable off-Windows (ctypes lays them out identically).
_ULONG_PTR = ctypes.c_size_t
VK_CONTROL = 0x11
VK_V = 0x56
KEYEVENTF_KEYUP = 0x0002
INPUT_KEYBOARD = 1


class KEYBDINPUT(ctypes.Structure):
    _fields_ = [("wVk", ctypes.c_ushort), ("wScan", ctypes.c_ushort),
                ("dwFlags", ctypes.c_uint), ("time", ctypes.c_uint),
                ("dwExtraInfo", _ULONG_PTR)]


class _INPUT_UNION(ctypes.Union):
    _fields_ = [("ki", KEYBDINPUT),
                ("_pad", ctypes.c_byte * 32)]   # MOUSEINPUT is larger


class INPUT(ctypes.Structure):
    _fields_ = [("type", ctypes.c_uint), ("u", _INPUT_UNION)]


def ctrl_v_key_sequence() -> list[tuple[int, int]]:
    """(vk, flags) stream for a ctrl-V chord — press ctrl, press V,
    release V, release ctrl (reference pastes via enigo's equivalent
    sequence, windows.rs:28-46)."""
    return [(VK_CONTROL, 0), (VK_V, 0),
            (VK_V, KEYEVENTF_KEYUP), (VK_CONTROL, KEYEVENTF_KEYUP)]


@functools.lru_cache(maxsize=1)
def _win_libs():
    """(user32, kernel32) with 64-bit-safe signatures declared once —
    ctypes' default c_int restype TRUNCATES HGLOBAL/LPVOID above 4 GB.
    Raises on non-Windows hosts (callers degrade to False)."""
    user32 = ctypes.WinDLL("user32")            # type: ignore[attr-defined]
    kernel32 = ctypes.WinDLL("kernel32")        # type: ignore[attr-defined]
    kernel32.GlobalAlloc.restype = ctypes.c_void_p
    kernel32.GlobalAlloc.argtypes = [ctypes.c_uint, ctypes.c_size_t]
    kernel32.GlobalLock.restype = ctypes.c_void_p
    kernel32.GlobalLock.argtypes = [ctypes.c_void_p]
    kernel32.GlobalUnlock.argtypes = [ctypes.c_void_p]
    user32.OpenClipboard.argtypes = [ctypes.c_void_p]
    user32.SetClipboardData.restype = ctypes.c_void_p
    user32.SetClipboardData.argtypes = [ctypes.c_uint, ctypes.c_void_p]
    return user32, kernel32


def _win_send_inputs(seq: list[tuple[int, int]]) -> bool:
    try:
        user32, _ = _win_libs()
    except (OSError, AttributeError):
        return False
    arr = (INPUT * len(seq))()
    for i, (vk, flags) in enumerate(seq):
        arr[i].type = INPUT_KEYBOARD
        arr[i].u.ki = KEYBDINPUT(vk, 0, flags, 0, 0)
    sent = user32.SendInput(len(seq), arr, ctypes.sizeof(INPUT))
    return int(sent) == len(seq)


def _win_set_clipboard(text: str) -> bool:
    """CF_UNICODETEXT via OpenClipboard/SetClipboardData (the arboard
    path in the reference, windows.rs:79-92)."""
    try:
        user32, kernel32 = _win_libs()
    except (OSError, AttributeError):
        return False
    CF_UNICODETEXT, GMEM_MOVEABLE = 13, 0x0002
    data = text.encode("utf-16-le") + b"\x00\x00"
    if not user32.OpenClipboard(None):
        return False
    try:
        user32.EmptyClipboard()
        handle = kernel32.GlobalAlloc(GMEM_MOVEABLE, len(data))
        if not handle:
            return False
        ptr = kernel32.GlobalLock(handle)
        if not ptr:
            return False
        ctypes.memmove(ptr, data, len(data))
        kernel32.GlobalUnlock(handle)
        return bool(user32.SetClipboardData(CF_UNICODETEXT, handle))
    finally:
        user32.CloseClipboard()


# ---------------------------------------------------------------------------
# The trait + backends
# ---------------------------------------------------------------------------

class HostPlatform:
    """Per-OS integration surface (parity: Platform trait,
    src/platform/mod.rs). All methods degrade to False, never raise."""

    name = "generic"

    def display_server(self) -> str:
        return linux_platform.detect_display_server()

    def is_tty(self) -> bool:
        return self.display_server() == "tty"

    def copy_to_clipboard(self, text: str) -> bool:
        raise NotImplementedError

    def paste_text(self, text: str, method: str = "type") -> bool:
        raise NotImplementedError

    def notify(self, summary: str, body: str = "",
               urgency: str = "normal") -> bool:
        raise NotImplementedError

    def play_sound(self, event: str = "bell") -> bool:
        raise NotImplementedError

    def accessibility_status(self) -> str:
        """granted | denied | unknown | not_required."""
        return "not_required"

    def open_accessibility_preferences(self) -> bool:
        return False


class LinuxPlatform(HostPlatform):
    """Delegates to the desktop-tool shims in utils/platform.py and
    output/handlers.py (parity: src/platform/linux.rs)."""

    name = "linux"

    def copy_to_clipboard(self, text: str) -> bool:
        from ..output import handlers
        return handlers.copy_to_clipboard(text)

    def paste_text(self, text: str, method: str = "type") -> bool:
        from ..output import handlers
        return handlers.paste_text(text, method)

    def notify(self, summary: str, body: str = "",
               urgency: str = "normal") -> bool:
        return linux_platform.notify(summary, body, urgency)

    def play_sound(self, event: str = "bell") -> bool:
        return linux_platform.play_sound(
            {"start": "audio-volume-change", "stop": "complete",
             "error": "dialog-error"}.get(event, "bell"))


class MacOSPlatform(HostPlatform):
    name = "macos"

    def display_server(self) -> str:
        return "macos"

    def is_tty(self) -> bool:
        return False    # parity: macos.rs:247 (always windowed)

    def copy_to_clipboard(self, text: str) -> bool:
        if shutil.which("pbcopy"):
            return _run(["pbcopy"], input_text=text, timeout=5)
        return False

    def paste_text(self, text: str, method: str = "type") -> bool:
        if method == "ctrl_v":
            if not self.copy_to_clipboard(text):
                return False
            return _run(macos_paste_keystroke_argv(), timeout=5)
        return _run(macos_type_argv(text), timeout=10)

    def notify(self, summary: str, body: str = "",
               urgency: str = "normal") -> bool:
        return _run(macos_notify_argv(summary, body), timeout=5)

    def play_sound(self, event: str = "bell") -> bool:
        argv = macos_sound_argv(event)
        if argv is None or not os.path.exists(argv[1]):
            return False
        return _run(argv, timeout=5)

    def accessibility_status(self) -> str:
        return macos_accessibility_status()

    def open_accessibility_preferences(self) -> bool:
        return _run(macos_open_accessibility_argv(), timeout=5)


class WindowsPlatform(HostPlatform):
    name = "windows"

    def display_server(self) -> str:
        return "windows"

    def is_tty(self) -> bool:
        return False

    def copy_to_clipboard(self, text: str) -> bool:
        if _win_set_clipboard(text):
            return True
        return _run(windows_clipboard_argv(), input_text=text, timeout=10)

    def paste_text(self, text: str, method: str = "type") -> bool:
        # Both methods go through the clipboard + ctrl-V on Windows: the
        # reference's enigo 'type' path is also synthesized key events,
        # and chord injection is the robust subset (windows.rs:28-46).
        if not self.copy_to_clipboard(text):
            return False
        return _win_send_inputs(ctrl_v_key_sequence())

    def notify(self, summary: str, body: str = "",
               urgency: str = "normal") -> bool:
        return _run(windows_notify_argv(summary, body), timeout=15)

    def play_sound(self, event: str = "bell") -> bool:
        try:
            import winsound                      # noqa: F401
            sounds = {"start": 0x40, "stop": -1, "error": 0x10,
                      "bell": 0}
            winsound.MessageBeep(sounds.get(event, 0))
            return True
        except ImportError:
            argv = windows_sound_argv(event)
            return _run(argv, timeout=10) if argv else False


def get_host_platform(platform: Optional[str] = None) -> HostPlatform:
    """Backend for this host (or an explicit 'linux'|'macos'|'windows')."""
    p = platform or sys.platform
    if p == "darwin" or p == "macos":
        return MacOSPlatform()
    if p.startswith("win"):
        return WindowsPlatform()
    return LinuxPlatform()
