"""Cross-OS global hotkey backends: Windows + macOS key-state polling.

Parity: src/input/hotkey.rs — the reference runs an rdev global hook on
every OS, emitting Pressed/Released over a channel. Linux here uses the
raw evdev reader (runtime/hotkey.py); this module adds the other two
hosts with the lightest native surface that supports press AND release
for push-to-talk:

- Windows: user32.GetAsyncKeyState polled per chord key (~120 Hz): no
  window, no message pump, works from a daemon thread.
- macOS: CGEventSourceKeyState(kCGEventSourceStateCombinedSessionState),
  same polling shape; requires the Accessibility/Input-Monitoring grant
  the reference also needs (platform/macos.rs:36-96).

The chord engine (`ChordPoller`) is OS-free: it takes a `probe(code) ->
bool` callable plus native keycodes, so the press/release edge logic and
both keycode tables are unit-tested on any host
(tests/test_platform_hosts.py); only the probe touches the OS.

A copy of openhush_tpu/runtime/hotkey_hosts.py.
"""

from __future__ import annotations

import ctypes
import logging
import sys
import threading
import time
from typing import Callable, Optional

from .hotkey import MODIFIERS, parse_key, split_chord

log = logging.getLogger(__name__)

# ---------------------------------------------------------------------------
# Keycode tables (pure data, keyed by the shared parse_key() names)
# ---------------------------------------------------------------------------

# Win32 virtual-key codes (winuser.h).
WIN_VK = {
    "esc": 0x1B, "space": 0x20, "enter": 0x0D, "tab": 0x09,
    "backspace": 0x08, "capslock": 0x14, "scrolllock": 0x91,
    "pause": 0x13, "insert": 0x2D, "home": 0x24, "end": 0x23,
    "pageup": 0x21, "pagedown": 0x22,
    "leftctrl": 0xA2, "rightctrl": 0xA3, "leftshift": 0xA0,
    "rightshift": 0xA1, "leftalt": 0xA4, "rightalt": 0xA5,
    "leftmeta": 0x5B, "rightmeta": 0x5C,
    **{f"f{i}": 0x6F + i for i in range(1, 13)},          # F1..F12
    **{chr(ord("a") + i): 0x41 + i for i in range(26)},
    **{str(i): 0x30 + i for i in range(10)},
}
WIN_MODIFIER_VKS = {"ctrl": (0xA2, 0xA3), "shift": (0xA0, 0xA1),
                    "alt": (0xA4, 0xA5), "meta": (0x5B, 0x5C),
                    "super": (0x5B, 0x5C)}

# macOS ANSI virtual keycodes (HIToolbox/Events.h kVK_*).
MAC_VK = {
    "a": 0x00, "s": 0x01, "d": 0x02, "f": 0x03, "h": 0x04, "g": 0x05,
    "z": 0x06, "x": 0x07, "c": 0x08, "v": 0x09, "b": 0x0B, "q": 0x0C,
    "w": 0x0D, "e": 0x0E, "r": 0x0F, "y": 0x10, "t": 0x11,
    "1": 0x12, "2": 0x13, "3": 0x14, "4": 0x15, "6": 0x16, "5": 0x17,
    "9": 0x19, "7": 0x1A, "8": 0x1C, "0": 0x1D,
    "o": 0x1F, "u": 0x20, "i": 0x22, "p": 0x23, "l": 0x25, "j": 0x26,
    "k": 0x28, "n": 0x2D, "m": 0x2E,
    "enter": 0x24, "tab": 0x30, "space": 0x31, "backspace": 0x33,
    "esc": 0x35, "capslock": 0x39, "home": 0x73, "pageup": 0x74,
    "end": 0x77, "pagedown": 0x79,
    "f1": 0x7A, "f2": 0x78, "f3": 0x63, "f4": 0x76, "f5": 0x60,
    "f6": 0x61, "f7": 0x62, "f8": 0x64, "f9": 0x65, "f10": 0x6D,
    "f11": 0x67, "f12": 0x6F,
    "leftctrl": 0x3B, "rightctrl": 0x3E, "leftshift": 0x38,
    "rightshift": 0x3C, "leftalt": 0x3A, "rightalt": 0x3D,
    "leftmeta": 0x37, "rightmeta": 0x36,
}
MAC_MODIFIER_VKS = {"ctrl": (0x3B, 0x3E), "shift": (0x38, 0x3C),
                    "alt": (0x3A, 0x3D), "meta": (0x37, 0x36),
                    "super": (0x37, 0x36)}


def native_chord(spec: str, key_table: dict, modifier_table: dict
                 ) -> tuple[int, tuple[tuple[int, ...], ...]]:
    """Translate a parse_key() spec into native (key, modifier-groups)
    codes. Raises ValueError on keys the host table lacks."""
    parse_key(spec)              # validates syntax against shared names
    mods, key = split_chord(spec)
    if key not in key_table:
        raise ValueError(f"key {key!r} not mapped on this host")
    groups = []
    for m in mods:
        if m not in modifier_table:
            raise ValueError(f"modifier {m!r} not mapped on this host")
        groups.append(tuple(modifier_table[m]))
    return key_table[key], tuple(groups)


# ---------------------------------------------------------------------------
# OS-free chord engine
# ---------------------------------------------------------------------------

class ChordPoller:
    """Edge-detects a chord from a key-state probe.

    `probe(code) -> bool` reports whether a native keycode is currently
    down. `tick()` samples the chord and fires on_press exactly once per
    press edge (key down while every modifier group has a member down)
    and on_release when the main key goes up — same semantics as the
    evdev listener's _on_key (hotkey.py:143-158)."""

    def __init__(self, key_code: int,
                 modifier_groups: tuple[tuple[int, ...], ...],
                 probe: Callable[[int], bool],
                 on_press: Callable[[], None],
                 on_release: Callable[[], None]):
        self.key_code = key_code
        self.modifier_groups = modifier_groups
        self.probe = probe
        self.on_press = on_press
        self.on_release = on_release
        self._active = False

    def tick(self) -> None:
        key_down = self.probe(self.key_code)
        if not self._active:
            if key_down and all(any(self.probe(m) for m in group)
                                for group in self.modifier_groups):
                self._active = True
                self.on_press()
        elif not key_down:
            self._active = False
            self.on_release()


class PollingHotkeyListener:
    """Thread that ticks a ChordPoller at `hz` (Windows/macOS hosts)."""

    def __init__(self, poller: ChordPoller, hz: float = 120.0):
        self.poller = poller
        self.interval = 1.0 / hz
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> bool:
        try:
            self.poller.probe(self.poller.key_code)   # probe the probe
        except Exception as e:  # noqa: BLE001 — any native failure
            log.warning("Global hotkey unavailable on this host (%s) — "
                        "use IPC/REST/D-Bus to control recording", e)
            return False
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="hotkey-poller")
        self._thread.start()
        return True

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2)

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self.poller.tick()
            except Exception:  # noqa: BLE001 — never kill the daemon
                log.exception("hotkey poll failed; stopping listener")
                return
            time.sleep(self.interval)


# ---------------------------------------------------------------------------
# Host probes
# ---------------------------------------------------------------------------

def windows_probe() -> Callable[[int], bool]:
    user32 = ctypes.WinDLL("user32")            # type: ignore[attr-defined]
    user32.GetAsyncKeyState.restype = ctypes.c_short

    def probe(vk: int) -> bool:
        return bool(user32.GetAsyncKeyState(vk) & 0x8000)
    return probe


def macos_probe() -> Callable[[int], bool]:
    cg = ctypes.cdll.LoadLibrary(
        "/System/Library/Frameworks/CoreGraphics.framework/CoreGraphics")
    cg.CGEventSourceKeyState.restype = ctypes.c_bool
    cg.CGEventSourceKeyState.argtypes = [ctypes.c_int, ctypes.c_ushort]
    combined_session_state = 0   # kCGEventSourceStateCombinedSessionState

    def probe(vk: int) -> bool:
        return bool(cg.CGEventSourceKeyState(combined_session_state, vk))
    return probe


def create_hotkey_listener(spec: str, on_press: Callable[[], None],
                           on_release: Callable[[], None],
                           platform: Optional[str] = None):
    """Host-appropriate listener: evdev on Linux, polling elsewhere.
    Returns an object with start() -> bool / stop() (parity: the rdev
    backend selection in src/input/hotkey.rs)."""
    p = platform or sys.platform
    if p.startswith("win"):
        key, groups = native_chord(spec, WIN_VK, WIN_MODIFIER_VKS)
        return PollingHotkeyListener(
            ChordPoller(key, groups, windows_probe(), on_press, on_release))
    if p in ("darwin", "macos"):
        key, groups = native_chord(spec, MAC_VK, MAC_MODIFIER_VKS)
        return PollingHotkeyListener(
            ChordPoller(key, groups, macos_probe(), on_press, on_release))
    from .hotkey import HotkeyListener
    return HotkeyListener(spec, on_press, on_release)


__all__ = ["ChordPoller", "PollingHotkeyListener", "create_hotkey_listener",
           "native_chord", "WIN_VK", "MAC_VK", "WIN_MODIFIER_VKS",
           "MAC_MODIFIER_VKS", "MODIFIERS"]
