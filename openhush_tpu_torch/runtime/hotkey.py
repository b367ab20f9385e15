"""Global hotkey listener via raw /dev/input (Linux evdev, no dependencies).

Parity: src/input/hotkey.rs (426 LoC) — rdev global hook in a dedicated
thread emitting Pressed/Released events over a channel, with key-string
parsing (F-keys, modifiers+key chords). Here we read input_event structs
straight from /dev/input/event* (struct: timeval + u16 type + u16 code +
s32 value); requires membership in the `input` group or root — when the
devices aren't readable the daemon logs a warning and relies on
IPC/REST/D-Bus-equivalent control instead (graceful degradation, matching
the reference's Wayland fallback posture).

A copy of openhush_tpu/runtime/hotkey.py.
"""

from __future__ import annotations

import dataclasses
import glob
import logging
import os
import select
import struct
import threading
from typing import Callable, Optional

log = logging.getLogger(__name__)

EV_KEY = 0x01
_EVENT_FMT = "llHHi"
_EVENT_SIZE = struct.calcsize(_EVENT_FMT)

# Linux input-event-codes for the keys the reference's parser accepts
# (hotkey.rs parse_key :138 — F-keys, modifiers, common keys).
KEY_CODES = {
    "esc": 1, "space": 57, "enter": 28, "tab": 15, "backspace": 14,
    "capslock": 58, "scrolllock": 70, "pause": 119, "insert": 110,
    "home": 102, "end": 107, "pageup": 104, "pagedown": 109,
    "leftctrl": 29, "rightctrl": 97, "leftshift": 42, "rightshift": 54,
    "leftalt": 56, "rightalt": 100, "leftmeta": 125, "rightmeta": 126,
    **{f"f{i}": 58 + i for i in range(1, 11)},       # F1..F10: 59..68
    "f11": 87, "f12": 88,
    **{chr(ord("a") + i): c for i, c in enumerate(
        [30, 48, 46, 32, 18, 33, 34, 35, 23, 36, 37, 38, 50, 49, 24, 25,
         16, 19, 31, 20, 22, 47, 17, 45, 21, 44])},
    **{str(i): c for i, c in zip(range(1, 10), range(2, 11))},
    "0": 11,
}
MODIFIERS = {"ctrl": (29, 97), "shift": (42, 54), "alt": (56, 100),
             "meta": (125, 126), "super": (125, 126)}


@dataclasses.dataclass(frozen=True)
class HotkeySpec:
    key_code: int
    modifiers: tuple[tuple[int, ...], ...]   # each entry: acceptable codes


def split_chord(spec: str) -> tuple[list[str], str]:
    """'ctrl+alt+F9' → (['ctrl', 'alt'], 'f9'), validating shape only —
    shared by the evdev parser below and the per-OS keycode translators
    (runtime/hotkey_hosts.py)."""
    parts = [p.strip().lower() for p in spec.split("+") if p.strip()]
    if not parts:
        raise ValueError("empty hotkey spec")
    *mods, key = parts
    if key in MODIFIERS and not mods:
        # A bare modifier as the hotkey (e.g. 'rightctrl').
        raise ValueError(f"hotkey must end in a non-modifier key: {spec!r}")
    return mods, key


def parse_key(spec: str) -> HotkeySpec:
    """Parse 'F9', 'ctrl+alt+space', ... (parity: parse_key,
    hotkey.rs:138)."""
    mods, key = split_chord(spec)
    if key not in KEY_CODES:
        raise ValueError(f"unknown key {key!r} in hotkey {spec!r}")
    mod_codes = []
    for m in mods:
        if m not in MODIFIERS:
            raise ValueError(f"unknown modifier {m!r} in hotkey {spec!r}")
        mod_codes.append(MODIFIERS[m])
    return HotkeySpec(KEY_CODES[key], tuple(mod_codes))


class HotkeyListener:
    """Watches /dev/input for the configured chord; emits
    on_press/on_release callbacks from a dedicated thread."""

    def __init__(self, spec: str,
                 on_press: Callable[[], None],
                 on_release: Callable[[], None],
                 device_glob: str = "/dev/input/event*"):
        self.spec = parse_key(spec)
        self.on_press = on_press
        self.on_release = on_release
        self.device_glob = device_glob
        self._fds: list[int] = []
        self._down: set[int] = set()
        self._active = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> bool:
        """Returns False when no input devices are readable."""
        for path in sorted(glob.glob(self.device_glob)):
            try:
                self._fds.append(os.open(path, os.O_RDONLY
                                         | os.O_NONBLOCK))
            except OSError:
                continue
        if not self._fds:
            log.warning("No readable input devices (%s) — global hotkey "
                        "disabled; use IPC/REST to control recording",
                        self.device_glob)
            return False
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="hotkey-listener")
        self._thread.start()
        return True

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2)
        for fd in self._fds:
            try:
                os.close(fd)
            except OSError:
                pass
        self._fds = []

    # -- internals -------------------------------------------------------------

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                ready, _, _ = select.select(self._fds, [], [], 0.25)
            except OSError:
                return
            for fd in ready:
                try:
                    data = os.read(fd, _EVENT_SIZE * 64)
                except OSError:
                    continue
                for off in range(0, len(data) - _EVENT_SIZE + 1,
                                 _EVENT_SIZE):
                    _, _, etype, code, value = struct.unpack_from(
                        _EVENT_FMT, data, off)
                    if etype == EV_KEY:
                        self._on_key(code, value)

    def _on_key(self, code: int, value: int) -> None:
        if value == 1:
            self._down.add(code)
        elif value == 0:
            self._down.discard(code)
        else:
            return  # autorepeat
        chord = (code == self.spec.key_code
                 and all(any(m in self._down for m in group)
                         for group in self.spec.modifiers))
        if value == 1 and chord and not self._active:
            self._active = True
            self.on_press()
        elif value == 0 and self._active and code == self.spec.key_code:
            self._active = False
            self.on_release()
