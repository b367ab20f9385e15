"""Platform integration: display-server detection, notifications, sounds,
active-window queries, status-bar emitters, sandbox detection.

Parity: src/platform/ (2,011 LoC) — DisplayServer::detect (mod.rs:169-180),
notify-rust desktop notifications, Wayland compositor IPC for Hyprland/Sway
active-window + Waybar JSON status (wayland_ipc.rs:65-433), sandbox
detection (sandbox.rs:178-236). All calls shell out to the standard desktop
tools and degrade to no-ops headlessly.

A copy of openhush_tpu/utils/platform.py (the active-window query that
utils/context.py's per-app profiles read; the desktop notify and beep);
the macOS and Windows hooks are utils/platform_hosts.py's.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import subprocess
from typing import Optional

log = logging.getLogger(__name__)


def detect_display_server() -> str:
    """x11 | wayland | tty | macos | windows
    (parity: DisplayServer::detect, platform/mod.rs:169-180)."""
    import sys
    if sys.platform == "darwin":
        return "macos"
    if sys.platform.startswith("win"):
        return "windows"
    if os.environ.get("WAYLAND_DISPLAY"):
        return "wayland"
    if os.environ.get("DISPLAY"):
        return "x11"
    return "tty"


def detect_compositor() -> Optional[str]:
    """hyprland | sway | None."""
    if os.environ.get("HYPRLAND_INSTANCE_SIGNATURE"):
        return "hyprland"
    if os.environ.get("SWAYSOCK"):
        return "sway"
    return None


def notify(summary: str, body: str = "", urgency: str = "normal") -> bool:
    """Desktop notification via notify-send; False when unavailable."""
    if not shutil.which("notify-send"):
        return False
    try:
        subprocess.run(["notify-send", "-u", urgency, "-a", "OpenHush",
                        summary, body], timeout=5, capture_output=True)
        return True
    except (subprocess.SubprocessError, OSError):
        return False


def play_sound(name: str = "bell") -> bool:
    """Audio feedback via paplay/aplay with the freedesktop sound theme."""
    paths = [f"/usr/share/sounds/freedesktop/stereo/{name}.oga",
             f"/usr/share/sounds/freedesktop/stereo/{name}.wav"]
    for player in ("paplay", "aplay"):
        if shutil.which(player):
            for p in paths:
                if os.path.exists(p):
                    try:
                        subprocess.run([player, p], timeout=5,
                                       capture_output=True)
                        return True
                    except (subprocess.SubprocessError, OSError):
                        pass
    return False


def active_window() -> Optional[dict]:
    """{'app': ..., 'title': ...} of the focused window, or None.
    Parity: active-app detection for per-app profiles (src/context.rs,
    wayland_ipc.rs Hyprland/Sway queries, xprop on X11)."""
    comp = detect_compositor()
    try:
        if comp == "hyprland" and shutil.which("hyprctl"):
            r = subprocess.run(["hyprctl", "activewindow", "-j"],
                               capture_output=True, timeout=3, text=True)
            if r.returncode == 0:
                data = json.loads(r.stdout)
                return {"app": data.get("class", ""),
                        "title": data.get("title", "")}
        if comp == "sway" and shutil.which("swaymsg"):
            r = subprocess.run(["swaymsg", "-t", "get_tree"],
                               capture_output=True, timeout=3, text=True)
            if r.returncode == 0:
                node = _find_focused(json.loads(r.stdout))
                if node:
                    return {"app": node.get("app_id")
                            or node.get("window_properties", {})
                            .get("class", ""),
                            "title": node.get("name", "")}
        if detect_display_server() == "x11" and shutil.which("xprop"):
            r = subprocess.run(
                ["xprop", "-root", "_NET_ACTIVE_WINDOW"],
                capture_output=True, timeout=3, text=True)
            if "0x" in r.stdout:
                wid = r.stdout.split()[-1]
                r2 = subprocess.run(["xprop", "-id", wid, "WM_CLASS",
                                     "_NET_WM_NAME"],
                                    capture_output=True, timeout=3,
                                    text=True)
                app = title = ""
                for line in r2.stdout.splitlines():
                    if line.startswith("WM_CLASS"):
                        parts = line.split('"')
                        app = parts[-2] if len(parts) >= 2 else ""
                    elif "_NET_WM_NAME" in line and '"' in line:
                        title = line.split('"', 1)[1].rstrip('"')
                return {"app": app, "title": title}
    except (subprocess.SubprocessError, OSError, json.JSONDecodeError,
            IndexError):
        pass
    return None


def _find_focused(node: dict) -> Optional[dict]:
    if node.get("focused"):
        return node
    for child in node.get("nodes", []) + node.get("floating_nodes", []):
        found = _find_focused(child)
        if found:
            return found
    return None


def status_bar_json(state: str, recording: bool,
                    queue_depth: int = 0) -> str:
    """Waybar custom-module JSON (parity: wayland_ipc.rs:373-433)."""
    icons = {"idle": "", "recording": "", "transcribing": ""}
    text = icons.get(state, state)
    klass = state if state in ("idle", "recording") else "transcribing"
    return json.dumps({
        "text": text,
        "tooltip": f"OpenHush: {state}"
                   + (f" (queue {queue_depth})" if queue_depth else ""),
        "class": klass,
        "alt": state,
    })


def detect_sandbox() -> Optional[str]:
    """apparmor | selinux | flatpak | firejail | container | None
    (parity: sandbox.rs:178-236)."""
    if os.environ.get("FLATPAK_ID"):
        return "flatpak"
    if os.path.exists("/run/firejail"):
        return "firejail"
    try:
        with open("/proc/self/attr/current") as f:
            label = f.read().strip("\x00\n ")
        if label and label != "unconfined":
            if "apparmor" in label.lower() or label.endswith("(enforce)"):
                return "apparmor"
            return "selinux"
    except OSError:
        pass
    if os.path.exists("/.dockerenv") or os.environ.get("container"):
        return "container"
    return None
