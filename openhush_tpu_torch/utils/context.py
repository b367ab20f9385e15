"""Per-application profiles: detect the focused app and override settings.

Parity: src/context.rs (458 LoC) + AppProfile config (src/config.rs:223-263,
Config::find_profile :1389) — profiles match the active window's app name by
case-insensitive substring and override vocabulary path, filler-removal
level, snippet set, or transcription preset while that app is focused.

A copy of openhush_tpu/utils/context.py.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Optional

from openhush_tpu_torch.utils import platform as plat

log = logging.getLogger(__name__)


@dataclasses.dataclass
class AppProfile:
    name: str                               # profile label
    app_match: str                          # substring of app class/name
    vocabulary_path: str = ""
    filler_mode: str = ""                   # override when non-empty
    preset: str = ""                        # transcription preset override
    translate: Optional[bool] = None

    def matches(self, app_name: str) -> bool:
        return bool(self.app_match) and \
            self.app_match.lower() in app_name.lower()


def profiles_from_config(raw: list[dict]) -> list[AppProfile]:
    out = []
    for entry in raw:
        try:
            out.append(AppProfile(
                name=entry.get("name", entry.get("app_match", "?")),
                app_match=entry["app_match"],
                vocabulary_path=entry.get("vocabulary_path", ""),
                filler_mode=entry.get("filler_mode", ""),
                preset=entry.get("preset", ""),
                translate=entry.get("translate")))
        except KeyError:
            log.warning("profile entry missing app_match: %r", entry)
    return out


class AppContext:
    """Caches the focused-app lookup and resolves the active profile."""

    def __init__(self, profiles: list[AppProfile],
                 poll_interval_secs: float = 1.0):
        self.profiles = profiles
        self.poll_interval = poll_interval_secs
        self._last_poll = 0.0
        self._current_app = ""
        self._current_profile: Optional[AppProfile] = None

    def refresh(self) -> Optional[AppProfile]:
        now = time.monotonic()
        if now - self._last_poll < self.poll_interval:
            return self._current_profile
        self._last_poll = now
        win = plat.active_window()
        app = (win or {}).get("app", "")
        if app != self._current_app:
            self._current_app = app
            self._current_profile = self.find_profile(app)
            if self._current_profile:
                log.info("App profile %r active for %r",
                         self._current_profile.name, app)
        return self._current_profile

    def find_profile(self, app_name: str) -> Optional[AppProfile]:
        """First matching profile wins (parity: Config::find_profile)."""
        if not app_name:
            return None
        for p in self.profiles:
            if p.matches(app_name):
                return p
        return None

    @property
    def current_app(self) -> str:
        return self._current_app
