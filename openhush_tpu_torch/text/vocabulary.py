"""Vocabulary replacement engine.

Parity: src/vocabulary/mod.rs (596 LoC) — TOML sections of find→replace
rules with per-section `case_sensitive` (and `enabled`) flags, rules applied
longest-pattern-first at word boundaries (alphanumeric delimits), hot-reload
when the file mtime changes, checked at a configurable interval.

Example vocabulary.toml:
    [medical]
    case_sensitive = false
    "acetaminophen" = "Tylenol"

    [names]
    case_sensitive = true
    "jon" = "Jon"

A copy of openhush_tpu/text/vocabulary.py.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import re
import time
import tomllib
from typing import Optional

log = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class Rule:
    pattern: str
    replacement: str
    case_sensitive: bool
    section: str
    regex: re.Pattern


def _compile_rule(pattern: str, replacement: str, case_sensitive: bool,
                  section: str) -> Rule:
    # Word boundary = not adjacent to alphanumerics (reference's definition,
    # vocabulary/mod.rs replace_exact: `is_alphanumeric()` delimits).
    body = re.escape(pattern)
    rx = re.compile(
        r"(?<![0-9A-Za-z])" + body + r"(?![0-9A-Za-z])",
        0 if case_sensitive else re.IGNORECASE)
    return Rule(pattern, replacement, case_sensitive, section, rx)


class VocabularyManager:
    """Loads, applies, and hot-reloads vocabulary rules."""

    def __init__(self, path: Optional[str] = None,
                 reload_interval_secs: float = 5.0):
        self.path = path
        self.reload_interval = reload_interval_secs
        self._rules: list[Rule] = []
        self._mtime: float = 0.0
        self._last_check: float = 0.0
        if path and os.path.exists(path):
            self._load()

    # -- loading ---------------------------------------------------------------

    def _load(self) -> None:
        try:
            with open(self.path, "rb") as f:
                raw = tomllib.load(f)
        except (OSError, tomllib.TOMLDecodeError) as e:
            log.warning("Failed to load vocabulary %s: %s", self.path, e)
            return
        rules: list[Rule] = []
        for section, table in raw.items():
            if not isinstance(table, dict):
                continue
            case_sensitive = bool(table.get("case_sensitive", False))
            if not table.get("enabled", True):
                continue
            for pattern, replacement in table.items():
                if pattern in ("enabled", "case_sensitive"):
                    continue
                if isinstance(replacement, str):
                    rules.append(_compile_rule(pattern, replacement,
                                               case_sensitive, section))
        # Longest pattern first so overlapping patterns resolve correctly
        # (vocabulary/mod.rs apply docs).
        rules.sort(key=lambda r: len(r.pattern), reverse=True)
        self._rules = rules
        self._mtime = os.path.getmtime(self.path)
        log.info("Loaded %d vocabulary rules from %s", len(rules), self.path)

    def check_reload(self) -> bool:
        """Reload if the file changed; rate-limited by reload_interval.
        Parity: check_reload (src/vocabulary/mod.rs:193)."""
        if not self.path:
            return False
        now = time.monotonic()
        if now - self._last_check < self.reload_interval:
            return False
        self._last_check = now
        try:
            mtime = os.path.getmtime(self.path)
        except OSError:
            return False
        if mtime != self._mtime:
            self._load()
            return True
        return False

    # -- application -------------------------------------------------------------

    def apply(self, text: str) -> str:
        """Apply all rules in longest-first order (src/vocabulary/mod.rs:219)."""
        result = text
        for rule in self._rules:
            result = rule.regex.sub(
                rule.replacement.replace("\\", "\\\\"), result)
        return result

    @property
    def rule_count(self) -> int:
        return len(self._rules)
