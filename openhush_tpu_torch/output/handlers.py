"""Output handlers: clipboard, paste-at-cursor, post-transcription actions.

Parity: src/output/ (1,242 LoC):
- clipboard via native CLI tools (wl-copy / xclip / xsel / pbcopy — the
  arboard equivalent without a compiled dependency), clipboard.rs
- paste by typing (xdotool type / wtype), Ctrl+V injection (xdotool key),
  paste.rs:43-142
- actions: shell (`sh -c` with injection sanitization stripping backticks,
  `$(`, `${`, `$[`; actions.rs:96-102), HTTP (method/headers/body), file
  append — each with `{text}/{text_escaped}/{text_base64}/{date}/{time}/
  {duration}/{model}/{seq_id}` substitution (actions.rs:60-90) and timeouts.

A copy of openhush_tpu/output/handlers.py; the macOS and Windows clipboard
and paste go through the port's utils/platform_hosts.py.
"""

from __future__ import annotations

import base64
import dataclasses
import datetime
import json
import logging
import shutil
import subprocess
import sys
from typing import Optional

from openhush_tpu_torch.utils.http import HttpError, request_json

log = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# Substitution context
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ActionContext:
    text: str
    duration_secs: float = 0.0
    model: str = ""
    seq_id: int = 0
    timestamp: Optional[datetime.datetime] = None

    def substitute(self, template: str) -> str:
        """Parity: substitute (src/output/actions.rs:73-90)."""
        ts = self.timestamp or datetime.datetime.now()
        text_escaped = json.dumps(self.text)[1:-1]
        text_b64 = base64.b64encode(self.text.encode()).decode()
        return (template
                .replace("{text}", self.text)
                .replace("{text_escaped}", text_escaped)
                .replace("{text_base64}", text_b64)
                .replace("{date}", ts.strftime("%Y-%m-%d"))
                .replace("{time}", ts.strftime("%H:%M:%S"))
                .replace("{duration}", f"{self.duration_secs:.1f}")
                .replace("{model}", self.model)
                .replace("{seq_id}", str(self.seq_id)))


def sanitize_for_shell(text: str) -> str:
    """Strip command-injection vectors (parity: actions.rs:96-102)."""
    return (text.replace("`", "'")
            .replace("$(", "(")
            .replace("${", "{")
            .replace("$[", "[")
            .replace("\0", ""))


# ---------------------------------------------------------------------------
# Clipboard + paste
# ---------------------------------------------------------------------------

_CLIPBOARD_TOOLS = (
    (("wl-copy",), None),
    (("xclip", "-selection", "clipboard"), None),
    (("xsel", "--clipboard", "--input"), None),
    (("pbcopy",), None),
)


def copy_to_clipboard(text: str) -> bool:
    if sys.platform == "darwin" or sys.platform.startswith("win"):
        from ..utils.platform_hosts import get_host_platform
        return get_host_platform().copy_to_clipboard(text)
    for cmd, _ in _CLIPBOARD_TOOLS:
        if shutil.which(cmd[0]):
            try:
                subprocess.run(cmd, input=text.encode(), timeout=5,
                               check=True, capture_output=True)
                return True
            except (subprocess.SubprocessError, OSError) as e:
                log.debug("%s failed: %s", cmd[0], e)
    log.warning("No clipboard tool available (wl-copy/xclip/xsel/pbcopy)")
    return False


def paste_text(text: str, method: str = "type") -> bool:
    """Type text at the cursor or inject Ctrl+V
    (parity: paste.rs:43-142)."""
    if sys.platform == "darwin" or sys.platform.startswith("win"):
        from ..utils.platform_hosts import get_host_platform
        return get_host_platform().paste_text(text, method)
    if method == "type":
        for tool, args in (("wtype", [text]),
                           ("xdotool", ["type", "--clearmodifiers", text])):
            if shutil.which(tool):
                try:
                    subprocess.run([tool] + args, timeout=10, check=True,
                                   capture_output=True)
                    return True
                except (subprocess.SubprocessError, OSError):
                    continue
        return False
    if method == "ctrl_v":
        if not copy_to_clipboard(text):
            return False
        if shutil.which("xdotool"):
            try:
                subprocess.run(["xdotool", "key", "--clearmodifiers",
                                "ctrl+v"], timeout=5, check=True,
                               capture_output=True)
                return True
            except (subprocess.SubprocessError, OSError):
                return False
    return False


class OutputHandler:
    """Clipboard/paste/both dispatch (src/output/mod.rs:44)."""

    def __init__(self, mode: str = "both", paste_method: str = "type",
                 fallback=None, separator: str = " "):
        self.mode = mode
        self.paste_method = paste_method
        self.fallback = fallback or (lambda text: print(text, flush=True))
        # [queue].separator (config.example.toml:64): joiner typed
        # between consecutive pasted transcriptions of one flush batch.
        self.separator = separator

    def output(self, text: str, continuation: bool = False) -> None:
        delivered = False
        if self.mode in ("clipboard", "both"):
            delivered = copy_to_clipboard(text) or delivered
        if self.mode in ("paste", "both"):
            pasted = (self.separator + text
                      if continuation and self.separator else text)
            delivered = paste_text(pasted, self.paste_method) or delivered
        if not delivered:
            self.fallback(text)


# ---------------------------------------------------------------------------
# Actions
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ShellAction:
    command: str
    timeout_secs: float = 10.0

    def execute(self, ctx: ActionContext) -> bool:
        safe_ctx = dataclasses.replace(
            ctx, text=sanitize_for_shell(ctx.text))
        cmd = safe_ctx.substitute(self.command)
        try:
            subprocess.run(["sh", "-c", cmd], timeout=self.timeout_secs,
                           check=True, capture_output=True)
            return True
        except (subprocess.SubprocessError, OSError) as e:
            log.warning("Shell action failed: %s", e)
            return False


@dataclasses.dataclass
class HttpAction:
    url: str
    method: str = "POST"
    headers: dict = dataclasses.field(default_factory=dict)
    body: str = "{\"text\": \"{text_escaped}\"}"
    timeout_secs: float = 10.0

    def execute(self, ctx: ActionContext) -> bool:
        url = ctx.substitute(self.url)
        body = ctx.substitute(self.body)
        headers = {k: ctx.substitute(v) for k, v in self.headers.items()}
        try:
            payload = json.loads(body) if body else None
        except json.JSONDecodeError:
            payload = None
        try:
            request_json(url, method=self.method, payload=payload,
                         headers=headers, timeout=self.timeout_secs)
            return True
        except HttpError as e:
            log.warning("HTTP action failed: %s", e)
            return False


@dataclasses.dataclass
class FileAction:
    path: str
    template: str = "{text}\n"

    def execute(self, ctx: ActionContext) -> bool:
        try:
            with open(ctx.substitute(self.path), "a") as f:
                f.write(ctx.substitute(self.template))
            return True
        except OSError as e:
            log.warning("File action failed: %s", e)
            return False


def action_from_config(cfg: dict):
    """Build an action from a config table ({'type': 'shell'|'http'|'file',
    ...}) — parity with ActionConfig's serde tag (actions.rs:108+)."""
    kind = cfg.get("type")
    if kind == "shell":
        return ShellAction(cfg["command"],
                           float(cfg.get("timeout_secs", 10)))
    if kind == "http":
        return HttpAction(cfg["url"], cfg.get("method", "POST"),
                          dict(cfg.get("headers", {})),
                          cfg.get("body", "{\"text\": \"{text_escaped}\"}"),
                          float(cfg.get("timeout_secs", 10)))
    if kind == "file":
        return FileAction(cfg["path"], cfg.get("template", "{text}\n"))
    raise ValueError(f"unknown action type {kind!r}")


class ActionRunner:
    """Run all configured actions after each transcription
    (parity: ActionRunner::run_all via ActionConfig::execute,
    src/output/actions.rs:194)."""

    def __init__(self, actions: list):
        self.actions = actions

    @classmethod
    def from_config_list(cls, configs: list[dict]) -> "ActionRunner":
        return cls([action_from_config(c) for c in configs])

    def run_all(self, ctx: ActionContext) -> int:
        ok = 0
        for action in self.actions:
            try:
                ok += bool(action.execute(ctx))
            except Exception as e:  # noqa: BLE001 — one action must not kill the rest
                log.warning("Action %r raised: %s", action, e)
        return ok
