"""Dispatch for the daemon-backed CLI subcommands, over the port's daemon
module (counterpart of openhush_tpu/runtime/daemon_cli.py).

`start`, `stop`, `status` and `recording` are ported; every other
subcommand of the reference CLI names the ROADMAP item that ports it and
exits 2.
"""

from __future__ import annotations

import sys

# The subcommands that go through dispatch (the reference's table,
# openhush_tpu/cli.py:478-545, with `model` among them here): name, help,
# and the ROADMAP item that ports it (None: ported, a `cmd_*` of
# runtime/daemon.py).
SUBCOMMANDS = (
    ("start", "Start the daemon", None),
    ("stop", "Stop the daemon", None),
    ("status", "Show daemon status", None),
    ("recording", "Control recording (start/stop/toggle/continuous)", None),
    ("record", "Record and transcribe long-form audio", "A9b"),
    ("model", "Manage models", "A9c"),
    ("config", "Get/set configuration", "A9c"),
    ("device", "List/select audio devices", "A9c"),
    ("service", "Manage autostart service", "A9c"),
    ("secret", "Manage secrets", "A9c"),
    ("api-key", "Manage API keys", "A9c"),
    ("summarize", "Summarize a transcript", "A9c"),
    ("evaluate", "Evaluate WER on a LibriSpeech-layout dataset", "A9c"),
    ("preferences", "Open preferences", "A9c"),
    ("setup", "First-run setup wizard", "A9c"))


def dispatch(command: str, args: list[str]) -> int:
    item = {name: item for name, _, item in SUBCOMMANDS}.get(command)
    if item is None:
        from openhush_tpu_torch.runtime import daemon
        fn = getattr(daemon, f"cmd_{command.replace('-', '_')}", None)
        if fn is not None:
            return fn(args)
    where = f" (ROADMAP {item})" if item else ""
    print(f"'{command}' is not ported to this package yet{where}",
          file=sys.stderr)
    return 2
