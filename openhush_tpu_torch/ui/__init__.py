"""Desktop UX shell: the system tray on Linux (StatusNotifierItem), macOS
and Windows (a copy of openhush_tpu/ui/, without the web preferences UI)."""
