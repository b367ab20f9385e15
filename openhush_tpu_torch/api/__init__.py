"""The REST control plane (a copy of openhush_tpu/api/)."""
