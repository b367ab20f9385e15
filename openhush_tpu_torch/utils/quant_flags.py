"""The int8 switches, as the JAX package resolves them: a copy of
openhush_tpu/utils/quant_flags.py, with the same names, markers and
environment variables (the port imports nothing of the JAX package).

The combined int8 rung (int8 decoder weights + int8 self-cache + int8
cross-KV) and the W8A8 encoder rung each sit behind one flag: an
environment variable when it is set (``=1`` on, anything else off), else a
marker file in the models directory that a real-weight WER gate drops
(tools/checkpoint_gate.py). The engine reads the rung for its int8
decoder weights and the encoder flag for the W8A8 encoder; the server reads
the rung, OPENHUSH_INT8_SELF_CACHE or SELF_CACHE_MARKER for its int8
self-cache.
"""

from __future__ import annotations

import os

RUNG_MARKER = "int8_rung.ok"
ENCODER_MARKER = "int8_encoder.ok"
SELF_CACHE_MARKER = "int8_self_cache.ok"


def _flag(env_name: str, marker: str, model_dir: str | None) -> bool:
    env = os.environ.get(env_name)
    if env is not None:
        return env == "1"
    if model_dir is None:
        from openhush_tpu_torch.runtime.engine import default_model_dir
        model_dir = default_model_dir()
    return os.path.exists(os.path.join(model_dir, marker))


def int8_rung_enabled(model_dir: str | None = None) -> bool:
    """True when the combined int8 rung is on: OPENHUSH_INT8_RUNG=1 (0
    forces off), else the checkpoint-gate marker in the models dir."""
    return _flag("OPENHUSH_INT8_RUNG", RUNG_MARKER, model_dir)


def int8_encoder_enabled(model_dir: str | None = None) -> bool:
    """True when the W8A8 encoder rung is on: OPENHUSH_INT8_ENCODER=1 (0
    forces off), else the checkpoint-gate marker. A flag of its own: the
    gate decides the encoder and decoder rungs apart."""
    return _flag("OPENHUSH_INT8_ENCODER", ENCODER_MARKER, model_dir)
