"""The daemon's per-window preprocess (the rest of the daemon is still to
come).

Counterpart of `build_preprocess` in openhush_tpu/runtime/daemon.py: the
worker's preprocess order denoise → normalize → compress → limit
(src/queue/worker.rs:196-240), handed to `EngineServer(preprocess=...)`.
Every stage runs on the device, the two dynamics stages on the DSP kernels
of csrc/dsp.cu (the reference takes its host C++ copies of the same
functions where they are built).
"""

from __future__ import annotations

import numpy as np
import torch

from openhush_tpu_torch.device import resolve_device
from openhush_tpu_torch.ops import denoise as dn
from openhush_tpu_torch.ops import dsp


def build_preprocess(audio_cfg, device=None):
    """The per-window preprocess for `audio_cfg`, any object with the
    reference AudioConfig's attribute names (normalization_*,
    compression_*, limiter_*, noise_reduction_*). The hook takes and
    returns fp32 numpy audio; denoise keeps its streaming noise-floor state
    on the device across windows. Runs on CUDA unless `device` says
    otherwise."""
    device = resolve_device(device)
    state = {"dn": None}

    def preprocess(audio: np.ndarray) -> np.ndarray:
        y = torch.from_numpy(np.array(audio, np.float32)).to(device)
        if audio_cfg.noise_reduction_enabled:
            y, state["dn"] = dn.denoise_tensor(
                y, strength=audio_cfg.noise_reduction_strength,
                state=state["dn"])
        if audio_cfg.normalization_enabled:
            y = dsp.normalize_rms(y, audio_cfg.normalization_target_db)
        if audio_cfg.compression_enabled:
            y = dsp.compress(y, audio_cfg.compression_threshold_db,
                             audio_cfg.compression_ratio,
                             audio_cfg.compression_attack_ms,
                             audio_cfg.compression_release_ms,
                             audio_cfg.compression_makeup_gain_db)
        if audio_cfg.limiter_enabled:
            y = dsp.limit(y, audio_cfg.limiter_ceiling_db,
                          audio_cfg.limiter_release_ms)
        return y.cpu().numpy()

    return preprocess
