"""Wake-word detection: a 3-stage streaming pipeline in PyTorch.

Counterpart of openhush_tpu/models/wakeword.py. The reference runs
openWakeWord's ONNX pipeline (src/input/wake_word.rs:22-40, inference
:296-420): an 80 ms (1280-sample) melspectrogram stage (32 mel bins,
spec/10+2 normalization), an embedding stage over a sliding 76-frame mel
window (→ 96-d), and a per-word classifier over the last 16 embeddings
(1536-d → score). Each stage here is a function on the device sharing the
frontend's matmul DFT; weights load from npz or come from an explicit
generator. The detector keeps the mel and embedding histories on the
device and a refractory period, one classifier evaluation per 80 ms chunk.

The embedding's convolution runs as fp32 matmuls (`silero.conv1d_fp32`),
never cuDNN's TF32. Converted openWakeWord `.onnx` stages run on the ONNX
executor (`from_onnx`, models/onnx2torch.py).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from openhush_tpu_torch.device import resolve_device
from openhush_tpu_torch.models.onnx2torch import OnnxTorchModel
from openhush_tpu_torch.models.silero import conv1d_fp32
from openhush_tpu_torch.models.whisper.weights import (from_numpy_params,
                                                       load_npz, save_npz)
from openhush_tpu_torch.ops import mel as mel_ops

CHUNK_SAMPLES = 1280       # 80 ms @ 16 kHz per pipeline step
N_MEL_BINS = 32
MEL_FRAMES_PER_CHUNK = CHUNK_SAMPLES // mel_ops.HOP_LENGTH   # 8
EMB_WINDOW = 76            # mel frames per embedding
EMB_DIM = 96
CLS_WINDOW = 16            # embeddings per classification
EMB_STRIDE = 8             # mel frames between embeddings (one chunk)
TAIL = mel_ops.N_FFT - mel_ops.HOP_LENGTH                    # 240


@functools.lru_cache(maxsize=4)
def _mel32_bases(device: torch.device):
    cos_b, sin_b = mel_ops._dft_bases()
    fb = mel_ops.mel_filter_bank(N_MEL_BINS)
    return tuple(torch.from_numpy(a).to(device) for a in (cos_b, sin_b, fb))


def melspectrogram_chunk(audio: torch.Tensor, tail: torch.Tensor
                         ) -> torch.Tensor:
    """Stage 1: one 1280-sample chunk (+240-sample tail for window overlap)
    → [8, 32] normalized log-mel frames (openWakeWord's spec/10 + 2)."""
    signal = torch.cat([tail, audio])                  # [1520]
    frames = signal.unfold(0, mel_ops.N_FFT,
                           mel_ops.HOP_LENGTH)[:MEL_FRAMES_PER_CHUNK]
    cos_b, sin_b, fb = _mel32_bases(audio.device)
    re, im = frames @ cos_b, frames @ sin_b
    melspec = (re * re + im * im) @ fb
    log_mel = torch.log10(torch.clamp(melspec, min=1e-10)) * 10.0  # dB-ish
    return log_mel / 10.0 + 2.0                        # spec/10 + 2


def init_embedding_params(generator: torch.Generator, device=None) -> dict:
    """Embedding model: [76, 32] mel window → 96-d. Conv over time + global
    pooling + dense (a compact stand-in for openWakeWord's embedding net;
    same I/O contract). The conv weight is HIO [8, 32, 64], as the JAX
    package keeps it."""
    device = resolve_device(device)

    def g(shape, fan):
        return torch.randn(shape, generator=generator, device=device) \
            * fan ** -0.5

    return {
        "conv_w": g((8, N_MEL_BINS, 64), 8 * 32),
        "conv_b": torch.zeros(64, device=device),
        "dense_w": g((64, 128), 64),
        "dense_b": torch.zeros(128, device=device),
        "out_w": g((128, EMB_DIM), 128),
        "out_b": torch.zeros(EMB_DIM, device=device),
    }


def embed_window(params: dict, mel_window: torch.Tensor) -> torch.Tensor:
    """[76, 32] → [96]. The time convolution is stride 4, zero pad 2 (the
    reference's NHC/HIO layout, here [O, I, K] over [C, T])."""
    x = conv1d_fp32(mel_window.T, params["conv_w"].permute(2, 1, 0),
                    params["conv_b"], 4, 2)            # [64, 19]
    x = torch.relu(x)
    x = torch.mean(x, dim=1)                           # pool time → [64]
    x = torch.relu(x @ params["dense_w"] + params["dense_b"])
    return x @ params["out_w"] + params["out_b"]


def init_classifier_params(generator: torch.Generator, device=None) -> dict:
    """Per-word classifier: [16*96] → score (hey_jarvis.onnx contract)."""
    device = resolve_device(device)
    d = CLS_WINDOW * EMB_DIM
    return {
        "w1": torch.randn(d, 128, generator=generator, device=device)
        * d ** -0.5,
        "b1": torch.zeros(128, device=device),
        "w2": torch.randn(128, 1, generator=generator, device=device)
        * 128 ** -0.5,
        "b2": torch.zeros(1, device=device),
    }


def classify_window(params: dict, embeddings: torch.Tensor) -> torch.Tensor:
    """[16, 96] → scalar probability."""
    x = embeddings.reshape(-1)
    h = torch.relu(x @ params["w1"] + params["b1"])
    return torch.sigmoid((h @ params["w2"] + params["b2"])[0])


@dataclasses.dataclass
class WakeWordConfig:
    threshold: float = 0.5
    refractory_secs: float = 2.0     # suppress repeat triggers
    model_name: str = "hey_jarvis"


class WakeWordDetector:
    """Streaming detector: feed 1280-sample chunks, get detections. Runs on
    CUDA unless `device` says otherwise; missing params come from a
    generator seeded 0 (embedding) and 1 (classifier).

    Parity surface: WakeWordDetector::process (src/input/wake_word.rs:296).
    """

    def __init__(self, config: Optional[WakeWordConfig] = None,
                 emb_params: Optional[dict] = None,
                 cls_params: Optional[dict] = None,
                 emb_fn=None, cls_fn=None, device=None):
        self.config = config or WakeWordConfig()
        self.device = resolve_device(device)

        def gen(seed):
            return torch.Generator(device=self.device).manual_seed(seed)

        self.emb_params = emb_params or init_embedding_params(gen(0),
                                                              self.device)
        self.cls_params = cls_params or init_classifier_params(gen(1),
                                                               self.device)
        self._emb_fn = emb_fn or (
            lambda mel: embed_window(self.emb_params, mel))
        self._cls_fn = cls_fn or (
            lambda embs: classify_window(self.cls_params, embs))
        self.reset()

    @classmethod
    def from_onnx(cls, embedding_path: str, classifier_path: str,
                  config: Optional[WakeWordConfig] = None, device=None
                  ) -> "WakeWordDetector":
        """Back stages 2+3 with converted openWakeWord .onnx graphs, run by
        the ONNX executor (models/onnx2torch.py) on `device`.

        openWakeWord's embedding model takes a [1, 76, 32, 1] mel image
        and emits [1, 1, 1, 96]; the per-word classifier takes
        [1, 16, 96] and emits [1, 1] (pipeline constants:
        src/input/wake_word.rs:22-40). Adapters reshape between those
        layouts and this detector's [76,32]/[16,96] histories."""
        device = resolve_device(device)
        emb = OnnxTorchModel.load(embedding_path, device)
        cls_m = OnnxTorchModel.load(classifier_path, device)

        def first(out):
            return out[0] if isinstance(out, tuple) else out

        def emb_fn(mel):
            out = first(emb(mel.reshape(1, EMB_WINDOW, N_MEL_BINS, 1)))
            return out.reshape(-1)[:EMB_DIM]

        def cls_fn(embs):
            out = first(cls_m(embs.reshape(1, CLS_WINDOW, EMB_DIM)))
            return out.reshape(-1)[-1]

        return cls(config, emb_fn=emb_fn, cls_fn=cls_fn, device=device)

    def reset(self) -> None:
        dev = self.device
        self._tail = torch.zeros(TAIL, dtype=torch.float32, device=dev)
        self._mel_hist = torch.zeros(EMB_WINDOW, N_MEL_BINS, device=dev)
        self._mel_filled = 0
        self._emb_hist = torch.zeros(CLS_WINDOW, EMB_DIM, device=dev)
        self._emb_filled = 0
        self._chunks_since_trigger = 10 ** 9

    @torch.no_grad()
    def process(self, chunk: np.ndarray) -> Optional[float]:
        """One 1280-sample chunk → score when the pipeline is warm (None
        while buffers fill), with refractory suppression applied by
        `detected`."""
        buf = np.zeros(CHUNK_SAMPLES, np.float32)
        n = min(len(chunk), CHUNK_SAMPLES)
        buf[:n] = chunk[:n]
        audio = torch.from_numpy(buf).to(self.device)
        mel8 = melspectrogram_chunk(audio, self._tail)
        self._tail = audio[-TAIL:]

        self._mel_hist = torch.cat([self._mel_hist[MEL_FRAMES_PER_CHUNK:],
                                    mel8])
        self._mel_filled = min(self._mel_filled + MEL_FRAMES_PER_CHUNK,
                               EMB_WINDOW)
        if self._mel_filled < EMB_WINDOW:
            return None

        emb = self._emb_fn(self._mel_hist)
        self._emb_hist = torch.cat([self._emb_hist[1:], emb[None]])
        self._emb_filled = min(self._emb_filled + 1, CLS_WINDOW)
        if self._emb_filled < CLS_WINDOW:
            return None

        score = float(self._cls_fn(self._emb_hist))
        self._chunks_since_trigger += 1
        return score

    def detected(self, score: Optional[float]) -> bool:
        """Threshold + refractory period."""
        if score is None or score < self.config.threshold:
            return False
        refractory_chunks = int(self.config.refractory_secs * 16000
                                / CHUNK_SAMPLES)
        if self._chunks_since_trigger <= refractory_chunks:
            return False
        self._chunks_since_trigger = 0
        return True

    @property
    def chunk_size(self) -> int:
        return CHUNK_SAMPLES

    # -- persistence ----------------------------------------------------------

    def save(self, path: str) -> None:
        save_npz({"embedding": self.emb_params,
                  "classifier": self.cls_params}, path)

    @classmethod
    def load(cls, path: str, config: Optional[WakeWordConfig] = None,
             device=None) -> "WakeWordDetector":
        device = resolve_device(device)
        params = from_numpy_params(load_npz(path), device=device)
        return cls(config, emb_params=params["embedding"],
                   cls_params=params["classifier"], device=device)
