"""Speaker diarization: segmentation + speaker embeddings + clustering.

Counterpart of openhush_tpu/models/diarization.py. The reference embeds
pyannote's ONNX models (src/diarization/mod.rs:1-385): segmentation-3.0
for speech regions, wespeaker CAM++ embeddings, then incremental
cosine-similarity clustering with a threshold and a max-speaker cap
(get_segments + EmbeddingExtractor::compute +
EmbeddingManager::search_speaker, mod.rs:266-299).

- The segmentation net: per-frame local-speaker activities (the
  segmentation-3.0 role): log-mel → strided convs → a GRU over time → K
  sigmoid activity channels. Trainable (training/speaker.py); a converted
  pyannote .onnx runs on the ONNX executor (models/onnx2torch.py) instead.
- The speaker embedder: log-mel → two strided convs → statistics pooling
  (mean||std) → an L2-normed d-vector; weights load from npz or a
  wespeaker .onnx, or come from an explicit generator.
- EmbeddingClusterer: incremental cosine clustering (threshold + max
  speakers), numpy, the reference's behaviour exactly.

Parameters keep the JAX package's layout (conv weights HIO [K, in, out],
linear weights [in, out]), so its npz files load as they are; the engine's
models run on `device` (CUDA unless the caller asks for the CPU). The
convolutions run in true fp32 as unfolded matmuls (never cuDNN's TF32),
as the reference's run at fp32 on the CPU. The GRU fuses its gates in the
order update, reset, candidate, as the reference's step does (not
nn.GRU's).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from openhush_tpu_torch.device import resolve_device
from openhush_tpu_torch.models.onnx2torch import OnnxTorchModel, conv_fp32
from openhush_tpu_torch.ops import mel as mel_ops

EMB_DIM = 192
N_MELS = 80
# The JAX package's trained checkpoints, read as data files (nothing of the
# package is imported).
ASSETS = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "openhush_tpu", "assets", "diarization")


def _normal(generator: torch.Generator, device, *shape) -> torch.Tensor:
    return torch.randn(shape, generator=generator, device=device)


def init_embedder_params(generator: torch.Generator, width: int = 128,
                         device=None) -> dict:
    """N(0, 1/fan_in) weights from `generator` (its draws differ from
    JAX's PRNG), biases zero."""
    device = resolve_device(device)
    g = lambda *s: _normal(generator, device, *s)
    z = lambda n: torch.zeros(n, device=device)
    return {
        "conv1_w": g(5, N_MELS, width) * (5 * 80) ** -0.5,
        "conv1_b": z(width),
        "conv2_w": g(3, width, width) * (3 * width) ** -0.5,
        "conv2_b": z(width),
        "dense_w": g(2 * width, EMB_DIM) * (2 * width) ** -0.5,
        "dense_b": z(EMB_DIM),
    }


def _conv_nhc(x: torch.Tensor, w: torch.Tensor, stride: int,
              pad: int) -> torch.Tensor:
    """The reference's NHC/HIO conv_general_dilated: x [B, T, C], w
    [K, C, O] → [B, T', O], in fp32 matmuls."""
    out = conv_fp32(x.transpose(1, 2), w.permute(2, 1, 0), [stride],
                    [(pad, pad)], [1])
    return out.transpose(1, 2)


def _stem(params: dict, mel: torch.Tensor) -> torch.Tensor:
    x = torch.relu(_conv_nhc(mel, params["conv1_w"], 2, 2)
                   + params["conv1_b"])
    return torch.relu(_conv_nhc(x, params["conv2_w"], 2, 1)
                      + params["conv2_b"])


def embed_batch(params: dict, mel: torch.Tensor) -> torch.Tensor:
    """Core embedder on batched mel: [B, T, n_mels] → L2-normed
    [B, EMB_DIM]. Differentiable: training/speaker.py optimizes through
    this exact function, so trained checkpoints match inference."""
    x = _stem(params, mel)
    # Statistics pooling: mean || std over time.
    mean = torch.mean(x, dim=1)
    std = torch.sqrt(torch.clamp(torch.var(x, dim=1, unbiased=False),
                                 min=1e-6))
    stats = torch.cat([mean, std], dim=-1)                 # [B, 2*width]
    emb = stats @ params["dense_w"] + params["dense_b"]
    return emb / torch.linalg.norm(emb, dim=-1, keepdim=True)


def log_mel_frames(audio: torch.Tensor, n_frames: int) -> torch.Tensor:
    """[B, n_frames*160] → [B, n_frames, N_MELS] Whisper log-mel, per
    row."""
    return mel_ops.log_mel_spectrogram(audio, n_mels=N_MELS,
                                       n_frames=n_frames).transpose(1, 2)


def speaker_embedding(params: dict, audio: torch.Tensor,
                      n_frames: int = 300) -> torch.Tensor:
    """audio [n_frames*160] (≥1 s recommended) → L2-normalized [EMB_DIM]."""
    return embed_batch(params, log_mel_frames(audio[None], n_frames))[0]


# ---------------------------------------------------------------------------
# Segmentation model (role of pyannote segmentation-3.0,
# src/diarization/mod.rs:266 get_segments): per-frame activity of up to
# SEG_K locally-active speakers, so overlapping speech separates.
# ---------------------------------------------------------------------------

SEG_K = 3          # local speaker channels per window (pyannote uses 3)
SEG_HIDDEN = 64


def init_segmentation_params(generator: torch.Generator,
                             n_mels: int = N_MELS, hidden: int = SEG_HIDDEN,
                             k: int = SEG_K, device=None) -> dict:
    device = resolve_device(device)
    g = lambda *s: _normal(generator, device, *s)
    z = lambda n: torch.zeros(n, device=device)
    return {
        "conv1_w": g(5, n_mels, hidden) * (5 * n_mels) ** -0.5,
        "conv1_b": z(hidden),
        "conv2_w": g(3, hidden, hidden) * (3 * hidden) ** -0.5,
        "conv2_b": z(hidden),
        # fused GRU gates [update, reset, candidate]
        "gru_wx": g(hidden, 3 * hidden) * hidden ** -0.5,
        "gru_wh": g(hidden, 3 * hidden) * hidden ** -0.5,
        "gru_b": z(3 * hidden),
        "out_w": g(hidden, k) * hidden ** -0.5,
        "out_b": z(k),
    }


def powerset_to_activities(probs: np.ndarray, k: int = SEG_K
                           ) -> np.ndarray:
    """pyannote segmentation-3.0 emits POWERSET classes over 3 local
    speakers — [∅, {0}, {1}, {2}, {0,1}, {0,2}, {1,2}] — rather than
    per-speaker sigmoids. Marginalize: activity of speaker s = Σ probs of
    classes containing s. probs [T, 7] → activities [T, k]."""
    classes = [(), (0,), (1,), (2,), (0, 1), (0, 2), (1, 2)]
    acts = np.zeros((probs.shape[0], k), np.float32)
    for c, members in enumerate(classes[:probs.shape[1]]):
        for m in members:
            if m < k:
                acts[:, m] += probs[:, c]
    return acts


def segmentation_fn_from_onnx(path: str, device=None):
    """Back segmentation with a converted pyannote segmentation-3.0
    .onnx (reference: get_segments, src/diarization/mod.rs:266), run on
    the ONNX executor: the graph takes waveform [1, 1, N] and emits
    powerset scores [1, T, 7] (log-softmax in the published export).
    Returns fn(audio [N]) → activities [T, SEG_K]."""
    model = OnnxTorchModel.load(path, device)

    @torch.no_grad()
    def fn(audio: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(np.asarray(audio, np.float32)).to(
            model.device)[None, None, :]
        out = model(x)
        out = out[0] if isinstance(out, (tuple, list)) else out
        scores = out.cpu().numpy()[0]                       # [T, C]
        row_sum = scores.sum(axis=-1)
        if scores.max() <= 1e-6 and np.allclose(
                np.exp(scores).sum(axis=-1), 1.0, atol=0.05):
            probs = np.exp(scores)                          # log-softmax
        elif scores.min() >= 0 and np.allclose(row_sum, 1.0, atol=0.05):
            probs = scores                                  # already probs
        else:                                               # raw logits
            e = np.exp(scores - scores.max(axis=-1, keepdims=True))
            probs = e / e.sum(axis=-1, keepdims=True)
        return powerset_to_activities(probs)

    return fn


def segmentation_activities(params: dict, mel: torch.Tensor) -> torch.Tensor:
    """mel [B, T, n_mels] → activities [B, T//4, SEG_K] in (0, 1).

    Strided convs (10 ms mel hop → 40 ms activity frames), a GRU over time
    (a loop of steps, the reference's lax.scan) and per-frame sigmoid
    heads. Channel order is order-of-appearance within the window (the
    training recipe sorts labels that way)."""
    h = params["gru_wx"].shape[0]
    x = _stem(params, mel)                        # [B, T/4, hidden]
    xg_all = x @ params["gru_wx"] + params["gru_b"]
    carry = torch.zeros(mel.shape[0], h, dtype=mel.dtype, device=mel.device)
    hs = []
    for t in range(x.shape[1]):
        xg = xg_all[:, t]
        hg = carry @ params["gru_wh"]
        z = torch.sigmoid(xg[:, :h] + hg[:, :h])
        r = torch.sigmoid(xg[:, h:2 * h] + hg[:, h:2 * h])
        n = torch.tanh(xg[:, 2 * h:] + r * hg[:, 2 * h:])
        carry = (1 - z) * n + z * carry
        hs.append(carry)
    hs = torch.stack(hs, dim=1)                   # [B, T/4, hidden]
    return torch.sigmoid(hs @ params["out_w"] + params["out_b"])


def kaldi_fbank(audio: np.ndarray, n_mels: int = N_MELS) -> np.ndarray:
    """Kaldi-style log-mel fbank features for wespeaker embedders:
    25 ms/10 ms frames @16 kHz, 0.97 pre-emphasis, povey-ish (hamming)
    window, per-utterance mean normalization (wespeaker's CMN)."""
    sr, win, hop = 16000, 400, 160
    a = np.asarray(audio, np.float32)
    if len(a) < win:
        a = np.pad(a, (0, win - len(a)))
    n_frames = 1 + (len(a) - win) // hop
    idx = np.arange(n_frames)[:, None] * hop + np.arange(win)[None, :]
    frames = a[idx]
    frames = frames - 0.97 * np.concatenate(
        [frames[:, :1], frames[:, :-1]], axis=1)
    frames = frames * np.hamming(win).astype(np.float32)
    spec = np.abs(np.fft.rfft(frames, n=512, axis=1)) ** 2
    fb = mel_ops.mel_filter_bank(n_mels, 257, sr)
    feats = np.log(np.maximum(spec @ fb, 1e-10)).astype(np.float32)
    return feats - feats.mean(axis=0, keepdims=True)


@dataclasses.dataclass
class DiarizationConfig:
    similarity_threshold: float = 0.6
    max_speakers: int = 8


class EmbeddingClusterer:
    """Incremental speaker assignment by cosine similarity to running
    centroids (parity: EmbeddingManager::search_speaker semantics)."""

    def __init__(self, config: Optional[DiarizationConfig] = None):
        self.config = config or DiarizationConfig()
        self.centroids: list[np.ndarray] = []
        self.counts: list[int] = []

    def assign(self, embedding: np.ndarray) -> int:
        """Return a speaker id (0-based), creating one if below threshold
        and under the cap; else the closest existing speaker."""
        e = np.asarray(embedding, np.float64)
        e = e / (np.linalg.norm(e) + 1e-12)
        if not self.centroids:
            self.centroids.append(e.copy())
            self.counts.append(1)
            return 0
        sims = np.array([float(c @ e) for c in self.centroids])
        best = int(sims.argmax())
        if sims[best] >= self.config.similarity_threshold or \
                len(self.centroids) >= self.config.max_speakers:
            c, n = self.centroids[best], self.counts[best]
            c = (c * n + e) / (n + 1)
            self.centroids[best] = c / (np.linalg.norm(c) + 1e-12)
            self.counts[best] += 1
            return best
        self.centroids.append(e.copy())
        self.counts.append(1)
        return len(self.centroids) - 1

    @property
    def n_speakers(self) -> int:
        return len(self.centroids)


@dataclasses.dataclass
class SpeakerSegment:
    start_secs: float
    end_secs: float
    speaker_id: int


def _padded(audio: np.ndarray, n_frames: int) -> np.ndarray:
    need = n_frames * mel_ops.HOP_LENGTH
    a = np.zeros(need, np.float32)
    a[:min(len(audio), need)] = audio[:need]
    return a


class DiarizationEngine:
    """Segment audio into speaker turns: VAD for speech regions + embedding
    clustering (parity surface: DiarizationEngine, mod.rs:101-338). The
    models run on `device` (CUDA unless the caller asks for the CPU);
    missing embedder params come from a generator seeded 0."""

    def __init__(self, config: Optional[DiarizationConfig] = None,
                 params: Optional[dict] = None,
                 vad_engine=None, embedder_fn=None,
                 seg_params: Optional[dict] = None,
                 seg_fn=None, device=None):
        from openhush_tpu_torch.models.vad import VadEngine
        self.config = config or DiarizationConfig()
        self.device = resolve_device(device)
        self.params = params or init_embedder_params(
            torch.Generator(device=self.device).manual_seed(0),
            device=self.device)
        self.clusterer = EmbeddingClusterer(self.config)
        self.vad = vad_engine or VadEngine(kind="energy", device=self.device)
        self._embedder_fn = embedder_fn      # audio [T] → embedding [D]
        # Segmentation backends, either of: a converted pyannote ONNX
        # (seg_fn, audio → activities) or the in-tree trained net
        # (seg_params, training/speaker.py). When absent the fixed-window
        # VAD-substitute path runs (cannot split overlap).
        self.seg_params = seg_params
        self.seg_fn = seg_fn

    @property
    def has_segmentation(self) -> bool:
        return self.seg_fn is not None or self.seg_params is not None

    def reset(self) -> None:
        """Forget the speaker bank (new meeting/recording): multi-file
        evaluations must not let file A's speakers absorb file B's."""
        self.clusterer = EmbeddingClusterer(self.config)

    @classmethod
    def from_local(cls, config: Optional[DiarizationConfig] = None,
                   device=None) -> "DiarizationEngine":
        """Best available local checkpoints, in preference order:
        wespeaker ONNX embedder > trained npz embedder > random-init;
        plus the trained segmentation net when present. Files live in
        <model_dir>/aux/ (written by `model convert-aux` or
        `python -m openhush_tpu_torch.training.speaker`); the packaged
        fallback is the JAX package's small trained checkpoints (ASSETS:
        synthetic voices, the training/speaker.py recipe), read as data."""
        from openhush_tpu_torch.models.whisper.weights import (
            from_numpy_params, load_npz)
        from openhush_tpu_torch.runtime.engine import default_model_dir

        device = resolve_device(device)
        aux = os.path.join(default_model_dir(), "aux")

        def find(name):
            for base in (aux, ASSETS):
                p = os.path.join(base, name)
                if os.path.exists(p):
                    return p
            return None

        def load(path):
            return from_numpy_params(load_npz(path), device=device)

        seg_onnx = os.path.join(aux, "segmentation.onnx")
        seg_fn = segmentation_fn_from_onnx(seg_onnx, device) \
            if os.path.exists(seg_onnx) else None
        seg_path = find("segmentation.npz")
        seg = load(seg_path) if seg_fn is None and seg_path else None
        onnx_path = os.path.join(aux, "wespeaker.onnx")
        if os.path.exists(onnx_path):
            eng = cls.from_onnx(onnx_path, config, device)
            eng.seg_params, eng.seg_fn = seg, seg_fn
            return eng
        emb_path = find("speaker_embedder.npz")
        params = load(emb_path) if emb_path else None
        return cls(config, params=params, seg_params=seg, seg_fn=seg_fn,
                   device=device)

    @classmethod
    def from_onnx(cls, embedder_path: str,
                  config: Optional[DiarizationConfig] = None,
                  device=None) -> "DiarizationEngine":
        """Back the embedder with a converted wespeaker .onnx
        (reference: EmbeddingExtractor::compute,
        src/diarization/mod.rs:266-299), run on the ONNX executor.
        wespeaker graphs take kaldi fbank features [1, T, 80] and emit
        [1, D]."""
        device = resolve_device(device)
        model = OnnxTorchModel.load(embedder_path, device)

        @torch.no_grad()
        def fn(audio: np.ndarray) -> np.ndarray:
            feats = torch.from_numpy(kaldi_fbank(audio)[None]).to(device)
            out = model(feats)
            out = out[0] if isinstance(out, tuple) else out
            e = out.cpu().numpy().reshape(-1)
            return e / (np.linalg.norm(e) + 1e-12)

        return cls(config, embedder_fn=fn, device=device)

    @torch.no_grad()
    def embed(self, audio: np.ndarray) -> np.ndarray:
        if self._embedder_fn is not None:
            return self._embedder_fn(np.asarray(audio, np.float32))
        n_frames = max(1, len(audio) // mel_ops.HOP_LENGTH)
        a = torch.from_numpy(_padded(audio, n_frames)).to(self.device)
        return speaker_embedding(self.params, a, n_frames).cpu().numpy()

    @torch.no_grad()
    def activities(self, audio: np.ndarray) -> np.ndarray:
        """Per-frame local-speaker activities [T', K] from whichever
        segmentation backend is installed."""
        if self.seg_fn is not None:
            return np.asarray(self.seg_fn(np.asarray(audio, np.float32)))
        assert self.seg_params is not None
        n_frames = max(8, len(audio) // mel_ops.HOP_LENGTH)
        a = torch.from_numpy(_padded(audio, n_frames)).to(self.device)
        mel = log_mel_frames(a[None], n_frames)
        return segmentation_activities(self.seg_params,
                                       mel)[0].cpu().numpy()   # [T/4, K]

    def segment_regions(self, audio: np.ndarray,
                        threshold: float = 0.5,
                        min_frames: int = 3) -> list[tuple[int, int, int]]:
        """Run segmentation: (start_sample, end_sample, channel)
        contiguous active regions per local-speaker channel. Frame
        duration is inferred from the backend's output rate (40 ms for
        the in-tree net; ~17 ms for pyannote exports)."""
        acts = self.activities(audio)
        regions = []
        frame = max(1, len(audio) // max(1, acts.shape[0]))  # samples/frame
        for ch in range(acts.shape[1]):
            active = acts[:, ch] >= threshold
            start = None
            for t, on in enumerate(list(active) + [False]):
                if on and start is None:
                    start = t
                elif not on and start is not None:
                    if t - start >= min_frames:
                        regions.append((start * frame,
                                        min(t * frame, len(audio)), ch))
                    start = None
        regions.sort()
        return regions

    def diarize_chunk(self, audio: np.ndarray,
                      offset_secs: float = 0.0,
                      window_secs: float = 1.5) -> list[SpeakerSegment]:
        """Assign speakers: trained-segmentation regions when available
        (separates overlap), fixed windows otherwise."""
        sr = 16000
        if self.has_segmentation:
            segments = []
            for s0, s1, _ch in self.segment_regions(audio):
                piece = audio[s0:s1]
                if len(piece) < sr // 4:
                    continue
                sid = self.clusterer.assign(self.embed(piece))
                segments.append(SpeakerSegment(
                    offset_secs + s0 / sr, offset_secs + s1 / sr, sid))
            return segments
        win = int(window_secs * sr)
        segments: list[SpeakerSegment] = []
        for start in range(0, max(1, len(audio) - win // 2), win):
            piece = audio[start:start + win]
            if len(piece) < sr // 4:
                break
            if float(np.sqrt(np.mean(piece ** 2))) < 1e-4:
                continue  # silence — skip embedding
            sid = self.clusterer.assign(self.embed(piece))
            segments.append(SpeakerSegment(
                offset_secs + start / sr,
                offset_secs + min(start + win, len(audio)) / sr, sid))
        # Merge adjacent same-speaker windows.
        merged: list[SpeakerSegment] = []
        for s in segments:
            if merged and merged[-1].speaker_id == s.speaker_id and \
                    abs(merged[-1].end_secs - s.start_secs) < 1e-6:
                merged[-1] = SpeakerSegment(merged[-1].start_secs,
                                            s.end_secs, s.speaker_id)
            else:
                merged.append(s)
        return merged
