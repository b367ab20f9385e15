"""WhisperEngine: model lifecycle + long-form transcription, on the GPU.

Port of openhush_tpu/runtime/engine.py: loads a checkpoint in the JAX
package's npz layout (or takes injected parameters, or random weights:
`random_init` says which), and runs the 30 s-window seek loop with temperature fallback,
previous-text conditioning, timestamp segmentation, language detection and
the translate flag — whisper.cpp's `full` pipeline, which the reference
drives at src/engine/whisper.rs:204-305.

Per window: log-mel on the frontend kernel, the encoder (flash-attention
kernel), the cross-KV (int8 on the per-head quantize kernel when the
weights are bf16, as in production; fp with fp32 weights), language
detection, then decoding under the temperature ladder: beam search at
T=0 when `transcribe` is given a beam_size (models/whisper/beam.py), else
speculative decoding at T=0 when a draft model is loaded
(models/whisper/speculative.py), else greedy; the rungs at T > 0 sample.

The int8 rungs resolve as the reference's: int8 decoder weights
(`quantize_weights`) and the W8A8 encoder (`quantize_encoder`), see
utils/quant_flags.py. A draft model (`draft_model`, else
OPENHUSH_DRAFT_MODEL) turns the T=0 rung into speculative decoding: a
shallower decoder that shares this model's encoder (large-v3-turbo for
large-v3) proposes tokens, and the output stays the greedy loop's.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
import zlib
from typing import Optional

import numpy as np
import torch

from openhush_tpu_torch.device import resolve_device
from openhush_tpu_torch.models.whisper import beam, decoding, speculative
from openhush_tpu_torch.models.whisper import model as whisper
from openhush_tpu_torch.models.whisper.config import get_config
from openhush_tpu_torch.models.whisper.weights import (from_numpy_params,
                                                        init_params, load_npz)
from openhush_tpu_torch.ops import frontend, mel as mel_ops
from openhush_tpu_torch.runtime import validation
from openhush_tpu_torch.text.tokenizer import WhisperTokenizer
from openhush_tpu_torch.utils.quant_flags import (int8_encoder_enabled,
                                                  int8_rung_enabled)

log = logging.getLogger(__name__)

# Temperature fallback schedule + acceptance thresholds (whisper defaults,
# the same heuristics whisper.cpp replicates). OPENHUSH_NO_FALLBACK=1
# disables the ladder (tests / latency-critical streaming).
TEMPERATURES = ((0.0,) if os.environ.get("OPENHUSH_NO_FALLBACK") == "1"
                else (0.0, 0.2, 0.4, 0.6, 0.8, 1.0))
COMPRESSION_RATIO_THRESHOLD = 2.4
LOGPROB_THRESHOLD = -1.0
NO_SPEECH_THRESHOLD = 0.6

FRAMES_PER_SECOND = 100          # mel frames / s (hop 160 @ 16 kHz)
TIME_PRECISION = 0.02            # seconds per timestamp token


@dataclasses.dataclass
class Segment:
    id: int
    start: float
    end: float
    text: str
    tokens: list[int]
    avg_logprob: float
    no_speech_prob: float
    compression_ratio: float
    temperature: float


@dataclasses.dataclass
class TranscriptionResult:
    text: str
    language: str
    segments: list[Segment]
    duration_ms: int                  # engine-side processing time
    windows: int = 0                  # 30 s seek-loop windows decoded


def compression_ratio(text: str) -> float:
    data = text.encode("utf-8")
    if not data:
        return 0.0
    return len(data) / len(zlib.compress(data))


def parse_window_segments(tokenizer, content: list[int], time_offset: float,
                          segment_duration: float, segment_frames: int, *,
                          avg_logprob: float, no_speech_prob: float,
                          compression_ratio: float, temperature: float
                          ) -> tuple[list[Segment], int]:
    """Split one 30 s window's tokens into timestamped segments and compute
    the seek advance — whisper's timestamp-pair consumption logic."""
    sp = tokenizer.special
    ts = np.array([t >= sp.timestamp_begin for t in content], bool)
    mk = lambda start, end, toks: Segment(
        id=0, start=start, end=end,
        text=tokenizer.decode(toks),
        tokens=[t for t in toks if t < sp.eot],
        avg_logprob=avg_logprob, no_speech_prob=no_speech_prob,
        compression_ratio=compression_ratio, temperature=temperature)

    if len(content) == 0:
        return [], segment_frames

    single_ending = (len(content) >= 2 and ts[-1] and not ts[-2])
    consecutive = [i + 1 for i in range(len(content) - 1)
                   if ts[i] and ts[i + 1]]
    segments: list[Segment] = []
    if consecutive:
        slices = list(consecutive)
        if single_ending:
            slices.append(len(content))
        last = 0
        for cur in slices:
            sliced = content[last:cur]
            start_t = (sliced[0] - sp.timestamp_begin) * TIME_PRECISION
            end_t = (sliced[-1] - sp.timestamp_begin) * TIME_PRECISION
            segments.append(mk(time_offset + start_t,
                               time_offset + end_t, sliced[1:-1]))
            last = cur
        if single_ending:
            frames_advance = segment_frames
        else:
            last_ts = content[last - 1] - sp.timestamp_begin
            frames_advance = max(
                1, int(last_ts * TIME_PRECISION * FRAMES_PER_SECOND))
    else:
        duration = segment_duration
        ts_tokens = [t for t in content if t >= sp.timestamp_begin]
        if ts_tokens and ts_tokens[-1] != sp.timestamp_begin:
            duration = (ts_tokens[-1] - sp.timestamp_begin) \
                * TIME_PRECISION
        segments.append(mk(time_offset, time_offset + duration,
                           [t for t in content
                            if t < sp.timestamp_begin]))
        frames_advance = segment_frames
    return segments, max(1, frames_advance)


def default_model_dir() -> str:
    return os.environ.get(
        "OPENHUSH_MODEL_DIR",
        os.path.join(os.path.expanduser("~"), ".local", "share",
                     "openhush-tpu", "models"))


_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _resolve_switches(quantize_weights, quantize_encoder, draft_model
                      ) -> tuple[bool, bool, Optional[str]]:
    """The int8 and draft switches as the reference's engine resolves them
    (openhush_tpu/runtime/engine.py:189-234) → (quantize_weights,
    quantize_encoder, draft_model). quantize_weights: the argument, else
    OPENHUSH_INT8_WEIGHTS (a hard switch both ways), else the int8 rung;
    quantize_encoder: the argument, else int8_encoder_enabled();
    draft_model: the argument, else OPENHUSH_DRAFT_MODEL, else None."""
    draft_model = draft_model or os.environ.get("OPENHUSH_DRAFT_MODEL") or None
    if quantize_weights is None:
        env_w = os.environ.get("OPENHUSH_INT8_WEIGHTS")
        quantize_weights = (env_w == "1" if env_w is not None
                            else int8_rung_enabled())
    if quantize_encoder is None:
        quantize_encoder = int8_encoder_enabled()
    return bool(quantize_weights), bool(quantize_encoder), draft_model


class WhisperEngine:
    """One loaded Whisper model on one device.

    Parity: WhisperEngine (src/engine/whisper.rs:110-179) — `new` loads the
    model; `transcribe` runs the full pipeline. `device` None means CUDA
    (and raises without a GPU); tests pass "cpu".
    """

    def __init__(self, model: str = "tiny",
                 model_path: Optional[str] = None,
                 language: str = "auto", translate: bool = False,
                 dtype: str = "bfloat16",
                 vocab_dir: Optional[str] = None,
                 allow_random_init: bool = False,
                 quantize_weights: Optional[bool] = None,
                 quantize_encoder: Optional[bool] = None,
                 draft_model: Optional[str] = None,
                 params=None, device=None):
        quantize_weights, quantize_encoder, draft_model = _resolve_switches(
            quantize_weights, quantize_encoder, draft_model)
        self.device = resolve_device(device)
        self.cfg = get_config(model)
        self.model_name = model
        self.language = language
        self.translate = translate
        self.dtype = _DTYPES[dtype]

        path = model_path or os.path.join(default_model_dir(),
                                          f"{model}.npz")
        if params is not None:
            # Injected parameters (tests, benchmarks): used as given, and
            # the activation dtype follows them.
            self.params = params
            self.dtype = params["decoder"]["pos_emb"].dtype
            self.random_init = False
        elif os.path.exists(path):
            self.params = from_numpy_params(load_npz(path), self.dtype,
                                            self.device)
            self.random_init = False
        elif allow_random_init:
            gen = torch.Generator(device=self.device).manual_seed(0)
            self.params = init_params(self.cfg, gen, self.dtype, self.device)
            self.random_init = True
        else:
            raise FileNotFoundError(
                f"Model not found: {path}\n"
                f"This package cannot convert checkpoints yet (ROADMAP "
                f"A9c). Convert a HF checkpoint with the JAX package's "
                f"CLI, whose npz this package reads: python -m "
                f"openhush_tpu.cli model convert {model} "
                f"--hf-path /path/to/hf_checkpoint")
        if quantize_weights:
            # int8 decoder weights, per output channel (the dense leaves
            # stay shared with the tree they came from).
            self.params = whisper.quantize_decoder_weights(self.params)
        if quantize_encoder:
            # The W8A8 encoder: int8 weights and per-row int8 activations.
            self.params = whisper.quantize_encoder_weights(self.params)
        self.tokenizer = WhisperTokenizer.for_model(
            model, vocab_dir or os.path.dirname(path))
        # Speculative decoding (token-exact, speed only): a shallower
        # decoder sharing this model's encoder drafts the T=0 rung's tokens.
        self.draft_cfg = self.draft_params = None
        if draft_model:
            self._init_draft(draft_model, allow_random_init)

    def _init_draft(self, draft_model: str, allow_random_init: bool) -> None:
        """Load the draft as the reference does (engine.py:236-264): an
        incompatible one (vocab, encoder width or context) or a missing
        checkpoint without allow_random_init logs a warning and leaves
        speculation off; random weights come from a generator seeded 1."""
        dcfg = get_config(draft_model)
        if (dcfg.n_vocab != self.cfg.n_vocab
                or dcfg.n_audio_state != self.cfg.n_audio_state
                or dcfg.n_audio_ctx != self.cfg.n_audio_ctx):
            log.warning(
                "draft model %s incompatible with %s (vocab/encoder dims "
                "differ); speculative decoding disabled", draft_model,
                self.model_name)
            return
        dpath = os.path.join(default_model_dir(), f"{draft_model}.npz")
        if os.path.exists(dpath):
            dparams = from_numpy_params(load_npz(dpath), self.dtype,
                                        self.device)
        elif allow_random_init:
            gen = torch.Generator(device=self.device).manual_seed(1)
            dparams = init_params(dcfg, gen, self.dtype, self.device)
        else:
            log.warning("draft model checkpoint missing (%s); speculative "
                        "decoding disabled", dpath)
            return
        self.draft_cfg, self.draft_params = dcfg, dparams
        log.info("speculative decoding: %s drafts for %s", draft_model,
                 self.model_name)

    def _draft_cross_kv(self, feats: torch.Tensor):
        """The draft's cross-KV from the same encoder features: fp, in the
        engine's dtype (the reference's engine.py:260); None without a
        draft."""
        if self.draft_cfg is None:
            return None
        return whisper.compute_cross_kv(self.draft_cfg, self.draft_params,
                                        feats)

    def _cross_kv(self, feats: torch.Tensor):
        # Production (bf16) path quantizes cross-KV to int8: halves the
        # dominant decode-step read of the cross-attention cache.
        if self.dtype == torch.bfloat16:
            return whisper.compute_cross_kv_quant(self.cfg, self.params, feats)
        return whisper.compute_cross_kv(self.cfg, self.params, feats)

    # -- single-window decode with temperature fallback ----------------------

    def _decode_window(self, cross_kv, language: str,
                       prompt_ids: list[int],
                       opts: decoding.DecodingOptions, draft_xkv=None
                       ) -> tuple[decoding.DecodingResult, float, str]:
        """Run decode with whisper's temperature fallback ladder. Returns
        (result, compression_ratio, text) for batch row 0. The T=0 rung runs
        beam search when opts.beam_size is set, else speculative decoding
        when draft_xkv (the draft's cross-KV) is given; rung i > 0 samples
        from a generator seeded i."""
        tok = self.tokenizer
        for ti, t in enumerate(TEMPERATURES):
            o = dataclasses.replace(opts, temperature=t,
                                    language=language)
            if t == 0.0 and opts.beam_size:
                result = beam.decode_beam(self.cfg, self.params, cross_kv,
                                          tok, o, prompt_ids=prompt_ids)
            elif t == 0.0 and draft_xkv is not None:
                result = speculative.decode_speculative(
                    self.cfg, self.params, self.draft_cfg, self.draft_params,
                    cross_kv, draft_xkv, tok, o, prompt_ids=prompt_ids)
            else:
                result = decoding.decode_greedy(
                    self.cfg, self.params, cross_kv, tok, o,
                    prompt_ids=prompt_ids,
                    rng=torch.Generator(device=self.device).manual_seed(ti))
            content = self._content_tokens(result)
            text = tok.decode(content)
            cr = compression_ratio(text)
            needs_fallback = (
                cr > COMPRESSION_RATIO_THRESHOLD
                or result.avg_logprob[0] < LOGPROB_THRESHOLD)
            if result.no_speech_prob[0] > NO_SPEECH_THRESHOLD and \
                    result.avg_logprob[0] < LOGPROB_THRESHOLD:
                break  # silence: fallback won't help
            if not needs_fallback or t == TEMPERATURES[-1]:
                break
        return result, cr, text

    def _content_tokens(self, result: decoding.DecodingResult,
                        row: int = 0) -> list[int]:
        eot = self.tokenizer.special.eot
        toks = result.tokens[row, result.prompt_len:]
        out = []
        for t in toks:
            if t == eot:
                break
            out.append(int(t))
        return out

    # -- long-form transcription ---------------------------------------------

    @torch.inference_mode()
    def transcribe(self, audio: np.ndarray,
                   language: Optional[str] = None,
                   translate: Optional[bool] = None,
                   without_timestamps: bool = False,
                   condition_on_previous_text: bool = True,
                   beam_size: Optional[int] = None,
                   max_new_tokens: Optional[int] = None,
                   ) -> TranscriptionResult:
        """Transcribe mono 16 kHz float32 audio of any length (validated to
        the same limits as the reference FFI guard)."""
        t0 = time.monotonic()
        validation.validate_audio(audio)
        language = language if language is not None else self.language
        translate = self.translate if translate is None else translate
        task = "translate" if translate else "transcribe"
        tok = self.tokenizer
        sp = tok.special

        audio = np.asarray(audio, dtype=np.float32)
        n_samples = len(audio)
        content_frames = n_samples // mel_ops.HOP_LENGTH

        detected_language: Optional[str] = None
        if language not in ("auto", "", None):
            detected_language = language

        segments: list[Segment] = []
        all_tokens: list[int] = []
        prompt_reset_since = 0
        seek = 0  # in mel frames
        windows = 0

        opts = decoding.DecodingOptions(
            task=task, without_timestamps=without_timestamps,
            beam_size=beam_size,
            max_new_tokens=(max_new_tokens
                            or decoding.DecodingOptions.max_new_tokens))

        while seek < content_frames:
            windows += 1
            time_offset = seek * mel_ops.HOP_LENGTH / mel_ops.SAMPLE_RATE
            window = audio[seek * mel_ops.HOP_LENGTH:
                           seek * mel_ops.HOP_LENGTH + mel_ops.N_SAMPLES]
            segment_frames = min(len(window) // mel_ops.HOP_LENGTH,
                                 content_frames - seek)
            segment_duration = segment_frames / FRAMES_PER_SECOND
            window = torch.from_numpy(mel_ops.pad_or_trim(window)).to(
                self.device)
            mel = frontend.log_mel(window[None], n_mels=self.cfg.n_mels)
            feats = whisper.encode(self.cfg, self.params,
                                   mel.to(self.dtype))
            cross_kv = self._cross_kv(feats)
            draft_xkv = self._draft_cross_kv(feats)

            if detected_language is None:
                langs, _ = decoding.detect_language(
                    self.cfg, self.params, cross_kv, tok)
                detected_language = langs[0]

            prompt_ids: list[int] = []
            if condition_on_previous_text and all_tokens[prompt_reset_since:]:
                prev = all_tokens[prompt_reset_since:]
                room = self.cfg.n_text_ctx // 2 - 1
                prompt_ids = [sp.start_of_prev] + prev[-room:]

            result, cr, text = self._decode_window(
                cross_kv, detected_language, prompt_ids, opts,
                draft_xkv=draft_xkv)
            content = self._content_tokens(result)

            # Silence skip (whisper's no_speech rule).
            if (result.no_speech_prob[0] > NO_SPEECH_THRESHOLD
                    and result.avg_logprob[0] < LOGPROB_THRESHOLD):
                seek += segment_frames
                continue

            new_segments, frames_advance = parse_window_segments(
                tok, content, time_offset, segment_duration, segment_frames,
                avg_logprob=float(result.avg_logprob[0]),
                no_speech_prob=float(result.no_speech_prob[0]),
                compression_ratio=cr, temperature=float(result.temperature))
            for s in new_segments:
                s.id = len(segments)
                segments.append(s)
                all_tokens.extend(s.tokens)
            seek += frames_advance

            if not condition_on_previous_text or result.temperature > 0.5:
                prompt_reset_since = len(all_tokens)

        text = "".join(s.text for s in segments).strip()
        duration_ms = int((time.monotonic() - t0) * 1000)
        return TranscriptionResult(
            text=text, language=detected_language or "en",
            segments=segments, duration_ms=duration_ms, windows=windows)

    # -- startup benchmark (chunk-interval auto-tune) ------------------------

    def benchmark_chunk_interval(self, margin: float = 0.2,
                                 fallback: float = 5.0) -> float:
        """Measure transcription overhead on 2 s of silence and derive the
        streaming chunk interval = overhead × (1+margin), clamped to
        [0.5, 4 x fallback]. Parity: src/engine/whisper.rs:329-382, as
        openhush_tpu/runtime/engine.py's; the first call warms the kernels
        (their build on the card) and is not timed. A failure falls back to
        `fallback` on the CPU, as the reference's does; on the card it
        propagates, so that a kernel that fails to build or launch stops
        the daemon's start instead of hiding behind a fixed interval."""
        silence = np.zeros(2 * mel_ops.SAMPLE_RATE, np.float32)
        try:
            self.transcribe(silence, language="en")
            t0 = time.monotonic()
            self.transcribe(silence, language="en")
            overhead = time.monotonic() - t0
            return max(0.5, min(fallback * 4, overhead * (1.0 + margin)))
        except Exception:  # noqa: BLE001 — fall back to a fixed interval
            if self.device.type == "cuda":
                raise
            return fallback
