"""TOML config system, schema-compatible with the reference's
~/.config/openhush/config.toml (src/config.rs:133-1247).

Implemented as dataclasses with per-field defaults so partial configs work
(the reference uses serde #[serde(default)] the same way). Sections are added
as their subsystems land; unknown sections/keys are preserved on save.

A copy of openhush_tpu/utils/config.py, so the port imports nothing of
the JAX package; `validate` checks the model against the port's own
models/whisper/config.CONFIGS. `transcription.device` stays a string
whose default is "tpu", so that a file written by either package reads
and writes back byte for byte; the port never hands it to torch.device
(the reference reads it nowhere either).
"""

from __future__ import annotations

import dataclasses
import os
import tomllib
from typing import Any, Optional

CONFIG_ENV = "OPENHUSH_CONFIG"


def config_path() -> str:
    if os.environ.get(CONFIG_ENV):
        return os.environ[CONFIG_ENV]
    xdg = os.environ.get("XDG_CONFIG_HOME",
                         os.path.join(os.path.expanduser("~"), ".config"))
    return os.path.join(xdg, "openhush", "config.toml")


@dataclasses.dataclass
class TranscriptionConfig:
    """Parity: transcription section incl. presets instant=small,
    balanced=medium, quality=large-v3 (src/config.rs:615-638)."""
    model: str = "base"
    preset: str = "custom"           # instant|balanced|quality|custom
    language: str = "auto"
    translate: bool = False
    device: str = "tpu"
    # Speculative decoding (beyond-parity): a shallow-decoder draft
    # sharing the model's encoder, e.g. "large-v3-turbo" for large-v3.
    # Empty = off. Token-exact; speed-only.
    draft_model: str = ""
    # Unload the model from device memory after this many seconds of
    # inactivity; 0 = keep resident (parity: transcription.
    # idle_unload_secs, src/config.rs:667,1156; daemon.rs:2181-2234).
    idle_unload_secs: int = 0
    # Compile every admission shape at model load (one synchronous round
    # of silent windows per prep bucket) so no live window ever pays a
    # cold-bucket compile in first-partial latency. Beyond-parity knob:
    # XLA compiles per batch shape, a concern the reference's CUDA
    # engines don't have.
    warmup_on_load: bool = True

    PRESETS = {"instant": "small", "balanced": "medium",
               "quality": "large-v3"}

    def effective_model(self) -> str:
        return self.PRESETS.get(self.preset, self.model)


@dataclasses.dataclass
class HotkeyConfig:
    key: str = "F9"
    mode: str = "push_to_talk"       # push_to_talk|toggle|continuous


@dataclasses.dataclass
class AudioConfig:
    device: str = ""
    sample_rate: int = 16000
    channels: list = dataclasses.field(default_factory=list)
    normalization_enabled: bool = True
    normalization_target_db: float = -20.0
    compression_enabled: bool = False
    compression_threshold_db: float = -20.0
    compression_ratio: float = 4.0
    compression_attack_ms: float = 5.0
    compression_release_ms: float = 50.0
    compression_makeup_gain_db: float = 0.0
    limiter_enabled: bool = True
    limiter_ceiling_db: float = -1.0
    limiter_release_ms: float = 50.0
    noise_reduction_enabled: bool = False
    noise_reduction_strength: float = 1.0
    resampling_quality: str = "sinc"  # sinc|linear


@dataclasses.dataclass
class QueueConfig:
    """Parity: queue section (src/config.rs:860-897): backpressure strategy
    + auto-tuned chunk interval when <= 0. max_pending = 0 means
    unlimited (reference semantics, config.example.toml [queue])."""
    max_pending: int = 10
    backpressure: str = "drop_oldest"   # drop_oldest|drop_newest|warn
    chunk_interval_secs: float = 0.0     # <=0 → auto-tune at startup
    # Auto-tuned interval = measured overhead × (1 + margin) (parity:
    # chunk_safety_margin, src/config.rs:892-895,1094).
    chunk_safety_margin: float = 0.2
    separator: str = " "                 # joiner between pasted chunks


@dataclasses.dataclass
class VadConfig:
    enabled: bool = True
    threshold: float = 0.5
    min_speech_ms: int = 250
    min_silence_ms: int = 700
    pad_ms: int = 30
    # engine selection (superset of the reference schema, which always
    # runs Silero): energy (weight-free default) | gru | silero.
    engine: str = "energy"
    model_path: str = ""             # converted silero .npz / .onnx


@dataclasses.dataclass
class WakeWordConfig:
    enabled: bool = False
    model: str = "hey_jarvis"
    threshold: float = 0.5
    # converted openWakeWord stages (openhush model convert-aux …)
    embedding_path: str = ""
    classifier_path: str = ""


@dataclasses.dataclass
class ApiConfig:
    enabled: bool = False
    host: str = "127.0.0.1"
    port: int = 8765
    api_key_hash: str = ""           # SHA-256 hex of the API key
    cors_origins: list = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class OutputConfig:
    """The reference schema expresses output as two booleans
    (config.example.toml [output] clipboard/paste); `mode` is the
    derived form the handlers consume — from_dict keeps them in sync
    whichever shape the file uses."""
    mode: str = "both"               # clipboard|paste|both|none
    paste_method: str = "type"       # type|ctrl_v|xdotool
    actions: list = dataclasses.field(default_factory=list)  # action tables

    def set_flags(self, clipboard: bool, paste: bool) -> None:
        self.mode = {(True, True): "both", (True, False): "clipboard",
                     (False, True): "paste",
                     (False, False): "none"}[(clipboard, paste)]

    @property
    def clipboard(self) -> bool:
        return self.mode in ("both", "clipboard")

    @property
    def paste(self) -> bool:
        return self.mode in ("both", "paste")


@dataclasses.dataclass
class VocabularyConfig:
    path: str = ""                   # vocabulary.toml location
    reload_interval_secs: float = 5.0


@dataclasses.dataclass
class CorrectionSection:
    enabled: bool = False
    ollama_url: str = "http://localhost:11434"
    model: str = "llama3.2:1b"
    remove_fillers: bool = True
    filler_mode: str = "moderate"    # conservative|moderate|aggressive
    timeout_secs: float = 30.0


@dataclasses.dataclass
class TranslationSection:
    enabled: bool = False
    backend: str = "ollama"          # ollama|m2m100|whisper
    target_language: str = "en"
    ollama_url: str = "http://localhost:11434"
    ollama_model: str = "llama3.2:1b"


@dataclasses.dataclass
class SummarizationConfig:
    """Accepts both the flat repo shape and the reference's nested
    [summarization.ollama]/[summarization.openai] tables +
    default_provider/default_template keys (src/config.rs summarization
    sections, config.example.toml:77-113)."""
    enabled: bool = True
    provider: str = "ollama"         # ollama|openai
    default_template: str = "meeting"
    ollama_url: str = "http://localhost:11434"
    model: str = "llama3.2:1b"
    ollama_timeout_secs: float = 120.0
    openai_url: str = "https://api.openai.com/v1"
    openai_model: str = "gpt-4o-mini"
    openai_timeout_secs: float = 120.0
    api_key: str = ""                # or keyring:NAME indirection
    templates_path: str = ""

    def absorb_reference_keys(self, raw: dict) -> dict:
        """Map reference-schema keys/subtables onto this shape; returns
        the keys it consumed."""
        used = {}
        if "default_provider" in raw:
            self.provider = used["default_provider"] = raw[
                "default_provider"]
        oll = raw.get("ollama")
        if isinstance(oll, dict):
            used["ollama"] = oll
            self.ollama_url = oll.get("url", self.ollama_url)
            self.model = oll.get("model", self.model)
            self.ollama_timeout_secs = float(
                oll.get("timeout_secs", self.ollama_timeout_secs))
        oai = raw.get("openai")
        if isinstance(oai, dict):
            used["openai"] = oai
            self.api_key = oai.get("api_key", self.api_key)
            self.openai_model = oai.get("model", self.openai_model)
            self.openai_url = oai.get("base_url", self.openai_url)
            self.openai_timeout_secs = float(
                oai.get("timeout_secs", self.openai_timeout_secs))
        return used


@dataclasses.dataclass
class GpuConfig:
    """Parity: [gpu] section (src/config.rs:899-908) — accepted and
    persisted; on a TPU host `devices` selects visible TPU chips when
    non-empty (the reference never consumes it at all)."""
    auto_detect: bool = True
    devices: list = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class FeedbackConfig:
    """Parity: [feedback] section (config.example.toml:51-57) — beep /
    desktop notification on recording start/stop."""
    audio: bool = True
    visual: bool = True


@dataclasses.dataclass
class LoggingConfig:
    level: str = "info"
    file_enabled: bool = False


@dataclasses.dataclass
class Config:
    transcription: TranscriptionConfig = dataclasses.field(
        default_factory=TranscriptionConfig)
    hotkey: HotkeyConfig = dataclasses.field(default_factory=HotkeyConfig)
    audio: AudioConfig = dataclasses.field(default_factory=AudioConfig)
    queue: QueueConfig = dataclasses.field(default_factory=QueueConfig)
    vad: VadConfig = dataclasses.field(default_factory=VadConfig)
    wake_word: WakeWordConfig = dataclasses.field(
        default_factory=WakeWordConfig)
    api: ApiConfig = dataclasses.field(default_factory=ApiConfig)
    output: OutputConfig = dataclasses.field(default_factory=OutputConfig)
    vocabulary: VocabularyConfig = dataclasses.field(
        default_factory=VocabularyConfig)
    correction: CorrectionSection = dataclasses.field(
        default_factory=CorrectionSection)
    translation: TranslationSection = dataclasses.field(
        default_factory=TranslationSection)
    summarization: SummarizationConfig = dataclasses.field(
        default_factory=SummarizationConfig)
    gpu: GpuConfig = dataclasses.field(default_factory=GpuConfig)
    feedback: FeedbackConfig = dataclasses.field(
        default_factory=FeedbackConfig)
    logging: LoggingConfig = dataclasses.field(default_factory=LoggingConfig)
    # Per-app overrides (parity: AppProfile list, src/config.rs:223-263):
    # [[profiles]] name / app_match / vocabulary_path / filler_mode / preset.
    profiles: list = dataclasses.field(default_factory=list)
    extra: dict = dataclasses.field(default_factory=dict)

    # -- load/save -----------------------------------------------------------

    @classmethod
    def load_or_default(cls, path: Optional[str] = None) -> "Config":
        path = path or config_path()
        if not os.path.exists(path):
            return cls()
        with open(path, "rb") as f:
            raw = tomllib.load(f)
        return cls.from_dict(raw)

    # Reference-schema key aliases (src/config.rs field names) → ours.
    _ALIASES = {
        "correction": {"ollama_model": "model"},
    }

    @classmethod
    def from_dict(cls, raw: dict) -> "Config":
        cfg = cls()
        known = {f.name: f for f in dataclasses.fields(cls)
                 if f.name != "extra"}
        for section, value in raw.items():
            if section == "profiles" and isinstance(value, list):
                cfg.profiles = value
            elif section in known and isinstance(value, dict):
                target = getattr(cfg, section)
                if section == "summarization":
                    value = dict(value)
                    for k in target.absorb_reference_keys(value):
                        value.pop(k)
                field_names = {f.name for f in dataclasses.fields(target)}
                aliases = cls._ALIASES.get(section, {})
                out_flags = {}
                for k, v in value.items():
                    if section == "output" and k in ("clipboard", "paste"):
                        out_flags[k] = bool(v)
                    elif k in field_names:
                        setattr(target, k, v)
                    elif k in aliases:
                        setattr(target, aliases[k], v)
                    else:
                        cfg.extra.setdefault(section, {})[k] = v
                if out_flags:
                    target.set_flags(
                        out_flags.get("clipboard", target.clipboard),
                        out_flags.get("paste", target.paste))
            else:
                cfg.extra[section] = value
        return cfg

    def to_dict(self) -> dict:
        out: dict[str, Any] = {}
        for f in dataclasses.fields(self):
            if f.name in ("extra", "profiles"):
                continue
            section = getattr(self, f.name)
            d = dataclasses.asdict(section)
            d.pop("PRESETS", None)
            out[f.name] = d
        if self.profiles:
            out["profiles"] = list(self.profiles)
        for section, value in self.extra.items():
            if section in out and isinstance(value, dict):
                out[section].update(value)
            else:
                out[section] = value
        return out

    def save(self, path: Optional[str] = None) -> None:
        path = path or config_path()
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            f.write(dumps_toml(self.to_dict()))

    # -- validation (parity: Config::validate, src/config.rs:1286) ----------

    def validate(self) -> list[str]:
        errors = []
        from openhush_tpu_torch.models.whisper.config import CONFIGS
        if self.transcription.effective_model() not in CONFIGS:
            errors.append(
                f"unknown model {self.transcription.effective_model()!r}")
        if self.transcription.preset not in (
                "instant", "balanced", "quality", "custom"):
            errors.append(f"unknown preset {self.transcription.preset!r}")
        if not 0.0 <= self.vad.threshold <= 1.0:
            errors.append("vad.threshold must be in [0, 1]")
        if self.queue.max_pending < 0:
            errors.append("queue.max_pending must be >= 0 (0 = unlimited)")
        if self.queue.backpressure not in ("drop_oldest", "drop_newest",
                                           "warn"):
            errors.append(
                f"unknown backpressure {self.queue.backpressure!r}")
        if not 1 <= self.api.port <= 65535:
            errors.append("api.port out of range")
        return errors


def dumps_toml(d: dict) -> str:
    """Minimal TOML writer (stdlib has no dumper)."""
    lines = []

    def fmt(v):
        if isinstance(v, bool):
            return "true" if v else "false"
        if isinstance(v, (int, float)):
            return repr(v)
        if isinstance(v, list):
            return "[" + ", ".join(fmt(x) for x in v) + "]"
        s = str(v).replace("\\", "\\\\").replace('"', '\\"')
        return f'"{s}"'

    def is_table_array(v):
        return (isinstance(v, list) and v
                and all(isinstance(x, dict) for x in v))

    def walk(prefix: str, table: dict):
        scalars = {k: v for k, v in table.items()
                   if not isinstance(v, dict) and not is_table_array(v)}
        subs = {k: v for k, v in table.items() if isinstance(v, dict)}
        arrays = {k: v for k, v in table.items() if is_table_array(v)}
        if prefix:
            lines.append(f"[{prefix}]")
        for k, v in scalars.items():
            lines.append(f"{k} = {fmt(v)}")
        if scalars or prefix:
            lines.append("")
        for k, v in subs.items():
            walk(f"{prefix}.{k}" if prefix else k, v)
        for k, entries in arrays.items():
            name = f"{prefix}.{k}" if prefix else k
            for entry in entries:
                lines.append(f"[[{name}]]")
                for ek, ev in entry.items():
                    lines.append(f"{ek} = {fmt(ev)}")
                lines.append("")

    walk("", d)
    return "\n".join(lines)
