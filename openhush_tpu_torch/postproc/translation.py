"""Translation layer: Whisper-native, Ollama, or M2M-100 backends.

Parity: src/translation/mod.rs:136-193 (Translator enum), ollama.rs (prompt
translation). The reference's primary any→English path is Whisper's built-in
translate task — here that's a first-class decode option (engine translate
flag), so the Translator covers the *arbitrary target language* case. The
M2M-100 JAX seq2seq backend registers when a converted checkpoint exists
(models/m2m100.py); until then requesting it raises a clear error.

Sentence coherence: chunks route through SentenceBuffer so backends receive
complete sentences (translation/mod.rs sentence-buffered path).

A copy of openhush_tpu/postproc/translation.py; backend 'm2m100' runs
the port's models/m2m100.py on the card.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Optional

from openhush_tpu_torch.text.sentence_buffer import SentenceBuffer
from openhush_tpu_torch.utils.http import HttpError, request_json

log = logging.getLogger(__name__)


@dataclasses.dataclass
class TranslationConfig:
    enabled: bool = False
    backend: str = "ollama"            # ollama | m2m100 | whisper
    target_language: str = "en"
    ollama_url: str = "http://localhost:11434"
    ollama_model: str = "llama3.2:1b"
    timeout_secs: float = 60.0


class OllamaTranslator:
    """Parity: src/translation/ollama.rs (prompt-based translation)."""

    def __init__(self, config: TranslationConfig):
        self.config = config

    def translate(self, text: str, target: Optional[str] = None) -> str:
        target = target or self.config.target_language
        prompt = (
            f"Translate the following text to {target}. Return only the "
            f"translation, nothing else.\n\nText: {text}\n\nTranslation:")
        try:
            resp = request_json(
                f"{self.config.ollama_url}/api/generate", method="POST",
                payload={"model": self.config.ollama_model,
                         "prompt": prompt, "stream": False},
                timeout=self.config.timeout_secs)
        except HttpError as e:
            log.warning("Translation unavailable: %s", e)
            return text
        out = str(resp.get("response", "")).strip()
        return out or text


class Translator:
    """Backend mux + sentence buffering (src/translation/mod.rs:136-193)."""

    def __init__(self, config: Optional[TranslationConfig] = None):
        self.config = config or TranslationConfig()
        self.buffer = SentenceBuffer()
        if self.config.backend == "ollama":
            self._backend = OllamaTranslator(self.config)
        elif self.config.backend == "m2m100":
            from openhush_tpu_torch.models import m2m100
            self._backend = m2m100.M2M100Translator(self.config)
        elif self.config.backend == "whisper":
            # Whisper translate handles any→en inside the decode loop; the
            # Translator becomes a pass-through.
            self._backend = None
        else:
            raise ValueError(f"unknown backend {self.config.backend!r}")

    def translate(self, text: str) -> str:
        if self._backend is None:
            return text
        return self._backend.translate(text)

    def add_chunk(self, text: str) -> list[str]:
        """Buffer a streaming chunk; translate any completed sentences."""
        return [self.translate(s) for s in self.buffer.add(text)]

    def flush(self) -> Optional[str]:
        rest = self.buffer.flush()
        return self.translate(rest) if rest else None
