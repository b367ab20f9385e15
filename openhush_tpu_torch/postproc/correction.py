"""LLM text correction via a local Ollama server.

Parity: src/correction/mod.rs (308 LoC) — prompt-based grammar/punctuation
fixing with three filler-removal modes (conservative/moderate/aggressive
word lists, :120-132), response trimming (whitespace + stray quotes),
availability probe against /api/tags (:149-155). Correction fails open:
errors return the original text (the daemon's graceful-degradation rule).

A copy of openhush_tpu/postproc/correction.py.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Optional

from openhush_tpu_torch.utils.http import HttpError, request_json

log = logging.getLogger(__name__)

FILLER_INSTRUCTIONS = {
    "conservative": "Remove basic filler words: um, uh, er, hmm.",
    "moderate": (
        "Remove filler words: um, uh, er, hmm, like (when used as filler, "
        "not as in 'I like'), you know, basically, I mean."),
    "aggressive": (
        "Remove all filler words and hesitation markers: um, uh, er, hmm, "
        "like (as filler), you know, basically, I mean, so (at start), "
        "well (at start), right, actually, literally, honestly, I guess."),
}


@dataclasses.dataclass
class CorrectionConfig:
    enabled: bool = False
    ollama_url: str = "http://localhost:11434"
    model: str = "llama3.2:1b"
    remove_fillers: bool = True
    filler_mode: str = "moderate"
    timeout_secs: float = 30.0


class TextCorrector:
    def __init__(self, config: Optional[CorrectionConfig] = None):
        self.config = config or CorrectionConfig()

    def build_prompt(self, text: str) -> str:
        """Parity: build_prompt (src/correction/mod.rs:113-147)."""
        instructions = ["Fix grammar and punctuation errors."]
        if self.config.remove_fillers:
            instructions.append(FILLER_INSTRUCTIONS.get(
                self.config.filler_mode, FILLER_INSTRUCTIONS["moderate"]))
        instructions += [
            "Preserve the original meaning and tone.",
            "Do not add new content.",
            "Return only the corrected text, nothing else.",
        ]
        system_prompt = " ".join(instructions)
        return (f"You are a transcription post-processor. {system_prompt}"
                f"\n\nInput: {text}\n\nOutput:")

    def correct(self, text: str) -> str:
        """Correct text; returns the input unchanged on any failure."""
        if not text.strip():
            return text
        try:
            resp = request_json(
                f"{self.config.ollama_url}/api/generate", method="POST",
                payload={"model": self.config.model,
                         "prompt": self.build_prompt(text),
                         "stream": False},
                timeout=self.config.timeout_secs)
        except HttpError as e:
            log.warning("Correction unavailable: %s", e)
            return text
        corrected = str(resp.get("response", "")).strip() \
            .strip('"').strip("'").strip()
        return corrected or text

    def is_available(self) -> bool:
        """Probe GET /api/tags (src/correction/mod.rs:149-155)."""
        try:
            request_json(f"{self.config.ollama_url}/api/tags", timeout=3)
            return True
        except HttpError:
            return False
