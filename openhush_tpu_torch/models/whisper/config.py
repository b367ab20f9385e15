"""Whisper model-size registry and architecture config.

Reference parity: the model enum tiny/base/small/medium/large-v3 with filenames
and sizes lives at ``src/engine/whisper.rs:45-103,427-435`` in the reference.
Here the registry carries the *architecture* hyperparameters instead of GGML
file metadata. A copy of openhush_tpu/models/whisper/config.py: the port
imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class WhisperConfig:
    """Architecture hyperparameters for one Whisper size.

    Field names follow OpenAI's dims naming (n_*), not HF's, because the
    layout below (sinusoidal encoder positions, learned decoder positions,
    pre-LN blocks, tied embedding/unembedding) is OpenAI Whisper's.
    """

    name: str = "tiny"
    n_mels: int = 80
    n_audio_ctx: int = 1500          # encoder positions (30 s / 20 ms per frame)
    n_audio_state: int = 384         # d_model
    n_audio_head: int = 6
    n_audio_layer: int = 4
    n_vocab: int = 51865
    n_text_ctx: int = 448            # max decoder positions
    n_text_state: int = 384
    n_text_head: int = 6
    n_text_layer: int = 4
    # Number of language tokens in the vocab (99 pre-large-v3, 100 after).
    n_langs: int = 99

    @property
    def head_dim(self) -> int:
        return self.n_audio_state // self.n_audio_head

    @property
    def ffn_dim(self) -> int:
        return 4 * self.n_text_state

    # Vocab padded up to a multiple of 128 for the unembedding matmul.
    @property
    def n_vocab_padded(self) -> int:
        return ((self.n_vocab + 127) // 128) * 128


def _cfg(name, state, head, layer, n_mels=80, n_vocab=51865, n_langs=99,
         dec_layer=None) -> WhisperConfig:
    return WhisperConfig(
        name=name, n_mels=n_mels,
        n_audio_state=state, n_audio_head=head, n_audio_layer=layer,
        n_text_state=state, n_text_head=head,
        n_text_layer=layer if dec_layer is None else dec_layer,
        n_vocab=n_vocab, n_langs=n_langs,
    )


# Size registry. Model enum parity: src/engine/whisper.rs:45-103.
CONFIGS = {
    "tiny": _cfg("tiny", 384, 6, 4),
    "base": _cfg("base", 512, 8, 6),
    "small": _cfg("small", 768, 12, 12),
    "medium": _cfg("medium", 1024, 16, 24),
    "large-v2": _cfg("large-v2", 1280, 20, 32),
    "large-v3": _cfg("large-v3", 1280, 20, 32, n_mels=128, n_vocab=51866,
                     n_langs=100),
    "large-v3-turbo": _cfg("large-v3-turbo", 1280, 20, 32, n_mels=128,
                           n_vocab=51866, n_langs=100, dec_layer=4),
    # Tiny-but-legal config for unit tests (128-aligned dims, 2 layers).
    "test": WhisperConfig(
        name="test", n_mels=80, n_audio_ctx=1500,
        n_audio_state=64, n_audio_head=2, n_audio_layer=2,
        n_text_state=64, n_text_head=2, n_text_layer=2,
        n_vocab=51865, n_text_ctx=448, n_langs=99,
    ),
    # 1-layer-decoder twin of "test" — the draft-model shape for
    # speculative decoding tests (the large-v3-turbo : large-v3
    # relationship: same encoder dims + vocab, shallow decoder).
    "test-draft": WhisperConfig(
        name="test-draft", n_mels=80, n_audio_ctx=1500,
        n_audio_state=64, n_audio_head=2, n_audio_layer=2,
        n_text_state=64, n_text_head=2, n_text_layer=1,
        n_vocab=51865, n_text_ctx=448, n_langs=99,
    ),
}


def get_config(name: str) -> WhisperConfig:
    try:
        return CONFIGS[name]
    except KeyError:
        raise ValueError(
            f"unknown model {name!r}; available: {sorted(CONFIGS)}") from None
