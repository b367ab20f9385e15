"""Whisper tokenizer: special-token layout, language tables, and byte-level BPE.

Replaces the tokenizer embedded in whisper.cpp (used via the reference engine,
src/engine/whisper.rs:204-305) and the lang-id→ISO table
(src/engine/whisper.rs:622-726, reproduced here as LANGUAGES order).

Design: the special-token ID layout (EOT/SOT/languages/task/timestamps) is
*structural* — identical across all multilingual Whisper checkpoints — so it
is computed from the vocab size alone. The text-region BPE is loaded from a
user-supplied vocab (HF vocab.json+merges.txt or OpenAI .tiktoken file). When
no vocab files are available (e.g. air-gapped test environments) a byte-level
fallback keeps the full pipeline runnable end-to-end: token ids still live in
the correct regions, only text rendering differs from the real BPE.
"""

from __future__ import annotations

import base64
import functools
import json
import os
from typing import Optional, Sequence

# whisper.cpp language-id order (parity: src/engine/whisper.rs:622-726).
# Token id of language L = SOT + 1 + index. large-v3 appends "yue".
LANGUAGES = (
    "en zh de es ru ko fr ja pt tr pl ca nl ar sv it id hi fi vi he uk el ms "
    "cs ro da hu ta no th ur hr bg lt la mi ml cy sk te fa lv bn sr az sl kn "
    "et mk br eu is hy ne mn bs kk sq sw gl mr pa si km sn yo so af oc ka be "
    "tg sd gu am yi lo uz fo ht ps tk nn mt sa lb my bo tl mg as tt haw ln "
    "ha ba jw su").split()
LANGUAGES_V3 = LANGUAGES + ["yue"]

LANGUAGE_NAMES = {
    "en": "english", "zh": "chinese", "de": "german", "es": "spanish",
    "ru": "russian", "ko": "korean", "fr": "french", "ja": "japanese",
    "pt": "portuguese", "tr": "turkish", "pl": "polish", "ca": "catalan",
    "nl": "dutch", "ar": "arabic", "sv": "swedish", "it": "italian",
    "id": "indonesian", "hi": "hindi", "fi": "finnish", "vi": "vietnamese",
    "he": "hebrew", "uk": "ukrainian", "el": "greek", "ms": "malay",
    "cs": "czech", "ro": "romanian", "da": "danish", "hu": "hungarian",
    "ta": "tamil", "no": "norwegian", "th": "thai", "ur": "urdu",
    "hr": "croatian", "bg": "bulgarian", "lt": "lithuanian", "la": "latin",
    "mi": "maori", "ml": "malayalam", "cy": "welsh", "sk": "slovak",
    "te": "telugu", "fa": "persian", "lv": "latvian", "bn": "bengali",
    "sr": "serbian", "az": "azerbaijani", "sl": "slovenian", "kn": "kannada",
    "et": "estonian", "mk": "macedonian", "br": "breton", "eu": "basque",
    "is": "icelandic", "hy": "armenian", "ne": "nepali", "mn": "mongolian",
    "bs": "bosnian", "kk": "kazakh", "sq": "albanian", "sw": "swahili",
    "gl": "galician", "mr": "marathi", "pa": "punjabi", "si": "sinhala",
    "km": "khmer", "sn": "shona", "yo": "yoruba", "so": "somali",
    "af": "afrikaans", "oc": "occitan", "ka": "georgian", "be": "belarusian",
    "tg": "tajik", "sd": "sindhi", "gu": "gujarati", "am": "amharic",
    "yi": "yiddish", "lo": "lao", "uz": "uzbek", "fo": "faroese",
    "ht": "haitian creole", "ps": "pashto", "tk": "turkmen", "nn": "nynorsk",
    "mt": "maltese", "sa": "sanskrit", "lb": "luxembourgish", "my": "myanmar",
    "bo": "tibetan", "tl": "tagalog", "mg": "malagasy", "as": "assamese",
    "tt": "tatar", "haw": "hawaiian", "ln": "lingala", "ha": "hausa",
    "ba": "bashkir", "jw": "javanese", "su": "sundanese", "yue": "cantonese",
}


class SpecialTokens:
    """Structural special-token ids, derived from the language count.

    Multilingual layout (n_text = 50257 text+byte tokens):
      eot = 50257, sot = 50258, languages sot+1..sot+n_langs,
      translate/transcribe/startoflm/startofprev/nospeech/notimestamps follow,
      then 1501 timestamp tokens <|0.00|>..<|30.00|> at 0.02 s resolution.
    """

    def __init__(self, n_langs: int = 99):
        self.n_langs = n_langs
        self.languages = LANGUAGES_V3 if n_langs == 100 else LANGUAGES
        self.eot = 50257
        self.sot = 50258
        self.lang_base = self.sot + 1
        self.translate = self.lang_base + n_langs
        self.transcribe = self.translate + 1
        self.start_of_lm = self.transcribe + 1
        self.start_of_prev = self.start_of_lm + 1
        self.no_speech = self.start_of_prev + 1
        self.no_timestamps = self.no_speech + 1
        self.timestamp_begin = self.no_timestamps + 1   # <|0.00|>
        self.n_vocab = self.timestamp_begin + 1501

    def lang_token(self, code: str) -> int:
        try:
            return self.lang_base + self.languages.index(code)
        except ValueError:
            raise ValueError(f"unknown language code {code!r}") from None

    def lang_code(self, token_or_id) -> str:
        """Language code from a language *token id* or a whisper.cpp-style
        0-based language id (parity: lang_id_to_code,
        src/engine/whisper.rs:622-726)."""
        i = int(token_or_id)
        if i >= self.lang_base:
            i -= self.lang_base
        if 0 <= i < len(self.languages):
            return self.languages[i]
        return "unknown"

    def is_timestamp(self, token: int) -> bool:
        return token >= self.timestamp_begin

    def timestamp_seconds(self, token: int) -> float:
        return (token - self.timestamp_begin) * 0.02

    def timestamp_token(self, seconds: float) -> int:
        return self.timestamp_begin + int(round(seconds / 0.02))

    def decode_special(self, token: int) -> str:
        if token == self.eot:
            return "<|endoftext|>"
        if token == self.sot:
            return "<|startoftranscript|>"
        if self.lang_base <= token < self.lang_base + self.n_langs:
            return f"<|{self.languages[token - self.lang_base]}|>"
        if token == self.translate:
            return "<|translate|>"
        if token == self.transcribe:
            return "<|transcribe|>"
        if token == self.start_of_lm:
            return "<|startoflm|>"
        if token == self.start_of_prev:
            return "<|startofprev|>"
        if token == self.no_speech:
            return "<|nospeech|>"
        if token == self.no_timestamps:
            return "<|notimestamps|>"
        if token >= self.timestamp_begin:
            return f"<|{self.timestamp_seconds(token):.2f}|>"
        return f"<|special_{token}|>"


# ---------------------------------------------------------------------------
# Byte-level BPE (GPT-2 style) — loads real Whisper vocabs when provided.
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=1)
def _bytes_to_unicode() -> dict[int, str]:
    """GPT-2's reversible byte↔unicode table."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


class BPE:
    """Minimal byte-level BPE codec over a {token_string: id} vocab and
    ranked merges. Encoding is greedy lowest-rank pair merging (GPT-2)."""

    def __init__(self, vocab: dict[str, int], merges: dict[tuple[str, str], int]):
        self.vocab = vocab
        self.inv_vocab = {v: k for k, v in vocab.items()}
        self.merges = merges
        self.byte_enc = _bytes_to_unicode()
        self.byte_dec = {v: k for k, v in self.byte_enc.items()}

    def _bpe_word(self, word: str) -> list[str]:
        parts = list(word)
        while len(parts) > 1:
            pairs = [(self.merges.get((parts[i], parts[i + 1]), 1 << 30), i)
                     for i in range(len(parts) - 1)]
            rank, i = min(pairs)
            if rank >= 1 << 30:
                break
            parts = parts[:i] + [parts[i] + parts[i + 1]] + parts[i + 2:]
        return parts

    def encode(self, text: str) -> list[int]:
        mapped = "".join(self.byte_enc[b] for b in text.encode("utf-8"))
        out = []
        for piece in self._bpe_word(mapped):
            if piece in self.vocab:
                out.append(self.vocab[piece])
            else:  # unmergeable: emit per-char byte tokens
                out.extend(self.vocab[c] for c in piece if c in self.vocab)
        return out

    def decode(self, ids: Sequence[int]) -> str:
        text = "".join(self.inv_vocab.get(i, "") for i in ids)
        data = bytes(self.byte_dec[c] for c in text if c in self.byte_dec)
        return data.decode("utf-8", errors="replace")


class ByteFallbackBPE:
    """Dependency-free stand-in used when no vocab files exist: token id =
    256-block byte mapping into the text region. Reversible and stable, NOT
    the real Whisper BPE (text differs from pretrained checkpoints)."""

    def encode(self, text: str) -> list[int]:
        return [b for b in text.encode("utf-8")]

    def decode(self, ids: Sequence[int]) -> str:
        return bytes(i for i in ids if 0 <= i < 256).decode(
            "utf-8", errors="replace")


class WhisperTokenizer:
    """Full tokenizer: BPE text region + structural special tokens."""

    def __init__(self, n_langs: int = 99, bpe=None):
        self.special = SpecialTokens(n_langs)
        self.bpe = bpe or ByteFallbackBPE()
        self.is_real_vocab = bpe is not None

    # -- construction -------------------------------------------------------

    @classmethod
    def from_files(cls, vocab_path: str, merges_path: Optional[str] = None,
                   n_langs: int = 99) -> "WhisperTokenizer":
        """Load from HF vocab.json(+merges.txt) or an OpenAI .tiktoken file
        (base64 token ↦ rank lines)."""
        if vocab_path.endswith(".tiktoken"):
            byte_enc = _bytes_to_unicode()
            vocab, merges = {}, {}
            ranked: list[str] = []
            with open(vocab_path, "rb") as f:
                for line in f:
                    if not line.strip():
                        continue
                    tok_b64, rank = line.split()
                    raw = base64.b64decode(tok_b64)
                    s = "".join(byte_enc[b] for b in raw)
                    vocab[s] = int(rank)
                    ranked.append(s)
            # Reconstruct merges (standard tiktoken merge recovery): a merged
            # token's true training pair is the split of previously-seen
            # halves that minimizes the max rank of the two halves — taking
            # the FIRST valid split instead can diverge from the real BPE.
            for s in sorted(vocab, key=vocab.get):
                if len(s) <= 1:
                    continue
                rank = vocab[s]
                best = None
                for i in range(1, len(s)):
                    ra = vocab.get(s[:i])
                    rb = vocab.get(s[i:])
                    if ra is None or rb is None or ra >= rank or rb >= rank:
                        continue
                    key = max(ra, rb)
                    if best is None or key < best[0]:
                        best = (key, s[:i], s[i:])
                if best is not None:
                    merges[(best[1], best[2])] = rank
            return cls(n_langs, BPE(vocab, merges))
        with open(vocab_path) as f:
            vocab = json.load(f)
        merges = {}
        if merges_path and os.path.exists(merges_path):
            with open(merges_path) as f:
                for rank, line in enumerate(f):
                    if line.startswith("#") or not line.strip():
                        continue
                    a, b = line.split()
                    merges[(a, b)] = rank
        return cls(n_langs, BPE(vocab, merges))

    @classmethod
    def for_model(cls, model_name: str,
                  vocab_dir: Optional[str] = None) -> "WhisperTokenizer":
        n_langs = 100 if "large-v3" in model_name else 99
        if vocab_dir:
            for name in ("vocab.json", "multilingual.tiktoken"):
                p = os.path.join(vocab_dir, name)
                if os.path.exists(p):
                    merges = os.path.join(vocab_dir, "merges.txt")
                    return cls.from_files(
                        p, merges if os.path.exists(merges) else None, n_langs)
        return cls(n_langs)

    # -- prompts ------------------------------------------------------------

    def sot_sequence(self, language: Optional[str] = None,
                     task: str = "transcribe",
                     timestamps: bool = True) -> list[int]:
        """<|startoftranscript|>[<|lang|>][<|task|>][<|notimestamps|>]."""
        sp = self.special
        seq = [sp.sot]
        if language is not None:
            seq.append(sp.lang_token(language))
            seq.append(sp.translate if task == "translate" else sp.transcribe)
        if not timestamps:
            seq.append(sp.no_timestamps)
        return seq

    # -- encode/decode ------------------------------------------------------

    def encode(self, text: str) -> list[int]:
        return self.bpe.encode(text)

    def decode(self, ids: Sequence[int], skip_special: bool = True) -> str:
        sp = self.special
        out, run = [], []
        for i in ids:
            if i >= sp.eot:
                if run:
                    out.append(self.bpe.decode(run))
                    run = []
                if not skip_special:
                    out.append(sp.decode_special(int(i)))
            else:
                run.append(int(i))
        if run:
            out.append(self.bpe.decode(run))
        return "".join(out)

    def decode_with_timestamps(self, ids: Sequence[int]) -> str:
        return self.decode(ids, skip_special=False)

    @property
    def non_speech_tokens(self) -> tuple[int, ...]:
        """Token ids suppressed to avoid non-speech artifacts — whisper's
        standard suppress list: punctuation/symbol tokens that whisper.cpp
        also suppresses by default. With a real vocab these are looked up;
        with the byte fallback, the same *characters* are suppressed."""
        symbols = list("\"#()*+/:;<=>@[\\]^_`{|}~「」『』") + [
            "<<", ">>", "<<<", ">>>", "--", "---", "-(", "-[", "('", "(\"",
            "((", "))", "(((", ")))", "[[", "]]", "{{", "}}", "♪♪", "♪♪♪"]
        miscellaneous = set("♩♪♫♬♭♮♯")
        result = set()
        for sym in symbols + list(miscellaneous):
            for tok_str in (sym, " " + sym):
                ids = self.encode(tok_str)
                if len(ids) == 1:
                    result.add(ids[0])
        return tuple(sorted(result))
