"""Fine-tuning data pipeline: audio + transcript datasets → batches, and the
fine-tuning loop. The port of openhush_tpu/training/data.py.

Sources:
- LibriSpeech-layout trees (chapter dirs with .trans.txt, .wav/.flac);
- a manifest TSV, `<audio_path>\\t<transcript>` per line.

Batches have fixed shapes, as in the reference: [B, n_mels, 3000] mel
windows (padded or trimmed to 30 s) and [B, max_tokens] decoder inputs and
targets (teacher forcing with the sot sequence as prompt, EOT appended,
IGNORE_ID padding). The mel is computed on the host with the plain log-mel
(ops/mel.py), as the reference computes it with its ops/mel and not with the
Pallas frontend.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Iterator, Optional

import numpy as np
import torch

from openhush_tpu_torch.audio.wav import load_wav
from openhush_tpu_torch.models.whisper.config import WhisperConfig
from openhush_tpu_torch.ops import mel as mel_ops
from openhush_tpu_torch.parallel import sharding
from openhush_tpu_torch.text.tokenizer import WhisperTokenizer
from openhush_tpu_torch.training import train
from openhush_tpu_torch.training.train import IGNORE_ID

log = logging.getLogger(__name__)


@dataclasses.dataclass
class Example:
    audio_path: str
    transcript: str


def load_manifest(path: str) -> list[Example]:
    """TSV manifest: audio_path<TAB>transcript; relative paths are taken
    from the manifest's directory, `#` lines and blank lines skipped."""
    out = []
    base = os.path.dirname(os.path.abspath(path))
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if not line or line.startswith("#"):
                continue
            audio, _, text = line.partition("\t")
            if not os.path.isabs(audio):
                audio = os.path.join(base, audio)
            out.append(Example(audio, text))
    return out


def load_librispeech(root: str) -> list[Example]:
    from openhush_tpu_torch.utils.wer import iter_librispeech
    return [Example(p, t) for p, t in iter_librispeech(root)]


@dataclasses.dataclass
class Batch:
    mel: np.ndarray        # [B, n_mels, 3000] f32
    tokens: np.ndarray     # [B, S] int32: decoder inputs
    targets: np.ndarray    # [B, S] int32: shifted, IGNORE_ID-padded


class WhisperDataset:
    """Shuffled epoch iterator producing fixed-shape batches."""

    def __init__(self, examples: list[Example], cfg: WhisperConfig,
                 tokenizer: Optional[WhisperTokenizer] = None,
                 batch_size: int = 8, max_tokens: int = 120,
                 language: str = "en", seed: int = 0):
        if not examples:
            raise ValueError("empty dataset")
        self.examples = examples
        self.cfg = cfg
        self.tokenizer = tokenizer or WhisperTokenizer(cfg.n_langs)
        self.batch_size = batch_size
        self.max_tokens = max_tokens
        self.language = language
        self._rng = np.random.default_rng(seed)

    def _encode_example(self, ex: Example):
        audio = load_wav(ex.audio_path)
        window = np.ascontiguousarray(mel_ops.pad_or_trim(
            np.asarray(audio, np.float32)))
        m = mel_ops.log_mel_spectrogram(torch.from_numpy(window)[None],
                                        n_mels=self.cfg.n_mels)[0].numpy()
        tok = self.tokenizer
        sp = tok.special
        prompt = tok.sot_sequence(self.language, "transcribe",
                                  timestamps=False)
        text_ids = tok.encode(ex.transcript)[: self.max_tokens
                                             - len(prompt) - 1]
        seq = prompt + text_ids + [sp.eot]
        # Teacher forcing: input = seq[:-1], target = seq[1:]; the prompt
        # positions don't contribute to the loss.
        inputs = np.full(self.max_tokens, sp.eot, np.int32)
        targets = np.full(self.max_tokens, IGNORE_ID, np.int32)
        inputs[:len(seq) - 1] = seq[:-1]
        targets[:len(seq) - 1] = seq[1:]
        targets[:len(prompt) - 1] = IGNORE_ID
        return m, inputs, targets

    def epoch(self) -> Iterator[Batch]:
        order = self._rng.permutation(len(self.examples))
        for start in range(0, len(order) - self.batch_size + 1,
                           self.batch_size):
            mels, toks, tgts = [], [], []
            for i in order[start:start + self.batch_size]:
                try:
                    m, t, g = self._encode_example(self.examples[i])
                except Exception as e:  # noqa: BLE001 — skip bad files
                    log.warning("skipping %s: %s",
                                self.examples[i].audio_path, e)
                    continue
                mels.append(m)
                toks.append(t)
                tgts.append(g)
            if len(mels) == self.batch_size:
                yield Batch(np.stack(mels), np.stack(toks), np.stack(tgts))


def finetune(cfg: WhisperConfig, params, dataset: WhisperDataset, *,
             epochs: int = 1, lr: float = 1e-5, mesh=None,
             log_every: int = 10):
    """Run fine-tuning; returns (params, losses). `params` are updated in
    place, and the batches go to the device they lie on. With a mesh
    (parallel.sharding.create_mesh; every rank of it runs this), params
    and batches shard dp × tp: the params are cut by shard_params unless
    they already lie on this mesh, each data rank trains on its rows of
    every batch, and the losses are the whole batches'."""
    rows = slice(None)
    if mesh is not None:
        if getattr(params, "mesh", None) is not mesh:
            params = sharding.shard_params(params, mesh)
        rows = sharding.data_sharding(mesh, dataset.batch_size)
    device = train.leaves(params)[0].device
    steps_per_epoch = len(dataset.examples) // dataset.batch_size
    optimizer = train.make_optimizer(
        lr=lr, warmup_steps=max(1, steps_per_epoch // 10),
        total_steps=max(2, steps_per_epoch * epochs))
    opt_state = optimizer.init(params)
    losses = []
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a[rows])
                                     ).to(device)
    step_i = 0
    for _ in range(epochs):
        for batch in dataset.epoch():
            params, opt_state, loss = train.train_step(
                cfg, optimizer, params, opt_state, put(batch.mel),
                put(batch.tokens), put(batch.targets))
            losses.append(float(loss))
            if step_i % log_every == 0:
                log.info("step %d loss %.4f", step_i, losses[-1])
            step_i += 1
    return params, losses
