"""Speaker-model training recipes on synthetic voices, in PyTorch.

Counterpart of openhush_tpu/training/speaker.py. The embedder and the
segmentation net ship architecture-only (no pretrained weights reachable
offline), so this module trains them on fully synthetic "speakers"
(distinct glottal f0 + formant-like spectral envelopes) far enough that
clustering is voice-discriminative and segmentation finds speech regions
and overlap. Everything trains through the exact inference functions
(diarization.embed_batch / segmentation_activities), so checkpoints are
drop-in, and `main` writes them in the JAX package's npz layout.

The synthesis is the reference's numpy, byte for byte from the same
np.random.Generator. The optimizer is optax.adam's arithmetic
(train.AdamW at weight decay 0). Parameters and the embedder's
augmentation noise come from an explicit torch.Generator seeded `seed`
(the reference draws them from jax.random), so trained weights differ from
the reference's; training runs on `device` (CUDA unless the caller asks
for the CPU).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from openhush_tpu_torch.device import resolve_device
from openhush_tpu_torch.models.diarization import (EMB_DIM, SEG_K,
                                                   embed_batch,
                                                   init_embedder_params,
                                                   init_segmentation_params,
                                                   log_mel_frames,
                                                   segmentation_activities)
from openhush_tpu_torch.ops import mel as mel_ops
from openhush_tpu_torch.training.train import AdamW, OptState, leaves

SR = 16000


# ---------------------------------------------------------------------------
# Synthetic voices (the reference's numpy)
# ---------------------------------------------------------------------------

def synth_speaker_bank(rng: np.random.Generator, n: int) -> list[dict]:
    """n synthetic speakers: fundamental f0 (85-280 Hz) + a smooth random
    log-spectral envelope (the "vocal tract")."""
    out = []
    for _ in range(n):
        out.append({
            "f0": float(rng.uniform(85.0, 280.0)),
            "ctrl": rng.normal(0.0, 1.4, 8),    # envelope control points
            "am_hz": float(rng.uniform(2.0, 4.5)),
        })
    return out


def _envelope(ctrl: np.ndarray, freqs: np.ndarray) -> np.ndarray:
    xs = np.linspace(0.0, 8000.0, len(ctrl))
    return np.exp(np.interp(freqs, xs, ctrl))


def synth_utterance(rng: np.random.Generator, spk: dict,
                    n_samples: int) -> np.ndarray:
    """Harmonic stack shaped by the speaker envelope, with vibrato and
    syllabic amplitude modulation + noise floor."""
    t = np.arange(n_samples) / SR
    f0 = spk["f0"] * (1.0
                      + 0.03 * np.sin(2 * np.pi * rng.uniform(4, 7) * t)
                      + 0.03 * rng.standard_normal())
    phase = 2 * np.pi * np.cumsum(f0) / SR
    kmax = max(3, int(7600.0 / spk["f0"]))
    ks = np.arange(1, kmax + 1)
    amps = _envelope(spk["ctrl"], spk["f0"] * ks) / ks
    x = (np.sin(phase[:, None] * ks[None, :]) @ amps).astype(np.float64)
    am = 0.55 + 0.45 * np.sin(2 * np.pi * spk["am_hz"] * t
                              + rng.uniform(0, 2 * np.pi))
    x = x * am + 0.01 * rng.standard_normal(n_samples)
    return (x / (np.abs(x).max() + 1e-9) * 0.3).astype(np.float32)


def _mel_batch(audio: np.ndarray, n_frames: int, device) -> torch.Tensor:
    """[B, n_frames*160] → [B, n_frames, N_MELS] on `device`."""
    with torch.no_grad():
        return log_mel_frames(torch.from_numpy(np.asarray(
            audio, np.float32)).to(device), n_frames)


def _train_step(opt: AdamW, params: dict, state: OptState, loss_fn):
    """loss_fn(params) → scalar; one optax-style update of every leaf of
    `params` in place. Returns the loss (before the update)."""
    ps = leaves(params)
    for p in ps:
        p.requires_grad_(True)
    with torch.enable_grad():
        loss = loss_fn(params)
        grads = torch.autograd.grad(loss, ps)
    opt.apply(params, list(grads), state)
    return loss.detach()


# ---------------------------------------------------------------------------
# Embedder training (classification proxy: softmax over training speakers,
# head discarded — standard x-vector recipe)
# ---------------------------------------------------------------------------

def embedder_loss(ph: dict, mel: torch.Tensor, labels: torch.Tensor
                  ) -> torch.Tensor:
    """ph {"params": embedder, "head": [EMB_DIM, n_speakers]}: softmax
    cross-entropy of the scaled-cosine-ish logits, the batch mean."""
    logits = embed_batch(ph["params"], mel) @ ph["head"] * 10.0
    return F.cross_entropy(logits, labels.long())


def embedder_step(opt: AdamW, ph: dict, state: OptState, mel: torch.Tensor,
                  labels: torch.Tensor) -> torch.Tensor:
    """One training step of train_embedder, in place; returns the loss."""
    return _train_step(opt, ph, state,
                       lambda p: embedder_loss(p, mel, labels))


def train_embedder(seed: int = 0, n_speakers: int = 12, steps: int = 300,
                   batch: int = 32, secs: float = 1.0, lr: float = 3e-3,
                   width: int = 128, utts_per_speaker: int = 6,
                   log_every: int = 0, device=None,
                   losses: Optional[list] = None) -> dict:
    """Returns trained embedder params (drop-in for DiarizationEngine).
    `losses`, when given, collects every step's loss (a float)."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    bank = synth_speaker_bank(rng, n_speakers)
    n_frames = int(secs * 100)
    n_samp = n_frames * mel_ops.HOP_LENGTH

    # Pre-synthesize a pool (synthesis dominates step time otherwise).
    pool_audio = np.stack([
        synth_utterance(rng, bank[s], n_samp)
        for s in range(n_speakers) for _ in range(utts_per_speaker)])
    pool_label = torch.from_numpy(
        np.repeat(np.arange(n_speakers), utts_per_speaker)).to(device)
    pool_mel = _mel_batch(pool_audio, n_frames, device)

    gen = torch.Generator(device=device).manual_seed(seed)
    params = init_embedder_params(gen, width=width, device=device)
    head = torch.randn(EMB_DIM, n_speakers, generator=gen,
                       device=device) * EMB_DIM ** -0.5
    ph = {"params": params, "head": head}
    opt = AdamW(lr)
    state = opt.init(ph)
    for i in range(steps):
        idx = torch.from_numpy(rng.integers(0, len(pool_mel), batch)).to(
            device)
        # Augment: gain + noise jitter keeps the embedder off energy cues.
        noise = 0.1 * torch.randn((), generator=gen, device=device)
        loss = embedder_step(opt, ph, state, pool_mel[idx] + noise,
                             pool_label[idx])
        if losses is not None:
            losses.append(float(loss))
        if log_every and i % log_every == 0:
            print(f"embedder step {i}: loss {float(loss):.4f}")
    return {k: v.detach() for k, v in ph["params"].items()}


# ---------------------------------------------------------------------------
# Segmentation training (BCE on per-frame local-speaker activity over
# synthetic 2-speaker mixtures incl. overlap)
# ---------------------------------------------------------------------------

def synth_mixture(rng: np.random.Generator, bank: list[dict],
                  secs: float = 4.0) -> tuple[np.ndarray, np.ndarray]:
    """One mixture + frame labels [T_act, SEG_K] (40 ms frames).
    Channels are order-of-appearance (pyannote local-speaker convention)."""
    n_frames = int(secs * 100)
    n_samp = n_frames * mel_ops.HOP_LENGTH
    n_act = n_frames // 4
    audio = np.zeros(n_samp, np.float32)
    labels = np.zeros((n_act, SEG_K), np.float32)
    spk_ids = rng.choice(len(bank), size=2, replace=False)
    appearance: list[int] = []
    for sid in spk_ids:
        n_int = rng.integers(1, 3)
        for _ in range(n_int):
            dur = rng.uniform(0.6, 1.8)
            start = rng.uniform(0, max(0.05, secs - dur))
            s0, s1 = int(start * SR), min(int((start + dur) * SR), n_samp)
            if s1 - s0 < SR // 5:
                continue
            seg = synth_utterance(rng, bank[sid], s1 - s0)
            fade = np.minimum(1.0, np.arange(s1 - s0) / (0.02 * SR))
            audio[s0:s1] += seg * fade * fade[::-1]
            if sid not in appearance:
                appearance.append(sid)
            ch = appearance.index(sid)
            if ch < SEG_K:
                a0, a1 = s0 // (4 * 160), max(s0 // (4 * 160) + 1,
                                              s1 // (4 * 160))
                labels[a0:min(a1, n_act), ch] = 1.0
    peak = np.abs(audio).max()
    if peak > 1e-6:
        audio *= min(1.0, 0.5 / peak)
    audio += 0.003 * rng.standard_normal(n_samp).astype(np.float32)
    return audio, labels


def segmentation_loss(params: dict, mel: torch.Tensor,
                      labels: torch.Tensor) -> torch.Tensor:
    """Mean per-frame, per-channel BCE of the clipped activities."""
    acts = torch.clamp(segmentation_activities(params, mel), 1e-6, 1 - 1e-6)
    bce = -(labels * torch.log(acts) + (1 - labels) * torch.log(1 - acts))
    return bce.mean()


def segmentation_step(opt: AdamW, params: dict, state: OptState,
                      mel: torch.Tensor, labels: torch.Tensor
                      ) -> torch.Tensor:
    """One training step of train_segmentation, in place; returns the
    loss."""
    return _train_step(opt, params, state,
                       lambda p: segmentation_loss(p, mel, labels))


def train_segmentation(seed: int = 0, steps: int = 300, batch: int = 16,
                       secs: float = 4.0, lr: float = 3e-3,
                       n_speakers: int = 8, pool_size: int = 96,
                       hidden: int = 64, log_every: int = 0,
                       device=None) -> dict:
    """Returns trained segmentation params."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    bank = synth_speaker_bank(rng, n_speakers)
    n_frames = int(secs * 100)

    auds, labs = zip(*(synth_mixture(rng, bank, secs)
                       for _ in range(pool_size)))
    pool_mel = _mel_batch(np.stack(auds), n_frames, device)
    pool_lab = torch.from_numpy(np.stack(labs)).to(device)

    params = init_segmentation_params(
        torch.Generator(device=device).manual_seed(seed), hidden=hidden,
        device=device)
    opt = AdamW(lr)
    state = opt.init(params)
    for i in range(steps):
        idx = torch.from_numpy(rng.integers(0, pool_size, batch)).to(device)
        loss = segmentation_step(opt, params, state, pool_mel[idx],
                                 pool_lab[idx])
        if log_every and i % log_every == 0:
            print(f"segmentation step {i}: loss {float(loss):.4f}")
    return {k: v.detach() for k, v in params.items()}


# ---------------------------------------------------------------------------
# CLI: produce npz checkpoints for the daemon/record pipeline
# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    import argparse

    from openhush_tpu_torch.models.whisper.weights import save_npz

    p = argparse.ArgumentParser(
        description="Train speaker embedder + segmentation on synthetic "
                    "voices (or bootstrap before real-data fine-tune)")
    p.add_argument("--out-dir", default=".")
    p.add_argument("--steps", type=int, default=600)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--n-speakers", type=int, default=16)
    p.add_argument("--device", default=None,
                   help="torch device (default: the GPU)")
    args = p.parse_args(argv)

    emb = train_embedder(seed=args.seed, n_speakers=args.n_speakers,
                         steps=args.steps, log_every=50, device=args.device)
    save_npz(emb, f"{args.out_dir}/speaker_embedder.npz")
    seg = train_segmentation(seed=args.seed, steps=args.steps,
                             n_speakers=args.n_speakers, log_every=50,
                             device=args.device)
    save_npz(seg, f"{args.out_dir}/segmentation.npz")
    print(f"wrote {args.out_dir}/speaker_embedder.npz and "
          f"{args.out_dir}/segmentation.npz")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
