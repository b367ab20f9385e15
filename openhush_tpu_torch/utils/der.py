"""Diarization error rate (DER/JER) harness — the diarization sibling of
utils/wer.py.

The port's own copy of openhush_tpu/utils/der.py (numpy and scipy; the
port imports nothing of the JAX package): its synthesis, engine and WAV
reader come from the port's training/speaker.py, models/diarization.py and
audio/wav.py.

Reference scope: the reference gets diarization quality from pretrained
pyannote models and reports nothing (src/diarization/mod.rs:248-338);
here the metric is first-class so the in-tree trained segmentation +
embedder recipe has a number attached.

DER follows the standard NIST definition, frame-based (10 ms frames):

    DER = (missed speech + false alarm + speaker confusion) / ref speech

with an optional no-score collar around reference segment boundaries and
an OPTIMAL speaker mapping (Hungarian assignment over the frame overlap
matrix). JER averages per-reference-speaker `1 - |correct|/|union|`.

`evaluate_synthetic_meetings()` builds 2-4-speaker synthetic meetings
(overlap + noise, training/speaker.py voices), runs a DiarizationEngine
over record-mode-style chunks, and aggregates DER — the quality gate
runnable with zero network (`openhush evaluate --diarization`).
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

import numpy as np

FRAME = 0.010     # scoring frame (seconds)


@dataclasses.dataclass
class Turn:
    start: float
    end: float
    speaker: int | str


@dataclasses.dataclass
class DerResult:
    der: float
    jer: float
    missed: float          # fractions of reference speech
    false_alarm: float
    confusion: float
    ref_speech_secs: float

    def __str__(self) -> str:
        return (f"DER {self.der:.3f} (miss {self.missed:.3f}, "
                f"fa {self.false_alarm:.3f}, conf {self.confusion:.3f}), "
                f"JER {self.jer:.3f} over {self.ref_speech_secs:.1f}s "
                f"speech")


def _frame_matrix(turns: Sequence[Turn], n_frames: int,
                  speakers: list) -> np.ndarray:
    """[n_speakers, n_frames] bool activity matrix."""
    m = np.zeros((len(speakers), n_frames), bool)
    index = {s: i for i, s in enumerate(speakers)}
    for t in turns:
        a = max(0, int(round(t.start / FRAME)))
        b = min(n_frames, int(round(t.end / FRAME)))
        if b > a:
            m[index[t.speaker], a:b] = True
    return m


def der(reference: Sequence[Turn], hypothesis: Sequence[Turn],
        collar: float = 0.25, total_secs: float | None = None
        ) -> DerResult:
    """Frame-based DER/JER with collar and optimal speaker mapping."""
    from scipy.optimize import linear_sum_assignment

    if total_secs is None:
        total_secs = max([t.end for t in list(reference)
                          + list(hypothesis)] or [0.0])
    n = int(np.ceil(total_secs / FRAME)) + 1
    ref_spk = sorted({t.speaker for t in reference}, key=str)
    hyp_spk = sorted({t.speaker for t in hypothesis}, key=str)
    R = _frame_matrix(reference, n, ref_spk)
    H = _frame_matrix(hypothesis, n, hyp_spk)

    # Collar: frames near any reference boundary are not scored.
    score = np.ones(n, bool)
    c = int(round(collar / FRAME))
    if c > 0:
        for t in reference:
            for edge in (t.start, t.end):
                i = int(round(edge / FRAME))
                score[max(0, i - c):i + c] = False
    R = R[:, score]
    H = H[:, score]

    # Optimal ref→hyp speaker mapping by total overlapping frames.
    if len(ref_spk) and len(hyp_spk):
        overlap = (R[:, None, :] & H[None, :, :]).sum(-1)
        ri, hi = linear_sum_assignment(-overlap)
        mapping = dict(zip(ri, hi))
    else:
        mapping = {}

    ref_count = R.sum(0)            # speakers active per frame
    hyp_count = H.sum(0)
    # Per-frame mapped-correct count (capped by both sides).
    correct = np.zeros(R.shape[1], np.int64)
    for r, h in mapping.items():
        correct += (R[r] & H[h])
    ref_total = int(ref_count.sum())
    missed = int(np.maximum(ref_count - hyp_count, 0).sum())
    fa = int(np.maximum(hyp_count - ref_count, 0).sum())
    conf = int(np.minimum(ref_count, hyp_count).sum()) - int(correct.sum())
    conf = max(conf, 0)
    denom = max(ref_total, 1)

    # JER: mean per-reference-speaker Jaccard error vs mapped hyp.
    jers = []
    for r in range(len(ref_spk)):
        h = mapping.get(r)
        hyp_row = H[h] if h is not None else np.zeros_like(R[r])
        union = int((R[r] | hyp_row).sum())
        inter = int((R[r] & hyp_row).sum())
        jers.append(1.0 - inter / union if union else 0.0)
    return DerResult(
        der=(missed + fa + conf) / denom,
        jer=float(np.mean(jers)) if jers else 0.0,
        missed=missed / denom, false_alarm=fa / denom,
        confusion=conf / denom,
        ref_speech_secs=ref_total * FRAME)


def aggregate(results: Iterable[DerResult]) -> DerResult:
    rs = list(results)
    w = np.asarray([max(r.ref_speech_secs, 1e-9) for r in rs])
    tot = w.sum()

    def avg(field):
        return float(sum(getattr(r, field) * wi
                         for r, wi in zip(rs, w)) / tot)

    return DerResult(der=avg("der"), jer=avg("jer"), missed=avg("missed"),
                     false_alarm=avg("false_alarm"),
                     confusion=avg("confusion"), ref_speech_secs=float(tot))


# ---------------------------------------------------------------------------
# Synthetic-meeting evaluation (no network needed)
# ---------------------------------------------------------------------------

def synth_meeting(rng: np.random.Generator, n_speakers: int,
                  secs: float = 20.0) -> tuple[np.ndarray, list[Turn]]:
    """A meeting: n_speakers synthetic voices, turn-taking with pauses,
    occasional overlap, low noise floor. Returns (audio 16 kHz, turns)."""
    from openhush_tpu_torch.training.speaker import (synth_speaker_bank,
                                               synth_utterance)

    sr = 16000
    bank = synth_speaker_bank(rng, n_speakers)
    n = int(secs * sr)
    audio = np.zeros(n, np.float32)
    turns: list[Turn] = []
    t = rng.uniform(0.2, 0.8)
    while t < secs - 1.5:
        spk = int(rng.integers(0, n_speakers))
        dur = float(rng.uniform(1.0, 3.0))
        end = min(t + dur, secs - 0.1)
        s0, s1 = int(t * sr), int(end * sr)
        seg = synth_utterance(rng, bank[spk], s1 - s0)
        fade = np.minimum(1.0, np.arange(s1 - s0) / (0.02 * sr))
        audio[s0:s1] += seg * fade * fade[::-1]
        turns.append(Turn(t, end, spk))
        if rng.random() < 0.25:      # overlapping interjection
            ospk = int(rng.integers(0, n_speakers))
            if ospk != spk:
                od = float(rng.uniform(0.4, 1.0))
                ot = float(rng.uniform(t, max(t, end - od)))
                o0, o1 = int(ot * sr), min(int((ot + od) * sr), n)
                if o1 - o0 > sr // 5:
                    oseg = synth_utterance(rng, bank[ospk], o1 - o0)
                    audio[o0:o1] += 0.8 * oseg
                    turns.append(Turn(ot, o1 / sr, ospk))
        t = end + float(rng.uniform(0.3, 1.2))
    peak = np.abs(audio).max()
    if peak > 1e-6:
        audio *= min(1.0, 0.5 / peak)
    audio += 0.003 * rng.standard_normal(n).astype(np.float32)
    return audio, turns


def load_rttm(path: str) -> list[Turn]:
    """Parse a NIST RTTM file (the AMI / pyannote interchange format:
    `SPEAKER <file> 1 <tbeg> <tdur> <NA> <NA> <name> ...`)."""
    turns: list[Turn] = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 8 and parts[0] == "SPEAKER":
                t0, dur = float(parts[3]), float(parts[4])
                turns.append(Turn(t0, t0 + dur, parts[7]))
    return turns


def write_rttm(path: str, file_id: str, turns: Sequence[Turn]) -> None:
    with open(path, "w") as f:
        for t in turns:
            f.write(f"SPEAKER {file_id} 1 {t.start:.3f} "
                    f"{t.end - t.start:.3f} <NA> <NA> spk{t.speaker} "
                    f"<NA> <NA>\n")


def evaluate_rttm_dataset(root: str, engine=None,
                          chunk_secs: float = 5.0,
                          limit: int | None = None,
                          progress: bool = False) -> DerResult:
    """DER over a real diarization dataset: a directory of <name>.wav
    files with matching <name>.rttm references (AMI-layout; the
    checkpoint gate points this at real meetings once the networked run
    fetches them — reference scope: pretrained pyannote in
    src/diarization/mod.rs:266-299)."""
    import os

    from openhush_tpu_torch.audio.wav import load_wav
    from openhush_tpu_torch.models.diarization import DiarizationEngine

    if engine is None:
        engine = DiarizationEngine.from_local()
    sr = 16000
    results = []
    wavs = sorted(f for f in os.listdir(root) if f.endswith(".wav"))
    n_evaluated = 0
    for wav in wavs:
        # The limit counts evaluated PAIRS: stray wavs without a matching
        # .rttm (e.g. references not fetched yet) must not consume it.
        if limit and n_evaluated >= limit:
            break
        rttm = os.path.join(root, wav[:-4] + ".rttm")
        if not os.path.exists(rttm):
            continue
        n_evaluated += 1
        ref = load_rttm(rttm)
        audio = load_wav(os.path.join(root, wav))
        engine.reset()   # fresh speaker bank per recording
        hyp: list[Turn] = []
        win = int(chunk_secs * sr)
        for s0 in range(0, len(audio), win):
            for seg in engine.diarize_chunk(audio[s0:s0 + win],
                                            offset_secs=s0 / sr):
                hyp.append(Turn(seg.start_secs, seg.end_secs,
                                f"spk{seg.speaker_id}"))
        r = der(ref, hyp, total_secs=len(audio) / sr)
        results.append(r)
        if progress:
            print(f"  {wav}: {r}")
    if not results:
        raise FileNotFoundError(f"no wav+rttm pairs under {root}")
    return aggregate(results)


def evaluate_synthetic_meetings(engine=None, n_meetings: int = 5,
                                seed: int = 0, secs: float = 20.0,
                                chunk_secs: float = 5.0,
                                progress: bool = False) -> DerResult:
    """Run the diarization engine over synthetic meetings in record-mode
    5 s chunks (src/recording.rs:28-32 cadence) and aggregate DER."""
    from openhush_tpu_torch.models.diarization import DiarizationEngine

    if engine is None:
        engine = DiarizationEngine.from_local()
    sr = 16000
    results = []
    rng = np.random.default_rng(seed)
    for m in range(n_meetings):
        n_spk = int(rng.integers(2, 5))
        audio, ref = synth_meeting(rng, n_spk, secs)
        hyp: list[Turn] = []
        win = int(chunk_secs * sr)
        for s0 in range(0, len(audio), win):
            chunk = audio[s0:s0 + win]
            for seg in engine.diarize_chunk(chunk,
                                            offset_secs=s0 / sr):
                hyp.append(Turn(seg.start_secs, seg.end_secs,
                                f"spk{seg.speaker_id}"))
        r = der(ref, hyp, total_secs=secs)
        results.append(r)
        if progress:
            print(f"  meeting {m}: {n_spk} speakers → {r}")
    return aggregate(results)
