"""The port's copy of the DER/JER harness (openhush_tpu_torch.utils.der)
against the JAX package's openhush_tpu/utils/der.py: the same turns give
equal results (both are numpy and scipy), the same generator gives the same
synthetic meetings, the RTTM files are byte-equal, and both evaluators give
equal DER over the same engines' output."""

import numpy as np
import pytest
import torch

from openhush_tpu.models import diarization as jdia
from openhush_tpu.utils import der as jder
from openhush_tpu_torch.audio.wav import save_wav
from openhush_tpu_torch.models import diarization as dia
from openhush_tpu_torch.utils import der


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads for this file's torch work: the suite runs six
    workers on one machine, and eight threads each oversubscribe it."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _turns(mod, rng, n, n_spk, secs=30.0):
    out = []
    for _ in range(n):
        a = float(rng.uniform(0, secs - 1))
        out.append(mod.Turn(a, a + float(rng.uniform(0.2, 4.0)),
                            f"s{int(rng.integers(0, n_spk))}"))
    return out


def _fields(r):
    return (r.der, r.jer, r.missed, r.false_alarm, r.confusion,
            r.ref_speech_secs)


CASES = [
    ([(0.0, 2.0, "A"), (3.0, 5.0, "B")], [(0.0, 2.0, "x"), (3.0, 5.0, "y")],
     0.25),
    ([(0.0, 2.0, "A"), (3.0, 5.0, "B")], [(0.0, 2.0, "y"), (3.0, 5.0, "x")],
     0.0),
    ([(0.0, 4.0, "A")], [(0.0, 2.0, "x")], 0.0),
    ([(0.0, 2.0, "A")], [(0.0, 4.0, "x")], 0.0),
    ([(0.0, 4.0, "A"), (1.0, 3.0, "B")], [(0.0, 4.0, "x")], 0.0),
    ([(0.0, 2.0, 0), (2.0, 4.0, 1)], [(0.1, 2.1, 5), (2.1, 4.0, 6)], 0.25),
    ([], [(0.0, 1.0, "x")], 0.0),
]


@pytest.mark.parametrize("ref,hyp,collar", CASES)
def test_der_matches_jax(ref, hyp, collar):
    ours = der.der([der.Turn(*t) for t in ref], [der.Turn(*t) for t in hyp],
                   collar=collar)
    want = jder.der([jder.Turn(*t) for t in ref],
                    [jder.Turn(*t) for t in hyp], collar=collar)
    assert _fields(ours) == _fields(want)
    assert str(ours) == str(want)


def test_der_on_random_turns_and_aggregate_match_jax():
    ours, want = [], []
    for seed in range(6):
        a, b = np.random.default_rng(seed), np.random.default_rng(seed)
        ref, jref = _turns(der, a, 12, 3), _turns(jder, b, 12, 3)
        hyp, jhyp = _turns(der, a, 15, 4), _turns(jder, b, 15, 4)
        ours.append(der.der(ref, hyp, total_secs=32.0))
        want.append(jder.der(jref, jhyp, total_secs=32.0))
        assert _fields(ours[-1]) == _fields(want[-1])
    assert _fields(der.aggregate(ours)) == _fields(jder.aggregate(want))


def test_synth_meeting_matches_jax():
    a, b = np.random.default_rng(3), np.random.default_rng(3)
    for n_spk in (2, 4):
        audio, turns = der.synth_meeting(a, n_spk, secs=12.0)
        jaudio, jturns = jder.synth_meeting(b, n_spk, secs=12.0)
        assert audio.tobytes() == jaudio.tobytes()
        assert [(t.start, t.end, t.speaker) for t in turns] == [
            (t.start, t.end, t.speaker) for t in jturns]


def test_rttm_roundtrip_matches_jax(tmp_path):
    turns = [der.Turn(0.5, 2.25, 0), der.Turn(2.0, 4.0, 1),
             der.Turn(7.125, 9.5, "x")]
    p, jp = str(tmp_path / "m.rttm"), str(tmp_path / "j.rttm")
    der.write_rttm(p, "m", turns)
    jder.write_rttm(jp, "m", [jder.Turn(t.start, t.end, t.speaker)
                              for t in turns])
    assert open(p, "rb").read() == open(jp, "rb").read()
    back, jback = der.load_rttm(p), jder.load_rttm(p)
    assert [(t.start, t.end, t.speaker) for t in back] == [
        (t.start, t.end, t.speaker) for t in jback]
    assert [t.speaker for t in back] == ["spk0", "spk1", "spkx"]


class _FakeDiarizer:
    """One full-chunk turn for speaker 0 a chunk."""

    def __init__(self, seg_cls):
        self.seg_cls, self.resets = seg_cls, 0

    def reset(self):
        self.resets += 1

    def diarize_chunk(self, audio, offset_secs=0.0):
        return [self.seg_cls(offset_secs, offset_secs + len(audio) / 16000,
                             0)]


def test_evaluate_rttm_dataset_matches_jax(tmp_path):
    audio = np.zeros(16000 * 3, np.float32)
    for name in ("a_stray", "b_pair", "c_pair"):
        save_wav(str(tmp_path / f"{name}.wav"), audio)
    for name, turns in (("b_pair", [der.Turn(0.0, 3.0, 0)]),
                        ("c_pair", [der.Turn(0.5, 1.5, 0),
                                    der.Turn(1.0, 2.0, 1)])):
        der.write_rttm(str(tmp_path / f"{name}.rttm"), name, turns)
    ours = _FakeDiarizer(dia.SpeakerSegment)
    ref = _FakeDiarizer(jdia.SpeakerSegment)
    got = der.evaluate_rttm_dataset(str(tmp_path), ours, chunk_secs=1.0)
    want = jder.evaluate_rttm_dataset(str(tmp_path), ref, chunk_secs=1.0)
    assert _fields(got) == _fields(want)
    assert ours.resets == ref.resets == 2
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(FileNotFoundError):
        der.evaluate_rttm_dataset(str(empty), ours)
    with pytest.raises(FileNotFoundError):
        jder.evaluate_rttm_dataset(str(empty), ref)


def test_synthetic_meetings_match_jax(tmp_path, monkeypatch):
    """The packaged checkpoints (from_local) over one synthetic meeting in
    5 s chunks: equal DER through both packages' engines and harnesses."""
    monkeypatch.setenv("OPENHUSH_MODEL_DIR", str(tmp_path))
    got = der.evaluate_synthetic_meetings(
        dia.DiarizationEngine.from_local(device="cpu"), n_meetings=1, seed=2,
        secs=10.0)
    want = jder.evaluate_synthetic_meetings(
        jdia.DiarizationEngine.from_local(), n_meetings=1, seed=2, secs=10.0)
    assert _fields(got) == _fields(want)
    assert np.isfinite(got.der)
