"""The port's long-form recording (runtime/recording.py) against the JAX
package's, on the CPU: the recording cases of the reference's
tests/test_wakeword_diarization.py on the port's session, with the
segments (texts, starts, ends, speakers), the live output and the saved
file compared with the JAX session's on the same audio and the same
server; F3 (the port's session on a file ends by itself, the reference's
only through its max_duration); a real EngineServer at the `test` config
on both sides (the same weights), whose window texts agree; the diarizer
on the capture loop; and `cmd_record`: no draft, the guards on random
weights, its exit codes. Every session that could run on runs on a thread
joined with a timeout."""

import dataclasses
import io
import os
import queue
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openhush_tpu.models import diarization as jax_diarization
from openhush_tpu.models.whisper import model as jax_model
from openhush_tpu.models.whisper.config import CONFIGS
from openhush_tpu.runtime import recording as jax_recording
from openhush_tpu.runtime.server import EngineServer as JaxServer
from openhush_tpu.text.tokenizer import WhisperTokenizer as JaxTokenizer
from openhush_tpu_torch.audio.capture import FileSource
from openhush_tpu_torch.audio.wav import save_wav
from openhush_tpu_torch.models import diarization
from openhush_tpu_torch.models.whisper import model, weights
from openhush_tpu_torch.runtime import recording
from openhush_tpu_torch.runtime.recording import RecordingSession
from openhush_tpu_torch.runtime.server import EngineServer
from openhush_tpu_torch.text.tokenizer import WhisperTokenizer

CFG = CONFIGS["test"]
NO_GUARDS = dict(temperatures=(0.0,), logprob_threshold=-1e9,
                 no_speech_threshold=2.0)


@dataclasses.dataclass
class Result:
    window_id: int
    text: str


class FakeServer:
    """Canned-text engine server: the session logic without weights (the
    reference's fake-backend pattern)."""

    def __init__(self):
        self._q = queue.Queue()
        self.submitted = []

    def open_session(self):
        return 1

    def submit_window(self, sid, audio, window_id=0, **kw):
        self.submitted.append((window_id, len(audio)))
        self._q.put(Result(window_id, f"chunk at {window_id}"))

    def poll(self, sid, timeout=None):
        try:
            return self._q.get_nowait()
        except queue.Empty:
            return None


class PushedSource:
    """Delivers all its audio inside start() in 32 ms blocks, then stands
    as a finished capture thread: both sessions see the same buffer."""

    def __init__(self, audio, block=512):
        self.audio, self.block, self._thread = audio, block, None

    def start(self, callback):
        for i in range(0, len(self.audio), self.block):
            callback(self.audio[i:i + self.block])
        self._thread = threading.Thread(target=lambda: None)
        self._thread.start()
        self._thread.join()

    def stop(self):
        pass


def _noise(secs, seed):
    rng = np.random.default_rng(seed)
    return (0.2 * rng.standard_normal(int(16000 * secs))).astype(np.float32)


def _run(session, timeout=60, **kw):
    t = threading.Thread(target=session.run, kwargs=kw, daemon=True)
    t.start()
    t.join(timeout=timeout)
    alive = t.is_alive()
    if alive:
        session.stop()
        t.join(timeout=10)
    return not alive


def _run_reference(session, timeout=120):
    """Runs a JAX session and stops it from outside once its source is
    done, less than a chunk is buffered and nothing is pending: the test
    the port's loop makes itself (F3), where a max_duration would cut a
    session whose chunks are slow (a first compile) short."""
    t = threading.Thread(target=session.run, daemon=True)
    t.start()
    for _ in range(int(timeout / 0.005)):
        if not t.is_alive():
            break
        src = session.source._thread
        if src is not None and not src.is_alive() and \
                len(session._buffer) < 80000 and session._pending == 0:
            session.stop()
            break
        t.join(timeout=0.005)
    t.join(timeout=timeout)
    return not t.is_alive()


def _segments(session):
    return [(s.start_secs, s.end_secs, s.text, s.speaker_id)
            for s in session.segments]


def _session(side, server, source, tmp_path, fmt="srt", **kw):
    mod = jax_recording if side == "jax" else recording
    out = io.StringIO()
    outfile = str(tmp_path / f"{side}.{fmt}")
    s = mod.RecordingSession(
        mod.RecordingConfig(source="file", output_file=outfile,
                            output_format=fmt, live_mode=True),
        server, source, stdout=out, **kw)
    return s, out, outfile


# ---------- F3: a file session ends by itself ----------

@pytest.mark.parametrize("fmt", ["srt", "vtt"])
def test_file_session_ends_by_itself_with_the_reference_segments(
        fmt, tmp_path):
    """12 s of audio: the port's session over a real FileSource ends
    without max_duration (F3); the JAX session on the same audio, cut by
    max_duration=1 (its only way out), gives the same segments, live
    output and saved file."""
    audio = _noise(12.0, 4)
    got = {}
    for side in ("jax", "port"):
        server = FakeServer()
        if side == "jax":
            s, out, outfile = _session(side, server, PushedSource(audio),
                                       tmp_path, fmt)
            assert _run(s, max_duration=1)
        else:
            s, out, outfile = _session(side, server, FileSource(
                audio, realtime=False), tmp_path, fmt)
            assert _run(s, timeout=30), "the port's session ended by itself"
        assert s._pending == 0
        got[side] = dict(segments=_segments(s), live=out.getvalue(),
                         saved=open(outfile).read(),
                         submitted=server.submitted)
    assert got["port"] == got["jax"]
    port = got["port"]
    # 5 s chunks with 0.5 s overlap: 0 and 4.5 s, then the 3 s remainder.
    assert port["submitted"] == [(0, 80000), (4500, 80000), (9000, 48000)]
    assert [s[:2] for s in port["segments"]] == [(0.0, 5.0), (4.5, 9.5),
                                                 (9.0, 14.0)]


def test_reference_session_does_not_end_by_itself(tmp_path):
    """F3 in the reference: with every window drained and its source done,
    the JAX session's loop still runs (the overlap it keeps holds 0.5 s,
    its exit test wants less); it ends only when stopped."""
    server = FakeServer()
    s, _, _ = _session("jax", server, PushedSource(_noise(12.0, 4)),
                       tmp_path)
    t = threading.Thread(target=s.run, daemon=True)
    t.start()
    try:
        for _ in range(2000):
            if len(server.submitted) == 2 and s._pending == 0:
                break
            t.join(timeout=0.005)
        assert len(server.submitted) == 2 and s._pending == 0
        assert len(s._buffer) == 48000         # 12 - 2 x 4.5 s
        t.join(timeout=0.5)
        assert t.is_alive()
    finally:
        s.stop()
        t.join(timeout=10)
    assert not t.is_alive()
    assert len(server.submitted) == 3          # the remainder, at stop


def test_recording_session_file_source(tmp_path):
    """The reference's case on the port's session, without max_duration."""
    audio = _noise(12.0, 4)
    server = FakeServer()
    s, out, outfile = _session("port", server,
                               FileSource(audio, realtime=False), tmp_path)
    assert _run(s, timeout=30)
    assert len(s.segments) >= 3
    offsets = sorted(w for w, _ in server.submitted)
    assert offsets[1] - offsets[0] == 4500
    content = open(outfile).read()
    assert "-->" in content and "chunk at" in content
    assert "chunk at 0" in out.getvalue()
    starts = [seg.start_secs for seg in s.segments]
    assert starts == sorted(starts)
    assert set(s.latencies) == {w for w, _ in server.submitted}


@pytest.mark.parametrize("secs", [4.0, 5.0, 5.05, 9.5, 45.0])
def test_chunking_matches_reference(secs, tmp_path):
    """Short files, a file of exactly one chunk, a remainder under 0.1 s,
    phase 11's 45 s: the same windows and segments."""
    audio = _noise(secs, 7)
    got = {}
    for side in ("jax", "port"):
        server = FakeServer()
        s, out, _ = _session(side, server, PushedSource(audio), tmp_path)
        assert _run_reference(s) if side == "jax" else _run(s)
        got[side] = (server.submitted, _segments(s), out.getvalue())
    assert got["port"] == got["jax"]
    if secs == 45.0:
        assert [w for w, _ in got["port"][0]] == [4500 * i
                                                  for i in range(10)]


def test_stop_flushes_the_remainder(tmp_path):
    """Ctrl+C (stop) during a live capture: the remainder is submitted and
    drained, and the file saved, as the reference's final flush."""
    server = FakeServer()
    source = FileSource(_noise(30.0, 2), realtime=True)
    s, _, outfile = _session("port", server, source, tmp_path)
    t = threading.Thread(target=s.run, daemon=True)
    t.start()
    try:
        for _ in range(2000):
            if s._buffered() >= 16000:
                break
            t.join(timeout=0.005)
    finally:
        s.stop()
        t.join(timeout=30)
    assert not t.is_alive() and s._pending == 0
    assert server.submitted and os.path.exists(outfile)


# ---------- diarization on the capture loop ----------

def test_diarized_session_matches_reference(tmp_path, monkeypatch):
    """Two synthetic speakers, 9.5 s: each segment's speaker is the
    dominant speaker of its chunk, on the port's diarizer as on the JAX
    package's (the packaged checkpoints)."""
    from openhush_tpu_torch.training import speaker as sp
    monkeypatch.setenv("OPENHUSH_MODEL_DIR", str(tmp_path / "models"))
    rng = np.random.default_rng(3)
    bank = sp.synth_speaker_bank(rng, 2)
    audio = np.concatenate([
        sp.synth_utterance(rng, bank[i % 2], 8000 * 3) for i in range(6)]
        + [sp.synth_utterance(rng, bank[0], 8000)])
    got = {}
    for side, dz in (("jax", jax_diarization.DiarizationEngine.from_local()),
                     ("port", diarization.DiarizationEngine.from_local(
                         device="cpu"))):
        s, _, _ = _session(side, FakeServer(), PushedSource(audio),
                           tmp_path, diarizer=dz)
        assert _run_reference(s) if side == "jax" else _run(s)
        got[side] = _segments(s)
        if side == "port":
            assert len(s.diarize_secs) == len(s.segments) == 3
    assert got["port"] == got["jax"]
    assert all(seg[3] is not None for seg in got["port"])


def test_dominant_speaker():
    @dataclasses.dataclass
    class S:
        start_secs: float
        end_secs: float
        speaker_id: int

    assert recording.dominant_speaker([]) is None
    assert recording.dominant_speaker([S(0, 1, 0), S(1, 3.5, 1),
                                       S(3.5, 4.5, 0)]) == 1
    assert recording.dominant_speaker([S(0, 1, 2), S(1, 2, 5)]) == 2


# ---------- a real engine server on both sides ----------

def _words(tokenizer):
    """A word a token: the built-in vocabulary decodes only byte tokens."""
    tokenizer.decode = lambda ids: " ".join(f"w{int(t)}" for t in ids)
    return tokenizer


class Synchronous:
    """Wraps an engine server: no threads; each poll runs scheduler turns
    until everything submitted is done, so every window is decoded alone,
    whatever the loop's timing."""

    def __init__(self, server):
        self.server, self.done = server, {}

    def open_session(self):
        return self.server.open_session()

    def submit_window(self, sid, audio, window_id=0, **kw):
        self.server.submit_window(sid, audio, window_id=window_id, **kw)
        for _ in range(500):
            self.server.run_once()
            r = self.server.poll(sid)
            if r is not None:
                self.done.setdefault(sid, []).append(r)
                return
        raise AssertionError("window not decoded in 500 turns")

    def poll(self, sid, timeout=None):
        rs = self.done.get(sid)
        return rs.pop(0) if rs else None


def test_real_engine_session_matches_reference(tmp_path, monkeypatch):
    """The `test` config with the same weights on both sides (JAX's
    init_params carried over), fp32, 16 new tokens a window: the same
    windows, tokens and texts."""
    from openhush_tpu_torch.runtime import engine
    from openhush_tpu.runtime import engine as jax_engine
    for m in (jax_model, model):
        monkeypatch.setattr(m, "_GELU_MODE", "erf")
    monkeypatch.setattr(engine, "TEMPERATURES", (0.0,))
    monkeypatch.setattr(jax_engine, "TEMPERATURES", (0.0,))
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        jparams = jax_model.init_params(CFG, jax.random.PRNGKey(0),
                                        dtype=jnp.float32)
        params = weights.from_numpy_params(
            jax.tree.map(np.asarray, jparams), torch.float32, "cpu")
        servers = {
            "jax": JaxServer(CFG, jparams, n_slots=1, dtype=jnp.float32,
                             max_decode_len=16,
                             tokenizer=_words(JaxTokenizer(CFG.n_langs)),
                             **NO_GUARDS),
            "port": EngineServer(CFG, params, n_slots=1,
                                 dtype=torch.float32, max_decode_len=16,
                                 tokenizer=_words(WhisperTokenizer(
                                     CFG.n_langs)), **NO_GUARDS)}
        audio = _noise(10.0, 11)
        got = {}
        for side, server in servers.items():
            s, out, _ = _session(side, Synchronous(server),
                                 PushedSource(audio), tmp_path, fmt="text")
            assert (_run_reference(s) if side == "jax"
                    else _run(s, timeout=120))
            got[side] = (_segments(s), out.getvalue())
    finally:
        torch.set_num_threads(n)
    assert got["port"] == got["jax"]
    assert [seg[0] for seg in got["port"][0]] == [0.0, 4.5, 9.0]
    assert all(seg[2] for seg in got["port"][0])


# ---------- cmd_record ----------

def _config_file(tmp_path, **transcription):
    extra = "".join(f'{k} = "{v}"\n' for k, v in transcription.items())
    p = tmp_path / "config.toml"
    p.write_text(f'[transcription]\nmodel = "test"\nlanguage = "en"\n'
                 f'{extra}')
    return str(p)


def test_cmd_record_builds_no_draft_and_guards_random_weights(
        tmp_path, monkeypatch):
    """`record` builds its engine without the configured draft (the
    reference's loads it and never uses it) and, on random weights,
    neutralizes the ladder as `start` does; the session's server has the
    default audio_ctx and no preprocess."""
    monkeypatch.setenv("OPENHUSH_CONFIG", _config_file(
        tmp_path, draft_model="test-draft"))
    monkeypatch.setenv("OPENHUSH_DRAFT_MODEL", "test-draft")
    monkeypatch.setenv("OPENHUSH_ALLOW_RANDOM_INIT", "1")
    monkeypatch.setenv("OPENHUSH_MODEL_DIR", str(tmp_path / "models"))
    built = {}

    def fake_run(self, max_duration=None):
        built["server"], built["diarizer"] = self.server, self.diarizer

    monkeypatch.setattr(RecordingSession, "run", fake_run)
    wav = tmp_path / "a.wav"
    save_wav(str(wav), _noise(1.0, 1))
    from openhush_tpu_torch.runtime import engine
    engines = []
    init = engine.WhisperEngine.__init__
    monkeypatch.setattr(engine.WhisperEngine, "__init__", lambda self, *a,
                        **k: (init(self, *a, **k), engines.append(self))[0])
    assert recording.cmd_record(["--source", f"file:{wav}", "--device",
                                 "cpu"]) == 0
    srv = built["server"]
    assert engines and engines[0].draft_cfg is None
    assert srv.draft_cfg is None and srv.preprocess is None
    assert srv.audio_ctx == CFG.n_audio_ctx
    assert srv.temperatures == (0.0,) and built["diarizer"] is None
    # The reference's engine loads the configured draft.
    from openhush_tpu.runtime import engine as jax_engine
    ref = jax_engine.WhisperEngine("test", allow_random_init=True,
                                   draft_model="test-draft")
    assert ref.draft_cfg is not None


@pytest.mark.parametrize("args,code,message", [
    (["--source", "nowhere"], 2, "unknown source"),
    (["--format", "docx"], 2, "format"),
    (["--source", "monitor"], 1, "System-audio capture unavailable"),
])
def test_cmd_record_exit_codes(args, code, message, tmp_path, monkeypatch,
                               capsys):
    monkeypatch.setenv("OPENHUSH_CONFIG", _config_file(tmp_path))
    monkeypatch.setenv("OPENHUSH_ALLOW_RANDOM_INIT", "1")
    monkeypatch.setenv("OPENHUSH_MODEL_DIR", str(tmp_path / "models"))
    from openhush_tpu_torch.audio import system_audio_hosts
    monkeypatch.setattr(system_audio_hosts, "open_system_source",
                        lambda: (_ for _ in ()).throw(RuntimeError("none")))
    assert recording.cmd_record(args + ["--device", "cpu"]) == code
    assert message.lower() in capsys.readouterr().err.lower()


def test_monitor_without_a_tool_exits_1(tmp_path, monkeypatch, capsys):
    """`--source monitor` where no parec/pw-record is on PATH: the source
    cannot start, `record` exits 1 with its message."""
    monkeypatch.setenv("OPENHUSH_CONFIG", _config_file(tmp_path))
    monkeypatch.setenv("OPENHUSH_ALLOW_RANDOM_INIT", "1")
    monkeypatch.setenv("OPENHUSH_MODEL_DIR", str(tmp_path / "models"))
    from openhush_tpu_torch.audio import system_audio
    monkeypatch.setattr(system_audio.shutil, "which", lambda name: None)
    assert recording.cmd_record(["--source", "monitor", "--device",
                                 "cpu"]) == 1
    assert "parec/pw-record" in capsys.readouterr().err
