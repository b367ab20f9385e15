"""The port's dictation daemon (runtime/daemon.py) against the JAX
package's, on the CPU: the reference's tests/test_daemon.py cases, each run
on both daemons with the same weights (JAX's `init_params` carried over)
and the same audio, comparing what both produce — output texts, the
servers' window results (tokens exact), chunk ids, the window ids `_pack`
made, VAD segments, IPC responses. The servers are driven synchronously
(`run_once` + `_drain_results`) so both see the same schedule; where a test
runs a real daemon thread (the IPC cycle) responses are compared, not
timing. Every test that runs `Daemon.run` gives it its own XDG_RUNTIME_DIR
(the PID file lives there). Also: F1 (the preprocess fails loudly), the
engine's `random_init` and `benchmark_chunk_interval`, `_build_daemon`, and
the `start`/`status`/`recording`/`stop` entry points in subprocesses."""

import json
import logging
import os
import subprocess
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openhush_tpu.audio.capture import FileSource as JaxFileSource
from openhush_tpu.models.whisper import model as jax_model
from openhush_tpu.models.whisper.config import CONFIGS
from openhush_tpu.runtime import daemon as jax_daemon
from openhush_tpu.runtime import engine as jax_engine
from openhush_tpu.runtime.server import EngineServer as JaxServer
from openhush_tpu.text.tokenizer import WhisperTokenizer as JaxTokenizer
from openhush_tpu.utils import config as jax_config
from openhush_tpu.utils import platform as jax_platform
from openhush_tpu_torch.audio.capture import FileSource
from openhush_tpu_torch.models.whisper import model, weights
from openhush_tpu_torch.ops import dsp
from openhush_tpu_torch.runtime import daemon, engine
from openhush_tpu_torch.runtime.ipc import IpcClient
from openhush_tpu_torch.runtime.server import EngineServer
from openhush_tpu_torch.runtime.tracker import ChunkResult
from openhush_tpu_torch.text.tokenizer import WhisperTokenizer
from openhush_tpu_torch.utils import config
from openhush_tpu_torch.utils import platform

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = CONFIGS["test"]
NO_GUARDS = dict(temperatures=(0.0,), logprob_threshold=-1e9,
                 no_speech_threshold=2.0)
SIDES = ("jax", "port")


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Two intra-op threads while this file runs: its JAX and PyTorch
    servers, subprocesses and daemon threads share the CPU with the other
    test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _pinned(monkeypatch, tmp_path):
    monkeypatch.setattr(jax_model, "_GELU_MODE", "erf")
    monkeypatch.setattr(model, "_GELU_MODE", "erf")
    monkeypatch.setattr(engine, "TEMPERATURES", (0.0,))
    monkeypatch.setattr(jax_engine, "TEMPERATURES", (0.0,))
    # Every daemon of this file keeps its PID file and socket here.
    monkeypatch.setenv("XDG_RUNTIME_DIR", str(tmp_path))


@pytest.fixture(scope="module")
def weights_pair():
    jparams = jax_model.init_params(CFG, jax.random.PRNGKey(0),
                                    dtype=jnp.float32)
    params = weights.from_numpy_params(jax.tree.map(np.asarray, jparams),
                                       torch.float32, "cpu")
    return jparams, params


def _words(tokenizer):
    """The tokenizer with a decode that gives a word a token: the built-in
    vocabulary decodes only byte tokens, which random weights seldom emit,
    and the text pipeline needs text to act on."""
    tokenizer.decode = lambda ids: " ".join(f"w{int(t)}" for t in ids)
    return tokenizer


def _servers(weights_pair, max_decode_len=32, **kw):
    """Both servers on the same weights. max_decode_len 32 bounds a window
    to 31 tokens: random weights seldom emit EOT, and the comparisons need
    the tokens, not their number."""
    jparams, params = weights_pair
    kw["max_decode_len"] = max_decode_len
    return {"jax": JaxServer(CFG, jparams, n_slots=2, inner_steps=8,
                             dtype=jnp.float32,
                             tokenizer=_words(JaxTokenizer(CFG.n_langs)),
                             **NO_GUARDS, **kw),
            "port": EngineServer(CFG, params, n_slots=2, inner_steps=8,
                                 dtype=torch.float32,
                                 tokenizer=_words(WhisperTokenizer(
                                     CFG.n_langs)),
                                 **NO_GUARDS, **kw)}


@pytest.fixture(scope="module")
def servers(weights_pair):
    return _servers(weights_pair)


def _audio(secs=3.0, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(16000 * secs)) / 16000
    return (0.3 * np.sin(2 * np.pi * 300 * t)
            + 0.02 * rng.standard_normal(len(t))).astype(np.float32)


class Recorder:
    """Wraps a server: the window ids submitted, and each polled result's
    (window id, tokens, text)."""

    def __init__(self, server):
        self.server, self.submitted, self.results = server, [], []

    def __getattr__(self, name):
        return getattr(self.server, name)

    def submit_window(self, session_id, audio, window_id=0, **kw):
        self.submitted.append((window_id, len(audio)))
        return self.server.submit_window(session_id, audio,
                                         window_id=window_id, **kw)

    def poll(self, session_id, timeout=None):
        r = self.server.poll(session_id, timeout)
        if r is not None:
            self.results.append((r.window_id, list(r.tokens), r.text))
        return r


def _config(side, **transcription):
    cfg = (jax_config if side == "jax" else config).Config()
    cfg.transcription.model = "test"
    cfg.transcription.language = "en"
    for k, v in transcription.items():
        setattr(cfg.transcription, k, v)
    return cfg


def _make(side, server, tmp_path, outputs, cfg=None, **kw):
    cfg = cfg or _config(side)
    sock = str(tmp_path / f"{side}.sock")
    if side == "jax":
        return jax_daemon.Daemon(cfg, server, JaxFileSource(
            _audio(), realtime=False), output=outputs.append, ipc_path=sock,
            chunk_interval=0.2, **kw)
    return daemon.Daemon(cfg, server, FileSource(_audio(), realtime=False),
                         output=outputs.append, ipc_path=sock,
                         chunk_interval=0.2, device="cpu", **kw)


def _drain(d, server, turns=200):
    for _ in range(turns):
        server.run_once()
        d._drain_results()
        if d.tracker.is_empty():
            break


def test_push_to_talk_cycle_matches_reference(servers, tmp_path):
    got = {}
    for side in SIDES:
        rec, outputs = Recorder(servers[side]), []
        d = _make(side, rec, tmp_path, outputs)
        d.ring.push(_audio(2.0))
        assert d.start_recording()
        assert d.state.value == "recording"
        assert not d.start_recording()          # double start rejected
        d.ring.push(_audio(1.0, seed=1))
        d._submit_chunk()                        # the chunk timer
        d.ring.push(_audio(0.7, seed=2))
        assert d.stop_recording()               # submits the final chunk
        assert d.state.value == "idle"
        _drain(d, rec)
        assert d.tracker.is_empty()
        got[side] = dict(outputs=outputs, chunk_id=d._chunk_id,
                         submitted=rec.submitted, results=rec.results)
    assert got["port"] == got["jax"]
    port = got["port"]
    seq = port["submitted"][0][0] >> 32
    assert [w for w, _ in port["submitted"]] == [
        daemon.Daemon._pack(seq, 0, False), daemon.Daemon._pack(seq, 1, True)]
    assert port["chunk_id"] == 2 and len(port["results"]) == 2
    assert all(toks for _, toks, _ in port["results"])
    assert port["outputs"]                      # text reached the output


def test_toggle_matches_reference(servers, tmp_path):
    states = {}
    for side in SIDES:
        d = _make(side, servers[side], tmp_path, [])
        seen = []
        for _ in range(2):
            seen.append((d.toggle_recording(), d.state.value))
        seen.append((d.stop_recording(), d.state.value))
        _drain(d, servers[side])
        states[side] = seen
    assert states["port"] == states["jax"] == [
        (True, "recording"), (True, "idle"), (False, "idle")]


def test_continuous_mode_vad_segments_match_reference(servers, tmp_path):
    """Noise floor, a speech burst, silence: the energy VAD cuts the same
    segments on both, and the same windows go to the servers."""
    got = {}
    rng = np.random.default_rng(1)
    quiet = [(0.001 * rng.standard_normal(512)).astype(np.float32)
             for _ in range(80)]
    for side in SIDES:
        rec, outputs = Recorder(servers[side]), []
        d = _make(side, rec, tmp_path, outputs)
        segs = []
        submit = d._submit_vad_segment
        d._submit_vad_segment = lambda seg, now: (
            segs.append((seg.start, seg.end, now)), submit(seg, now))
        assert d.start_continuous()
        assert d.state.value == "continuous"
        for q in quiet[:20]:
            d.ring.push(q)
            d._vad_tick()
        d.ring.push(_audio(1.0))
        d._vad_tick()
        for q in quiet[20:]:
            d.ring.push(q)
            d._vad_tick()
        _drain(d, rec)
        assert d.stop_recording()
        got[side] = dict(segments=segs, chunk_id=d._chunk_id,
                         submitted=rec.submitted, results=rec.results,
                         outputs=outputs)
    assert got["port"] == got["jax"]
    assert len(got["port"]["segments"]) >= 1 and got["port"]["chunk_id"] >= 1


def test_ipc_full_cycle_matches_reference(weights_pair, tmp_path,
                                          monkeypatch):
    """A real daemon thread on each side (fresh servers), driven over its
    socket: the same responses for every command, the PID file gone at
    the end. queue_depth's value depends on timing, so only its presence
    is compared. The port's status reply also carries
    preprocess_failures (0 here), which the reference's lacks (F1)."""
    servers = _servers(weights_pair)
    cmds = ["status", "start_recording", "status", "stop_recording",
            "version", "queue_depth", "toggle_recording", "toggle_recording",
            "load_model", "unload_model", "bogus_command", "stop"]
    replies = {}
    for side in SIDES:
        run_dir = tmp_path / side
        run_dir.mkdir()
        monkeypatch.setenv("XDG_RUNTIME_DIR", str(run_dir))
        d = _make(side, servers[side], run_dir, [])
        t = threading.Thread(target=d.run, kwargs={"max_runtime": 60},
                             daemon=True)
        t.start()
        client = IpcClient(path=str(run_dir / f"{side}.sock"))
        for _ in range(100):
            if os.path.exists(client.path):
                break
            time.sleep(0.05)
        assert os.path.exists(str(run_dir / "openhush.pid"))
        out = []
        try:
            for cmd in cmds:
                r = client.send(cmd)
                if side == "port" and cmd == "status":
                    assert r.pop("preprocess_failures") == 0
                if "queue_depth" in r:
                    r["queue_depth"] = type(r["queue_depth"]).__name__
                out.append(r)
                if cmd == "start_recording":
                    time.sleep(0.5)       # let a chunk timer fire
        finally:
            t.join(timeout=60)
        assert not t.is_alive()
        assert not os.path.exists(str(run_dir / "openhush.pid"))
        replies[side] = out
    assert replies["port"] == replies["jax"]
    assert replies["port"][0]["ok"] and not replies["port"][0]["recording"]
    assert replies["port"][2]["recording"]
    assert replies["port"][-2] == {"ok": False,
                                   "error": "unknown command 'bogus_command'"}


def test_pid_file_lifecycle_matches_reference(tmp_path, monkeypatch):
    for mod in (jax_daemon, daemon):
        path = str(tmp_path / f"{mod.__name__}.pid")
        mod.write_pid_file(path)
        with open(path) as f:
            assert int(f.read()) == os.getpid()
        mod.remove_pid_file(path)
        with open(path, "w") as f:
            f.write("999999")
        mod.write_pid_file(path)            # stale: cleaned up
        mod.remove_pid_file(path)
        assert not os.path.exists(path)
    monkeypatch.setenv("XDG_RUNTIME_DIR", str(tmp_path))
    assert daemon.pid_file_path() == jax_daemon.pid_file_path() == str(
        tmp_path / "openhush.pid")
    # A live openhush process is refused by both.
    child = subprocess.Popen([sys.executable, "-c",
                              "import time; time.sleep(30)", "openhush"])
    try:
        for mod in (jax_daemon, daemon):
            path = str(tmp_path / "live.pid")
            with open(path, "w") as f:
                f.write(str(child.pid))
            with pytest.raises(RuntimeError, match="already running"):
                mod.write_pid_file(path)
    finally:
        child.kill()
        child.wait()


def test_app_profile_vocabulary_override_matches_reference(
        servers, tmp_path, monkeypatch):
    vocab = tmp_path / "code_vocab.toml"
    vocab.write_text('[subs]\n"foo" = "BAR"\n')
    outs = {}
    for side, plat, cr in ((
            "jax", jax_platform, jax_daemon.ChunkResult), (
            "port", platform, ChunkResult)):
        outputs = []
        cfg = _config(side)
        cfg.profiles = [{"name": "code", "app_match": "editor",
                         "vocabulary_path": str(vocab)}]
        d = _make(side, servers[side], tmp_path, outputs, cfg=cfg)
        monkeypatch.setattr(plat, "active_window",
                            lambda: {"app": "MyEditor", "title": "x"})
        d._process_and_output(cr(text="say foo now", sequence_id=1,
                                 chunk_id=0, is_final=True,
                                 duration_secs=1.0))
        monkeypatch.setattr(plat, "active_window",
                            lambda: {"app": "firefox", "title": "y"})
        d.app_context._last_poll = 0.0
        d.app_context._current_app = ""
        d._process_and_output(cr(text="say foo now", sequence_id=1,
                                 chunk_id=1, is_final=True,
                                 duration_secs=1.0))
        outs[side] = outputs
    assert outs["port"] == outs["jax"] == ["say BAR now", "say foo now"]


def test_idle_unload_and_reload_matches_reference(servers, tmp_path):
    got = {}
    for side in SIDES:
        server = servers[side]
        d = _make(side, server, tmp_path, [])
        d.config.transcription.idle_unload_secs = 1
        built = []
        d._server_factory = lambda: (built.append(1), server)[1]
        seen = []
        d.ring.push(_audio(1.0))
        seen.append(d.start_recording())
        seen.append(d.unload_model())           # refused while recording
        seen.append(d.stop_recording())
        _drain(d, server)
        d._session_id = None
        d._last_activity = time.monotonic()
        d._idle_check(time.monotonic())         # not idle long enough
        seen.append(d.model_loaded)
        d._idle_check(time.monotonic() + 5.0)   # past the deadline
        seen += [d.model_loaded, d.status().model_loaded]
        d.ring.push(_audio(1.0))
        seen += [d.start_recording(), list(built), d.model_loaded]
        d.stop_recording()
        _drain(d, server)
        got[side] = seen
    assert got["port"] == got["jax"] == [True, False, True, True, False,
                                         False, True, [1], True]


def test_ipc_load_unload_model_matches_reference(servers, tmp_path):
    got = {}
    for side in SIDES:
        server = servers[side]
        d = _make(side, server, tmp_path, [])
        seen = [d._handle_ipc({"cmd": "unload_model"}), d.model_loaded]
        d._server_factory = lambda: server
        seen += [d._handle_ipc({"cmd": "unload_model"}), d.model_loaded,
                 d._handle_ipc({"cmd": "status"})["model_loaded"],
                 d._handle_ipc({"cmd": "load_model"}), d.model_loaded]
        got[side] = seen
    assert got["port"] == got["jax"] == [{"ok": True}, True, {"ok": True},
                                         False, False, {"ok": True}, True]


def test_window_in_flight_at_the_next_start_is_lost_as_in_reference(
        servers, tmp_path):
    """F2 (ROADMAP C), repaired in the port: a final window still in flight
    when the next recording starts. The JAX daemon drains only its current
    session, so that window is never read: its text is lost, the tracker
    keeps it pending and idle unload is refused from then on. The port's
    daemon drains the earlier session first and closes it: both texts go
    out in the order of the presses, nothing stays pending, the unload
    goes through."""
    got = {}
    for side in SIDES:
        rec, outputs = Recorder(servers[side]), []
        d = _make(side, rec, tmp_path, outputs)
        assert d.start_recording()
        d.ring.push(_audio(1.0, seed=4))
        assert d.stop_recording()             # the final window, in flight
        first_session = d._session_id
        assert d.start_recording()            # the next press, before it ends
        _drain(d, rec, turns=40)
        d.ring.push(_audio(0.5, seed=5))
        assert d.stop_recording()
        _drain(d, rec, turns=40)
        d._server_factory = lambda: servers[side]
        got[side] = dict(outputs=outputs, polled=[w for w, _, _ in
                                                  rec.results],
                         texts={w: t for w, _, t in rec.results},
                         submitted=[w for w, _ in rec.submitted],
                         pending=d.tracker.pending_count,
                         first_open=first_session in servers[
                             side]._results,
                         unloaded=d.unload_model())
    ref, port = got["jax"], got["port"]
    assert len(ref["submitted"]) == 2 and ref["polled"] == \
        ref["submitted"][1:]
    assert len(ref["outputs"]) == 1
    assert ref["pending"] == 1 and not ref["unloaded"]
    assert port["submitted"] == ref["submitted"]
    assert port["polled"] == port["submitted"]            # in order
    assert port["outputs"] == [port["texts"][port["submitted"][0]].strip(),
                               ref["outputs"][0]]
    assert port["texts"][port["submitted"][1]] == \
        ref["texts"][ref["submitted"][1]]
    assert port["pending"] == 0 and port["unloaded"]
    assert not port["first_open"]                        # closed once drained


def test_drain_holds_a_later_session_until_the_earlier_is_in(servers,
                                                             tmp_path):
    """F2's order: while the earlier session's window is still in flight,
    a later session's finished window waits on the server; once the
    earlier one is in, both go out, earlier first."""
    server = servers["port"]
    outputs = []
    d = _make("port", server, tmp_path, outputs)
    assert d.start_recording()
    d.ring.push(_audio(1.0, seed=6))
    assert d.stop_recording()
    first = d._session_id
    assert d.start_recording()
    d.ring.push(_audio(0.5, seed=7))
    assert d.stop_recording()
    second = d._session_id
    assert [sid for _, sid in d._draining] == [first]
    # Decode both, without draining, then hand the earlier result back to
    # the server's queue after the later one: the later arrives first.
    for _ in range(200):
        server.run_once()
        if server._results[first].qsize() and server._results[second].qsize():
            break
    early = server._results[first].get_nowait()
    q = server._results[first]
    d._drain_results()
    assert outputs == [] and d.tracker.pending_count == 2
    q.put(early)
    d._drain_results()
    assert len(outputs) == 2 and d.tracker.pending_count == 0
    assert d._draining == [] and first not in server._results


def test_start_without_model_or_factory_fails_as_reference(tmp_path):
    for side in SIDES:
        d = _make(side, None, tmp_path, [])
        assert not d.model_loaded
        assert not d.start_recording()
        assert not d.start_continuous()
        assert d._handle_ipc({"cmd": "load_model"}) == {"ok": False}


def _http(port, method, path, key=None):
    import urllib.error
    import urllib.request
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 method=method,
                                 data=b"" if method == "POST" else None)
    if key:
        req.add_header("X-API-Key", key)
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_api_enabled_serves_the_rest_api(weights_pair, tmp_path,
                                         monkeypatch):
    """[api] enabled = true: `run` starts the port's ApiServer (the
    reference's routes), which answers /api/v1/health, refuses a request
    without the key, and drives one push-to-talk cycle whose text is
    output; every reply but status's preprocess_failures equals the JAX
    daemon's, and the outputs are the same."""
    from openhush_tpu.api.server import hash_api_key as jax_hash
    from openhush_tpu_torch.api.server import ApiServer, hash_api_key
    servers = _servers(weights_pair)
    got = {}
    for side in SIDES:
        run_dir = tmp_path / side
        run_dir.mkdir()
        monkeypatch.setenv("XDG_RUNTIME_DIR", str(run_dir))
        cfg = _config(side)
        cfg.api.enabled, cfg.api.port = True, 0
        cfg.api.api_key_hash = (jax_hash if side == "jax"
                                else hash_api_key)("k")
        outputs = []
        d = _make(side, servers[side], run_dir, outputs, cfg=cfg)
        t = threading.Thread(target=d.run, kwargs={"max_runtime": 60,
                                                   "enable_tray": False},
                             daemon=True)
        t.start()
        replies = []
        try:
            for _ in range(400):
                if getattr(d, "_api", None) is not None:
                    break
                time.sleep(0.05)
            api = d._api
            assert api is not None
            if side == "port":
                assert isinstance(api, ApiServer)
            port = api.port
            replies.append(_http(port, "GET", "/api/v1/health"))
            replies.append(_http(port, "GET", "/api/v1/status"))
            replies.append(_http(port, "POST", "/api/v1/recording/start",
                                 key="k"))
            d.ring.push(_audio(1.0, seed=8))
            replies.append(_http(port, "POST", "/api/v1/recording/stop",
                                 key="k"))
            for _ in range(1200):
                if outputs and d.tracker.is_empty():
                    break
                time.sleep(0.05)
            status = _http(port, "GET", "/api/v1/status", key="k")
            if side == "port":
                assert status[1].pop("preprocess_failures") == 0
            replies.append(status)
        finally:
            d._stop_event.set()
            t.join(timeout=60)
        assert not t.is_alive()
        got[side] = dict(replies=replies, outputs=outputs)
    assert got["port"] == got["jax"]
    port = got["port"]
    assert port["replies"][0][0] == 200 and port["replies"][1][0] == 401
    assert port["replies"][2] == (200, {"ok": True,
                                        "message": "Recording started"})
    assert port["replies"][4][1]["queue_depth"] == 0
    assert len(port["outputs"]) == 1 and port["outputs"][0]


def test_ipc_on_windows_routes_to_the_named_pipe(monkeypatch, tmp_path):
    """`ipc.create_server` on win32 gives the port's NamedPipeServer (as
    the reference's does), and a daemon built there answers over it."""
    from openhush_tpu_torch.runtime import ipc
    from openhush_tpu_torch.runtime.named_pipe import (NamedPipeClient,
                                                       NamedPipeServer)
    monkeypatch.setattr(ipc.sys, "platform", "win32")
    server = ipc.create_server(lambda r: {"ok": True}, path=str(
        tmp_path / "p.pipe"))
    assert isinstance(server, NamedPipeServer)
    d = daemon.Daemon(config.Config(), None, FileSource(_audio(0.5)),
                      output=print, ipc_path=str(tmp_path / "d.pipe"),
                      device="cpu")
    assert isinstance(d._ipc, NamedPipeServer)
    d._ipc.start()
    try:
        client = ipc.IpcClient(path=str(tmp_path / "d.pipe"))
        assert isinstance(client, NamedPipeClient)
        assert client.send("version") == {"ok": True,
                                          "version": daemon.__version__}
        assert client.send("status")["state"] == "idle"
    finally:
        d._ipc.stop()


# ---------- F1: the preprocess fails loudly ----------

def test_preprocess_failure_is_counted_and_logged(weights_pair, caplog,
                                                  tmp_path):
    """A preprocess that raises on a window: the server still transcribes
    the raw audio (as the reference does) but counts the failure in
    preprocess_failures, logs it at error level, and a daemon on that
    server reports the count in its IPC status reply."""
    _, params = weights_pair

    def broken(audio):
        raise RuntimeError("oh_limiter_gain: CUDA error 98 at launch")

    srv = EngineServer(CFG, params, n_slots=1, dtype=torch.float32,
                       max_decode_len=16, preprocess=broken, **NO_GUARDS)
    assert srv.preprocess_failures == 0
    sid = srv.open_session()
    with caplog.at_level(logging.ERROR):
        srv.submit_window(sid, _audio(0.5), window_id=7)
        for _ in range(50):
            srv.run_once()
            r = srv.poll(sid)
            if r is not None:
                break
    assert r is not None and r.window_id == 7
    assert srv.preprocess_failures == 1
    errors = [rec for rec in caplog.records if rec.levelno >= logging.ERROR
              and "preprocess failed" in rec.getMessage()]
    assert errors and "CUDA error 98" in caplog.text
    d = _make("port", srv, tmp_path, [])
    assert d._handle_ipc({"cmd": "status"})["preprocess_failures"] == 1


def test_build_preprocess_raises_at_build_when_a_kernel_fails(monkeypatch):
    """The chain runs once when it is built: a DSP stage that cannot launch
    (a stub that raises stands in for the card's kernel) fails
    build_preprocess itself; a working chain keeps its denoise state
    untouched by that run."""
    cfg = config.AudioConfig(noise_reduction_enabled=True)
    calls = []
    limit = dsp.limit
    monkeypatch.setattr(dsp, "limit", lambda *a, **k: (
        calls.append(1), limit(*a, **k))[1])
    pre = daemon.build_preprocess(cfg, device="cpu")
    assert calls == [1]                          # ran at build
    from openhush_tpu.runtime.daemon import build_preprocess as jax_build
    ref = jax_build(jax_config.AudioConfig(noise_reduction_enabled=True))
    x = _audio(0.5, seed=3) + 0.01
    np.testing.assert_allclose(pre(x), ref(x), atol=2e-5)
    np.testing.assert_allclose(pre(x), ref(x), atol=2e-5)

    def dead(*a, **k):
        raise RuntimeError("oh_limiter_gain: CUDA error 209 at launch")

    monkeypatch.setattr(dsp, "limit", dead)
    with pytest.raises(RuntimeError, match="CUDA error 209"):
        daemon.build_preprocess(config.AudioConfig(), device="cpu")


# ---------- the engine: random_init, benchmark_chunk_interval ----------

def test_random_init_matches_reference(weights_pair, tmp_path, monkeypatch):
    jparams, params = weights_pair
    monkeypatch.setenv("OPENHUSH_MODEL_DIR", str(tmp_path))
    kw = dict(dtype="float32", allow_random_init=True)
    cases = {"random": ({}, {}),
             "injected": ({"params": jparams}, {"params": params})}
    got = {}
    for name, (jkw, pkw) in cases.items():
        got[name] = (jax_engine.WhisperEngine("test", **kw, **jkw).random_init,
                     engine.WhisperEngine("test", **kw, **pkw,
                                          device="cpu").random_init)
    from openhush_tpu.models.whisper.convert import save_npz
    save_npz(jax.tree.map(np.asarray, jparams), str(tmp_path / "test.npz"))
    got["checkpoint"] = (
        jax_engine.WhisperEngine("test", **kw).random_init,
        engine.WhisperEngine("test", **kw, device="cpu").random_init)
    assert got == {"random": (True, True), "injected": (False, False),
                   "checkpoint": (False, False)}


def test_missing_checkpoint_names_the_conversion(tmp_path, monkeypatch):
    monkeypatch.setenv("OPENHUSH_MODEL_DIR", str(tmp_path))
    with pytest.raises(FileNotFoundError) as e:
        engine.WhisperEngine("test", device="cpu")
    assert "A9c" in str(e.value)
    assert "python -m openhush_tpu.cli model convert test" in str(e.value)


def test_benchmark_chunk_interval_within_the_reference_clamp(weights_pair,
                                                             monkeypatch):
    _, params = weights_pair
    eng = engine.WhisperEngine("test", params=params, device="cpu")
    calls = []
    transcribe = eng.transcribe
    monkeypatch.setattr(eng, "transcribe", lambda a, **k: (
        calls.append((len(a), k)), transcribe(a, max_new_tokens=4, **k))[1])
    secs = eng.benchmark_chunk_interval(margin=0.2)
    assert calls == [(32000, {"language": "en"})] * 2
    assert 0.5 <= secs <= 20.0          # max(0.5, min(4 * 5.0, ...))
    monkeypatch.setattr(eng, "transcribe", lambda *a, **k: 1 / 0)
    jeng = jax_engine.WhisperEngine.__new__(jax_engine.WhisperEngine)
    jeng.transcribe = lambda *a, **k: 1 / 0
    assert eng.benchmark_chunk_interval(fallback=3.0) == \
        jeng.benchmark_chunk_interval(fallback=3.0) == 3.0
    # On the card a failure (a kernel that cannot launch) propagates.
    monkeypatch.setattr(eng, "device", torch.device("cuda"))
    with pytest.raises(ZeroDivisionError):
        eng.benchmark_chunk_interval(fallback=3.0)


# ---------- _build_daemon and the entry points ----------

def _config_file(tmp_path, model="test", **transcription):
    p = tmp_path / "config.toml"
    extra = "".join(f"{k} = {json.dumps(v)}\n"
                    for k, v in transcription.items())
    p.write_text(f'[transcription]\nmodel = "{model}"\nlanguage = "en"\n'
                 f'warmup_on_load = false\n{extra}')
    return str(p)


def test_build_daemon_matches_reference(tmp_path, monkeypatch):
    """From one config file both builds give the same chunk interval,
    audio_ctx (5 s chunks → 512), ladder guards and preprocess; the port's
    lies on the device it was given."""
    monkeypatch.setenv("OPENHUSH_CONFIG", _config_file(tmp_path))
    monkeypatch.setenv("OPENHUSH_ALLOW_RANDOM_INIT", "1")
    monkeypatch.setenv("OPENHUSH_MODEL_DIR", str(tmp_path / "models"))
    ref = jax_daemon._build_daemon()
    port = daemon._build_daemon(device="cpu")
    for d in (ref, port):
        assert d.chunk_interval == 5.0 and d.server.audio_ctx == 512
        assert d.server.temperatures == (0.0,)
        assert d.server.preprocess is not None
        assert d.config.transcription.effective_model() == "test"
    assert daemon.audio_ctx_for(5.0) == 512
    assert [daemon.audio_ctx_for(s) for s in (0.5, 7.7, 40.0)] == \
        [256, 832, 1500]
    assert port.device.type == "cpu"
    assert port.server.params["decoder"]["tok_emb"].device.type == "cpu"
    assert port.server.audio_ctx == ref.server.audio_ctx
    rebuilt = port._server_factory()       # the reload path
    assert rebuilt is not port.server and rebuilt.audio_ctx == 512


def test_entry_points_start_status_recording_stop(tmp_path, monkeypatch,
                                                 capsys):
    """`start --no-tray --device cpu` in a subprocess, driven by the
    `status`, `recording start|stop` and `stop` subcommands (run through
    cli.main here): their exit codes, the state status prints, the PID
    file while it runs and its removal after, and the daemon's exit code
    0."""
    from openhush_tpu_torch import cli
    for k, v in (("OPENHUSH_CONFIG", _config_file(tmp_path)),
                 ("OPENHUSH_ALLOW_RANDOM_INIT", "1"),
                 ("OPENHUSH_MODEL_DIR", str(tmp_path / "models"))):
        monkeypatch.setenv(k, v)

    def run(*args):
        rc = cli.main(list(args))
        out = capsys.readouterr()
        return rc, out.out, out.err

    pid_file = tmp_path / "openhush.pid"
    assert run("status")[0] == 1                       # not running yet
    proc = subprocess.Popen(
        [sys.executable, "-m", "openhush_tpu_torch.cli", "start",
         "--no-tray", "--device", "cpu"],
        env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2"),
        cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        for _ in range(600):
            if (tmp_path / "openhush.sock").exists() or proc.poll() is not None:
                break
            time.sleep(0.1)
        assert proc.poll() is None, proc.communicate()[1][-2000:]
        assert int(pid_file.read_text()) == proc.pid
        rc, out, _ = run("status")
        assert rc == 0 and "State: idle" in out
        assert run("recording", "start")[:2] == (0, "ok\n")
        rc, out, _ = run("status")
        assert "State: recording" in out and "Recording: True" in out
        assert run("recording", "stop")[:2] == (0, "ok\n")
        assert "State: idle" in run("status")[1]
        assert run("recording", "stop")[0] == 1       # not recording
        rc, out, _ = run("stop")
        assert rc == 0 and "Daemon stopping" in out
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.communicate()
    assert not pid_file.exists()
    assert run("stop")[0] == 1                         # nothing to stop


def _eot_checkpoint(path):
    """A `test` checkpoint whose decoder gives token 1000, then EOT, in
    every window: the final layer norm gives its bias alone, and the bias
    points along both tokens' embeddings, a little more along EOT's, and
    long enough to make both logits stand far above the rest. EOT is
    suppressed at the first step (whisper's blank suppression), so 1000
    comes first; the window is confident, and no ladder rung follows."""
    tree = jax.tree.map(np.asarray, jax_model.init_params(
        CFG, jax.random.PRNGKey(0), dtype=jnp.float32))
    dec = tree["decoder"]
    emb = dec["tok_emb"]
    eot = WhisperTokenizer(CFG.n_langs).special.eot
    unit = lambda t: emb[t] / np.linalg.norm(emb[t])
    dec["ln_scale"] = np.zeros_like(dec["ln_scale"])
    dec["ln_bias"] = 4000.0 * (1.1 * unit(eot) + unit(1000))
    weights.save_npz(tree, path)


def test_record_entry_point_on_a_file(tmp_path, monkeypatch, capsys):
    """`record --source file:X --format srt -o OUT --device cpu` through
    cli.main: it ends by itself (F3) and exits 0; its live SRT on stdout
    and the file agree, in order, one cue a window with text."""
    import signal
    from openhush_tpu_torch import cli
    from openhush_tpu_torch.audio.wav import save_wav
    models = tmp_path / "models"
    models.mkdir()
    _eot_checkpoint(str(models / "test.npz"))
    for k, v in (("OPENHUSH_CONFIG", _config_file(tmp_path)),
                 ("OPENHUSH_MODEL_DIR", str(models))):
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(WhisperTokenizer, "decode",
                        lambda self, ids: " ".join(f"w{int(t)}"
                                                   for t in ids))
    wav, out = tmp_path / "talk.wav", tmp_path / "talk.srt"
    save_wav(str(wav), _audio(10.0, seed=9))
    handler = signal.getsignal(signal.SIGINT)
    try:
        rc = cli.main(["record", "--source", f"file:{wav}", "--format",
                       "srt", "-o", str(out), "--device", "cpu"])
    finally:
        signal.signal(signal.SIGINT, handler)
    live = capsys.readouterr().out
    assert rc == 0
    saved = out.read_text()
    cues = [c for c in saved.strip().split("\n\n") if c]
    assert len(cues) == 3                            # 0, 4.5 and 9 s
    assert [c.split("\n")[1].split(" --> ")[0] for c in cues] == [
        "00:00:00,000", "00:00:04,500", "00:00:09,000"]
    assert all(c.split("\n")[2] == "w1000" for c in cues)
    # Live cues are numbered in arrival order, the file's by start.
    assert sorted(c.split("\n", 1)[1] for c in live.strip().split("\n\n")) \
        == sorted(c.split("\n", 1)[1] for c in cues)
