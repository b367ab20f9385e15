"""The PyTorch port (openhush_tpu_torch) stands alone: it imports neither jax
nor anything of the JAX package, its entry points default to CUDA and raise
without it, and its kernel wrappers never fall back to the plain version on
a device other than the CPU.

The import check runs in a subprocess because this test process has
already imported jax (tests/conftest.py)."""

import ast
import os
import subprocess
import sys

import pytest
import torch

from openhush_tpu_torch.ops import _build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "openhush_tpu_torch")


def _port_sources():
    for root, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


def _forbidden(name: str) -> bool:
    return (name == "jax" or name.startswith("jax.")
            or name == "openhush_tpu" or name.startswith("openhush_tpu."))


def test_import_pulls_in_no_jax():
    code = (
        "import pkgutil, sys, openhush_tpu_torch\n"
        "for m in pkgutil.walk_packages(openhush_tpu_torch.__path__, "
        "'openhush_tpu_torch.'):\n"
        "    __import__(m.name)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'openhush_tpu' or "
        "m.startswith('openhush_tpu.'))\n"
        "print(len([m for m in sys.modules if m.startswith('openhush_tpu_torch')]))\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, cwd=REPO, timeout=300)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.split()[-1]) >= 65     # every module was imported


@pytest.mark.parametrize("path", list(_port_sources()),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_sources_import_nothing_of_jax(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path}:{node.lineno} imports {bad}"


def test_entry_points_need_cuda_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    from openhush_tpu_torch.device import resolve_device
    from openhush_tpu_torch.models.whisper import weights
    from openhush_tpu_torch.models.whisper.config import get_config
    from openhush_tpu_torch.runtime.engine import WhisperEngine
    with pytest.raises(RuntimeError, match="no CUDA device"):
        WhisperEngine("test", allow_random_init=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        weights.init_params(get_config("test"), torch.Generator())
    assert resolve_device("cpu") == torch.device("cpu")
    eng = WhisperEngine("test", allow_random_init=True, dtype="float32",
                        device="cpu")
    assert eng.params["decoder"]["tok_emb"].device.type == "cpu"


def test_audio_front_needs_cuda_unless_cpu_is_asked():
    """The audio front's entry points default to CUDA as the engine does."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    from openhush_tpu_torch.models import silero, vad, wakeword
    from openhush_tpu_torch.ops import denoise
    from openhush_tpu_torch.runtime.daemon import build_preprocess

    class Cfg:
        engine, threshold, model_path = "energy", 0.5, ""

    for make in (lambda: build_preprocess(Cfg()), vad.VadEngine,
                 lambda: vad.create_engine(Cfg()), silero.SileroVad,
                 wakeword.WakeWordDetector, denoise.init_state):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    assert vad.VadEngine(device="cpu").device.type == "cpu"


def test_aux_models_need_cuda_unless_cpu_is_asked():
    """The aux models' and trainers' entry points default to CUDA as the
    engine does."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    from openhush_tpu_torch.models import diarization, m2m100, onnx2torch
    from openhush_tpu_torch.training import speaker
    from openhush_tpu_torch.utils.onnx_io import OnnxGraph, OnnxModel
    model = OnnxModel(OnnxGraph(nodes=[], initializers={}, inputs=[],
                                outputs=[]))
    gen = torch.Generator()
    for make in (diarization.DiarizationEngine,
                 lambda: diarization.init_segmentation_params(gen),
                 lambda: m2m100.init_params(m2m100.CONFIGS["test"], gen),
                 lambda: onnx2torch.OnnxTorchModel(model),
                 lambda: speaker.train_embedder(steps=0, n_speakers=2,
                                                utts_per_speaker=1)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    assert onnx2torch.OnnxTorchModel(model, "cpu").device.type == "cpu"


def test_daemon_needs_cuda_unless_cpu_is_asked(tmp_path):
    """The dictation daemon and its builder default to CUDA as the engine
    does; the copied host modules (config, ring, tracker, IPC, text
    pipeline) need no device."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    from openhush_tpu_torch.audio.capture import NullSource
    from openhush_tpu_torch.runtime import daemon
    from openhush_tpu_torch.utils.config import Config
    for make in (daemon._build_daemon,
                 lambda: daemon.Daemon(Config(), None, NullSource(1.0),
                                       output=print),
                 lambda: daemon.build_preprocess(Config().audio)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    d = daemon.Daemon(Config(), None, NullSource(1.0), output=print,
                      ipc_path=str(tmp_path / "s.sock"), device="cpu")
    assert d.device.type == "cpu" and d.vad_engine.device.type == "cpu"


def test_wrappers_never_fall_back_off_the_cpu():
    """On a device other than the CPU a wrapper launches its kernel or
    raises; the 'meta' device stands in for one here."""
    from openhush_tpu_torch.ops import flash_attention, frontend, quantize
    x = torch.empty(1, 4, 128, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        quantize.quantize_heads(x, 2)
    q = torch.empty(1, 2, 8, 64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        flash_attention.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="unsupported device"):
        frontend.log_mel(torch.empty(1, 480000, device="meta"))
    from openhush_tpu_torch.ops import denoise, dsp
    a = torch.empty(480000, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        dsp.follow_envelope(a, 0.9, 0.99)
    with pytest.raises(ValueError, match="unsupported device"):
        dsp.limiter_gain(a, 0.99)
    with pytest.raises(ValueError, match="unsupported device"):
        denoise.noise_floor(torch.empty(3000, 22, device="meta"),
                            torch.empty(22, device="meta"))


def test_kernel_build_needs_nvcc(tmp_path, monkeypatch):
    """Without a CUDA toolkit the build raises; nothing is compiled or
    loaded when the modules are imported."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
    name = _build.library_path().name
    assert name.startswith("libopenhush_kernels_") and name.endswith(".so")
    assert _build._lib is None


def test_record_needs_cuda_unless_cpu_is_asked(tmp_path, monkeypatch,
                                               capsys):
    """`record` resolves the card as `start` does: without CUDA (and
    without --device cpu) it exits 1 naming it and builds nothing; its
    session's diarizer defaults to CUDA too. The surfaces (REST API, named
    pipe, hotkey, D-Bus, tray, host hooks) need no device."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    from openhush_tpu_torch.runtime import recording
    monkeypatch.setenv("OPENHUSH_CONFIG", str(tmp_path / "none.toml"))
    wav = tmp_path / "a.wav"
    wav.write_bytes(b"")
    assert recording.cmd_record(["--source", f"file:{wav}"]) == 1
    assert "no CUDA device" in capsys.readouterr().err
    with pytest.raises(RuntimeError, match="no CUDA device"):
        recording.RecordingSession(
            recording.RecordingConfig(enable_diarization=True), None, None)
