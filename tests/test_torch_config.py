"""The port's config file (utils/config.py) against the JAX package's: the
same files load to equal values, save writes the same bytes, validate gives
the same errors; and the two CLIs resolve their model, language and draft
from one config file alike (ROADMAP C3: the port's transcribe used to
ignore the file)."""

import dataclasses
import json
import os
import subprocess
import sys

import pytest

from openhush_tpu.utils import config as jax_config
from openhush_tpu_torch.utils import config as config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROFILES = """
[transcription]
model = "small"
language = "de"

[output]
clipboard = false
paste = true

[correction]
ollama_model = "qwen"

[summarization.ollama]
url = "http://h:1"
model = "m"

[custom_section]
key = 1

[[profiles]]
name = "code"
app_match = "editor"
vocabulary_path = "/tmp/v.toml"

[[profiles]]
name = "chat"
app_match = "slack"
filler_mode = "aggressive"
"""


def _files(tmp_path):
    p = tmp_path / "profiles.toml"
    p.write_text(PROFILES)
    return {"example": os.path.join(REPO, "config.example.toml"),
            "golden": os.path.join(REPO, "tests", "data",
                                   "reference_config_golden.toml"),
            "profiles": str(p)}


@pytest.mark.parametrize("which", ["example", "golden", "profiles", "none"])
def test_load_equal_values_and_save_equal_bytes(tmp_path, which):
    path = _files(tmp_path).get(which, str(tmp_path / "missing.toml"))
    ref = jax_config.Config.load_or_default(path)
    port = config.Config.load_or_default(path)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.to_dict() == ref.to_dict()
    assert port.transcription.effective_model() == \
        ref.transcription.effective_model()
    ref.save(str(tmp_path / "ref.toml"))
    port.save(str(tmp_path / "port.toml"))
    saved = (tmp_path / "port.toml").read_bytes()
    assert saved == (tmp_path / "ref.toml").read_bytes()
    # And the saved file reads back to the same values.
    again = config.Config.load_or_default(str(tmp_path / "port.toml"))
    assert again.to_dict() == port.to_dict()
    if which == "profiles":
        assert [p["name"] for p in port.profiles] == ["code", "chat"]
        assert port.output.mode == "paste" and port.correction.model == "qwen"
        assert port.extra["custom_section"] == {"key": 1}
    if which == "none":
        assert port.transcription.device == "tpu"   # written back as read


BAD = {
    "model": ("transcription", "model", "huge"),
    "preset": ("transcription", "preset", "fast"),
    "vad threshold": ("vad", "threshold", 1.5),
    "max_pending": ("queue", "max_pending", -1),
    "backpressure": ("queue", "backpressure", "block"),
    "port": ("api", "port", 70000),
    "test model": ("transcription", "model", "test"),
}


@pytest.mark.parametrize("case", list(BAD))
def test_validate_gives_the_reference_errors(case):
    section, key, value = BAD[case]
    errors = []
    for mod in (jax_config, config):
        cfg = mod.Config()
        setattr(getattr(cfg, section), key, value)
        errors.append(cfg.validate())
    assert errors[1] == errors[0]
    assert bool(errors[1]) == (case != "test model")


def test_presets_and_config_path(tmp_path, monkeypatch):
    for preset in ("instant", "balanced", "quality", "custom"):
        cfgs = [m.TranscriptionConfig(preset=preset, model="tiny")
                for m in (jax_config, config)]
        assert cfgs[1].effective_model() == cfgs[0].effective_model()
    monkeypatch.delenv(config.CONFIG_ENV, raising=False)
    monkeypatch.setenv("XDG_CONFIG_HOME", str(tmp_path))
    assert config.config_path() == jax_config.config_path() == str(
        tmp_path / "openhush" / "config.toml")
    monkeypatch.setenv(config.CONFIG_ENV, str(tmp_path / "x.toml"))
    assert config.config_path() == jax_config.config_path() == str(
        tmp_path / "x.toml")


def _cli(package, config_path, model_dir, wav, extra=()):
    env = dict(os.environ, PYTHONPATH=REPO, OPENHUSH_NO_FALLBACK="1",
               OPENHUSH_CONFIG=config_path, OPENHUSH_MODEL_DIR=model_dir,
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="2")
    env.pop("OPENHUSH_DRAFT_MODEL", None)
    r = subprocess.run(
        [sys.executable, "-m", f"{package}.cli", "transcribe", wav,
         "--random-init", "--dtype", "float32", "--format", "json", *extra],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    # The reference prints progress lines before the JSON object.
    out = r.stdout
    return json.loads(out[out.index("\n{") + 1 if not out.startswith("{")
                          else 0:])


def test_cli_resolves_model_and_language_from_the_config_file(tmp_path):
    """C3: with no --model or --language, both CLIs take them from the file
    that OPENHUSH_CONFIG names (the port's used to take large-v3 and
    auto)."""
    cfg = tmp_path / "config.toml"
    cfg.write_text('[transcription]\nmodel = "test"\nlanguage = "de"\n'
                   'draft_model = ""\n')
    (tmp_path / "models").mkdir()
    wav = os.path.join(REPO, "tests", "data", "speechlike.wav")
    ref = _cli("openhush_tpu", str(cfg), str(tmp_path / "models"), wav)
    port = _cli("openhush_tpu_torch", str(cfg), str(tmp_path / "models"),
                wav, ("--device", "cpu"))
    assert (port["model"], port["language"]) == (ref["model"],
                                                 ref["language"])
    assert (port["model"], port["language"]) == ("test", "de")


def test_cli_draft_falls_back_to_the_config_file(tmp_path, monkeypatch,
                                                 capsys):
    """C3: without --draft the port's engine gets the file's
    transcription.draft_model, as the reference's does; a flag still
    wins."""
    from openhush_tpu_torch import cli
    from openhush_tpu_torch.runtime import engine
    cfg = tmp_path / "config.toml"
    cfg.write_text('[transcription]\nmodel = "test"\n'
                   'draft_model = "test-draft"\n')
    monkeypatch.setenv("OPENHUSH_CONFIG", str(cfg))
    monkeypatch.delenv("OPENHUSH_DRAFT_MODEL", raising=False)
    seen = []

    class Engine:
        def __init__(self, model, **kw):
            seen.append((model, kw["language"], kw["draft_model"]))
            raise FileNotFoundError("stop here")

    monkeypatch.setattr(engine, "WhisperEngine", Engine)
    wav = os.path.join(REPO, "tests", "data", "speechlike.wav")
    for extra in ([], ["--draft", "tiny", "--model", "base", "-l", "fr"]):
        assert cli.main(["transcribe", wav, "--device", "cpu", *extra]) == 1
    assert seen == [("test", "auto", "test-draft"), ("base", "fr", "tiny")]
