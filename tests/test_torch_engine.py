"""The port's whole slice against the JAX package on the same random weights
("test" config, fp32): greedy decoding, language detection, the engine's
seek loop, and the CLI.

The temperature ladder is pinned to (0.0,) in both engines: at t > 0 the
samples come from different random generators and cannot match. The GELU
choice is pinned to erf in both models. Tolerances: tokens and segments
exact; avg_logprob rtol 1e-5 (the issue's bound on sum_logprobs, divided
by the same length); no_speech_prob and language probabilities atol 1e-5."""

import json
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openhush_tpu.models.whisper import decoding as jax_decoding
from openhush_tpu.models.whisper import model as jax_model
from openhush_tpu.models.whisper.config import CONFIGS
from openhush_tpu.runtime import engine as jax_engine
from openhush_tpu.text.tokenizer import WhisperTokenizer as JaxTokenizer
from openhush_tpu_torch.models.whisper import decoding, model, weights
from openhush_tpu_torch.runtime import engine
from openhush_tpu_torch.text.tokenizer import WhisperTokenizer
from tests.test_torch_cli_support import cli_hooks  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = CONFIGS["test"]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this file's small-shape tests: the decode
    loops run thousands of tiny ops, and the test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _pinned(monkeypatch):
    monkeypatch.setattr(jax_model, "_GELU_MODE", "erf")
    monkeypatch.setattr(model, "_GELU_MODE", "erf")
    monkeypatch.setattr(jax_engine, "TEMPERATURES", (0.0,))
    monkeypatch.setattr(engine, "TEMPERATURES", (0.0,))


@pytest.fixture(scope="module")
def weights_pair():
    jparams = jax_model.init_params(CFG, jax.random.PRNGKey(0),
                                    dtype=jnp.float32)
    params = weights.from_numpy_params(jax.tree.map(np.asarray, jparams),
                                       torch.float32, "cpu")
    return jparams, params


def _speechish(secs, seed=0):
    rng = np.random.default_rng(seed)
    n = int(16000 * secs)
    t = np.arange(n) / 16000
    x = 0.3 * np.sin(2 * np.pi * 220 * t) * (0.5 + 0.5 * np.sin(
        2 * np.pi * 3 * t))
    return (x + 0.05 * rng.standard_normal(n)).astype(np.float32)


def _cross_pair(weights_pair, kind):
    jparams, _ = weights_pair
    feats = jnp.asarray(np.random.default_rng(1).standard_normal(
        (2, CFG.n_audio_ctx, CFG.n_audio_state)).astype(np.float32))
    fn = (jax_model.compute_cross_kv_quant if kind == "int8"
          else jax_model.compute_cross_kv)
    jkv = fn(CFG, jparams, feats)
    t = lambda a: torch.from_numpy(np.array(a))
    if kind == "int8":
        kv = model.QuantKVCache(t(jkv.k), t(jkv.k_scale), t(jkv.v),
                                t(jkv.v_scale))
    else:
        kv = model.KVCache(t(jkv.k), t(jkv.v))
    return jkv, kv


@pytest.mark.parametrize("kind", ["fp", "int8"])
def test_decode_greedy_matches_jax(weights_pair, kind):
    jparams, params = weights_pair
    jkv, kv = _cross_pair(weights_pair, kind)
    opts = jax_decoding.DecodingOptions(language="en", max_new_tokens=24)
    prompt = [50361, 440, 1000, 2000]          # start_of_prev + text
    ref = jax_decoding.decode_greedy(CFG, jparams, jkv, JaxTokenizer(99),
                                     opts, prompt_ids=prompt)
    ours = decoding.decode_greedy(
        CFG, params, kv, WhisperTokenizer(99),
        decoding.DecodingOptions(language="en", max_new_tokens=24),
        prompt_ids=prompt)
    np.testing.assert_array_equal(ours.tokens, ref.tokens)
    assert ours.prompt_len == ref.prompt_len
    np.testing.assert_allclose(ours.avg_logprob, ref.avg_logprob, rtol=1e-5)
    np.testing.assert_allclose(ours.no_speech_prob, ref.no_speech_prob,
                               atol=1e-5)


@pytest.mark.parametrize("kind", ["fp", "int8"])
def test_detect_language_matches_jax(weights_pair, kind):
    jparams, params = weights_pair
    jkv, kv = _cross_pair(weights_pair, kind)
    ref_langs, ref = jax_decoding.detect_language(CFG, jparams, jkv,
                                                  JaxTokenizer(99))
    langs, probs = decoding.detect_language(CFG, params, kv,
                                            WhisperTokenizer(99))
    assert langs == ref_langs
    np.testing.assert_allclose(probs, ref, atol=1e-5)


def _segments(result):
    return [(s.text, round(s.start, 6), round(s.end, 6), s.tokens)
            for s in result.segments]


@pytest.mark.parametrize("secs,language", [(2.0, "auto"), (35.0, "en")])
def test_transcribe_matches_jax_engine(weights_pair, secs, language):
    """Same injected weights, same audio: same windows and segments. The
    35 s input takes the seek loop over several windows with previous-text
    prompts."""
    jparams, params = weights_pair
    audio = _speechish(secs)
    ref = jax_engine.WhisperEngine("test", params=jparams).transcribe(
        audio, language=language, max_new_tokens=24)
    ours = engine.WhisperEngine("test", params=params,
                                device="cpu").transcribe(
        audio, language=language, max_new_tokens=24)
    assert ours.language == ref.language
    assert ours.windows == ref.windows
    assert _segments(ours) == _segments(ref)
    assert ours.text == ref.text


def test_transcribe_validates_and_refuses_unported_options(weights_pair,
                                                          monkeypatch):
    """Invalid audio raises; beam search is ported: transcribe(beam_size=3)
    runs the one-shot beam at T=0 on fp and on int8 decoder weights
    (parity with JAX in tests/test_torch_beam.py)."""
    from openhush_tpu_torch.models.whisper import beam
    from openhush_tpu_torch.runtime.validation import AudioValidationError
    _, params = weights_pair
    eng = engine.WhisperEngine("test", params=params, device="cpu")
    with pytest.raises(AudioValidationError):
        eng.transcribe(np.zeros(10, np.float32))
    q_eng = engine.WhisperEngine("test", params=params, device="cpu",
                                 quantize_weights=True)
    w = q_eng.params["decoder"]["layers"]["q_w"]
    assert w["q"].dtype == torch.int8 and w["s"].dtype == torch.float32
    assert q_eng.params["encoder"] is params["encoder"]
    calls = []
    decode_beam = beam.decode_beam
    monkeypatch.setattr(beam, "decode_beam", lambda *a, **k: (
        calls.append(1), decode_beam(*a, **k))[1])
    for e in (eng, q_eng):
        r = e.transcribe(_speechish(1.0), language="en", beam_size=3,
                         max_new_tokens=8)
        assert r.windows == 1 and isinstance(r.text, str)
    assert len(calls) == 2


def _run_cli(*args):
    # Two intra-op threads: the subprocess shares the CPU with the other
    # test workers, and an oversubscribed OpenMP pool runs many times
    # slower than a small one.
    env = dict(os.environ, PYTHONPATH=REPO, OPENHUSH_NO_FALLBACK="1",
               OPENHUSH_GELU="erf", OMP_NUM_THREADS="2")
    return subprocess.run(
        [sys.executable, "-m", "openhush_tpu_torch.cli", "transcribe",
         os.path.join(REPO, "tests", "data", "speechlike.wav"),
         "--model", "test", "--random-init", "--dtype", "float32",
         "--device", "cpu", *args],
        capture_output=True, text=True, env=env, timeout=300)


@pytest.mark.parametrize("fmt", ["json", "srt"])
def test_cli_output_parses(fmt):
    r = _run_cli("--format", fmt)
    assert r.returncode == 0, r.stderr
    if fmt == "json":
        data = json.loads(r.stdout)
        assert set(data) == {"text", "language", "duration_ms",
                             "audio_duration_secs", "transcription_time_ms",
                             "real_time_factor", "model"}
        assert data["model"] == "test" and data["audio_duration_secs"] == 1.5
        return
    ts = r"\d\d:\d\d:\d\d,\d\d\d"
    cues = re.findall(rf"^(\d+)\n{ts} --> {ts}$", r.stdout, re.M)
    assert cues and r.stdout.count(" --> ") == len(cues)
    assert [int(c) for c in cues] == list(range(1, len(cues) + 1))


def test_cli_refuses_several_files(capsys, cli_hooks):
    """Several files are no longer refused: they run through the serving
    path, and the text output heads each file's transcript with its path."""
    from openhush_tpu_torch import cli
    data = os.path.join(REPO, "tests", "data")
    paths = [os.path.join(data, "speechlike.wav"),
             os.path.join(data, "tone_sweep.wav")]
    rc = cli.main(["transcribe", *paths, "--model", "test", "--random-init",
                   "--dtype", "float32", "--device", "cpu"])
    assert rc == 0
    out = capsys.readouterr().out
    assert [line for line in out.splitlines() if line.startswith("--- /")] \
        == [f"--- {p} ---" for p in paths]
