"""The port's host hooks (utils/platform_hosts.py, audio/system_audio_hosts.py)
against the JAX package's: the platform and loopback-capture cases of the
reference's tests/test_platform_hosts.py on the port's modules, with every
command plan (argv), quoting, key sequence, dispatch, device ranking and
resampled stream compared with the JAX modules' on the same input; the
macOS and Windows clipboard and paste of output/handlers.py, which now go
through the port's platform_hosts (the argv each host runs, recorded at
the `_run` choke point, equal to the JAX package's); and the daemon's
[feedback] cue and notification through them. No host command runs."""

import ctypes

import numpy as np
import pytest

from openhush_tpu.audio import system_audio_hosts as jax_sah
from openhush_tpu.output import handlers as jax_handlers
from openhush_tpu.utils import platform_hosts as jax_ph
from openhush_tpu_torch.audio import system_audio_hosts as sah
from openhush_tpu_torch.output import handlers
from openhush_tpu_torch.utils import platform_hosts as ph

TEXTS = ["", "hello", 'say "hi" \\ done', "it's", "multi\nline\ttab",
         "ünïcødé ✓", "$(rm -rf /); `x`", "a'b\"c\\d"]


# ---------- command plans, quoting: equal to the reference's ----------

@pytest.mark.parametrize("text", TEXTS)
def test_quoting_and_plans_match_reference(text):
    for name in ("osa_quote", "ps_quote", "macos_type_argv"):
        assert getattr(ph, name)(text) == getattr(jax_ph, name)(text)
    assert ph.macos_notify_argv("Title", text) == \
        jax_ph.macos_notify_argv("Title", text)
    assert ph.windows_notify_argv(text, "body") == \
        jax_ph.windows_notify_argv(text, "body")


@pytest.mark.parametrize("event", ["start", "stop", "error", "bell", "nope"])
def test_sound_plans_match_reference(event):
    assert ph.macos_sound_argv(event) == jax_ph.macos_sound_argv(event)
    assert ph.windows_sound_argv(event) == jax_ph.windows_sound_argv(event)


def test_fixed_plans_match_reference():
    for name in ("macos_paste_keystroke_argv",
                 "macos_open_accessibility_argv", "windows_clipboard_argv",
                 "ctrl_v_key_sequence"):
        assert getattr(ph, name)() == getattr(jax_ph, name)()
    assert ph.ACCESSIBILITY_INSTRUCTIONS == jax_ph.ACCESSIBILITY_INSTRUCTIONS
    assert ph.MAC_SOUNDS == jax_ph.MAC_SOUNDS
    assert ph.WIN_SOUNDS == jax_ph.WIN_SOUNDS
    assert ctypes.sizeof(ph.INPUT) == ctypes.sizeof(jax_ph.INPUT)
    assert ctypes.sizeof(ph.KEYBDINPUT) == ctypes.sizeof(jax_ph.KEYBDINPUT)


@pytest.mark.parametrize("plat", ["linux", "darwin", "macos", "win32"])
def test_dispatch_matches_reference(plat):
    assert type(ph.get_host_platform(plat)).__name__ == \
        type(jax_ph.get_host_platform(plat)).__name__


def _plans(mod, monkeypatch, host, calls):
    monkeypatch.setattr(mod, "_run", lambda argv, **kw: calls.append(
        (argv, kw.get("input_text"))) or True)
    monkeypatch.setattr(mod.shutil, "which", lambda name: f"/usr/bin/{name}")
    monkeypatch.setattr(mod, "_win_set_clipboard", lambda text: False)
    monkeypatch.setattr(mod, "_win_send_inputs", lambda seq: calls.append(
        ("send_inputs", tuple(seq))) or True)
    plat = mod.get_host_platform(host)
    return [plat.notify("Hi", "body"), plat.copy_to_clipboard("text"),
            plat.paste_text("some text", method="ctrl_v"),
            plat.paste_text("typed text", method="type"),
            plat.display_server(), plat.is_tty(),
            plat.accessibility_status()]


@pytest.mark.parametrize("host", ["darwin", "win32"])
def test_host_platform_runs_the_reference_plans(monkeypatch, host):
    got, want = [], []
    results = _plans(ph, monkeypatch, host, got)
    assert results == _plans(jax_ph, monkeypatch, host, want)
    assert got == want and len(got) >= 4


# ---------- the reference's cases on the port's module ----------

def test_osa_quote_escapes():
    assert ph.osa_quote('say "hi" \\ done') == '"say \\"hi\\" \\\\ done"'


def test_ps_quote_escapes():
    assert ph.ps_quote("it's") == "'it''s'"


def test_macos_sounds_match_reference_app():
    # macos.rs:222-240: Tink on start, Pop on stop.
    assert ph.macos_sound_argv("start")[1].endswith("Tink.aiff")
    assert ph.macos_sound_argv("stop")[1].endswith("Pop.aiff")
    assert ph.macos_sound_argv("nope") is None


def test_windows_sounds_match_reference_app():
    # windows.rs:115-140: Asterisk on start, Beep on stop.
    assert "Asterisk" in ph.windows_sound_argv("start")[-1]
    assert "Beep" in ph.windows_sound_argv("stop")[-1]
    assert ph.windows_sound_argv("nope") is None


def test_win32_input_struct_layout():
    inp = ph.INPUT()
    inp.type = ph.INPUT_KEYBOARD
    inp.u.ki = ph.KEYBDINPUT(0x56, 0, 2, 0, 0)
    assert inp.u.ki.wVk == 0x56 and inp.u.ki.dwFlags == 2


def test_macos_platform_runs_plans(monkeypatch):
    calls = []
    monkeypatch.setattr(ph, "_run",
                        lambda argv, **kw: calls.append(argv) or True)
    monkeypatch.setattr(ph.shutil, "which", lambda name: f"/usr/bin/{name}")
    mac = ph.MacOSPlatform()
    assert mac.notify("Hi", "body")
    assert calls[-1][0] == "osascript"
    assert mac.copy_to_clipboard("text")
    assert calls[-1] == ["pbcopy"]
    assert mac.paste_text("text", method="ctrl_v")
    assert "keystroke" in calls[-1][2] and "command down" in calls[-1][2]
    assert mac.display_server() == "macos" and not mac.is_tty()


def test_macos_accessibility_unknown_off_mac():
    assert ph.macos_accessibility_status() == "unknown"


def test_windows_platform_falls_back_to_powershell(monkeypatch):
    calls = []
    monkeypatch.setattr(ph, "_run",
                        lambda argv, **kw: calls.append(argv) or True)
    win = ph.WindowsPlatform()
    assert win.copy_to_clipboard("hello")
    assert "Set-Clipboard" in calls[-1][-1]
    assert win.notify("T", "B")
    assert "ShowBalloonTip" in calls[-1][-1]
    assert win.display_server() == "windows"


def test_windows_send_inputs_degrades_off_windows():
    assert ph._win_send_inputs(ph.ctrl_v_key_sequence()) is False


def test_linux_platform_delegates(monkeypatch):
    monkeypatch.setattr(handlers, "copy_to_clipboard", lambda t: True)
    assert ph.LinuxPlatform().copy_to_clipboard("x")


# ---------- output/handlers.py on macOS and Windows ----------

def _handler_plans(ph_mod, handlers_mod, monkeypatch, plat):
    calls = []
    monkeypatch.setattr(handlers_mod.sys, "platform", plat)
    monkeypatch.setattr(ph_mod, "_run", lambda argv, **kw: calls.append(
        (argv, kw.get("input_text"))) or True)
    monkeypatch.setattr(ph_mod.shutil, "which", lambda n: f"/usr/bin/{n}")
    monkeypatch.setattr(ph_mod, "_win_set_clipboard", lambda text: False)
    monkeypatch.setattr(ph_mod, "_win_send_inputs", lambda seq: calls.append(
        ("send_inputs", tuple(seq))) or True)
    out = [handlers_mod.copy_to_clipboard("copied"),
           handlers_mod.paste_text("pasted", "ctrl_v"),
           handlers_mod.paste_text("typed", "type")]
    return out, calls


@pytest.mark.parametrize("plat", ["darwin", "win32"])
def test_handlers_route_through_host_platform_as_reference(monkeypatch,
                                                           plat):
    """The clipboard and paste on macOS and Windows: delivered through the
    port's platform_hosts, with the reference's argv."""
    got = _handler_plans(ph, handlers, monkeypatch, plat)
    want = _handler_plans(jax_ph, jax_handlers, monkeypatch, plat)
    assert got == want
    assert got[0] == [True, True, True] and got[1]


# ---------- system_audio_hosts: ranking, resampler, guidance ----------

def _dev(name, inputs=2, rate=48_000.0):
    return {"name": name, "max_input_channels": inputs,
            "default_samplerate": rate}


DEVICES = [_dev("Microphone (USB)"), _dev("Stereo Mix (Realtek)"),
           _dev("Speakers [Loopback]"), _dev("Render target", inputs=0),
           _dev("BlackHole 2ch"), _dev("Soundflower (2ch)"),
           _dev("MacBook Pro Microphone"), _dev("Loopback Audio")]


@pytest.mark.parametrize("name", [None, "blackhole", "missing", "stereo"])
def test_rank_loopback_matches_reference(name):
    for markers in ("WINDOWS_LOOPBACK_MARKERS", "MACOS_LOOPBACK_MARKERS"):
        assert sah.rank_loopback_devices(
            DEVICES, getattr(sah, markers), name=name) == \
            jax_sah.rank_loopback_devices(
                DEVICES, getattr(jax_sah, markers), name=name)


def test_rank_loopback_prefers_marker_order():
    ranked = sah.rank_loopback_devices(DEVICES[:4],
                                       sah.WINDOWS_LOOPBACK_MARKERS)
    assert ranked == [2, 1]                  # [loopback] outranks stereo mix


def test_downmix_mono_matches_reference():
    rng = np.random.default_rng(0)
    for block in (rng.standard_normal((64, 2)), rng.standard_normal(64),
                  rng.standard_normal((16, 6)).astype(np.float32)):
        np.testing.assert_array_equal(sah.downmix_mono(block),
                                      jax_sah.downmix_mono(block))
    stereo = np.stack([np.ones(8), np.zeros(8)], axis=1)
    assert np.allclose(sah.downmix_mono(stereo), 0.5)


@pytest.mark.parametrize("rates", [(48_000, 16_000), (44_100, 16_000),
                                   (16_000, 16_000), (8_000, 16_000)])
def test_stream_resampler_matches_reference(rates):
    """The same ragged block stream through both resamplers: the same
    samples, bit for bit."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal(30_000).astype(np.float32)
    outs = []
    for mod in (sah, jax_sah):
        r = mod.StreamResampler(*rates)
        pos, chunks = 0, []
        for size in (7, 480, 1111, 4800, 9600, 13_991):
            chunks.append(r.process(x[pos:pos + size]))
            pos += size
        outs.append(np.concatenate(chunks))
    np.testing.assert_array_equal(outs[0], outs[1])
    assert len(outs[0]) > 0


def test_stream_resampler_matches_oneshot():
    rng = np.random.default_rng(0)
    x = rng.standard_normal(48_000).astype(np.float32)
    whole = sah.StreamResampler(48_000, 16_000).process(x)
    streamed = sah.StreamResampler(48_000, 16_000)
    chunks, pos = [], 0
    for size in (7, 480, 1111, 4800, 9600):
        while pos + size <= len(x):
            chunks.append(streamed.process(x[pos:pos + size]))
            pos += size
    chunks.append(streamed.process(x[pos:]))
    got = np.concatenate(chunks)
    n = min(len(whole), len(got))
    assert n > 15_000
    np.testing.assert_allclose(got[:n], whole[:n], atol=1e-6)


class _FakeSD:
    """Stands in for sounddevice in _DeviceLoopbackSource tests."""

    def __init__(self, devices):
        self._devices = devices

    def query_devices(self, idx=None):
        return self._devices if idx is None else self._devices[idx]


@pytest.mark.parametrize("cls", ["WasapiLoopbackSource",
                                 "MacSystemAudioSource"])
def test_loopback_guidance_matches_reference(monkeypatch, cls):
    msgs = []
    for mod in (sah, jax_sah):
        src = getattr(mod, cls)()
        monkeypatch.setattr(src, "_sounddevice",
                            lambda: _FakeSD([_dev("Normal Mic")]))
        with pytest.raises(mod.SystemAudioUnavailable) as ei:
            src.start(lambda s: None)
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]
    assert ("Stereo Mix" in msgs[0] if cls.startswith("Wasapi")
            else "blackhole" in msgs[0].lower())


def test_open_system_source_dispatch():
    assert isinstance(sah.open_system_source(platform="win32"),
                      sah.WasapiLoopbackSource)
    assert isinstance(sah.open_system_source(platform="darwin"),
                      sah.MacSystemAudioSource)
    from openhush_tpu_torch.audio.system_audio import MonitorSource
    assert isinstance(sah.open_system_source(platform="linux"),
                      MonitorSource)


# ---------- the daemon's [feedback] ----------

class _Host:
    def __init__(self, calls):
        self.calls = calls

    def play_sound(self, event="bell"):
        self.calls.append(("play_sound", event))
        return True

    def notify(self, summary, body="", urgency="normal"):
        self.calls.append(("notify", summary, body))
        return True


@pytest.mark.parametrize("audio,visual", [(True, True), (True, False),
                                          (False, True), (False, False)])
def test_daemon_feedback_matches_reference(monkeypatch, audio, visual):
    """`Daemon._feedback(started)` on a recording's start and stop: the
    same cue and notification through each package's platform_hosts."""
    import types

    from openhush_tpu.runtime import daemon as jax_daemon
    from openhush_tpu_torch.runtime import daemon
    got = {}
    for side, mod, hosts in (("jax", jax_daemon, jax_ph),
                             ("port", daemon, ph)):
        calls = []
        monkeypatch.setattr(hosts, "get_host_platform",
                            lambda platform=None: _Host(calls))
        d = types.SimpleNamespace(config=types.SimpleNamespace(
            feedback=types.SimpleNamespace(audio=audio, visual=visual)))
        mod.Daemon._feedback(d, started=True)
        mod.Daemon._feedback(d, started=False)
        got[side] = calls
    assert got["port"] == got["jax"]
    assert len(got["port"]) == 2 * (audio + visual)
