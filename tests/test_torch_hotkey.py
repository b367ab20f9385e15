"""The port's global hotkey (runtime/hotkey.py, runtime/hotkey_hosts.py) and
system-audio mixing (audio/system_audio.py) against the JAX package's: the
hotkey and system-audio cases of the reference's
tests/test_hotkey_sysaudio.py and tests/test_platform_hosts.py on the
port's modules, with parsed keys, native chords, chord-engine and
listener events, the evdev listener's events from input_event bytes, and
mixed audio compared with the JAX modules' on the same input. Every thread
a test starts is joined."""

import os
import struct
import threading

import numpy as np
import pytest

from openhush_tpu.audio import system_audio as jax_sa
from openhush_tpu.runtime import hotkey as jax_hk
from openhush_tpu.runtime import hotkey_hosts as jax_hh
from openhush_tpu_torch.audio import system_audio as sa
from openhush_tpu_torch.audio.system_audio import (MixedSource,
                                                   list_monitor_sources)
from openhush_tpu_torch.runtime import hotkey as hk
from openhush_tpu_torch.runtime import hotkey_hosts as hh

SPECS = ["F9", "f1", "f12", "space", "a", "0", "ctrl+alt+space",
         "shift+meta+F5", "super+z", "ctrl+shift+alt+meta+enter",
         "CTRL + F9", "rightctrl+a", "pause", "esc"]
BAD_SPECS = ["notakey", "hyper+a", "", "ctrl+", "rightctrl", "ctrl",
             "+", "f13"]


def _outcome(fn, *args):
    try:
        return ("ok", fn(*args))
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("spec", SPECS + BAD_SPECS)
def test_parse_key_matches_reference(spec):
    got, want = _outcome(hk.parse_key, spec), _outcome(jax_hk.parse_key,
                                                       spec)
    if got[0] == "ok":
        got = ("ok", (got[1].key_code, got[1].modifiers))
        want = ("ok", (want[1].key_code, want[1].modifiers))
    assert got == want
    assert _outcome(hk.split_chord, spec) == _outcome(jax_hk.split_chord,
                                                      spec)


def test_tables_match_reference():
    assert hk.KEY_CODES == jax_hk.KEY_CODES
    assert hk.MODIFIERS == jax_hk.MODIFIERS
    for name in ("WIN_VK", "MAC_VK", "WIN_MODIFIER_VKS",
                 "MAC_MODIFIER_VKS"):
        assert getattr(hh, name) == getattr(jax_hh, name)


@pytest.mark.parametrize("spec", SPECS + BAD_SPECS)
@pytest.mark.parametrize("host", ["win", "mac"])
def test_native_chord_matches_reference(spec, host):
    tables = {"win": ("WIN_VK", "WIN_MODIFIER_VKS"),
              "mac": ("MAC_VK", "MAC_MODIFIER_VKS")}[host]
    got = _outcome(hh.native_chord, spec, *(getattr(hh, t) for t in tables))
    want = _outcome(jax_hh.native_chord, spec,
                    *(getattr(jax_hh, t) for t in tables))
    assert got == want


# A key script: (code, value) events, value 1 down, 0 up, 2 autorepeat.
KEY_SCRIPT = [(29, 1), (67, 1), (67, 2), (67, 0), (29, 0), (67, 1),
              (67, 0), (97, 1), (67, 1), (97, 0), (67, 0), (56, 1),
              (29, 1), (67, 1), (67, 0), (56, 0), (29, 0)]


def _listener_events(mod, spec, script, tmp_path):
    events = []
    listener = mod.HotkeyListener(
        spec, on_press=lambda: events.append("press"),
        on_release=lambda: events.append("release"),
        device_glob=str(tmp_path / "none*"))
    for code, value in script:
        listener._on_key(code, value)
        events.append(("down", tuple(sorted(listener._down))))
    return events


@pytest.mark.parametrize("spec", ["ctrl+f9", "f9", "ctrl+alt+f9"])
def test_chord_state_machine_matches_reference(spec, tmp_path):
    got = _listener_events(hk, spec, KEY_SCRIPT, tmp_path)
    assert got == _listener_events(jax_hk, spec, KEY_SCRIPT, tmp_path)
    assert "press" in got


def test_chord_state_machine(tmp_path):
    events = []
    listener = hk.HotkeyListener("ctrl+f9",
                                 on_press=lambda: events.append("press"),
                                 on_release=lambda: events.append("release"),
                                 device_glob=str(tmp_path / "none*"))
    listener._on_key(29, 1)           # ctrl down
    listener._on_key(67, 1)           # F9 down → press
    listener._on_key(67, 2)           # autorepeat ignored
    listener._on_key(67, 0)           # F9 up → release
    listener._on_key(29, 0)
    assert events == ["press", "release"]
    listener._on_key(67, 1)           # without the modifier: nothing
    listener._on_key(67, 0)
    assert events == ["press", "release"]


def test_evdev_listener_reads_input_events(tmp_path):
    """The listener's device thread on a FIFO that stands in for
    /dev/input/event0: input_event structs (timeval, type, code, value)
    written to it give the press and the release."""
    dev = tmp_path / "event0"
    os.mkfifo(dev)
    pressed, released = threading.Event(), threading.Event()
    events = []
    listener = hk.HotkeyListener(
        "ctrl+f9", on_press=lambda: (events.append("press"), pressed.set()),
        on_release=lambda: (events.append("release"), released.set()),
        device_glob=str(tmp_path / "event*"))
    assert listener.start()
    fd = os.open(dev, os.O_WRONLY)
    try:
        for code, value in [(29, 1), (67, 1)]:
            os.write(fd, struct.pack(hk._EVENT_FMT, 0, 0, hk.EV_KEY, code,
                                     value))
        assert pressed.wait(5)
        os.write(fd, struct.pack(hk._EVENT_FMT, 0, 0, 0x04, 4, 67))  # MSC
        for code, value in [(67, 0), (29, 0)]:
            os.write(fd, struct.pack(hk._EVENT_FMT, 0, 0, hk.EV_KEY, code,
                                     value))
        assert released.wait(5)
    finally:
        os.close(fd)
        listener.stop()
    assert not listener._thread.is_alive()
    assert events == ["press", "release"]


def test_listener_degrades_without_devices(tmp_path):
    listener = hk.HotkeyListener("f9", lambda: None, lambda: None,
                                 device_glob=str(tmp_path / "nope*"))
    assert listener.start() is False
    listener.stop()


# ---------- hotkey_hosts: the chord engine and the listeners ----------

POLL_SCRIPT = [set(), {0x78}, {0x78, 0xA3}, {0x78, 0xA3}, {0x78},
               set(), {0x78}, {0xA2}, {0xA2, 0x78}, set()]


def _poller_events(mod, script):
    down, events = set(), []
    poller = mod.ChordPoller(0x78, ((0xA2, 0xA3),), lambda c: c in down,
                             lambda: events.append("press"),
                             lambda: events.append("release"))
    for held in script:
        down.clear()
        down.update(held)
        poller.tick()
        events.append(len(events))
    return events


def test_chord_poller_matches_reference():
    got = _poller_events(hh, POLL_SCRIPT)
    assert got == _poller_events(jax_hh, POLL_SCRIPT)
    assert got.count("press") == 2 and got.count("release") == 2


def test_chord_poller_edges():
    down: set = set()
    events = []
    poller = hh.ChordPoller(0x78, ((0xA2, 0xA3),), lambda c: c in down,
                            lambda: events.append("press"),
                            lambda: events.append("release"))
    poller.tick()
    down.add(0x78)
    poller.tick()                            # key without modifier
    assert events == []
    down.add(0xA3)                           # right-ctrl counts
    poller.tick()
    poller.tick()                            # held: no repeat event
    assert events == ["press"]
    down.discard(0xA3)
    poller.tick()                            # mods released, key held
    assert events == ["press"]
    down.discard(0x78)
    poller.tick()
    assert events == ["press", "release"]


def test_native_chord_rejects_unmapped():
    with pytest.raises(ValueError):
        hh.native_chord("insert", hh.MAC_VK, hh.MAC_MODIFIER_VKS)
    with pytest.raises(ValueError):
        hh.native_chord("ctrl+", hh.WIN_VK, hh.WIN_MODIFIER_VKS)


def test_polling_listener_start_probes():
    def bad_probe(code):
        raise OSError("no native hook")
    listener = hh.PollingHotkeyListener(
        hh.ChordPoller(1, (), bad_probe, lambda: None, lambda: None))
    assert listener.start() is False


def test_polling_listener_fires_through_thread():
    down: set = set()
    fired = []
    evt = threading.Event()
    listener = hh.PollingHotkeyListener(
        hh.ChordPoller(7, (), lambda c: c in down,
                       lambda: (fired.append(1), evt.set()),
                       lambda: None), hz=500)
    assert listener.start()
    down.add(7)
    assert evt.wait(2.0)
    listener.stop()
    assert not listener._thread.is_alive()
    assert fired == [1]


def test_create_listener_dispatch():
    lin = hh.create_hotkey_listener("f9", lambda: None, lambda: None,
                                    platform="linux")
    assert isinstance(lin, hk.HotkeyListener)
    # Off-OS the Windows and macOS listeners need their native library:
    # OSError or AttributeError at construction, or a listener whose
    # start() says whether it runs.
    for plat in ("win32", "darwin"):
        try:
            listener = hh.create_hotkey_listener(
                "f9", lambda: None, lambda: None, platform=plat)
        except (OSError, AttributeError):
            continue
        assert listener.start() in (True, False)
        listener.stop()


# ---------- system audio ----------

def test_list_monitor_sources_no_crash():
    assert isinstance(list_monitor_sources(), list)


class _StubSource:
    def __init__(self, blocks):
        self.blocks = blocks

    def start(self, cb):
        for b in self.blocks:
            cb(b)

    def stop(self):
        pass


def test_mixed_source_sums_aligned():
    a = _StubSource([np.ones(100, np.float32),
                     np.ones(50, np.float32) * 3])
    b = _StubSource([np.ones(150, np.float32) * 2])
    out = []
    mixed = MixedSource(a, b)
    mixed.start(out.append)
    mixed.stop()
    got = np.concatenate(out)
    assert len(got) == 150
    np.testing.assert_allclose(got[:100], 1.5)   # (1+2)/2
    np.testing.assert_allclose(got[100:], 2.5)   # (3+2)/2


@pytest.mark.parametrize("n_sources", [2, 3])
def test_mixed_source_matches_reference(n_sources):
    """Ragged blocks from each source, fed in the same interleaving to
    both MixedSources: the same mixed blocks, bit for bit."""
    rng = np.random.default_rng(n_sources)
    streams = [[rng.standard_normal(int(n)).astype(np.float32)
                for n in rng.integers(1, 700, size=12)]
               for _ in range(n_sources)]
    order = rng.permutation(np.repeat(np.arange(n_sources), 12))

    def mix(mod):
        out = []
        m = mod.MixedSource(*[_StubSource([]) for _ in range(n_sources)])
        m.start(out.append)
        cbs = [m._make_cb(i) for i in range(n_sources)]
        taken = [0] * n_sources
        for i in order:
            cbs[i](streams[i][taken[i]])
            taken[i] += 1
        return out

    got, want = mix(sa), mix(jax_sa)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float32
        np.testing.assert_array_equal(g, w)


def test_monitor_source_without_a_tool_raises(monkeypatch):
    """No parec/pw-record on PATH: start() raises, as the reference's,
    which `record --source monitor` turns into exit 1."""
    monkeypatch.setattr(sa.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="parec/pw-record"):
        sa.MonitorSource().start(lambda s: None)
