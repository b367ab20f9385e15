"""Daemon orchestrator: state machine, chunked streaming, IPC, PID lifecycle,
on the GPU.

Port of openhush_tpu/runtime/daemon.py (the counterpart of the reference's
src/daemon.rs): always-on capture into the ring buffer, push-to-talk /
toggle / continuous modes, the chunk timer, VAD-gated segmentation, results
→ tracker (ordering + dedup) → vocabulary, correction, translation, output
and actions. The model runs in the continuous-batching EngineServer on the
card; the per-window preprocess (`build_preprocess`), the VAD engine and the
wake-word detector run there too. `_build_daemon(device=None)` builds all
of them on CUDA and raises without a card; tests pass device="cpu".

States (parity: daemon.rs:739-762): IDLE / RECORDING / CONTINUOUS.
PID lifecycle (parity: daemon.rs:2269-2355,2509-2588): O_EXCL create, stale
cleanup with /proc existence + cmdline verification. The PID file and the
IPC socket live in $XDG_RUNTIME_DIR (else /tmp): give each concurrent
daemon, a test's included, its own directory.

The control surfaces start in `run` as the reference's do: the system
tray (ui/tray_windows.create_tray: SNI, macOS or Windows), the global
hotkey (runtime/hotkey_hosts.create_hotkey_listener, by [hotkey] mode),
the REST API (api/server.ApiServer, when [api] enabled) and the D-Bus
service (utils/dbus.DbusService); each that cannot start on this host is
logged and the daemon carries on. [feedback] plays the start/stop cue and
shows the notification through utils/platform_hosts.

Differences from the reference:
- A window still in flight when the next recording starts is not lost
  (ROADMAP C, F2): the reference drains only its current session, so the
  text of such a window never reaches the output, the tracker keeps it
  pending for good and refuses every idle unload after. Here
  `_drain_results` polls every earlier session that still has windows in
  flight, in session order, before the current one, and closes each once
  it has drained; the current session's results wait until then, so texts
  go out in the order of the presses.
- The REST API's `status` reply carries `preprocess_failures`, as the IPC
  reply does (next item).
- `build_preprocess` runs its chain once on a short silent window when it
  is built, so a DSP kernel that fails to build or to launch raises there
  and not, window after window, inside the server (ROADMAP C, F1). A
  window whose preprocess still raises is counted by the server, and the
  IPC `status` reply (and `status`'s printout) carries that count as
  `preprocess_failures`.
- An idle unload also releases PyTorch's cached device memory
  (`torch.cuda.empty_cache`, after clearing the cuBLAS workspaces that
  would keep large cached blocks reserved), so that other programs on a
  shared card can use it: the point of unloading.
"""

from __future__ import annotations

import dataclasses
import enum
import gc
import json
import logging
import os
import signal
import sys
import threading
import time
from typing import Callable, Optional

import numpy as np
import torch

from openhush_tpu_torch import __version__
from openhush_tpu_torch.device import resolve_device
from openhush_tpu_torch.models import vad as vad_mod
from openhush_tpu_torch.ops import denoise as dn
from openhush_tpu_torch.ops import dsp
from openhush_tpu_torch.runtime import ipc
from openhush_tpu_torch.runtime.ring_buffer import RingBuffer
from openhush_tpu_torch.runtime.tracker import ChunkResult, TranscriptionTracker

log = logging.getLogger(__name__)

class DaemonState(enum.Enum):
    IDLE = "idle"
    RECORDING = "recording"
    CONTINUOUS = "continuous"


def pid_file_path() -> str:
    runtime = os.environ.get("XDG_RUNTIME_DIR", "/tmp")
    return os.path.join(runtime, "openhush.pid")


def write_pid_file(path: Optional[str] = None) -> None:
    """O_EXCL create with stale-PID cleanup (daemon.rs:2269-2355)."""
    path = path or pid_file_path()
    while True:
        try:
            fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_EXCL, 0o600)
            os.write(fd, str(os.getpid()).encode())
            os.close(fd)
            return
        except FileExistsError:
            try:
                with open(path) as f:
                    old_pid = int(f.read().strip() or "0")
            except (ValueError, OSError):
                old_pid = 0
            if old_pid and _pid_is_openhush(old_pid):
                raise RuntimeError(
                    f"Daemon already running (pid {old_pid})")
            log.warning("Removing stale PID file (pid %d gone)", old_pid)
            try:
                os.unlink(path)
            except FileNotFoundError:
                pass


def _pid_is_openhush(pid: int) -> bool:
    """Verify the process exists AND is ours before refusing/killing —
    parity with the /proc/<pid>/exe check (daemon.rs:2509-2588)."""
    try:
        with open(f"/proc/{pid}/cmdline", "rb") as f:
            cmdline = f.read().decode(errors="replace")
    except OSError:
        return False
    return "openhush" in cmdline


def remove_pid_file(path: Optional[str] = None) -> None:
    try:
        os.unlink(path or pid_file_path())
    except FileNotFoundError:
        pass


@dataclasses.dataclass
class DaemonStatus:
    running: bool
    recording: bool
    state: str
    model: str
    queue_depth: int
    model_loaded: bool = True
    version: str = __version__
    # Windows whose preprocess raised and went on as raw audio (the
    # server's count; 0 while unloaded). The port's own field: the
    # reference has no such count.
    preprocess_failures: int = 0


class Daemon:
    """Composable daemon: inject audio source / engine server / output.
    The default VAD engine and the wake-word detector run on `device`
    (CUDA unless the caller asks for the CPU)."""

    def __init__(self, config, server, audio_source,
                 output: Optional[Callable[[str], None]] = None,
                 ipc_path: Optional[str] = None,
                 vad_engine=None,
                 chunk_interval: Optional[float] = None,
                 server_factory: Optional[Callable[[], object]] = None,
                 device=None):
        self.config = config
        self.device = resolve_device(device)
        self.server = server
        # Rebuilds the engine server after an idle unload (parity:
        # WorkerCommand::LoadEngine/UnloadEngine, src/queue/worker.rs:18-25,
        # daemon.rs:2181-2234).
        self._server_factory = server_factory
        # Serializes server load/unload/final-submit so an idle unload
        # can't pull the server out from under an in-flight submission
        # (never nested inside self._lock — take it first).
        self._model_lock = threading.Lock()
        # Held by the run loop's device work (the VAD and wake-word
        # engines) and by an unload's release of the cuBLAS workspaces.
        self._device_lock = threading.Lock()
        self._running = False
        self._last_activity = time.monotonic()
        self.source = audio_source
        self._handler = None
        if output is None:
            # Real daemon path: clipboard/paste per [output] config with
            # [queue].separator between pasted chunks (parity:
            # OutputHandler::output, src/output/mod.rs:44); falls back
            # to stdout when no clipboard/display is available.
            from openhush_tpu_torch.output.handlers import OutputHandler
            self._handler = OutputHandler(
                mode=config.output.mode,
                paste_method=config.output.paste_method,
                separator=getattr(config.queue, "separator", " "))
            output = self._handler.output
        self.output = output
        self._batch_outputs = 0
        self.ring = RingBuffer(duration_secs=60.0)
        self.tracker = TranscriptionTracker(streaming=True)
        self.vad_engine = vad_engine or vad_mod.create_engine(
            config.vad, device=self.device)
        self.vad_state = vad_mod.VadState(vad_mod.VadStateConfig(
            threshold=config.vad.threshold,
            min_silence_ms=config.vad.min_silence_ms,
            min_speech_ms=config.vad.min_speech_ms,
            speech_pad_ms=config.vad.pad_ms))
        self.chunk_interval = chunk_interval or (
            config.queue.chunk_interval_secs
            if config.queue.chunk_interval_secs > 0 else 5.0)

        # Post-processing pipeline (parity: process_and_output,
        # daemon.rs:459-560) — every stage degrades gracefully.
        from openhush_tpu_torch.output.handlers import (ActionContext,
                                                        ActionRunner)
        from openhush_tpu_torch.postproc.correction import (CorrectionConfig,
                                                            TextCorrector)
        from openhush_tpu_torch.postproc.translation import (
            TranslationConfig, Translator)
        from openhush_tpu_torch.text.vocabulary import VocabularyManager
        self._ActionContext = ActionContext
        self.vocabulary = VocabularyManager(
            config.vocabulary.path or None,
            config.vocabulary.reload_interval_secs)
        self.corrector = None
        if config.correction.enabled:
            self.corrector = TextCorrector(CorrectionConfig(
                enabled=True, ollama_url=config.correction.ollama_url,
                model=config.correction.model,
                remove_fillers=config.correction.remove_fillers,
                filler_mode=config.correction.filler_mode,
                timeout_secs=config.correction.timeout_secs))
        self.translator = None
        if config.translation.enabled:
            try:
                self.translator = Translator(TranslationConfig(
                    enabled=True, backend=config.translation.backend,
                    target_language=config.translation.target_language,
                    ollama_url=config.translation.ollama_url,
                    ollama_model=config.translation.ollama_model))
            except Exception as e:  # noqa: BLE001
                log.warning("Translation disabled: %s", e)
        try:
            self.actions = ActionRunner.from_config_list(
                list(config.output.actions))
        except Exception as e:  # noqa: BLE001
            log.warning("Actions disabled: %s", e)
            self.actions = ActionRunner([])

        # Per-app profiles (parity: context.rs + Config::find_profile).
        from openhush_tpu_torch.utils.context import (AppContext,
                                                      profiles_from_config)
        self.app_context = AppContext(
            profiles_from_config(list(getattr(config, "profiles", []))))
        self._profile_vocab: dict[str, VocabularyManager] = {}

        # Wake word: always-on while IDLE (parity: daemon.rs:2105-2179).
        self.wake_detector = None
        self._wake_pos = 0
        if getattr(config.wake_word, "enabled", False):
            try:
                from openhush_tpu_torch.models.wakeword import (
                    WakeWordConfig, WakeWordDetector)
                ww_cfg = WakeWordConfig(
                    threshold=config.wake_word.threshold,
                    model_name=config.wake_word.model)
                emb_p = getattr(config.wake_word, "embedding_path", "")
                cls_p = getattr(config.wake_word, "classifier_path", "")
                if emb_p and cls_p:
                    # converted openWakeWord ONNX stages
                    self.wake_detector = WakeWordDetector.from_onnx(
                        emb_p, cls_p, ww_cfg, device=self.device)
                else:
                    self.wake_detector = WakeWordDetector(
                        ww_cfg, device=self.device)
            except Exception as e:  # noqa: BLE001
                log.warning("Wake word disabled: %s", e)

        self.state = DaemonState.IDLE
        self._session_id: Optional[int] = None
        self._sequence = 0
        self._chunk_id = 0
        self._chunk_mark = 0         # ring position of last submitted chunk
        self._vad_pos = 0
        self._stop_event = threading.Event()
        self._lock = threading.Lock()
        # Windows submitted and not yet polled, by session; and the earlier
        # sessions (server, session id) that still had windows in flight
        # when the next one opened, in session order (F2). Both under
        # self._lock.
        self._in_flight: dict[int, int] = {}
        self._draining: list[tuple[object, int]] = []
        self._tray = self._hotkey = self._api = self._dbus = None
        self._ipc = ipc.create_server(self._handle_ipc, path=ipc_path)

    # -- recording control (parity: daemon.rs:1274-1308) ----------------------

    def start_recording(self) -> bool:
        if not self.ensure_model():
            return False
        with self._lock:
            if self.state != DaemonState.IDLE or self.server is None:
                return False
            self.state = DaemonState.RECORDING
            self._sequence += 1
            self._chunk_id = 0
            self._chunk_mark = self.ring.current_position()
            self.tracker.reset_dedup()
            self._open_session()
            self._last_chunk_time = time.monotonic()
            self._last_activity = self._last_chunk_time
        log.info("Recording started (seq %d)", self._sequence)
        self._emit_recording_changed()
        self._feedback(started=True)
        return True

    def _open_session(self) -> None:
        """A new server session for the next recording (under self._lock).
        The one before it is closed now if it has nothing in flight, else
        drained first by `_drain_results` (F2)."""
        old = self._session_id
        if old is not None:
            if self._in_flight.get(old):
                self._draining.append((self.server, old))
            else:
                self._in_flight.pop(old, None)
                self.server.close_session(old)
        self._session_id = self.server.open_session()

    def _feedback(self, started: bool) -> None:
        """[feedback] section parity (config.example.toml:51-57): beep +
        desktop notification on recording start/stop."""
        fb = getattr(self.config, "feedback", None)
        if fb is None:
            return
        try:
            from openhush_tpu_torch.utils.platform_hosts import (
                get_host_platform)
            host = get_host_platform()
            if fb.audio:
                host.play_sound("start" if started else "stop")
            if fb.visual:
                host.notify("OpenHush",
                            "Recording…" if started else "Recording stopped")
        except Exception:  # noqa: BLE001 — feedback is never fatal
            pass

    def stop_recording(self) -> bool:
        with self._lock:
            if self.state == DaemonState.IDLE:
                return False
            state = self.state
            self.state = DaemonState.IDLE
        if state == DaemonState.RECORDING:
            # Under the model lock: state is already IDLE here, so an
            # idle/IPC unload could otherwise race the final submit.
            with self._model_lock:
                if self.server is not None:
                    self._submit_chunk(final=True)
        self._last_activity = time.monotonic()
        log.info("Recording stopped (seq %d)", self._sequence)
        self._emit_recording_changed()
        self._feedback(started=False)
        return True

    def toggle_recording(self) -> bool:
        if self.state == DaemonState.IDLE:
            return self.start_recording()
        return self.stop_recording()

    # -- dynamic model residency (parity: WorkerCommand::{Load,Unload}Engine
    # + the idle-unload timer, daemon.rs:1155-1173,2181-2234) ------------------

    @property
    def model_loaded(self) -> bool:
        return self.server is not None

    def ensure_model(self) -> bool:
        """Load the engine server if it was unloaded; True when usable.
        Concurrent callers (IPC load + start) build at most ONE server: the
        factory runs under the model lock, losers reuse it."""
        if self.server is not None:
            return True
        if self._server_factory is None:
            return False
        with self._model_lock:
            if self.server is not None:   # built while we waited
                return True
            log.info("Loading model on demand…")
            try:
                server = self._server_factory()
            except Exception as e:  # noqa: BLE001 — soft failure
                log.error("Model load failed: %s", e)
                return False
            with self._lock:
                self.server = server
                self._last_activity = time.monotonic()
            if self._running and hasattr(server, "start"):
                server.start()
        return True

    def unload_model(self) -> bool:
        """Free device memory while idle; reloads on the next recording.
        No-op (False) while recording or without a rebuild factory."""
        with self._model_lock:
            with self._lock:
                if (self.state != DaemonState.IDLE or self.server is None
                        or self._server_factory is None
                        or self.tracker.pending_count):
                    return False
                server, self.server = self.server, None
                self._session_id = None
                self._in_flight.clear()
                self._draining.clear()
            if hasattr(server, "stop"):
                try:
                    server.stop()
                except Exception:  # noqa: BLE001
                    pass
            del server
            gc.collect()        # drop the device buffers now, not at next GC
            if self.device.type == "cuda":
                # The server's threads leave cuBLAS workspaces (32 MiB a
                # thread and stream) that were allocated inside the large
                # blocks of earlier temporaries and would keep those
                # blocks reserved: clear them, then release the cached
                # blocks. The run loop's device work waits meanwhile.
                with self._device_lock:
                    torch._C._cuda_clearCublasWorkspaces()
                    torch.cuda.empty_cache()
        log.info("Model unloaded")
        return True

    def _idle_check(self, now: float) -> None:
        idle_secs = getattr(self.config.transcription,
                            "idle_unload_secs", 0)
        if (idle_secs > 0 and self.state == DaemonState.IDLE
                and self.server is not None
                and self._server_factory is not None
                and now - self._last_activity >= idle_secs):
            if self.unload_model():
                log.info("Unloaded model after %.0f s of inactivity",
                         now - self._last_activity)

    def start_continuous(self) -> bool:
        if not self.ensure_model():
            return False
        with self._lock:
            if self.state != DaemonState.IDLE or self.server is None:
                return False
            self.state = DaemonState.CONTINUOUS
            self._sequence += 1
            self._chunk_id = 0
            self._vad_pos = self.ring.current_position()
            self._vad_ring_base = self._vad_pos
            self.vad_state.reset()
            self.vad_engine.reset()
            self.tracker.reset_dedup()
            self._open_session()
        log.info("Continuous dictation started (seq %d)", self._sequence)
        self._emit_recording_changed()
        return True

    # -- chunk submission -------------------------------------------------------

    def _submit_chunk(self, final: bool = False) -> None:
        now = self.ring.current_position()
        audio = self.ring.extract_range(self._chunk_mark, now)
        self._chunk_mark = now
        min_samples = int(0.2 * 16000)
        if len(audio) < min_samples and not final:
            return
        if len(audio) < min_samples:
            audio = np.pad(audio, (0, min_samples - len(audio)))
        self._submit_audio(audio, final)

    def _submit_audio(self, audio: np.ndarray, final: bool) -> None:
        """Submit audio, splitting anything longer than the server's
        (audio_ctx-restricted) window."""
        # Snapshot: an unload on another thread nulls self.server, but a
        # local reference keeps this submission safe end-to-end.
        server, session_id = self.server, self._session_id
        if server is None or session_id is None:
            return
        max_window = getattr(server, "audio_ctx", 1500) * 2 * 160
        pieces = [audio[i:i + max_window]
                  for i in range(0, max(1, len(audio)), max_window)]
        for j, piece in enumerate(pieces):
            is_last = final and j == len(pieces) - 1
            accepted = self.tracker.add_pending(
                self._sequence, self._chunk_id,
                max_pending=self.config.queue.max_pending,
                strategy=self.config.queue.backpressure)
            if accepted:
                with self._lock:
                    self._in_flight[session_id] = \
                        self._in_flight.get(session_id, 0) + 1
                server.submit_window(
                    session_id, piece,
                    window_id=self._pack(self._sequence, self._chunk_id,
                                         is_last),
                    language=self.config.transcription.language,
                    task=("translate"
                          if self.config.transcription.translate
                          else "transcribe"),
                    timestamps=False)
            elif not getattr(self, "_backpressure_notified", False):
                # Desktop heads-up on drops (parity: backpressure
                # notifications via notify-rust).
                from openhush_tpu_torch.utils.platform import notify
                notify("OpenHush", "Transcription queue full — audio "
                       "chunks are being dropped", urgency="critical")
                self._backpressure_notified = True
            self._chunk_id += 1

    @staticmethod
    def _pack(seq: int, chunk: int, final: bool) -> int:
        return (seq << 32) | (chunk << 1) | int(final)

    @staticmethod
    def _unpack(window_id: int) -> tuple[int, int, bool]:
        return window_id >> 32, (window_id & 0xFFFFFFFF) >> 1, \
            bool(window_id & 1)

    # -- main loop -----------------------------------------------------------------

    def run(self, max_runtime: Optional[float] = None,
            enable_tray: bool = True) -> None:
        write_pid_file()
        self._ipc.start()
        # System tray (StatusNotifierItem; graceful when no SNI host —
        # parity: daemon.rs:843-859 tray init warning path, gated by the
        # --no-tray flag like main.rs:57-59).
        self._tray = None
        if enable_tray:
            try:
                from openhush_tpu_torch.ui.tray_windows import create_tray
                self._tray = create_tray()
                log.info("System tray initialized")
            except Exception as e:  # noqa: BLE001
                log.info("System tray unavailable (%s); continuing", e)
        self._start_hotkey()
        self._start_api()
        # D-Bus service (Linux desktop control plane; graceful when no
        # session bus — parity: daemon.rs:877-886 D-Bus init warning path).
        self._dbus = None
        try:
            from openhush_tpu_torch.utils.dbus import DbusService
            self._dbus = DbusService(self._handle_dbus)
            log.info("D-Bus service registered: org.openhush.Daemon1")
        except Exception as e:  # noqa: BLE001
            log.info("D-Bus unavailable (%s); socket/REST control only", e)
        self.source.start(self._on_audio)
        self._running = True
        if self.server is not None and hasattr(self.server, "start"):
            self.server.start()
        # SIGHUP → config reload (parity: daemon.rs:1240-1244,417-428);
        # SIGTERM/SIGINT → graceful stop. Only from the main thread.
        if threading.current_thread() is threading.main_thread():
            signal.signal(signal.SIGHUP, lambda *a: self.reload_config())
            signal.signal(signal.SIGTERM,
                          lambda *a: self._stop_event.set())
            signal.signal(signal.SIGINT,
                          lambda *a: self._stop_event.set())
        started = time.monotonic()
        self._last_chunk_time = started
        self._last_activity = started
        last_vad_tick = started
        last_idle_check = started
        try:
            while not self._stop_event.is_set():
                now = time.monotonic()
                if max_runtime and now - started > max_runtime:
                    break
                if now - last_idle_check >= 10.0:
                    last_idle_check = now
                    self._idle_check(now)
                if self.state == DaemonState.RECORDING and \
                        now - self._last_chunk_time >= self.chunk_interval:
                    self._submit_chunk()
                    self._last_chunk_time = now
                if self.state == DaemonState.CONTINUOUS and \
                        now - last_vad_tick >= 0.032:
                    self._vad_tick()
                    last_vad_tick = now
                if self.state == DaemonState.IDLE and \
                        self.wake_detector is not None:
                    self._wake_tick()
                self._drain_results()
                if self._tray is not None and not self._tray_tick():
                    break           # Quit picked from the tray menu
                time.sleep(0.005)
        finally:
            self.shutdown()

    def _start_hotkey(self) -> None:
        """Global hotkey (push-to-talk / toggle / continuous by
        config.hotkey.mode)."""
        self._hotkey = None
        try:
            from openhush_tpu_torch.runtime.hotkey_hosts import (
                create_hotkey_listener)
            mode = self.config.hotkey.mode
            if mode == "toggle":
                on_press, on_release = self.toggle_recording, lambda: None
            elif mode == "continuous":
                on_press, on_release = self.start_continuous, lambda: None
            else:  # push_to_talk
                on_press, on_release = (self.start_recording,
                                        self.stop_recording)
            hk = create_hotkey_listener(self.config.hotkey.key, on_press,
                                        on_release)
            if hk.start():
                self._hotkey = hk
                log.info("Global hotkey %s active (%s mode)",
                         self.config.hotkey.key, mode)
        except (ValueError, OSError) as e:
            log.warning("Hotkey disabled: %s", e)

    def _start_api(self) -> None:
        """The REST control plane, when [api] enabled."""
        self._api = None
        if not getattr(self.config.api, "enabled", False):
            return
        from openhush_tpu_torch.api.server import ApiServer
        self._api = ApiServer(
            host=self.config.api.host, port=self.config.api.port,
            api_key_hash=self.config.api.api_key_hash,
            cors_origins=self.config.api.cors_origins,
            status_fn=lambda: dataclasses.asdict(self.status()),
            command_fn=self._api_command)
        try:
            self._api.start()
            log.info("REST API on %s:%d", self.config.api.host,
                     self._api.port)
        except OSError as e:
            log.warning("REST API failed to start: %s", e)
            self._api = None

    def shutdown(self) -> None:
        self._stop_event.set()
        self._running = False
        try:
            self.source.stop()
        except Exception:  # noqa: BLE001
            pass
        if self.server is not None and hasattr(self.server, "stop"):
            self.server.stop()
        for surface in (self._api, self._hotkey, self._dbus, self._tray):
            if surface is not None:
                try:
                    surface.stop()
                except Exception:  # noqa: BLE001
                    pass
        self._ipc.stop()
        remove_pid_file()

    def _tray_tick(self) -> bool:
        """Poll tray events + refresh the status icon; False = quit
        requested (parity: daemon.rs:1251-1271)."""
        from openhush_tpu_torch.ui.tray import TrayEvent, TrayStatus
        ev = self._tray.try_recv()
        if ev is TrayEvent.QUIT:
            log.info("Quit requested from tray")
            return False
        if ev is TrayEvent.SHOW_PREFERENCES:
            log.info("Opening preferences from tray")
            self._spawn_preferences()
        if self.state != DaemonState.IDLE:
            status = TrayStatus.RECORDING
        elif self.tracker.pending_count > 0:
            status = TrayStatus.PROCESSING
        else:
            status = TrayStatus.IDLE
        try:
            self._tray.set_status(status)
        except Exception:  # noqa: BLE001 — bus went away; keep running
            pass
        return True

    def _spawn_preferences(self) -> None:
        """Open the preferences UI as a detached subprocess (parity:
        gui::spawn_preferences, src/gui/mod.rs:52 — the reference also
        re-execs itself with a `preferences` argument). The port's
        `preferences` is ROADMAP A9c and exits 2 naming it until then."""
        import subprocess
        try:
            subprocess.Popen(
                [sys.executable, "-m", "openhush_tpu_torch.cli",
                 "preferences", "--open"],
                stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
                start_new_session=True)
        except OSError as e:
            log.warning("could not spawn preferences UI: %s", e)

    def _handle_dbus(self, member: str):
        """org.openhush.Daemon1 methods (parity: src/dbus/interface.rs:35)."""
        if member == "StartRecording":
            return ("b", self.start_recording())
        if member == "StopRecording":
            return ("b", self.stop_recording())
        if member == "ToggleRecording":
            return ("b", self.toggle_recording())
        if member == "LoadModel":
            return ("b", self.ensure_model())
        if member == "UnloadModel":
            return ("b", (True if self._server_factory is None
                          else self.unload_model()))
        if member == "GetStatus":
            return ("s", json.dumps(dataclasses.asdict(self.status())))
        if member == "GetQueueDepth":
            return ("u", self.tracker.pending_count)
        if member == "GetVersion":
            return ("s", __version__)
        raise ValueError(f"unknown method {member!r}")

    def _emit_recording_changed(self) -> None:
        if self._dbus is not None:
            try:
                self._dbus.emit_recording_changed(
                    self.state != DaemonState.IDLE)
            except Exception:  # noqa: BLE001
                pass

    def _api_command(self, action: str) -> bool:
        return {"start": self.start_recording,
                "stop": self.stop_recording,
                "toggle": self.toggle_recording}[action]()

    def reload_config(self) -> None:
        """Reload hot-swappable config sections (SIGHUP). Model/audio-device
        changes need a restart — same constraint as the reference."""
        from openhush_tpu_torch.utils.config import Config
        try:
            new = Config.load_or_default()
        except Exception as e:  # noqa: BLE001
            log.warning("Config reload failed: %s", e)
            return
        errors = new.validate()
        if errors:
            log.warning("Config reload rejected: %s", "; ".join(errors))
            return
        self.config.vad = new.vad
        self.config.queue = new.queue
        self.config.output = new.output
        self.config.vocabulary = new.vocabulary
        self.config.correction = new.correction
        self.config.translation = new.translation
        self.config.transcription.language = new.transcription.language
        self.config.transcription.translate = new.transcription.translate
        if new.queue.chunk_interval_secs > 0:
            self.chunk_interval = new.queue.chunk_interval_secs
        from openhush_tpu_torch.text.vocabulary import VocabularyManager
        self.vocabulary = VocabularyManager(
            new.vocabulary.path or None,
            new.vocabulary.reload_interval_secs)
        log.info("Configuration reloaded (SIGHUP)")

    def _on_audio(self, samples: np.ndarray) -> None:
        self.ring.push(samples)

    # -- VAD continuous mode (parity: daemon.rs:1955-2079) -------------------------

    def _vad_tick(self) -> None:
        now = self.ring.current_position()
        chunk = self.ring.extract_range(self._vad_pos, now)
        if len(chunk) < vad_mod.CHUNK_SIZE:
            return
        self._vad_pos = now
        # Feed complete 512-sample chunks through the VAD.
        for off in range(0, len(chunk) - vad_mod.CHUNK_SIZE + 1,
                         vad_mod.CHUNK_SIZE):
            with self._device_lock:
                result = self.vad_engine.process(
                    chunk[off:off + vad_mod.CHUNK_SIZE])
            seg = self.vad_state.update(result, vad_mod.CHUNK_SIZE)
            if seg is not None:
                self._submit_vad_segment(seg, now)

    def _submit_vad_segment(self, seg, now: int) -> None:
        pad = int(self.config.vad.pad_ms / 1000 * 16000)
        # VadState positions are samples since start_continuous; the ring
        # position at that moment anchors them to absolute ring offsets.
        base = self._vad_ring_base
        start = max(base, base + seg.start - pad)
        end = min(now, base + seg.end + pad)
        audio = self.ring.extract_range(start, end)
        if len(audio) == 0:
            return
        self._submit_audio(audio, final=False)

    # -- wake word (parity: daemon.rs:2105-2179) --------------------------------------

    def _wake_tick(self) -> None:
        from openhush_tpu_torch.models.wakeword import CHUNK_SAMPLES
        now = self.ring.current_position()
        if self._wake_pos == 0:
            self._wake_pos = max(0, now - CHUNK_SAMPLES)
        while now - self._wake_pos >= CHUNK_SAMPLES:
            chunk = self.ring.extract_range(self._wake_pos,
                                            self._wake_pos + CHUNK_SAMPLES)
            self._wake_pos += CHUNK_SAMPLES
            with self._device_lock:
                score = self.wake_detector.process(chunk)
            if self.wake_detector.detected(score):
                log.info("Wake word detected (score %.2f) — starting "
                         "continuous dictation", score)
                from openhush_tpu_torch.utils.platform_hosts import (
                    get_host_platform)
                host = get_host_platform()
                host.play_sound("start")   # audible cue (parity: beep)
                host.notify("OpenHush", "Listening…")
                self.start_continuous()
                return

    # -- results → output -----------------------------------------------------------

    def _drain_results(self) -> None:
        # The earlier sessions first, in order (F2): each is polled until
        # its last window is in, then closed; while one still waits, the
        # later sessions' results stay on the server.
        while True:
            with self._lock:
                if not self._draining:
                    break
                server, session_id = self._draining[0]
            self._poll_session(server, session_id)
            with self._lock:
                done = not self._in_flight.get(session_id)
                if done:
                    self._draining.pop(0)
                    self._in_flight.pop(session_id, None)
            self._output_ready()
            if not done:
                return
            server.close_session(session_id)
            # As at the press that followed it: the next session's first
            # text is not deduplicated against this one's last.
            self.tracker.reset_dedup()
        # Snapshot against a concurrent unload (poll on a stopped server
        # only reads host-side queues, so a stale local ref is safe).
        server, session_id = self.server, self._session_id
        if session_id is None or server is None:
            return
        self._poll_session(server, session_id)
        self._output_ready()

    def _poll_session(self, server, session_id: int) -> None:
        while True:
            res = server.poll(session_id)
            if res is None:
                break
            with self._lock:
                if self._in_flight.get(session_id):
                    self._in_flight[session_id] -= 1
            self._last_activity = time.monotonic()
            seq, chunk, final = self._unpack(res.window_id)
            self.tracker.add_result(ChunkResult(
                text=res.text.strip(), sequence_id=seq, chunk_id=chunk,
                is_final=final, duration_secs=0.0))

    def _output_ready(self) -> None:
        self._batch_outputs = 0
        for ready in self.tracker.take_ready():
            if ready.text:
                self._process_and_output(ready)

    def _process_and_output(self, ready: ChunkResult) -> None:
        """vocab → LLM correction → translation → output + actions
        (parity: process_and_output, daemon.rs:459-560), with per-app
        profile overrides for vocabulary/filler level."""
        profile = (self.app_context.refresh()
                   if self.app_context.profiles else None)
        vocab = self.vocabulary
        if profile is not None and profile.vocabulary_path:
            from openhush_tpu_torch.text.vocabulary import VocabularyManager
            vocab = self._profile_vocab.setdefault(
                profile.vocabulary_path,
                VocabularyManager(profile.vocabulary_path))
        vocab.check_reload()
        text = vocab.apply(ready.text)
        if self.corrector is not None:
            if profile is not None and profile.filler_mode:
                old = self.corrector.config
                self.corrector.config = dataclasses.replace(
                    old, filler_mode=profile.filler_mode)
                try:
                    text = self.corrector.correct(text)
                finally:
                    self.corrector.config = old
            else:
                text = self.corrector.correct(text)
        if self.translator is not None:
            pieces = self.translator.add_chunk(text)
            if ready.is_final:
                rest = self.translator.flush()
                if rest:
                    pieces.append(rest)
            texts = pieces
        else:
            texts = [text]
        for out_text in texts:
            if not out_text:
                continue
            if self._handler is not None:
                self._handler.output(out_text,
                                     continuation=self._batch_outputs > 0)
            else:
                self.output(out_text)
            self._batch_outputs += 1
            self.actions.run_all(self._ActionContext(
                text=out_text, duration_secs=ready.duration_secs,
                model=self.config.transcription.effective_model(),
                seq_id=ready.sequence_id))

    # -- IPC (wire parity: src/ipc/mod.rs:41-110) -------------------------------------

    def status(self) -> DaemonStatus:
        return DaemonStatus(
            running=True,
            recording=self.state != DaemonState.IDLE,
            state=self.state.value,
            model=self.config.transcription.effective_model(),
            queue_depth=self.tracker.pending_count,
            model_loaded=self.model_loaded,
            preprocess_failures=getattr(self.server, "preprocess_failures",
                                        0))

    def _handle_ipc(self, request: dict) -> dict:
        cmd = request.get("cmd", "")
        if cmd == "status":
            s = self.status()
            return {"ok": True, "running": True, "recording": s.recording,
                    "model_loaded": self.model_loaded,
                    "version": s.version,
                    "state": s.state, "queue_depth": s.queue_depth,
                    "preprocess_failures": s.preprocess_failures}
        if cmd == "stop":
            self._stop_event.set()
            return {"ok": True}
        if cmd == "start_recording":
            return {"ok": self.start_recording()}
        if cmd == "stop_recording":
            return {"ok": self.stop_recording()}
        if cmd == "toggle_recording":
            return {"ok": self.toggle_recording()}
        if cmd == "start_continuous":
            return {"ok": self.start_continuous()}
        if cmd == "queue_depth":
            return {"ok": True, "queue_depth": self.tracker.pending_count}
        if cmd == "version":
            return {"ok": True, "version": __version__}
        if cmd == "load_model":
            return {"ok": self.ensure_model()}
        if cmd == "unload_model":
            # Without a rebuild factory (embedded/test daemons) the model
            # must stay resident: report ok=True, loaded stays True.
            if self._server_factory is None:
                return {"ok": True}
            return {"ok": self.unload_model()}
        if cmd == "reload":
            self.reload_config()
            return {"ok": True}
        return {"ok": False, "error": f"unknown command {cmd!r}"}


# ---------------------------------------------------------------------------
# Building the daemon, and the CLI entry points (dispatched from daemon_cli)
# ---------------------------------------------------------------------------

# The build-time run of the preprocess chain: 0.1 s of silence.
_PROBE_SAMPLES = 1600


def build_preprocess(audio_cfg, device=None):
    """The per-window preprocess for `audio_cfg` (utils/config.AudioConfig,
    or any object with its attribute names: normalization_*,
    compression_*, limiter_*, noise_reduction_*), in the worker's order
    denoise → normalize → compress → limit (src/queue/worker.rs:196-240).
    The hook takes and returns fp32 numpy audio; every stage runs on the
    device, the two dynamics stages and the noise floor on the DSP kernels
    of csrc/dsp.cu (the reference takes its host C++ copies where they are
    built); denoise keeps its streaming noise-floor state on the device
    across windows. Runs on CUDA unless `device` says otherwise.

    The chain runs once here on a short silent window, with its own
    denoise state, so a kernel that fails to build or to launch raises
    now rather than on every window inside the server."""
    device = resolve_device(device)
    state = {"dn": None}

    def chain(audio: np.ndarray, dn_state):
        y = torch.from_numpy(np.array(audio, np.float32)).to(device)
        if audio_cfg.noise_reduction_enabled:
            y, dn_state = dn.denoise_tensor(
                y, strength=audio_cfg.noise_reduction_strength,
                state=dn_state)
        if audio_cfg.normalization_enabled:
            y = dsp.normalize_rms(y, audio_cfg.normalization_target_db)
        if audio_cfg.compression_enabled:
            y = dsp.compress(y, audio_cfg.compression_threshold_db,
                             audio_cfg.compression_ratio,
                             audio_cfg.compression_attack_ms,
                             audio_cfg.compression_release_ms,
                             audio_cfg.compression_makeup_gain_db)
        if audio_cfg.limiter_enabled:
            y = dsp.limit(y, audio_cfg.limiter_ceiling_db,
                          audio_cfg.limiter_release_ms)
        return y.cpu().numpy(), dn_state

    chain(np.zeros(_PROBE_SAMPLES, np.float32), None)

    def preprocess(audio: np.ndarray) -> np.ndarray:
        y, state["dn"] = chain(audio, state["dn"])
        return y

    return preprocess


def audio_ctx_for(chunk_secs: float) -> int:
    """The encoder context for a streaming chunk (whisper.cpp's audio_ctx
    knob): ~50 positions a second with headroom, 64-aligned, in [256,
    1500]. VAD segments longer than the window are split at submission."""
    return min(1500, max(256, int(-(-chunk_secs * 50 * 2 // 64)) * 64))


def _build_daemon(device=None) -> Daemon:
    """The daemon `cmd_start` runs, from the config file: the engine, the
    preprocess, the engine server (with its warmup), the VAD engine and
    the wake-word detector, all on `device` (CUDA unless the caller asks
    for the CPU)."""
    from openhush_tpu_torch.audio.capture import NullSource, SoundDeviceSource
    from openhush_tpu_torch.runtime.engine import WhisperEngine
    from openhush_tpu_torch.runtime.server import EngineServer
    from openhush_tpu_torch.utils.config import Config

    device = resolve_device(device)
    config = Config.load_or_default()
    model = config.transcription.effective_model()
    allow_random = os.environ.get("OPENHUSH_ALLOW_RANDOM_INIT") == "1"

    def load_engine():
        return WhisperEngine(model, language=config.transcription.language,
                             allow_random_init=allow_random,
                             draft_model=config.transcription.draft_model
                             or None, device=device)

    eng = load_engine()
    # Streaming chunk interval: configured value, or auto-tuned from a
    # measured 2 s-silence transcription (parity: WhisperEngine::benchmark
    # overhead × (1 + chunk_safety_margin), src/engine/whisper.rs:329-382).
    # Random-init dev mode skips the measurement (fixed 5 s).
    if config.queue.chunk_interval_secs > 0:
        chunk_secs = config.queue.chunk_interval_secs
    elif eng.random_init:
        chunk_secs = 5.0
    else:
        chunk_secs = eng.benchmark_chunk_interval(
            margin=config.queue.chunk_safety_margin)
        log.info("Auto-tuned chunk interval: %.2f s", chunk_secs)
    audio_ctx = audio_ctx_for(chunk_secs)
    preprocess = build_preprocess(config.audio, device=device)

    first_engine = [eng]
    del eng

    def make_server():
        """Builds (or rebuilds, after an idle unload) the engine server.
        The first call reuses the engine loaded above; later calls reload
        the checkpoint from disk."""
        e = first_engine.pop() if first_engine else load_engine()
        # Random-init dev mode: neutralize the quality-fallback ladder —
        # untrained logits sit at avg_logprob ~ -log(V) and would send
        # every window through all ladder temperatures.
        guards = ({} if not e.random_init
                  else dict(temperatures=(0.0,), logprob_threshold=-1e9,
                            no_speech_threshold=2.0))
        server = EngineServer(e.cfg, e.params, tokenizer=e.tokenizer,
                              dtype=e.dtype, audio_ctx=audio_ctx,
                              max_decode_len=256, preprocess=preprocess,
                              **guards)
        if config.transcription.warmup_on_load:
            # Every prep bucket and install path once before live traffic
            # (and on the card every kernel built and loaded), so none of
            # that lands in a user's first-partial latency.
            t0 = time.monotonic()
            server.warmup()
            log.info("Admission shapes warmed in %.1f s",
                     time.monotonic() - t0)
        return server

    server = make_server()
    try:
        source = SoundDeviceSource(device=config.audio.device or None,
                                   channels=config.audio.channels or None)
    except Exception as e:  # noqa: BLE001
        log.warning("No audio capture available (%s); using silence", e)
        source = NullSource()
    return Daemon(config, server, source, chunk_interval=chunk_secs,
                  server_factory=make_server, device=device)


def cmd_start(args: list[str]) -> int:
    logging.basicConfig(level=logging.INFO)
    # --no-tray disables the tray icon (parity: main.rs:57-59); --device
    # DEV runs the daemon elsewhere than on CUDA (e.g. cpu).
    enable_tray = "--no-tray" not in args
    device = (args[args.index("--device") + 1]
              if "--device" in args[:-1] else None)
    try:
        daemon = _build_daemon(device=device)
    except (FileNotFoundError, RuntimeError) as e:
        print(str(e), file=sys.stderr)
        return 1
    try:
        daemon.run(enable_tray=enable_tray)
    except RuntimeError as e:
        print(str(e), file=sys.stderr)
        return 1
    return 0


def cmd_stop(args: list[str]) -> int:
    try:
        resp = ipc.IpcClient().send("stop")
    except (ConnectionError, OSError):
        print("Daemon not running", file=sys.stderr)
        return 1
    print("Daemon stopping" if resp.get("ok") else "Failed to stop daemon")
    return 0 if resp.get("ok") else 1


def cmd_status(args: list[str]) -> int:
    try:
        resp = ipc.IpcClient().send("status")
    except (ConnectionError, OSError):
        print("Daemon: not running")
        return 1
    print(f"Daemon: running (v{resp.get('version', '?')})")
    print(f"State: {resp.get('state', '?')}")
    print(f"Recording: {resp.get('recording', False)}")
    print(f"Queue depth: {resp.get('queue_depth', 0)}")
    print(f"Preprocess failures: {resp.get('preprocess_failures', 0)}")
    return 0


def cmd_record(args: list[str]) -> int:
    from openhush_tpu_torch.runtime.recording import cmd_record as run
    return run(args)


def cmd_recording(args: list[str]) -> int:
    action = args[0] if args else "toggle"
    cmd = {"start": "start_recording", "stop": "stop_recording",
           "toggle": "toggle_recording",
           "continuous": "start_continuous"}.get(action)
    if cmd is None:
        print(f"unknown recording action {action!r} "
              f"(use start|stop|toggle|continuous)", file=sys.stderr)
        return 2
    try:
        resp = ipc.IpcClient().send(cmd)
    except (ConnectionError, OSError):
        print("Daemon not running", file=sys.stderr)
        return 1
    print("ok" if resp.get("ok") else f"failed: {resp.get('error', '')}")
    return 0 if resp.get("ok") else 1
