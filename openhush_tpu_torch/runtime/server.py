"""Engine server: session-multiplexed continuous batching over one device.

Port of openhush_tpu/runtime/server.py. Sessions submit 30 s (or shorter,
padded) windows; a prep thread encodes them in batches (log-mel, encoder,
int8 cross-KV, language logits); the scheduler turn installs prepared
windows into free batch slots, advances every active slot by `inner_steps`
tokens (runtime/batcher.step), and harvests finished slots into
per-session queues, retrying degenerate windows up the temperature ladder.
`peek` reads a window's tokens mid-decode.

Both threads launch kernels on the device's current stream (PyTorch's
default stream unless the caller sets another for both), so every window's
prepared tensors are written before any step that reads them.

`int8_self_cache` (None: OPENHUSH_INT8_SELF_CACHE, else the combined
int8 rung or the int8_self_cache.ok marker, as the reference resolves it)
keeps the slots' self-cache in int8 with per-(position, head) scales.

`draft=(draft_cfg, draft_params)` (a draft of the big model's width, heads
and vocab) turns on speculative serving: the prep thread projects the
draft's int8 cross-KV from the same encoder features, and the device loop
runs batcher.spec_step under `spec_policy` ("auto" speculates only while a
window decodes alone; "always"; "never"), with the same tokens as the plain
step.

Differences from the reference: the memory budgeter reads the card's
capacity from torch.cuda.mem_get_info; a preprocess that raises on a window
is logged at error level and counted in `preprocess_failures` (the window
is still transcribed from its raw audio, as the reference does, which only
warns: the reference's hook may be a missing host DSP library, the port's
runs the card's kernels, whose failure must not pass unseen).
"""

from __future__ import annotations

import dataclasses
import functools
import logging
import os
import queue
import threading
import time
import zlib
from typing import Optional

import numpy as np
import torch

from openhush_tpu_torch.models.whisper import decoding, model as whisper
from openhush_tpu_torch.models.whisper.config import WhisperConfig
from openhush_tpu_torch.ops import frontend, mel as mel_ops
from openhush_tpu_torch.runtime import batcher
from openhush_tpu_torch.runtime.engine import default_model_dir
from openhush_tpu_torch.text.tokenizer import WhisperTokenizer
from openhush_tpu_torch.utils.quant_flags import (SELF_CACHE_MARKER,
                                                  int8_rung_enabled)

log = logging.getLogger(__name__)


@dataclasses.dataclass
class WindowResult:
    session_id: int
    window_id: int
    tokens: list[int]             # content tokens (prompt stripped, pre-EOT)
    text: str
    avg_logprob: float
    no_speech_prob: float
    first_token_latency: float    # seconds from submit to first content token
    latency: float                # seconds from submit to completion
    temperature: float = 0.0      # ladder temperature the window finished at
    compression_ratio: float = 0.0
    skipped_silence: bool = False  # no_speech gate fired → empty result
    language: str = "en"           # resolved (possibly auto-detected)
    steps: int = 0                 # decode steps of the final rung (EOT too)


def compression_ratio(text: str) -> float:
    """zlib compression ratio of the UTF-8 text: whisper's repetition
    metric (> 2.4 = degenerate)."""
    data = text.encode("utf-8")
    if not data:
        return 0.0
    return len(data) / len(zlib.compress(data))


def _params_device(params) -> torch.device:
    return params["decoder"]["tok_emb"].device


def device_hbm_limit(device=None) -> Optional[int]:
    """The card's memory in bytes: OPENHUSH_HBM_BYTES overrides, else
    torch.cuda.mem_get_info's total for a CUDA `device` (None means the
    current one). None on the CPU, which disables the slot budgeter."""
    env = os.environ.get("OPENHUSH_HBM_BYTES")
    if env:
        return int(env) or None
    device = torch.device("cuda") if device is None else torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        return None
    return int(torch.cuda.mem_get_info(device)[1])


# Fraction of the card's memory the budgeter hands to weights + slot state;
# the rest covers encode activations, prep buffers, logits and workspace.
HBM_BUDGET_FRACTION = 0.85


def _nbytes(tree) -> int:
    """Device bytes of a parameter tree (0 for None): an int8 weight {"q",
    "s"} counts its levels at one byte and its fp32 scales."""
    if tree is None:
        return 0
    if isinstance(tree, dict):
        return sum(_nbytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def hbm_fit_count(params, state_bytes_at, draft_params=None
                  ) -> Optional[int]:
    """Largest slot count whose state fits next to the weights (and the
    draft's) under HBM_BUDGET_FRACTION, or None when the capacity is
    unknown (the CPU). state_bytes_at(n) → exact bytes of the batch state
    at n slots (a batcher.state_bytes partial)."""
    limit = device_hbm_limit(_params_device(params))
    if limit is None:
        return None
    budget = (int(limit * HBM_BUDGET_FRACTION) - _nbytes(params)
              - _nbytes(draft_params))
    per = max(1, state_bytes_at(1))
    fits = max(0, budget // per)
    while fits > 0 and state_bytes_at(fits) > budget:
        fits -= 1
    return fits


def slot_seed(info) -> int:
    """Deterministic per-(session, window, temperature-rung) sampling seed:
    the single source for plain and batched installs, so a retry draws the
    same stream whichever path installed it."""
    return (info.session_id * 1000003 + info.window_id * 101
            + info.temp_idx) & 0x7FFFFFFF


@dataclasses.dataclass
class _Pending:
    session_id: int
    window_id: int
    audio: np.ndarray
    language: str
    task: str
    timestamps: bool
    submitted_at: float
    first: bool = False     # session's first window → priority admission


@dataclasses.dataclass
class _SlotInfo:
    session_id: int
    window_id: int
    prompt_len: int
    submitted_at: float
    admitted_at: float
    first_token_at: Optional[float] = None
    # Fallback-ladder state: the resolved language/task stay here; a retry
    # re-prefills from the cross-KV copy the slot already holds on the
    # device (batcher.readmit).
    language: str = "en"
    task: str = "transcribe"
    timestamps: bool = True
    temp_idx: int = 0


class EngineServer:
    """One model, one device loop, many sessions."""

    def __init__(self, cfg: WhisperConfig, params, *, n_slots: int = 8,
                 inner_steps: int = 8, dtype=torch.bfloat16,
                 tokenizer: Optional[WhisperTokenizer] = None,
                 audio_ctx: Optional[int] = None,
                 max_decode_len: Optional[int] = None,
                 preprocess=None,
                 temperatures: tuple = (0.0, 0.2, 0.4, 0.6, 0.8, 1.0),
                 compression_ratio_threshold: float = 2.4,
                 logprob_threshold: float = -1.0,
                 no_speech_threshold: float = 0.6,
                 rep_threshold: int = 12,
                 max_admissions_per_turn: int = 1,
                 int8_self_cache: Optional[bool] = None,
                 draft: Optional[tuple] = None,
                 k_spec: int = 4,
                 spec_policy: str = "auto",
                 spec_force_accept: bool = False,
                 harvest_every: int = 1,
                 deep_factor: int = 4,
                 reserve_first_window: Optional[bool] = None):
        if spec_policy not in ("auto", "always", "never"):
            raise ValueError(f"spec_policy {spec_policy!r} not in "
                             "('auto', 'always', 'never')")
        if int8_self_cache is None:
            # As the reference's server (server.py:253-267): the variable
            # when set, else the combined int8 rung or the self-cache's own
            # checkpoint-gate marker.
            env = os.environ.get("OPENHUSH_INT8_SELF_CACHE")
            if env is not None:
                int8_self_cache = env == "1"
            else:
                int8_self_cache = (int8_rung_enabled() or os.path.exists(
                    os.path.join(default_model_dir(), SELF_CACHE_MARKER)))
        self.int8_self_cache = bool(int8_self_cache)
        self.cfg = cfg
        self.params = params
        self.device = _params_device(params)
        self.n_slots = n_slots
        self.inner_steps = inner_steps
        # Deep stepping: when EVERY slot is occupied, admission is
        # impossible until a harvest frees one, so the step runs
        # deep_factor x more inner steps and harvests every turn: the same
        # tokens, fewer scheduler turns. deep_factor=1 disables.
        self.deep_factor = max(1, int(deep_factor))
        self.step_dispatches = 0         # batcher.step calls (accounting)
        self.spec_iters = 0              # spec_step iterations (accounting)
        self.tokenizer = tokenizer or WhisperTokenizer(cfg.n_langs)
        # Speculative serving: the shared draft proposes k_spec-token blocks
        # that the big model verifies in one pass (batcher.spec_step). The
        # policy: speculation loses once several slots decode together (the
        # plain step's weight reads are shared by the batch), so "auto"
        # re-picks the mode each time the batcher is empty: speculate iff
        # exactly one window waits. The mode changes only at occupancy 0:
        # the two steps keep different cache fills (spec keeps the tip out
        # of the cache), so a switch mid-decode would corrupt the slots in
        # flight. "always" and "never" pin it.
        self.draft_cfg = self.draft_params = None
        self.k_spec = max(2, int(k_spec))
        self.spec_policy = spec_policy
        self._spec_mode = spec_policy == "always"
        self._spec_blocked = False
        # Measurement only (the accept-everything upper bound; its tokens
        # are not greedy's): constructor-only, no variable reaches it.
        self.spec_force_accept = bool(spec_force_accept)
        if draft is not None:
            dcfg, dparams = draft
            if (dcfg.n_text_state == cfg.n_text_state
                    and dcfg.n_vocab == cfg.n_vocab
                    and dcfg.n_text_head == cfg.n_text_head
                    and dcfg.n_audio_state == cfg.n_audio_state):
                self.draft_cfg, self.draft_params = dcfg, dparams
            else:
                log.warning("draft model %s incompatible with %s; "
                            "speculative serving disabled", dcfg.name,
                            cfg.name)
        # audio_ctx: whisper.cpp-style encoder-context restriction (short
        # streaming windows need ~chunk_secs*50 encoder positions).
        self.audio_ctx = min(audio_ctx or cfg.n_audio_ctx, cfg.n_audio_ctx)
        self.room_cap = (max_decode_len or cfg.n_text_ctx) - 1
        self._init_device_state(dtype=dtype, max_len=max_decode_len,
                                int8_self_cache=self.int8_self_cache)
        # Per-window preprocessing (denoise/normalize/...), applied in prep.
        self.preprocess = preprocess
        self.preprocess_failures = 0     # windows whose preprocess raised
        # Quality guards: whisper's heuristic ladder applied per window.
        self.temperatures = tuple(temperatures) or (0.0,)
        self.compression_ratio_threshold = compression_ratio_threshold
        self.logprob_threshold = logprob_threshold
        self.no_speech_threshold = no_speech_threshold
        self.rep_threshold = rep_threshold
        self.max_admissions_per_turn = max(1, max_admissions_per_turn)
        # Harvest (a host sync) every N step dispatches; 1 = every turn.
        self.harvest_every = max(1, harvest_every)
        self._turn = 0
        # The suppress mask is built once.
        self._suppress = torch.from_numpy(decoding.build_suppress_mask(
            self.tokenizer, cfg, decoding.DecodingOptions())).to(self.device)
        blank = self.tokenizer.encode(" ")
        self._blank_token = int(blank[0]) if blank else 220
        self._act_dtype = params["decoder"]["pos_emb"].dtype
        # Joiners are prepared in batches, at a few bucket sizes.
        self._prep_buckets = tuple(
            b for b in (1, 2, 4, 8) if b <= max(1, n_slots))

        self._pending: queue.Queue[_Pending] = queue.Queue()
        # Prepared windows awaiting a slot: (job, info, batched_xkv, row,
        # the draft's batched_xkv or None).
        # A prep thread fills this so the step loop never stalls on
        # admission work; the scheduler turn only installs.
        self._ready: queue.Queue[tuple] = queue.Queue()
        # First-window QoS: a session's FIRST window lands on this priority
        # queue, is admitted ahead of resubmissions and outside
        # max_admissions_per_turn, and (reserve) one slot is held back from
        # non-first windows WHILE such a window is in flight, so a joiner
        # under saturation waits at most one harvest. The reserve costs
        # nothing at steady state with no joiners, and nothing for
        # all-first traffic (batch transcription).
        if reserve_first_window is None:
            reserve_first_window = n_slots >= 4
        self.reserve_first_window = bool(reserve_first_window)
        self._ready_first: queue.Queue[tuple] = queue.Queue()
        self._served: set[int] = set()   # sessions with >= 1 admitted window
        # Sessions whose first window is submitted but not yet admitted:
        # while nonempty, the reserve is active and deep stepping is off.
        self._first_pending: set[int] = set()
        # Windows submitted but not yet on _ready (pending or mid-prep).
        self._unlanded = 0
        self._count_lock = threading.Lock()
        self._slots: dict[int, _SlotInfo] = {}
        self._results: dict[int, queue.Queue] = {}
        self._lock = threading.Lock()
        self._running = False
        self._thread: Optional[threading.Thread] = None
        self._prep_thread: Optional[threading.Thread] = None
        self._seq = 0

    # -- public API -----------------------------------------------------------

    def open_session(self) -> int:
        with self._lock:
            self._seq += 1
            sid = self._seq
            self._results[sid] = queue.Queue()
        return sid

    def close_session(self, session_id: int) -> None:
        with self._lock:
            self._results.pop(session_id, None)
            self._served.discard(session_id)
            self._first_pending.discard(session_id)

    def submit_window(self, session_id: int, audio: np.ndarray,
                      window_id: int = 0, language: str = "en",
                      task: str = "transcribe",
                      timestamps: bool = True) -> None:
        """Queue one ≤30 s audio window for transcription."""
        with self._lock:
            first = (session_id not in self._served
                     and session_id not in self._first_pending)
            if first:
                self._first_pending.add(session_id)
        with self._count_lock:
            self._unlanded += 1
        self._pending.put(_Pending(session_id, window_id,
                                   np.asarray(audio, np.float32), language,
                                   task, timestamps, time.monotonic(),
                                   first=first))

    def poll(self, session_id: int, timeout: Optional[float] = None
             ) -> Optional[WindowResult]:
        q = self._results.get(session_id)
        if q is None:
            return None
        try:
            return q.get(timeout=timeout) if timeout else q.get_nowait()
        except queue.Empty:
            return None

    def peek(self, session_id: int) -> Optional[list[int]]:
        """Partial content tokens of the session's in-flight window. Reads
        pos first: the step writes a token before it advances pos, so
        tokens[:pos] is always written."""
        with self._lock:
            slot = next((s for s, info in self._slots.items()
                         if info.session_id == session_id), None)
            if slot is None:
                return None
            info = self._slots[slot]
        state = self.state
        pos = int(state.pos[slot])
        tokens = state.tokens[slot].cpu().tolist()
        return [t for t in tokens[info.prompt_len:pos]
                if t != self.tokenizer.special.eot]

    def queue_depth(self) -> int:
        return (self._unlanded + self._ready.qsize()
                + self._ready_first.qsize() + len(self._slots))

    def warmup(self) -> None:
        """One synchronous round of exactly-bucket-size silent windows per
        prep bucket, before live traffic: every batched prep size and
        install path runs once (and on the card, every kernel is built and
        loaded). Must run before start()."""
        if self._running:
            raise RuntimeError("warmup() must be called before start()")
        n_samples = self.audio_ctx * 2 * mel_ops.HOP_LENGTH
        silence = np.zeros(n_samples, np.float32)
        for b in reversed(self._prep_buckets):
            sids = [self.open_session() for _ in range(b)]
            for j, sid in enumerate(sids):
                self.submit_window(sid, silence, window_id=10 ** 9 + j,
                                   language="en", timestamps=False)
            pending = set(sids)
            while pending:
                self.run_once()
                for sid in list(pending):
                    if self.poll(sid) is not None:
                        pending.discard(sid)
            for sid in sids:
                self.close_session(sid)

    # -- device loop ------------------------------------------------------------

    def start(self) -> None:
        self._running = True
        self._prep_thread = threading.Thread(target=self._prep_loop,
                                             daemon=True,
                                             name="engine-server-prep")
        self._prep_thread.start()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="engine-server")
        self._thread.start()

    def stop(self) -> None:
        self._running = False
        if self._thread:
            self._thread.join(timeout=30)
        if self._prep_thread:
            self._prep_thread.join(timeout=30)

    def _loop(self) -> None:
        while self._running:
            if not self.run_once():
                time.sleep(0.002)

    def _prep_loop(self) -> None:
        """Prepare pending windows concurrently with the step loop, in
        batches of the windows waiting together; one thread keeps
        per-session FIFO order."""
        while self._running:
            jobs = []
            try:
                jobs.append(self._pending.get(timeout=0.05))
            except queue.Empty:
                continue
            while len(jobs) < self._prep_buckets[-1]:
                try:
                    jobs.append(self._pending.get_nowait())
                except queue.Empty:
                    break
            try:
                self._prepare_many(jobs)
            except Exception:  # noqa: BLE001
                log.exception("window preparation failed; dropping %d "
                              "window(s)", len(jobs))

    def run_once(self) -> bool:
        """One scheduler turn: admit prepared windows → step → harvest.
        Returns True if any work happened (used for idle backoff).

        Driven synchronously (tests, batch transcription: no start()),
        pending windows are prepared inline here."""
        if self._prep_thread is None or not self._prep_thread.is_alive():
            while not self._pending.empty() and self._free_slots():
                jobs = []
                while len(jobs) < self._prep_buckets[-1]:
                    try:
                        jobs.append(self._pending.get_nowait())
                    except queue.Empty:
                        break
                if not jobs:
                    break
                self._prepare_many(jobs)
        if self.draft_cfg is not None and self.spec_policy == "auto":
            # Re-pick the mode only while the batcher is empty: speculate iff
            # exactly one window waits (counting windows mid-prep, or a
            # stagger can look like one).
            with self._lock:
                occupied = bool(self._slots)
            if not occupied:
                waiting = (self._ready.qsize() + self._ready_first.qsize()
                           + self._unlanded)
                if waiting == 0:
                    # Idle: forget the concurrency evidence, so a later lone
                    # window speculates again.
                    self._spec_blocked = False
                self._spec_mode = waiting == 1 and not self._spec_blocked
        worked = self._admit_pending()
        with self._lock:
            n_active = len(self._slots)
        if n_active:
            # Deep stepping only when no admission is possible before a
            # harvest, and never while a first window is in flight.
            deep = (n_active >= self._regular_cap()
                    and not self._first_pending and self.deep_factor > 1)
            self._step_state(deep=deep)
            self._turn += 1
            if (deep or self._turn % self.harvest_every == 0
                    or ((not self._ready.empty()
                         or not self._ready_first.empty())
                        and not self._free_slots())):
                self._harvest()
            worked = True
        return worked

    def _regular_cap(self) -> int:
        """Max occupancy non-first windows may fill: one slot stays in
        reserve WHILE a session's first window is in flight."""
        if (self.reserve_first_window and self.n_slots > 1
                and self._first_pending):
            return self.n_slots - 1
        return self.n_slots

    # -- internals ---------------------------------------------------------------

    def _init_device_state(self, *, dtype, max_len, int8_self_cache) -> None:
        self._check_hbm_budget(functools.partial(
            batcher.state_bytes, self.cfg, dtype=dtype, max_len=max_len,
            audio_ctx=self.audio_ctx, int8_self_cache=int8_self_cache,
            draft_cfg=self.draft_cfg))
        self.state = batcher.init_state(self.cfg, self.n_slots, dtype=dtype,
                                        int8_self_cache=int8_self_cache,
                                        max_len=max_len,
                                        audio_ctx=self.audio_ctx,
                                        draft_cfg=self.draft_cfg,
                                        device=self.device)

    def _check_hbm_budget(self, state_bytes_at) -> None:
        """Refuse slot counts whose state cannot fit next to the weights
        (the draft's included), computed from cfg (batcher.state_bytes)
        rather than found as an out-of-memory error mid-run. No-op on the
        CPU."""
        fits = hbm_fit_count(self.params, state_bytes_at,
                             draft_params=self.draft_params)
        if fits is None or self.n_slots <= fits:
            return
        limit = device_hbm_limit(self.device)
        weights = _nbytes(self.params) + _nbytes(self.draft_params)
        raise ValueError(
            f"n_slots={self.n_slots} needs "
            f"{state_bytes_at(self.n_slots) / 2**30:.2f} GiB of slot "
            f"state next to {weights / 2**30:.2f} GiB of "
            f"weights (card: {limit / 2**30:.2f} GiB, "
            f"{HBM_BUDGET_FRACTION:.0%} budgeted); "
            f"largest slot count that fits: {fits}")

    def _step_state(self, deep: bool = False) -> None:
        """One step dispatch; `deep` multiplies the inner steps by
        deep_factor (the same per-token math). In the speculative mode,
        max(1, inner // k_spec) spec_step iterations. Both pass room_cap,
        so a draft's SPEC_MARGIN rows never extend a decode."""
        inner = self.inner_steps * (self.deep_factor if deep else 1)
        self.step_dispatches += 1
        if self.draft_cfg is not None and self._spec_mode:
            n_iters = max(1, inner // self.k_spec)
            self.spec_iters += n_iters
            batcher.spec_step(self.cfg, self.params, self.draft_cfg,
                              self.draft_params, self.state, self._suppress,
                              k_spec=self.k_spec, n_iters=n_iters,
                              room_cap=self.room_cap,
                              blank_token=self._blank_token,
                              rep_threshold=self.rep_threshold,
                              force_accept=self.spec_force_accept)
        else:
            batcher.step(self.cfg, self.params, self.state, self._suppress,
                         inner_steps=inner, blank_token=self._blank_token,
                         rep_threshold=self.rep_threshold,
                         room_cap=self.room_cap)

    def _free_slots(self) -> list[int]:
        with self._lock:
            return [i for i in range(self.n_slots) if i not in self._slots]

    def _admit_pending(self) -> bool:
        """Install prepared windows into free slots: at most
        `max_admissions_per_turn` non-first windows per turn while other
        sessions decode (an idle batcher fills every free slot at once).
        A session's FIRST window goes ahead of resubmissions, outside the
        per-turn budget, and may take the reserved slot (_regular_cap).

        Under spec_policy "auto" in the speculative mode a batch holds one
        window: a window that becomes ready while one decodes waits, and is
        recorded as concurrency, so the next re-pick (at occupancy 0)
        chooses the plain step. Without that, two sessions whose windows
        alternate would each find exactly one window waiting at every
        drain and serialize on single-stream speculation."""
        with self._lock:
            n_active = len(self._slots)
        budget = self.max_admissions_per_turn if n_active else self.n_slots
        spec_limited = self.spec_policy == "auto" and self._spec_mode
        if spec_limited:
            if n_active and (self._ready.qsize() + self._ready_first.qsize()
                             + self._unlanded) > 0:
                self._spec_blocked = True
            budget = min(budget, max(0, 1 - n_active))
        admitted = False
        picked = []            # (slot, info, xkv, row, dxkv)
        free = self._free_slots()
        f = 0
        while f < len(free) and not (spec_limited and budget <= 0):
            try:
                job, info, xkv, row, dxkv = self._ready_first.get_nowait()
            except queue.Empty:
                break
            picked.append((free[f], info, xkv, row, dxkv))
            f += 1
            if spec_limited:
                budget -= 1
            with self._lock:
                self._served.add(job.session_id)
                self._first_pending.discard(job.session_id)
            log.debug("admitting session %d FIRST window %d into slot %d",
                      job.session_id, job.window_id, free[f - 1])
        cap = self._regular_cap()
        while (f < len(free) and budget > 0
               and n_active + len(picked) < cap):
            try:
                job, info, xkv, row, dxkv = self._ready.get_nowait()
            except queue.Empty:
                break
            picked.append((free[f], info, xkv, row, dxkv))
            f += 1
            budget -= 1
            with self._lock:
                self._served.add(job.session_id)
            log.debug("admitting session %d window %d into slot %d",
                      job.session_id, job.window_id, free[f - 1])
        # Windows prepared in the same batch (same xkv tensors) with the
        # same prompt length install together (batcher.admit_many).
        tok = self.tokenizer
        plens = [len(tok.sot_sequence(info.language, info.task,
                                      timestamps=info.timestamps))
                 for _, info, *_ in picked]
        i = 0
        while i < len(picked):
            group = [picked[i]]
            while (i + len(group) < len(picked)
                   and picked[i + len(group)][2] is picked[i][2]
                   and plens[i + len(group)] == plens[i]):
                group.append(picked[i + len(group)])
            i += len(group)
            admitted = True
            if len(group) == 1:
                slot, info, xkv, row, dxkv = group[0]
                self._install(slot, info, xkv=xkv, row=row, dxkv=dxkv)
            else:
                self._install_many(group)
        return admitted

    def _prep(self, windows: torch.Tensor, detect: bool):
        """Batched mel → encode → int8 cross-KV (→ language probs), and with
        a draft its int8 cross-KV from the same features (the draft shares
        the big model's encoder) → (xkv, probs or None, dxkv or None)."""
        cfg = self.cfg
        mel = frontend.log_mel(windows, n_mels=cfg.n_mels,
                               n_frames=self.audio_ctx * 2)
        feats = whisper.encode(cfg, self.params, mel.to(self._act_dtype))
        xkv = whisper.compute_cross_kv_quant(cfg, self.params, feats)
        probs = (decoding.detect_language_logits(cfg, self.params, xkv)
                 if detect else None)
        dxkv = (whisper.compute_cross_kv_quant(self.draft_cfg,
                                               self.draft_params, feats)
                if self.draft_cfg is not None else None)
        return xkv, probs, dxkv

    def _prepare_many(self, jobs: list[_Pending]) -> None:
        """All per-window work that needs no slot, for a batch of windows:
        preprocess, mel, encode, int8 cross-KV, language logits. Entries
        land on _ready / _ready_first as (job, info, batched_xkv, row,
        the draft's batched_xkv or None)."""
        log.debug("prep batch: windows %s",
                  [job.window_id for job in jobs])
        try:
            self._prepare_many_inner(jobs)
        except Exception:
            # Dropped windows must not hold the first-window reserve (or
            # suspend deep stepping) forever.
            with self._lock:
                for job in jobs:
                    if job.first:
                        self._first_pending.discard(job.session_id)
            raise
        finally:
            with self._count_lock:
                self._unlanded -= len(jobs)

    @torch.no_grad()
    def _prepare_many_inner(self, jobs: list[_Pending]) -> None:
        tok = self.tokenizer
        n_samples = self.audio_ctx * 2 * mel_ops.HOP_LENGTH
        bucket = next(b for b in self._prep_buckets if b >= len(jobs))
        windows = np.zeros((bucket, n_samples), np.float32)
        for j, job in enumerate(jobs):
            if self.preprocess is not None:
                try:
                    job.audio = self.preprocess(job.audio)
                except Exception:  # noqa: BLE001 — degrade, keep audio
                    self.preprocess_failures += 1
                    log.exception("preprocess failed on window %d; using "
                                  "raw audio", job.window_id)
            n = min(len(job.audio), n_samples)
            windows[j, :n] = job.audio[:n]
        need_detect = any(j.language in ("auto", "", None) for j in jobs)
        xkv, lang_probs, dxkv = self._prep(
            torch.from_numpy(windows).to(self.device), need_detect)
        if need_detect:
            idx = lang_probs.argmax(dim=-1).tolist()
            detected = [tok.special.languages[i] for i in idx]
        for j, job in enumerate(jobs):
            language = job.language
            if language in ("auto", "", None):
                language = detected[j]
            info = _SlotInfo(job.session_id, job.window_id, 0,
                             job.submitted_at, time.monotonic(),
                             language=language, task=job.task,
                             timestamps=job.timestamps, temp_idx=0)
            dest = self._ready_first if job.first else self._ready
            dest.put((job, info, xkv, j, dxkv))

    def _install(self, slot: int, info: _SlotInfo, xkv=None,
                 row: int = 0, dxkv=None) -> None:
        """Prefill `slot` at the ladder temperature info.temp_idx: from a
        prepared batched cross-KV (first install; the draft's from `dxkv`)
        or from the slot's own copies (retry, batcher.readmit)."""
        prompt = self.tokenizer.sot_sequence(info.language, info.task,
                                             timestamps=info.timestamps)
        info.prompt_len = len(prompt)
        temp = float(self.temperatures[info.temp_idx])
        draft = dict(draft_cfg=self.draft_cfg, draft_params=self.draft_params)
        if xkv is not None:
            batcher.admit(self.cfg, self.params, self.state, slot, xkv,
                          prompt, info.timestamps, prompt_len=len(prompt),
                          temperature=temp, seed=slot_seed(info), row=row,
                          draft_xkv=dxkv, **draft)
        else:
            batcher.readmit(self.cfg, self.params, self.state, slot, prompt,
                            info.timestamps, prompt_len=len(prompt),
                            temperature=temp, seed=slot_seed(info), **draft)
        with self._lock:
            self._slots[slot] = info

    def _install_many(self, group) -> None:
        """Install k windows of one prep batch."""
        tok = self.tokenizer
        slots, prompts, use_ts, temps, seeds, rows = [], [], [], [], [], []
        for slot, info, _, row, _ in group:
            prompt = tok.sot_sequence(info.language, info.task,
                                      timestamps=info.timestamps)
            info.prompt_len = len(prompt)
            slots.append(slot)
            prompts.append(prompt)
            use_ts.append(info.timestamps)
            temps.append(float(self.temperatures[info.temp_idx]))
            seeds.append(slot_seed(info))
            rows.append(row)
        batcher.admit_many(self.cfg, self.params, self.state, slots,
                           group[0][2], prompts, use_ts,
                           prompt_len=len(prompts[0]), temperatures=temps,
                           seeds=seeds, rows=rows, draft_cfg=self.draft_cfg,
                           draft_params=self.draft_params,
                           draft_xkv=group[0][4])
        with self._lock:
            for slot, info, *_ in group:
                self._slots[slot] = info

    def _quality_verdict(self, text: str, avg_logprob: float,
                         no_speech_prob: float,
                         degenerate: bool) -> tuple[str, float]:
        """whisper's per-window heuristics → ('emit'|'skip'|'fallback', cr).

        skip: confident silence (no_speech AND low logprob) → empty result.
        fallback: degenerate output (repetition-guard abort, compression
        ratio, or low confidence) → retry at the next ladder temperature."""
        cr = compression_ratio(text)
        if (no_speech_prob > self.no_speech_threshold
                and avg_logprob < self.logprob_threshold):
            return "skip", cr
        if (degenerate or cr > self.compression_ratio_threshold
                or avg_logprob < self.logprob_threshold):
            return "fallback", cr
        return "emit", cr

    def _harvest(self) -> None:
        # One device→host read for the per-turn check.
        flags = torch.stack([self.state.finished.long(),
                             self.state.length]).cpu().numpy()
        finished, lengths = flags[0].astype(bool), flags[1]
        if not finished.any():
            # First-token latency bookkeeping for live partials.
            with self._lock:
                for slot, info in self._slots.items():
                    if info.first_token_at is None and lengths[slot] > 0:
                        info.first_token_at = time.monotonic()
            return
        st = self.state
        tokens = st.tokens.cpu().numpy()
        rows = torch.stack([st.pos.double(), st.sum_logprob.double(),
                            st.no_speech.double(),
                            st.degenerate.double()]).cpu().numpy()
        pos, sum_lp, no_speech, degenerate = rows
        eot = self.tokenizer.special.eot
        done_mask = np.zeros(self.n_slots, bool)
        retries: list[tuple[int, _SlotInfo]] = []
        now = time.monotonic()
        with self._lock:
            done = [(s, i) for s, i in self._slots.items() if finished[s]]
            for slot, info in done:
                content = [int(t) for t in
                           tokens[slot, info.prompt_len:int(pos[slot])]
                           if t != eot]
                text = self.tokenizer.decode(content)
                avg_lp = float(sum_lp[slot]) / max(int(lengths[slot]), 1)
                ns = float(no_speech[slot])
                verdict, cr = self._quality_verdict(
                    text, avg_lp, ns, bool(degenerate[slot]))
                temp = float(self.temperatures[info.temp_idx])
                if (verdict == "fallback"
                        and info.temp_idx + 1 < len(self.temperatures)):
                    info.temp_idx += 1
                    log.info("slot %d window %d degenerate (cr=%.2f, "
                             "lp=%.2f%s); retrying at T=%.1f",
                             slot, info.window_id, cr, avg_lp,
                             ", rep-guard" if degenerate[slot] else "",
                             self.temperatures[info.temp_idx])
                    retries.append((slot, info))
                    del self._slots[slot]
                    continue
                skipped = verdict == "skip"
                result = WindowResult(
                    session_id=info.session_id, window_id=info.window_id,
                    tokens=[] if skipped else content,
                    text="" if skipped else text,
                    avg_logprob=avg_lp, no_speech_prob=ns,
                    first_token_latency=(info.first_token_at
                                         or now) - info.submitted_at,
                    latency=now - info.submitted_at,
                    temperature=temp, compression_ratio=cr,
                    skipped_silence=skipped, language=info.language,
                    steps=int(lengths[slot]))
                q = self._results.get(info.session_id)
                if q is not None:
                    q.put(result)
                del self._slots[slot]
                done_mask[slot] = True
        if done_mask.any():
            batcher.release(self.state, done_mask)
        for slot, info in retries:
            self._install(slot, info)
