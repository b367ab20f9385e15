"""Beam-search serving: EngineServer with beam GROUPS instead of slots.
The port of openhush_tpu/runtime/beam_server.py.

The whole EngineServer surface stays (sessions, the prep thread, batched
encode, admission, the quality ladder, peek); the device state is
runtime/beam_batcher's groups: G concurrent windows, each a K-beam search,
advanced together by one step.

The temperature ladder follows openai/whisper's DecodingTask: T=0 runs beam
search; a retry (compression-ratio or logprob failure) runs at T > 0 as
best-of-K sampling over the cross-KV the group already holds on the device
(beam_batcher.readmit, no re-encode).
"""

from __future__ import annotations

import functools
import logging
import time
from typing import Optional

import numpy as np
import torch

from openhush_tpu_torch.runtime import beam_batcher
from openhush_tpu_torch.runtime.server import (EngineServer, WindowResult,
                                               _SlotInfo, slot_seed)

log = logging.getLogger(__name__)


class BeamEngineServer(EngineServer):
    """Continuous-batching server whose unit of work is a K-beam group.

    `n_slots` counts GROUPS (concurrent windows); the device batch is
    n_slots * beam_size rows. The int8 self-cache quantizes each beam's K/V
    as it is written (the scales ride the same ancestry mask,
    model.decode_beam_step), and deep stepping runs deep_factor x more
    inner steps when every group is busy. Drafting stays greedy-only: a
    draft proposes one chain a window, and a K-beam frontier has no single
    chain to verify."""

    def __init__(self, cfg, params, *, beam_size: int = 5,
                 length_penalty: Optional[float] = None, **kw):
        if kw.pop("draft", None) is not None:
            log.warning("speculative drafting is unsupported with beam "
                        "serving; ignoring draft model")
        self.beam_size = max(1, int(beam_size))
        self.length_penalty = length_penalty
        super().__init__(cfg, params, **kw)

    # -- device state ----------------------------------------------------------

    def _init_device_state(self, *, dtype, max_len, int8_self_cache) -> None:
        self._check_hbm_budget(functools.partial(
            beam_batcher.state_bytes, self.cfg, beam_size=self.beam_size,
            dtype=dtype, max_len=max_len, audio_ctx=self.audio_ctx,
            int8_self_cache=int8_self_cache))
        self.state = beam_batcher.init_state(
            self.cfg, self.n_slots, self.beam_size, dtype=dtype,
            max_len=max_len, audio_ctx=self.audio_ctx,
            int8_self_cache=int8_self_cache, device=self.device)

    def _step_state(self, deep: bool = False) -> None:
        inner = self.inner_steps * (self.deep_factor if deep else 1)
        self.step_dispatches += 1
        beam_batcher.step(self.cfg, self.params, self.state, self._suppress,
                          inner_steps=inner, blank_token=self._blank_token,
                          length_penalty=self.length_penalty)

    # -- admission -------------------------------------------------------------

    def _group_rng(self, info: _SlotInfo) -> list:
        """K generators for the best-of rungs' rows, seeded from a
        generator seeded slot_seed(info): split from the one per-window
        stream, as the reference splits its key."""
        seeds = torch.randint(
            0, 2 ** 31 - 1, (self.beam_size,),
            generator=torch.Generator().manual_seed(slot_seed(info)))
        return [torch.Generator(device=self.device).manual_seed(int(s))
                for s in seeds]

    def _install(self, slot: int, info: _SlotInfo, xkv=None,
                 row: int = 0, dxkv=None) -> None:
        prompt = self.tokenizer.sot_sequence(info.language, info.task,
                                             timestamps=info.timestamps)
        info.prompt_len = len(prompt)
        temp = float(self.temperatures[info.temp_idx])
        kw = dict(prompt_len=len(prompt),
                  max_new=max(1, self.room_cap - len(prompt)),
                  temperature=temp,
                  rng=self._group_rng(info) if temp > 0 else None)
        if xkv is not None:
            beam_batcher.admit(self.cfg, self.params, self.state, slot, xkv,
                               prompt, info.timestamps, row=row, **kw)
        else:
            beam_batcher.readmit(self.cfg, self.params, self.state, slot,
                                 prompt, info.timestamps, **kw)
        with self._lock:
            self._slots[slot] = info

    def _install_many(self, group) -> None:
        """A group prefills one row; the installs run one by one."""
        for slot, info, xkv, row, _ in group:
            self._install(slot, info, xkv=xkv, row=row)

    # -- observation -----------------------------------------------------------

    def peek(self, session_id: int) -> Optional[list[int]]:
        """Partial content tokens of the window's top alive beam (row 0:
        each expansion sorts the rows by score). Reads `step` first: the
        step writes the tokens before it advances `step`."""
        with self._lock:
            slot = next((s for s, info in self._slots.items()
                         if info.session_id == session_id), None)
            if slot is None:
                return None
            info = self._slots[slot]
        state = self.state
        n = int(state.step[slot])
        tokens = state.tokens[slot, 0].cpu().tolist()
        return [t for t in tokens[info.prompt_len:info.prompt_len + n]
                if t != self.tokenizer.special.eot]

    # -- harvest ---------------------------------------------------------------

    def _harvest(self) -> None:
        st = self.state
        flags = torch.stack([st.finished.long(), st.step]).cpu().numpy()
        finished, steps = flags[0].astype(bool), flags[1]
        if not finished.any():
            with self._lock:
                for slot, info in self._slots.items():
                    if info.first_token_at is None and steps[slot] > 0:
                        info.first_token_at = time.monotonic()
            return
        (tokens, alive_lp, alive_len, fin_scores, fin_tokens, fin_lens,
         done_row, no_speech) = (t.cpu().numpy() for t in (
             st.tokens, st.alive_lp, st.alive_len, st.fin_scores,
             st.fin_tokens, st.fin_lens, st.done_row, st.no_speech))
        eot = self.tokenizer.special.eot
        done_mask = np.zeros(self.n_slots, bool)
        retries: list[tuple[int, _SlotInfo]] = []
        now = time.monotonic()
        with self._lock:
            done = [(s, i) for s, i in self._slots.items() if finished[s]]
            for slot, info in done:
                row, length, score = beam_batcher.best_hypothesis(
                    tokens[slot], alive_lp[slot], alive_len[slot],
                    fin_scores[slot], fin_tokens[slot], fin_lens[slot],
                    st.temperature[slot], done_row[slot],
                    length_penalty=self.length_penalty)
                content = [int(t) for t in
                           row[info.prompt_len:info.prompt_len + length]
                           if t != eot]
                text = self.tokenizer.decode(content)
                # With length_penalty None the hypothesis score is the
                # average logprob (beam._length_score), so the ladder's
                # logprob_threshold applies as it is.
                avg_lp = float(score)
                ns = float(no_speech[slot])
                verdict, cr = self._quality_verdict(text, avg_lp, ns, False)
                temp = float(self.temperatures[info.temp_idx])
                if (verdict == "fallback"
                        and info.temp_idx + 1 < len(self.temperatures)):
                    info.temp_idx += 1
                    log.info("group %d window %d degenerate (cr=%.2f, "
                             "lp=%.2f); retrying best-of-%d at T=%.1f",
                             slot, info.window_id, cr, avg_lp,
                             self.beam_size,
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
                    skipped_silence=skipped, language=info.language)
                q = self._results.get(info.session_id)
                if q is not None:
                    q.put(result)
                del self._slots[slot]
                done_mask[slot] = True
        if done_mask.any():
            beam_batcher.release(self.state, done_mask)
        for slot, info in retries:
            self._install(slot, info)
