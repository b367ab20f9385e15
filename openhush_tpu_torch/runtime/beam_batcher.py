"""Continuous beam batching: concurrent beam-search groups in one decode loop.
The port of openhush_tpu/runtime/beam_batcher.py.

The greedy batcher (runtime/batcher.py) advances one hypothesis a slot;
this module advances one beam-search GROUP of K hypotheses a slot, so the
server gets beam search (whisper.cpp's beam_size > 1) at fixed shapes:
admission and harvest happen between steps, as in the greedy server.

Each group gives the tokens of a B=1 `beam.beam_search_loop` run on its
window alone: the same expansion (top-2K over K·V candidates, EOT routing
into the finished set, length-penalized scores), with per-group live masks
that freeze a group once its stop condition fires.

The temperature ladder: a group admitted at temperature > 0 runs best-of-K
sampling (openai/whisper's DecodingTask: beam_size at T=0, best_of at
T > 0): K independent sampling rows, no reordering; the harvest picks the
best finished row by length-normalized logprob.

Device state, as runtime/batcher.SlotState with a beam axis:
  cache_k/v [L, G*K, T, H*Dh]   self-attention KV (int8 in the int8
  cache_ks/vs [L, G*K, T, H]      self-cache mode, with fp32 scales;
                                [L, G*K, 1, 1] placeholders otherwise),
                                never reordered: a beam inherits its
                                parent's history through `anc`
  anc [G, K, K, T] bool         ancestry: beam i reads cache row r at
                                position t iff its history wrote it
  xkv_k/v [L, G, A, H*Dh] int8  one cross-KV copy a group, with
  xkv_ks/vs [L, G, A, H]          per-(position, head) fp32 scales
  tokens [G, K, T]              prompt + each beam's hypothesis
  alive_lp / fin_* [G, K]       beam.py's alive/finished bookkeeping;
                                alive_lp is a row's sum logprob in
                                best-of sampling

Differences from the reference, each with its reason:
- The state is updated in place (the reference donates its buffers); in
  `step` the tokens are written before `step` advances, so a concurrent
  reader of step then tokens (BeamEngineServer.peek) finds them written.
- `step` runs its inner steps as a Python loop.
- Best-of rows draw from one torch.Generator a row (batcher._choose_tokens'
  recipe), seeded at admission; not the reference's random numbers. The
  per-group temperatures and generators live on the host.
- `admit` refuses prompt_len + max_new > T: the grouped step writes a
  beam's new key first and attends under its own bit, so a live step past
  the cache would not see its new key, where the reference's would
  (model.decode_beam_step).
"""

from __future__ import annotations

import dataclasses
import types
from typing import Optional, Sequence

import numpy as np
import torch

from openhush_tpu_torch.device import resolve_device
from openhush_tpu_torch.models.whisper import decoding, model as whisper
from openhush_tpu_torch.models.whisper.beam import (_gather_beams,
                                                    _length_score, _tile,
                                                    _top_k)
from openhush_tpu_torch.models.whisper.config import WhisperConfig
from openhush_tpu_torch.runtime.batcher import _choose_tokens, _filter_logits
from openhush_tpu_torch.text.tokenizer import WhisperTokenizer

NEG_INF = decoding.NEG_INF


@dataclasses.dataclass
class BeamState:
    cache_k: torch.Tensor        # [L, G*K, T, H*Dh], int8 in int8 mode
    cache_v: torch.Tensor
    cache_ks: torch.Tensor       # f32 [L, G*K, T, H] ([L, G*K, 1, 1] when fp)
    cache_vs: torch.Tensor
    xkv_k: torch.Tensor          # int8 [L, G, A, H*Dh], one copy a group
    xkv_ks: torch.Tensor         # f32  [L, G, A, H]
    xkv_v: torch.Tensor
    xkv_vs: torch.Tensor
    tokens: torch.Tensor         # [G, K, T] int64
    alive_lp: torch.Tensor       # [G, K] f32: sum logprob of a beam / row
    alive_len: torch.Tensor      # [G, K] int64
    fin_scores: torch.Tensor     # [G, K] f32, length-normalized
    fin_tokens: torch.Tensor     # [G, K, T] int64
    fin_lens: torch.Tensor       # [G, K] int64
    ts_prev: torch.Tensor        # [G, K] bool
    ts_prevprev: torch.Tensor    # [G, K] bool
    ts_floor: torch.Tensor       # [G, K] int64
    use_ts: torch.Tensor         # [G] bool
    prompt_len: torch.Tensor     # [G] int64
    step: torch.Tensor           # [G] int64: sampled tokens so far
    max_new: torch.Tensor        # [G] int64: the group's step budget
    no_speech: torch.Tensor      # [G] f32
    last_logits: torch.Tensor    # [G*K, V] f32
    active: torch.Tensor         # [G] bool
    finished: torch.Tensor       # [G] bool
    done_row: torch.Tensor       # [G, K] bool: a sampling row hit EOT
    anc: torch.Tensor            # [G, K, K, T] bool: the ancestry
    temperature: list            # [G] host floats: 0 = beam, > 0 best-of
    rng: list                    # [G] K torch.Generators, or None


def _state_shapes(cfg: WhisperConfig, G: int, K: int, dtype: torch.dtype,
                  int8_self_cache: bool, max_len: Optional[int],
                  audio_ctx: Optional[int]) -> dict:
    """{field: (shape, dtype)} of every device tensor of BeamState: the one
    source of both init_state's allocation and state_bytes."""
    GK = G * K
    L, H = cfg.n_text_layer, cfg.n_text_head
    HD = cfg.n_text_state
    T = max_len or cfg.n_text_ctx
    A = audio_ctx or cfg.n_audio_ctx
    i64, f32, b = torch.int64, torch.float32, torch.bool
    cache_dt = torch.int8 if int8_self_cache else dtype
    scales = (L, GK, T, H) if int8_self_cache else (L, GK, 1, 1)
    shapes = {
        "cache_k": ((L, GK, T, HD), cache_dt),
        "cache_v": ((L, GK, T, HD), cache_dt),
        "cache_ks": (scales, f32), "cache_vs": (scales, f32),
        "xkv_k": ((L, G, A, HD), torch.int8), "xkv_ks": ((L, G, A, H), f32),
        "xkv_v": ((L, G, A, HD), torch.int8), "xkv_vs": ((L, G, A, H), f32),
        "tokens": ((G, K, T), i64), "fin_tokens": ((G, K, T), i64),
        "last_logits": ((GK, cfg.n_vocab_padded), f32),
        "anc": ((G, K, K, T), b),
    }
    for name in ("alive_lp", "fin_scores"):
        shapes[name] = ((G, K), f32)
    for name in ("alive_len", "fin_lens", "ts_floor"):
        shapes[name] = ((G, K), i64)
    for name in ("ts_prev", "ts_prevprev", "done_row"):
        shapes[name] = ((G, K), b)
    for name in ("prompt_len", "step", "max_new"):
        shapes[name] = ((G,), i64)
    shapes["no_speech"] = ((G,), f32)
    for name in ("use_ts", "active", "finished"):
        shapes[name] = ((G,), b)
    return shapes


def _nbytes(shape, dtype) -> int:
    return int(np.prod(shape)) * torch.empty((), dtype=dtype).element_size()


def init_state(cfg: WhisperConfig, n_groups: int, beam_size: int,
               dtype=torch.bfloat16, max_len: Optional[int] = None,
               audio_ctx: Optional[int] = None,
               int8_self_cache: bool = False, device=None) -> BeamState:
    """G = n_groups groups of K = beam_size beams. `device` None means
    CUDA."""
    device = resolve_device(device)
    sp = WhisperTokenizer(cfg.n_langs).special
    fill = {"tokens": sp.eot, "fin_tokens": sp.eot, "alive_lp": NEG_INF,
            "fin_scores": NEG_INF, "last_logits": NEG_INF,
            "ts_floor": sp.timestamp_begin}
    tensors = {name: torch.full(shape, fill.get(name, 0), dtype=dt,
                                device=device)
               for name, (shape, dt) in _state_shapes(
                   cfg, n_groups, beam_size, dtype, int8_self_cache, max_len,
                   audio_ctx).items()}
    return BeamState(**tensors, temperature=[0.0] * n_groups,
                     rng=[None] * n_groups)


def state_bytes(cfg: WhisperConfig, n_groups: int, beam_size: int,
                dtype=torch.bfloat16, max_len: Optional[int] = None,
                audio_ctx: Optional[int] = None,
                int8_self_cache: bool = False) -> int:
    """Device bytes of init_state(...), from the same shape table, plus,
    where the fallback formulation runs (K·H > 128), what each of its step
    dispatches holds beside the state: the cross-KV tiled K ways (as the
    reference counts it) and the self-cache rows gathered by parent."""
    shapes = _state_shapes(cfg, n_groups, beam_size, dtype, int8_self_cache,
                           max_len, audio_ctx)
    total = sum(_nbytes(*s) for s in shapes.values())
    if not whisper.beam_grouped_ok(cfg, beam_size):
        total += beam_size * sum(_nbytes(*shapes[f]) for f in (
            "xkv_k", "xkv_ks", "xkv_v", "xkv_vs"))
        total += sum(_nbytes(*shapes[f]) for f in (
            "cache_k", "cache_v", "cache_ks", "cache_vs"))
    return total


def _cache(state: BeamState, rows=slice(None)):
    """The self-cache of `rows` (a QuantKVCache in int8 mode)."""
    if state.cache_k.dtype == torch.int8:
        return whisper.QuantKVCache(state.cache_k[:, rows],
                                    state.cache_ks[:, rows],
                                    state.cache_v[:, rows],
                                    state.cache_vs[:, rows])
    return whisper.KVCache(state.cache_k[:, rows], state.cache_v[:, rows])


def _xkv(state: BeamState, groups=slice(None)) -> whisper.QuantKVCache:
    return whisper.QuantKVCache(state.xkv_k[:, groups],
                                state.xkv_ks[:, groups],
                                state.xkv_v[:, groups],
                                state.xkv_vs[:, groups])


@torch.no_grad()
def admit(cfg: WhisperConfig, params, state: BeamState, group: int,
          new_xkv: whisper.QuantKVCache, prompt: Sequence[int],
          use_timestamps: bool, *, prompt_len: int, max_new: int,
          temperature: float = 0.0, rng: Optional[list] = None,
          row: int = 0) -> BeamState:
    """Install one window as beam group `group` and prefill its prompt.

    new_xkv: a prepared batch of int8 cross-KV windows ([L, k, A, H*Dh] +
    [L, k, A, H] scales); `row` picks the window, stored once for the
    group. temperature 0: beam search (only beam 0 alive at the start);
    > 0: best-of-K sampling, row r drawing from rng[r] (K generators on
    the state's device)."""
    _check_group(state, prompt, prompt_len, max_new, temperature, rng)
    for name, src in (("xkv_k", new_xkv.k), ("xkv_ks", new_xkv.k_scale),
                      ("xkv_v", new_xkv.v), ("xkv_vs", new_xkv.v_scale)):
        getattr(state, name)[:, group] = src[:, row]
    return _prefill_group(cfg, params, state, group, prompt, use_timestamps,
                          prompt_len, max_new, temperature, rng)


@torch.no_grad()
def readmit(cfg: WhisperConfig, params, state: BeamState, group: int,
            prompt: Sequence[int], use_timestamps: bool, *, prompt_len: int,
            max_new: int, temperature: float,
            rng: Optional[list] = None) -> BeamState:
    """Re-prefill `group` from the cross-KV it already holds: the
    temperature ladder's retry (beam → best-of sampling), no re-encode."""
    _check_group(state, prompt, prompt_len, max_new, temperature, rng)
    return _prefill_group(cfg, params, state, group, prompt, use_timestamps,
                          prompt_len, max_new, temperature, rng)


def _check_group(state: BeamState, prompt, prompt_len: int, max_new: int,
                 temperature: float, rng) -> None:
    _, K, T = state.tokens.shape
    if len(prompt) != prompt_len:
        raise ValueError(f"prompt has {len(prompt)} ids, not {prompt_len}")
    if prompt_len + max_new > T:
        raise ValueError(f"prompt_len {prompt_len} + max_new {max_new} "
                         f"passes the cache's {T} rows")
    if temperature > 0 and (rng is None or len(rng) != K):
        raise ValueError(f"sampling needs {K} generators")


def _prefill_group(cfg: WhisperConfig, params, state: BeamState, group: int,
                   prompt: Sequence[int], use_timestamps: bool,
                   prompt_len: int, max_new: int, temperature: float,
                   rng: Optional[list]) -> BeamState:
    """Shared tail of admit/readmit: prefill the prompt into the group's
    first cache row against its cross-KV and copy that row to the other
    K-1 (the beams are identical until the first expansion, as in
    beam.py), then reset every per-group field."""
    G, K, T = state.tokens.shape
    sp = WhisperTokenizer(cfg.n_langs).special
    dev = state.tokens.device
    base = group * K
    bufs = (state.cache_k, state.cache_v, state.cache_ks, state.cache_vs)
    for buf in bufs:
        buf[:, base:base + K].zero_()
    p = torch.tensor([list(prompt)], dtype=torch.int64, device=dev)
    logits, _ = whisper.decode(cfg, params, p, 0,
                               _cache(state, slice(base, base + 1)),
                               _xkv(state, slice(group, group + 1)))
    for buf in bufs:
        buf[:, base + 1:base + K] = buf[:, base:base + 1]
    sot_probs = torch.softmax(logits[:, 0].float(), dim=-1)
    state.last_logits[base:base + K] = logits[0, -1].float()
    state.tokens[group] = sp.eot
    state.tokens[group, :, :prompt_len] = p[0]
    state.fin_tokens[group] = sp.eot
    # Beam: only beam 0 alive at the start. Sampling: every row alive.
    state.alive_lp[group] = (torch.tensor([0.0] + [NEG_INF] * (K - 1),
                                          device=dev)
                             if temperature == 0 else 0.0)
    for name, value in (("alive_len", 0), ("fin_scores", NEG_INF),
                        ("fin_lens", 0), ("ts_prev", False),
                        ("ts_prevprev", False),
                        ("ts_floor", sp.timestamp_begin),
                        ("use_ts", bool(use_timestamps)),
                        ("prompt_len", prompt_len), ("step", 0),
                        ("max_new", max_new), ("active", True),
                        ("finished", False), ("done_row", False)):
        getattr(state, name)[group] = value
    state.no_speech[group] = sot_probs[0, sp.no_speech]
    state.anc[group] = whisper.beam_ancestry(1, K, T, prompt_len, dev)[0]
    state.temperature[group] = float(temperature)
    state.rng[group] = list(rng) if temperature > 0 else None
    return state


@torch.no_grad()
def step(cfg: WhisperConfig, params, state: BeamState,
         suppress_mask: torch.Tensor, *, inner_steps: int = 8,
         max_initial_index: int = 50, blank_token: int = 220,
         length_penalty: Optional[float] = None) -> BeamState:
    """Advance every live group by `inner_steps` beam expansions (sampling
    steps for groups at T > 0). A group whose stop condition fires freezes
    for the rest of the call: its state is that of a B=1 one-shot
    beam_search_loop at its exit."""
    sp = WhisperTokenizer(cfg.n_langs).special
    sp_consts = (sp.timestamp_begin, sp.eot)
    eot = sp.eot
    G, K, T = state.tokens.shape
    GK = G * K
    V = state.last_logits.shape[1]
    dev = state.tokens.device
    ids = torch.arange(V, device=dev)
    blank_mask = (ids == blank_token) | (ids == eot)
    is_ts_ids = ids >= sp.timestamp_begin
    grouped = whisper.beam_grouped_ok(cfg, K)
    # Grouped: the shared cross-KV and no cache reorder
    # (model.decode_beam_step). Else the parent-gather formulation, with
    # the cross-KV tiled K ways once a call.
    xkv = _xkv(state) if grouped else _tile(_xkv(state), K)
    is_beam = torch.tensor([t == 0 for t in state.temperature], device=dev)
    # batcher._choose_tokens' per-row temperatures and generators.
    rows = types.SimpleNamespace(
        temperature=[t for t in state.temperature for _ in range(K)],
        rng=[r[i] if r else None for r in state.rng for i in range(K)])
    identity = torch.arange(K, device=dev).expand(G, K)
    groups = torch.arange(G, device=dev)[:, None]

    for _ in range(inner_steps):
        st = state
        live = st.active & ~st.finished                          # [G]
        liver = live.repeat_interleave(K)                        # [GK]
        stepv = st.step.repeat_interleave(K)
        ts_flat = (st.ts_prev.view(GK), st.ts_prevprev.view(GK),
                   st.ts_floor.view(GK))
        lg = _filter_logits(st.last_logits, suppress_mask=suppress_mask,
                            length=stepv, ts_state=ts_flat,
                            use_ts=st.use_ts.repeat_interleave(K), sp=sp,
                            blank_mask=blank_mask, is_ts=is_ts_ids,
                            max_initial_index=max_initial_index)
        # Sampling candidates (rows of groups at T > 0); the logprobs serve
        # the beam expansion too.
        nxt_s, logprobs = _choose_tokens(lg, rows)

        # ---- beam expansion (beam.py's formulation) ----
        cand = st.alive_lp[:, :, None] + logprobs.view(G, K, V)
        top_lp, top_idx = _top_k(cand.view(G, K * V), 2 * K)
        parent = top_idx // V                                    # [G, 2K]
        tok = top_idx % V
        is_eot = tok == eot
        new_len = st.alive_len.gather(1, parent) + 1
        eot_scores = torch.where(
            is_eot, _length_score(top_lp, new_len, length_penalty), NEG_INF)
        all_scores = torch.cat([st.fin_scores, eot_scores], dim=1)
        all_tokens = torch.cat([st.fin_tokens,
                                _gather_beams(st.tokens, parent)], dim=1)
        all_lens = torch.cat([st.fin_lens,
                              torch.where(is_eot, new_len - 1, 0)], dim=1)
        b_fin_scores, fin_idx = _top_k(all_scores, K)
        b_fin_tokens = _gather_beams(all_tokens, fin_idx)
        b_fin_lens = all_lens.gather(1, fin_idx)
        b_alive_lp, aidx = _top_k(torch.where(is_eot, NEG_INF, top_lp), K)
        b_parent = parent.gather(1, aidx)                        # [G, K]
        b_tok = tok.gather(1, aidx)
        b_len = new_len.gather(1, aidx)

        # ---- best-of sampling rows (identity parents) ----
        done = st.done_row
        s_tok = torch.where(done, eot, nxt_s.view(G, K))
        tok_lp = logprobs.gather(1, nxt_s[:, None]).view(G, K)
        s_emit = ~done                       # the EOT step itself counts
        s_lp = st.alive_lp + torch.where(s_emit, tok_lp, 0.0)
        s_len = st.alive_len + s_emit.long()
        s_done = done | (s_tok == eot)

        # ---- per-group choice, then freeze the groups that are not live ----
        sel = lambda b, s: torch.where(is_beam[:, None], b, s)
        parent_sel = torch.where((live & is_beam)[:, None], b_parent,
                                 identity)
        tok_sel = sel(b_tok, s_tok)
        keep = lambda new, old: torch.where(
            live.view(G, *[1] * (old.dim() - 1)), new, old)
        alive_lp = keep(sel(b_alive_lp, s_lp), st.alive_lp)
        alive_len = keep(sel(b_len, s_len), st.alive_len)
        fin_scores = keep(sel(b_fin_scores, st.fin_scores), st.fin_scores)
        fin_lens = keep(sel(b_fin_lens, st.fin_lens), st.fin_lens)
        fin_tokens = keep(torch.where(is_beam[:, None, None], b_fin_tokens,
                                      st.fin_tokens), st.fin_tokens)
        done_row = keep(sel(done, s_done), done)

        # ---- tokens: gathered by parent, written at the group's column ----
        pos_g = st.prompt_len + st.step                          # [G]
        at = pos_g.clamp(max=T - 1).view(G, 1, 1).expand(G, K, 1)
        written = _gather_beams(st.tokens, parent_sel).scatter_(
            2, at, tok_sel[:, :, None])
        tokens = keep(written, st.tokens)

        # ---- ts state: gathered, then updated (done sampling rows keep) ----
        flat_parent = (parent_sel + groups * K).view(GK)
        ts_old = tuple(t[flat_parent] for t in ts_flat)
        new_ts = decoding._update_ts_state(ts_old, tok_sel.view(GK),
                                           sp_consts, stepv)
        upd = liver & ~((~is_beam).repeat_interleave(K) & done.view(GK))
        ts_sel = [torch.where(upd, n, o).view(G, K)
                  for n, o in zip(new_ts, ts_old)]

        # ---- one decode step for every row ----
        if grouped:
            # The parent's ancestry plus the own write at pos_g: this
            # step's visibility, and the next step's ancestry where live.
            att = whisper.beam_own(_gather_beams(st.anc, parent_sel), pos_g)
            logits, _ = whisper.decode_beam_step(
                cfg, params, tok_sel, pos_g, _cache(st),
                att.view(G, K, K * T), xkv)
            logits = logits.view(GK, V)
            st.anc = keep(att, st.anc)
        else:
            for name in ("cache_k", "cache_v", "cache_ks", "cache_vs"):
                setattr(st, name, getattr(st, name)[:, flat_parent])
            logits, _ = whisper.decode(cfg, params, tok_sel.view(GK, 1),
                                       pos_g.repeat_interleave(K), _cache(st),
                                       xkv)
            logits = logits[:, -1]

        # ---- stop conditions, per group (beam.py's for B=1) ----
        step_new = st.step + live.long()
        slots_open = (fin_scores <= NEG_INF / 2).any(dim=1)
        alive_ok = alive_lp.amax(dim=1) > NEG_INF / 2
        cont = (step_new < st.max_new) & torch.where(
            is_beam, slots_open & alive_ok, ~done_row.all(dim=1))

        st.tokens = tokens
        st.alive_lp, st.alive_len = alive_lp, alive_len
        st.fin_scores, st.fin_tokens, st.fin_lens = (fin_scores, fin_tokens,
                                                     fin_lens)
        st.ts_prev, st.ts_prevprev, st.ts_floor = ts_sel
        st.done_row = done_row
        st.last_logits = torch.where(liver[:, None], logits.float(),
                                     st.last_logits)
        st.finished = st.finished | (live & ~cont)
        st.step = step_new
    return state


def release(state: BeamState, group_mask) -> BeamState:
    """Mark the groups in group_mask ([G] bool, on the host) as free: the
    active/finished flags change, and the host-side sampling state."""
    mask = torch.as_tensor(group_mask, dtype=torch.bool)
    for g, free in enumerate(mask.tolist()):
        if free:
            state.temperature[g] = 0.0
            state.rng[g] = None
    mask = mask.to(state.active.device)
    state.active &= ~mask
    state.finished &= ~mask
    return state


def best_hypothesis(tokens, alive_lp, alive_len, fin_scores, fin_tokens,
                    fin_lens, temperature, done_row,
                    length_penalty: Optional[float] = None):
    """The harvest's pick for ONE group, on the host (numpy [K, ...] rows).

    Beam (T=0): the best finished hypothesis, else the best alive beam
    (beam.py). Sampling (T > 0): the best row by length-normalized sum
    logprob, rows that hit EOT first. Returns (row_tokens [T], length,
    score)."""
    def lscore(slp, ln):
        ln = max(int(ln), 1)
        if length_penalty is None:
            return float(slp) / ln
        return float(slp) / (((5.0 + ln) / 6.0) ** length_penalty)

    if float(temperature) == 0.0:
        if fin_scores[0] > NEG_INF / 2:
            return fin_tokens[0], int(fin_lens[0]), float(fin_scores[0])
        return tokens[0], int(alive_len[0]), lscore(alive_lp[0],
                                                    alive_len[0])
    scores = np.asarray([lscore(alive_lp[r], alive_len[r])
                         for r in range(len(alive_lp))])
    # Prefer completed rows; budget-cut rows only if nothing completed.
    if done_row.any():
        scores = np.where(done_row, scores, -np.inf)
    r = int(scores.argmax())
    # Sampling rows count the EOT step in alive_len (as greedy_loop); strip
    # it from the content length.
    ln = int(alive_len[r]) - (1 if done_row[r] else 0)
    return tokens[r], max(ln, 0), float(scores[r])
