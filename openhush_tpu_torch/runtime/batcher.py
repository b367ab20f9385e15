"""Continuous batching across concurrent sessions: the port of
openhush_tpu/runtime/batcher.py.

One decode step advances EVERY active slot by one token; admission and
eviction happen between steps at fixed shapes. Device state (flat KV layout,
as models/whisper/model.py):
  cache_k/v [L, B, T, H*Dh]      per-slot self-attention KV (int8 in the
  cache_ks/vs [L, B, T, H]         int8 self-cache mode, with fp32 scales;
                                 [L, B, 1, 1] placeholders otherwise)
  xkv_k/v   [L, B, A, H*Dh] int8 per-slot cross-attention KV, with
  xkv_ks/vs [L, B, A, H]         per-(position, head) fp32 scales
  d_cache_k/v [Ld, B, T, H*Dh]   the draft model's self-cache and int8
  d_xkv_k/v, d_xkv_ks/vs         cross-KV (speculative serving, spec_step;
                                 [1, 1, 1, 1] placeholders without a draft)
  tokens [B, T]                  prompt + generated ids
  pos [B] / length [B]           per-row decode offsets
  last_logits [B, V]             carried between steps
  ts_*, finished, active, ...    per-row decode-rule state

Differences from the reference, each with its reason:
- The state is updated in place (the reference donates its buffers through
  jitted functions and gets new ones back); `tokens` is written in place and
  `pos` replaced, in that order, so a concurrent reader of pos then tokens
  (EngineServer.peek) always finds tokens[:pos] written.
- `step` runs its inner steps as a Python loop of decode steps.
- Sampling rows (temperature > 0) draw from one torch.Generator per slot,
  seeded at admission (EngineServer passes server.slot_seed), so a row's
  draws depend only on its own seed, as the reference's per-row keys do;
  they are not the reference's random numbers. The per-slot temperatures and
  generators live on the host, with a per-slot `fresh` flag (admitted, no
  token yet), so that `spec_step` draws a row's numbers in `step`'s order
  without reading the device.
- `spec_step` runs its iterations and its draft rolls as Python loops of
  decode calls; the decode step writes first (model.py), so the rows a
  rejected block leaves past a row's fill are overwritten before any query
  sees them.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Sequence

import torch

from openhush_tpu_torch.device import resolve_device
from openhush_tpu_torch.models.whisper import decoding, model as whisper
from openhush_tpu_torch.models.whisper.config import WhisperConfig
from openhush_tpu_torch.text.tokenizer import WhisperTokenizer

NEG_INF = decoding.NEG_INF


@dataclasses.dataclass
class SlotState:
    cache_k: torch.Tensor        # [L, B, T, H*Dh], int8 in int8 mode
    cache_v: torch.Tensor
    cache_ks: torch.Tensor       # f32 [L, B, T, H] ([L, B, 1, 1] when fp)
    cache_vs: torch.Tensor
    xkv_k: torch.Tensor          # int8 [L, B, A, H*Dh]
    xkv_ks: torch.Tensor         # f32  [L, B, A, H]
    xkv_v: torch.Tensor
    xkv_vs: torch.Tensor
    d_cache_k: torch.Tensor      # [Ld, B, T, H*Dh] draft self-cache
    d_cache_v: torch.Tensor      #   ([1, 1, 1, 1] without a draft)
    d_xkv_k: torch.Tensor        # int8 [Ld, B, A, H*Dh] draft cross-KV
    d_xkv_ks: torch.Tensor       # f32  [Ld, B, A, H]
    d_xkv_v: torch.Tensor
    d_xkv_vs: torch.Tensor
    tokens: torch.Tensor         # [B, T] int64
    pos: torch.Tensor            # [B] int64: next cache write offset
    prompt_len: torch.Tensor     # [B] int64
    length: torch.Tensor         # [B] int64: generated tokens so far
    sum_logprob: torch.Tensor    # [B] f32
    no_speech: torch.Tensor      # [B] f32
    last_logits: torch.Tensor    # [B, V] f32
    active: torch.Tensor         # [B] bool
    finished: torch.Tensor       # [B] bool
    ts_prev: torch.Tensor        # [B] bool
    ts_prevprev: torch.Tensor    # [B] bool
    ts_floor: torch.Tensor       # [B] int64
    use_ts: torch.Tensor         # [B] bool: per-session timestamps flag
    prev_tok: torch.Tensor       # [B] int64: last sampled token
    prevprev_tok: torch.Tensor   # [B] int64
    rep_count: torch.Tensor      # [B] int64: consecutive short-cycle repeats
    degenerate: torch.Tensor     # [B] bool: aborted by the repetition guard
    temperature: list            # [B] host floats: 0 = greedy, > 0 sampling
    rng: list                    # [B] torch.Generator or None (host side)
    fresh: list                  # [B] host bools: admitted, no token drawn


# Rows past the decode budget when a draft is allocated: spec_step's verify
# pass writes K-token blocks at per-row offsets up to room_cap + K - 1.
SPEC_MARGIN = 16


def _state_shapes(cfg: WhisperConfig, n_slots: int, dtype: torch.dtype,
                  int8_self_cache: bool, max_len: Optional[int],
                  audio_ctx: Optional[int],
                  draft_cfg: Optional[WhisperConfig] = None) -> dict:
    """{field: (shape, dtype)} of every device tensor of SlotState: the one
    source of both init_state's allocation and state_bytes."""
    B = n_slots
    L, H = cfg.n_text_layer, cfg.n_text_head
    HD = cfg.n_text_state
    T = (max_len or cfg.n_text_ctx) + (SPEC_MARGIN if draft_cfg else 0)
    A = audio_ctx or cfg.n_audio_ctx
    i64, f32 = torch.int64, torch.float32
    cache_dt = torch.int8 if int8_self_cache else dtype
    scales = (L, B, T, H) if int8_self_cache else (L, B, 1, 1)
    shapes = {
        "cache_k": ((L, B, T, HD), cache_dt),
        "cache_v": ((L, B, T, HD), cache_dt),
        "cache_ks": (scales, f32), "cache_vs": (scales, f32),
        # Cross-KV slots are ALWAYS int8 (halves the dominant per-step read).
        "xkv_k": ((L, B, A, HD), torch.int8), "xkv_ks": ((L, B, A, H), f32),
        "xkv_v": ((L, B, A, HD), torch.int8), "xkv_vs": ((L, B, A, H), f32),
        "tokens": ((B, T), i64), "last_logits": ((B, cfg.n_vocab_padded), f32),
    }
    # The draft's state: the big model's width and heads (the server takes
    # only such a draft), its own depth.
    Ld = draft_cfg.n_text_layer if draft_cfg else None
    one = (1, 1, 1, 1)
    for name, shape, dt in (("d_cache_k", (Ld, B, T, HD), dtype),
                            ("d_cache_v", (Ld, B, T, HD), dtype),
                            ("d_xkv_k", (Ld, B, A, HD), torch.int8),
                            ("d_xkv_ks", (Ld, B, A, H), f32),
                            ("d_xkv_v", (Ld, B, A, HD), torch.int8),
                            ("d_xkv_vs", (Ld, B, A, H), f32)):
        shapes[name] = (shape if draft_cfg else one, dt)
    for name in ("pos", "prompt_len", "length", "ts_floor", "prev_tok",
                 "prevprev_tok", "rep_count"):
        shapes[name] = ((B,), i64)
    for name in ("sum_logprob", "no_speech"):
        shapes[name] = ((B,), f32)
    for name in ("active", "finished", "ts_prev", "ts_prevprev", "use_ts",
                 "degenerate"):
        shapes[name] = ((B,), torch.bool)
    return shapes


def init_state(cfg: WhisperConfig, n_slots: int, dtype=torch.bfloat16,
               int8_self_cache: bool = False,
               max_len: Optional[int] = None,
               audio_ctx: Optional[int] = None,
               draft_cfg: Optional[WhisperConfig] = None,
               device=None) -> SlotState:
    """audio_ctx < n_audio_ctx restricts the encoder context (whisper.cpp's
    audio_ctx speed knob). int8_self_cache: the self-cache holds int8
    levels with per-(position, head) scales. draft_cfg: allocate the draft
    model's state for spec_step (a draft of the big model's width and
    heads), with SPEC_MARGIN more rows in every T-sized buffer. `device`
    None means CUDA."""
    device = resolve_device(device)
    sp = WhisperTokenizer(cfg.n_langs).special
    fill = {"tokens": sp.eot, "last_logits": NEG_INF,
            "ts_floor": sp.timestamp_begin, "prev_tok": -1,
            "prevprev_tok": -1}
    tensors = {name: torch.full(shape, fill.get(name, 0), dtype=dt,
                                device=device)
               for name, (shape, dt) in _state_shapes(
                   cfg, n_slots, dtype, int8_self_cache, max_len,
                   audio_ctx, draft_cfg).items()}
    return SlotState(**tensors, temperature=[0.0] * n_slots,
                     rng=[None] * n_slots, fresh=[False] * n_slots)


def state_bytes(cfg: WhisperConfig, n_slots: int, dtype=torch.bfloat16,
                int8_self_cache: bool = False,
                max_len: Optional[int] = None,
                audio_ctx: Optional[int] = None,
                draft_cfg: Optional[WhisperConfig] = None) -> int:
    """Exact device bytes init_state(...) allocates, from the same shape
    table, so the two cannot drift. The server's memory budgeter uses it to
    refuse slot counts that do not fit next to the weights."""
    total = 0
    for shape, dt in _state_shapes(cfg, n_slots, dtype, int8_self_cache,
                                   max_len, audio_ctx, draft_cfg).values():
        n = 1
        for d in shape:
            n *= d
        total += n * torch.empty((), dtype=dt).element_size()
    return total


def _self_cache(state: SlotState, rows=slice(None)):
    """The decode() self-cache of `rows`: a QuantKVCache in int8 mode."""
    if state.cache_k.dtype == torch.int8:
        return whisper.QuantKVCache(state.cache_k[:, rows],
                                    state.cache_ks[:, rows],
                                    state.cache_v[:, rows],
                                    state.cache_vs[:, rows])
    return whisper.KVCache(state.cache_k[:, rows], state.cache_v[:, rows])


def _xkv(state: SlotState, rows=slice(None)) -> whisper.QuantKVCache:
    return whisper.QuantKVCache(state.xkv_k[:, rows], state.xkv_ks[:, rows],
                                state.xkv_v[:, rows], state.xkv_vs[:, rows])


def _draft_cache(state: SlotState, rows=slice(None)) -> whisper.KVCache:
    return whisper.KVCache(state.d_cache_k[:, rows], state.d_cache_v[:, rows])


def _draft_xkv(state: SlotState, rows=slice(None)) -> whisper.QuantKVCache:
    return whisper.QuantKVCache(state.d_xkv_k[:, rows],
                                state.d_xkv_ks[:, rows],
                                state.d_xkv_v[:, rows],
                                state.d_xkv_vs[:, rows])


def _install_xkv(state: SlotState, slot: int, xkv: whisper.QuantKVCache,
                 row: int, draft: bool = False) -> None:
    """Copy row `row` of a prepared cross-KV (the draft's with draft=True)
    into `slot`."""
    pre = "d_xkv" if draft else "xkv"
    for name, src in (("_k", xkv.k), ("_ks", xkv.k_scale), ("_v", xkv.v),
                      ("_vs", xkv.v_scale)):
        getattr(state, pre + name)[:, slot] = src[:, row]


def _prefill_row(cfg: WhisperConfig, params, state: SlotState, slot: int,
                 prompt: Sequence[int], use_timestamps: bool,
                 temperature: float, seed: int,
                 draft_cfg: Optional[WhisperConfig] = None,
                 draft_params=None) -> None:
    """Shared tail of admit/readmit: zero the slot's self-cache (values and
    scales), prefill the prompt against the cross-KV the slot holds, reset
    every per-slot field. With a draft, zero its self-cache row too and
    prefill the draft on the prompt against its cross-KV row: both caches
    then hold the prompt (spec_step keeps them at pos - 1)."""
    sp = WhisperTokenizer(cfg.n_langs).special
    dev = state.tokens.device
    for buf in (state.cache_k, state.cache_v, state.cache_ks, state.cache_vs):
        buf[:, slot].zero_()
    rows = slice(slot, slot + 1)
    row_cache = _self_cache(state, rows)
    p = torch.tensor([list(prompt)], dtype=torch.int64, device=dev)
    logits, _ = whisper.decode(cfg, params, p, 0, row_cache,
                               _xkv(state, rows))
    if draft_cfg is not None:
        for buf in (state.d_cache_k, state.d_cache_v):
            buf[:, slot].zero_()
        whisper.decode(draft_cfg, draft_params, p, 0,
                       _draft_cache(state, rows), _draft_xkv(state, rows))
    sot_probs = torch.softmax(logits[:, 0].float(), dim=-1)
    state.tokens[slot] = sp.eot
    state.tokens[slot, :len(prompt)] = p[0]
    for name, value in (("pos", len(prompt)), ("prompt_len", len(prompt)),
                        ("length", 0), ("sum_logprob", 0.0),
                        ("active", True), ("finished", False),
                        ("ts_prev", False), ("ts_prevprev", False),
                        ("ts_floor", sp.timestamp_begin),
                        ("use_ts", bool(use_timestamps)), ("prev_tok", -1),
                        ("prevprev_tok", -1), ("rep_count", 0),
                        ("degenerate", False)):
        getattr(state, name)[slot] = value
    state.no_speech[slot] = sot_probs[0, sp.no_speech]
    state.last_logits[slot] = logits[0, -1].float()
    state.temperature[slot] = float(temperature)
    state.rng[slot] = (torch.Generator(device=dev).manual_seed(int(seed))
                       if temperature > 0 else None)
    state.fresh[slot] = True


@torch.no_grad()
def admit(cfg: WhisperConfig, params, state: SlotState, slot: int,
          new_xkv: whisper.QuantKVCache, prompt: Sequence[int],
          use_timestamps: bool, *, prompt_len: int,
          temperature: float = 0.0, seed: int = 0, row: int = 0,
          draft_cfg: Optional[WhisperConfig] = None, draft_params=None,
          draft_xkv: Optional[whisper.QuantKVCache] = None) -> SlotState:
    """Install a session into `slot` and prefill its prompt.

    new_xkv: quantized cross-KV ([L, k, A, H*Dh] int8 + [L, k, A, H]
    scales) of k prepared windows; `row` picks which one to install.
    prompt: prompt_len token ids. temperature > 0 switches the row to
    sampling from a generator seeded `seed` (the fallback ladder).
    draft_*: speculative serving: install row `row` of the draft's int8
    cross-KV too and prefill the draft's self-cache."""
    if len(prompt) != prompt_len:
        raise ValueError(f"prompt has {len(prompt)} ids, not {prompt_len}")
    _install_xkv(state, slot, new_xkv, row)
    if draft_cfg is not None:
        _install_xkv(state, slot, draft_xkv, row, draft=True)
    _prefill_row(cfg, params, state, slot, prompt, use_timestamps,
                 temperature, seed, draft_cfg, draft_params)
    return state


@torch.no_grad()
def readmit(cfg: WhisperConfig, params, state: SlotState, slot: int,
            prompt: Sequence[int], use_timestamps: bool, *,
            prompt_len: int, temperature: float, seed: int,
            draft_cfg: Optional[WhisperConfig] = None,
            draft_params=None) -> SlotState:
    """Re-prefill `slot` from the cross-KV it already holds (the draft's
    too): the temperature-fallback retry path (no re-encode)."""
    if len(prompt) != prompt_len:
        raise ValueError(f"prompt has {len(prompt)} ids, not {prompt_len}")
    _prefill_row(cfg, params, state, slot, prompt, use_timestamps,
                 temperature, seed, draft_cfg, draft_params)
    return state


def admit_many(cfg: WhisperConfig, params, state: SlotState, slots,
               new_xkv: whisper.QuantKVCache, prompts, use_timestamps, *,
               prompt_len: int, temperatures, seeds, rows,
               draft_cfg: Optional[WhisperConfig] = None, draft_params=None,
               draft_xkv: Optional[whisper.QuantKVCache] = None
               ) -> SlotState:
    """Install k sessions from ONE prepared batch (all sharing `new_xkv`,
    `draft_xkv` and prompt_len): the reference's one-dispatch install, here
    the same admits one after another."""
    for i, slot in enumerate(slots):
        admit(cfg, params, state, int(slot), new_xkv, prompts[i],
              bool(use_timestamps[i]), prompt_len=prompt_len,
              temperature=float(temperatures[i]), seed=int(seeds[i]),
              row=int(rows[i]), draft_cfg=draft_cfg,
              draft_params=draft_params, draft_xkv=draft_xkv)
    return state


def _filter_logits(lg, *, suppress_mask, length, ts_state, use_ts, sp,
                   blank_mask, is_ts, max_initial_index):
    """The per-step [B, V] filter stack, every row at its own decode clock
    (`length`)."""
    sp_consts = (sp.timestamp_begin, sp.eot)
    lg = torch.where(suppress_mask[None, :], NEG_INF, lg)
    first = length == 0
    lg = torch.where(first[:, None] & blank_mask[None, :], NEG_INF, lg)
    lg_ts = decoding._timestamp_filter(lg, sp_consts, ts_state, length,
                                       max_initial_index)
    lg = torch.where(use_ts[:, None], lg_ts, lg)
    no_ts_mask = use_ts[:, None] | ~is_ts[None, :]
    return torch.where(no_ts_mask, lg, NEG_INF)


def _sampling_rows(state: SlotState) -> list:
    return [b for b, t in enumerate(state.temperature) if t > 0]


def _choose_tokens(lg, state: SlotState, rows=None):
    """Greedy argmax, or per-row temperature sampling (Gumbel-max on
    lg / T with the row's own generator) in `rows` (host list; default:
    every row whose temperature > 0), each drawing once. Returns (token [B]
    int64, logprobs [B, V])."""
    logprobs = torch.log_softmax(lg, dim=-1)
    nxt = torch.argmax(lg, dim=-1)
    if rows is None:
        rows = _sampling_rows(state)
    if rows:
        idx = torch.tensor(rows, device=lg.device)
        u = torch.stack([torch.rand(lg.shape[1], generator=state.rng[b],
                                    device=lg.device) for b in rows])
        temps = torch.tensor([max(state.temperature[b], 1e-6) for b in rows],
                             device=lg.device)
        gumbel = -torch.log(-torch.log(u))
        nxt[idx] = torch.argmax(lg[idx] / temps[:, None] + gumbel, dim=-1)
    return nxt, logprobs


@torch.no_grad()
def step(cfg: WhisperConfig, params, state: SlotState,
         suppress_mask: torch.Tensor, *, inner_steps: int = 8,
         max_initial_index: int = 50, blank_token: int = 220,
         rep_threshold: int = 12,
         room_cap: Optional[int] = None) -> SlotState:
    """Advance every active unfinished slot by `inner_steps` tokens (greedy,
    or sampled where the row's temperature > 0). A row whose last
    `rep_threshold` tokens all short-cycle (period 1 or 2) is finished early
    with `degenerate=True`: the repetition guard. Only live rows advance
    `pos`; a row finishes at `room_cap` (default: the buffer width - 1)."""
    sp = WhisperTokenizer(cfg.n_langs).special
    sp_consts = (sp.timestamp_begin, sp.eot)
    eot = sp.eot
    B, T = state.tokens.shape
    cap = T - 1 if room_cap is None else room_cap
    ids = torch.arange(state.last_logits.shape[1], device=state.tokens.device)
    blank_mask = (ids == blank_token) | (ids == eot)
    is_ts_ids = ids >= sp.timestamp_begin
    b_idx = torch.arange(B, device=ids.device)
    xkv = _xkv(state)

    for _ in range(inner_steps):
        st = state
        ts_state = (st.ts_prev, st.ts_prevprev, st.ts_floor)
        lg = _filter_logits(st.last_logits, suppress_mask=suppress_mask,
                            length=st.length, ts_state=ts_state,
                            use_ts=st.use_ts, sp=sp, blank_mask=blank_mask,
                            is_ts=is_ts_ids,
                            max_initial_index=max_initial_index)
        nxt, logprobs = _choose_tokens(lg, st)
        live = st.active & ~st.finished
        nxt = torch.where(live, nxt, eot)

        # Repetition guard: consecutive period-1/2 cycles of text tokens.
        is_text = (nxt != eot) & (nxt < sp.timestamp_begin)
        rep = live & is_text & ((nxt == st.prev_tok) | (nxt == st.prevprev_tok))
        rep_count = torch.where(live, torch.where(rep, st.rep_count + 1, 0),
                                st.rep_count)
        degenerate_now = live & (rep_count >= rep_threshold)

        tok_lp = torch.gather(logprobs, -1, nxt[:, None])[:, 0]
        new_ts = decoding._update_ts_state(ts_state, nxt, sp_consts,
                                           st.length)
        keep = lambda new, old: torch.where(live, new, old)
        out_of_room = st.pos >= cap
        finished = st.finished | (live & ((nxt == eot) | out_of_room
                                          | degenerate_now))

        # The token lands at each live row's pos; then the decode step.
        at = st.pos.clamp(max=T - 1)
        st.tokens[b_idx, at] = torch.where(live, nxt, st.tokens[b_idx, at])
        logits, _ = whisper.decode(cfg, params, nxt[:, None], st.pos,
                                   _self_cache(st), xkv)

        st.prevprev_tok = keep(st.prev_tok, st.prevprev_tok)
        st.prev_tok = keep(nxt, st.prev_tok)
        st.rep_count = rep_count
        st.degenerate = st.degenerate | degenerate_now
        st.sum_logprob = st.sum_logprob + torch.where(live, tok_lp, 0.0)
        st.length = st.length + live.long()
        st.ts_prev = keep(new_ts[0], st.ts_prev)
        st.ts_prevprev = keep(new_ts[1], st.ts_prevprev)
        st.ts_floor = keep(new_ts[2], st.ts_floor)
        st.finished = finished
        st.last_logits = logits[:, -1].float()
        st.pos = st.pos + (live & ~finished).long()
        st.fresh = [False] * B
    return state


@torch.no_grad()
def spec_step(cfg: WhisperConfig, params, draft_cfg: WhisperConfig,
              draft_params, state: SlotState, suppress_mask: torch.Tensor,
              *, k_spec: int = 4, n_iters: int = 2, room_cap: int,
              max_initial_index: int = 50, blank_token: int = 220,
              rep_threshold: int = 12,
              force_accept: bool = False) -> SlotState:
    """The speculative twin of step(): advance every active slot by
    1..k_spec tokens an iteration, n_iters iterations a call (the
    reference's batcher.spec_step).

    An iteration: the draft rolls k_spec proposals from every row's tip
    (S=1 steps at per-row fill + i), the big model verifies [tip,
    p1..p_{K-1}] in one decode at per-row fill over the slot's self-cache
    (int8 when the state has one), and each row emits its big-model tokens
    until the first one that differs from the proposal fed after it. Every
    emitted token is the big model's filtered argmax (or, for a ladder row
    at temperature > 0, its sample: such a row emits one token an
    iteration), with step()'s bookkeeping in step()'s order: repetition
    guard, timestamp state, room_cap, EOT. So the tokens are step()'s.

    Invariant between iterations: the newest emitted token (the tip,
    tokens[pos - 1]) is in neither cache; cache fill == pos - 1. A freshly
    admitted row (length 0, its frontier logits in last_logits) emits
    token #0 from last_logits first, which enters it into the invariant.
    step() keeps the other convention (the cache holds the tip), so the two
    must not run on one admitted row: the server switches modes only while
    the batcher is empty.

    A ladder row draws once from its generator at token #0 (only while
    `fresh`) and once at the verify's first position: one draw for each
    token it emits while live, in step()'s order, so it samples what
    step() would for the same seed.

    room_cap: the decode budget (the state's buffer rows minus
    SPEC_MARGIN, minus one); k_spec + room_cap + 1 must fit the buffers.
    force_accept (measurement only): the chain never breaks on a mismatch,
    so the output is no longer greedy's."""
    B, T = state.tokens.shape
    if k_spec + room_cap + 1 > T:
        raise ValueError(
            f"k_spec={k_spec} needs {k_spec + room_cap + 1} rows but the "
            f"state has {T} (init_state(draft_cfg=...) adds "
            f"SPEC_MARGIN={SPEC_MARGIN})")
    sp = WhisperTokenizer(cfg.n_langs).special
    sp_consts = (sp.timestamp_begin, sp.eot)
    eot = sp.eot
    K = k_spec
    dev = state.tokens.device
    ids = torch.arange(state.last_logits.shape[1], device=dev)
    filt = functools.partial(
        _filter_logits, suppress_mask=suppress_mask, sp=sp,
        blank_mask=(ids == blank_token) | (ids == eot),
        is_ts=ids >= sp.timestamp_begin, max_initial_index=max_initial_index)
    b_idx = torch.arange(B, device=dev)
    at = b_idx[:, None], torch.arange(K, device=dev)[None, :]
    cache, xkv = _self_cache(state), _xkv(state)
    dcache, dxkv = _draft_cache(state), _draft_xkv(state)
    sampling = _sampling_rows(state)
    greedy = torch.tensor([t == 0 for t in state.temperature], device=dev)
    no = torch.zeros(B, dtype=torch.bool, device=dev)

    def bookkeeping(c, nxt, tok_lp, emit, clock):
        """One emitted token's state advance, in step()'s order, with
        `emit` in the role of step()'s `live`."""
        ts, slp, length, pos, prev, prevprev, repc, deg, fin = c
        is_text = (nxt != eot) & (nxt < sp.timestamp_begin)
        rep = emit & is_text & ((nxt == prev) | (nxt == prevprev))
        repc = torch.where(emit, torch.where(rep, repc + 1, 0), repc)
        deg_now = emit & (repc >= rep_threshold)
        new_ts = decoding._update_ts_state(ts, nxt, sp_consts, clock)
        ts = tuple(torch.where(emit, a, b) for a, b in zip(new_ts, ts))
        fin_now = emit & ((nxt == eot) | (pos >= room_cap) | deg_now)
        c = (ts, slp + torch.where(emit, tok_lp, 0.0), length + emit.long(),
             pos + (emit & ~fin_now).long(),
             torch.where(emit, nxt, prev), torch.where(emit, prev, prevprev),
             repc, deg | deg_now, fin | fin_now)
        return c, fin_now

    for _ in range(n_iters):
        st = state
        live = st.active & ~st.finished

        # Fresh rows (length 0) emit token #0 from last_logits.
        ts_state = (st.ts_prev, st.ts_prevprev, st.ts_floor)
        lg0 = filt(st.last_logits, length=st.length, ts_state=ts_state,
                   use_ts=st.use_ts)
        nxt0, lp0 = _choose_tokens(lg0, st,
                                   [b for b in sampling if st.fresh[b]])
        st.fresh = [False] * B
        fresh = live & (st.length == 0)
        c = (ts_state, st.sum_logprob, st.length, st.pos, st.prev_tok,
             st.prevprev_tok, st.rep_count, st.degenerate, st.finished)
        c, _ = bookkeeping(c, nxt0, torch.gather(lp0, -1, nxt0[:, None])[:, 0],
                           fresh, st.length)
        # The fresh token lands at the old pos.
        st.tokens[b_idx, st.pos] = torch.where(fresh, nxt0,
                                               st.tokens[b_idx, st.pos])

        # Every live row now holds the tip invariant.
        length, pos, fin = c[2], c[3], c[8]
        live = st.active & ~fin
        fill = (pos - 1).clamp(min=0)
        tip = st.tokens[b_idx, fill]

        # The draft: K proposals from the tip.
        cur, dts, props = tip, c[0], []
        for i in range(K):
            lg, _ = whisper.decode(draft_cfg, draft_params, cur[:, None],
                                   fill + i, dcache, dxkv)
            lgf = filt(lg[:, -1].float(), length=length + i, ts_state=dts,
                       use_ts=st.use_ts)
            cur = torch.argmax(lgf, dim=-1)
            dts = decoding._update_ts_state(dts, cur, sp_consts, length + i)
            props.append(cur)
        props = torch.stack(props, dim=1)                  # [B, K]

        # The big model verifies [tip, p1..p_{K-1}] in one pass.
        block = torch.cat([tip[:, None], props[:, :K - 1]], dim=1)
        vlogits, _ = whisper.decode(cfg, params, block, fill, cache, xkv)
        vlogits = vlogits.float()                          # [B, K, V]

        # The accept scan, unrolled over the small K.
        ok = ~no
        trues, emits = [], []
        for i in range(K):
            lg = filt(vlogits[:, i], length=length + i, ts_state=c[0],
                      use_ts=st.use_ts)
            nxt, lps = _choose_tokens(lg, st, sampling if i == 0 else [])
            emit = ok & live & ~c[8]
            c, fin_now = bookkeeping(
                c, nxt, torch.gather(lps, -1, nxt[:, None])[:, 0], emit,
                length + i)
            # The chain goes on for greedy rows whose fed proposal was the
            # verified token (any proposal under force_accept).
            cont = emit & ~fin_now & greedy & (nxt != eot)
            if i == K - 1:
                ok = no
            else:
                ok = cont if force_accept else cont & (props[:, i] == nxt)
            trues.append(nxt)
            emits.append(emit)
        trues = torch.stack(trues, dim=1)
        emits = torch.stack(emits, dim=1)

        # The emitted window at each row's pos, then the state, pos last.
        win = (at[0], pos[:, None] + at[1])
        st.tokens[win] = torch.where(emits, trues, st.tokens[win])
        ((st.ts_prev, st.ts_prevprev, st.ts_floor), st.sum_logprob,
         st.length, pos, st.prev_tok, st.prevprev_tok, st.rep_count,
         st.degenerate, st.finished) = c
        st.pos = pos
    return state


def release(state: SlotState, slot_mask) -> SlotState:
    """Mark slots in slot_mask ([B] bool, on the host) as free: only the
    active/finished flags change, and the host-side sampling state."""
    mask = torch.as_tensor(slot_mask, dtype=torch.bool)
    for b, free in enumerate(mask.tolist()):
        if free:
            state.temperature[b] = 0.0
            state.rng[b] = None
    mask = mask.to(state.active.device)
    state.active &= ~mask
    state.finished &= ~mask
    return state
