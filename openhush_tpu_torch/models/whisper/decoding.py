"""Whisper decoding: logit filters, the greedy/sampling loop, language ID.

Port of openhush_tpu/models/whisper/decoding.py (whisper.cpp's decode-time
heuristics: non-speech token suppression, blank suppression at the first
step, the paired-timestamp grammar, monotonic timestamps, the
timestamp-vs-text probability rule, and no-speech probability capture).

The reference runs the whole loop as one compiled `lax.while_loop`; here it
is a Python loop of decode steps on the device, with the "every row has
finished" test read on the host after each step. Sampling at temperature
> 0 draws Gumbel noise from a torch.Generator: the same rule as
`jax.random.categorical`, but not the same random numbers.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from openhush_tpu_torch.models.whisper import model as whisper
from openhush_tpu_torch.models.whisper.config import WhisperConfig
from openhush_tpu_torch.text.tokenizer import WhisperTokenizer

NEG_INF = float(np.finfo(np.float32).min)


@dataclasses.dataclass(frozen=True)
class DecodingOptions:
    task: str = "transcribe"               # "transcribe" | "translate"
    language: Optional[str] = None          # None → auto-detect
    temperature: float = 0.0
    beam_size: Optional[int] = None         # None → greedy
    length_penalty: Optional[float] = None  # None → simple length average
    without_timestamps: bool = False
    max_initial_timestamp: float = 1.0
    suppress_blank: bool = True
    suppress_tokens: bool = True            # non-speech list
    max_new_tokens: int = 224               # half of n_text_ctx, whisper default


@dataclasses.dataclass
class DecodingResult:
    tokens: np.ndarray          # [B, T] including prompt, EOT-padded
    prompt_len: int
    avg_logprob: np.ndarray     # [B]
    no_speech_prob: np.ndarray  # [B]
    language: list[str]
    temperature: float = 0.0


def build_suppress_mask(tok: WhisperTokenizer, cfg: WhisperConfig,
                        opts: DecodingOptions) -> np.ndarray:
    """Static [V_padded] bool mask of always-suppressed ids (True=suppress).
    Mirrors whisper's SuppressTokens + sot-sequence suppression."""
    sp = tok.special
    mask = np.zeros(cfg.n_vocab_padded, dtype=bool)
    if opts.suppress_tokens:
        for t in tok.non_speech_tokens:
            mask[t] = True
    # Task/meta tokens are never sampled.
    for t in (sp.sot, sp.translate, sp.transcribe, sp.start_of_lm,
              sp.start_of_prev, sp.no_speech):
        mask[t] = True
    for l in range(sp.lang_base, sp.lang_base + sp.n_langs):
        mask[l] = True
    if opts.without_timestamps:
        mask[sp.timestamp_begin:] = True
    else:
        mask[sp.no_timestamps] = True
    mask[cfg.n_vocab:] = True  # vocab padding
    return mask


def _timestamp_filter(logits, sp_consts, state, step: int,
                      max_initial_index):
    """Apply whisper's timestamp grammar to [B, V] fp32 logits.

    state: (prev_was_ts [B], prevprev_was_ts [B], ts_floor [B]) where ts_floor
    is the minimum allowed timestamp token id (monotonicity); step is the
    count of tokens sampled so far: an int, or a [B] tensor when every row
    is at its own step (continuous batching)."""
    ts_begin, eot = sp_consts
    B, V = logits.shape
    vocab_ids = torch.arange(V, device=logits.device)[None, :]     # [1, V]
    is_ts = vocab_ids >= ts_begin
    prev_was_ts, prevprev_was_ts, ts_floor = state
    # openai-whisper: penultimate_was_timestamp is True when fewer than
    # two tokens have been sampled (decoding.py ApplyTimestampRules), so
    # the step-0 initial timestamp forces *text* at step 1, not a pair.
    penult_was_ts = prevprev_was_ts | (step < 2)

    # Rule: after a timestamp pair → no timestamps; after a lone timestamp →
    # only timestamps or EOT.
    block_ts = (prev_was_ts & penult_was_ts)[:, None] & is_ts
    block_text = (prev_was_ts & ~penult_was_ts)[:, None] & (vocab_ids < eot)
    # Monotonic: timestamps below the floor are illegal.
    block_old_ts = is_ts & (vocab_ids < ts_floor[:, None])
    logits = torch.where(block_ts | block_text | block_old_ts, NEG_INF, logits)

    # First sampled token must be a timestamp, capped at max_initial
    # (openai blocks everything below timestamp_begin here, EOT included).
    init_block = (~is_ts) | (vocab_ids > ts_begin + max_initial_index)
    if torch.is_tensor(step):
        logits = torch.where((step == 0)[:, None] & init_block, NEG_INF,
                             logits)
    elif step == 0:
        logits = torch.where(init_block, NEG_INF, logits)

    # Probability rule: if p(any timestamp) > max p(text) → force timestamp.
    logprobs = torch.log_softmax(logits, dim=-1)
    ts_logprob = torch.logsumexp(
        torch.where(is_ts, logprobs, NEG_INF), dim=-1)            # [B]
    max_text = torch.where(is_ts, NEG_INF, logprobs).amax(dim=-1)
    force_ts = (ts_logprob > max_text)[:, None] & ~is_ts
    return torch.where(force_ts, NEG_INF, logits)


def _update_ts_state(state, next_tok, sp_consts, step: int):
    ts_begin, _ = sp_consts
    prev_was_ts, prevprev_was_ts, ts_floor = state
    is_ts = next_tok >= ts_begin
    # openai floor semantics (timestamp_last in ApplyTimestampRules): a
    # *lone* timestamp keeps equality legal (its pair partner may repeat
    # it); a pair-completing timestamp — or the step-0 initial timestamp,
    # which openai's len<2 rule treats as already paired — moves the
    # floor past itself.
    exclusive = prev_was_ts | (step == 0)
    new_floor = torch.where(
        is_ts, torch.where(exclusive, next_tok + 1, next_tok), ts_floor)
    return (is_ts, prev_was_ts, torch.maximum(ts_floor, new_floor))


def greedy_loop(cfg: WhisperConfig, params, cross_kv, cache,
                prompt: torch.Tensor, suppress_mask: torch.Tensor,
                temperature: float, generator: Optional[torch.Generator], *,
                prompt_len: int, max_new: int, use_timestamps: bool,
                suppress_blank: bool, max_initial_index: int,
                blank_token: int, sot_index: int = 0):
    """Prefill the prompt, then greedy (temperature 0) or sampled steps until
    every row emits EOT or max_new tokens are drawn.

    prompt: [B, prompt_len] int64. Returns (tokens [B, prompt_len+max_new],
    sum_logprobs [B], lengths [B], no_speech_prob [B]) as tensors."""
    sp = WhisperTokenizer(cfg.n_langs).special
    sp_consts = (sp.timestamp_begin, sp.eot)
    B = prompt.shape[0]
    dev = prompt.device
    eot = sp.eot

    tokens = torch.full((B, prompt_len + max_new), eot, dtype=torch.int64,
                        device=dev)
    tokens[:, :prompt_len] = prompt

    logits, cache = whisper.decode(cfg, params, prompt, 0, cache, cross_kv)
    # no_speech prob read at the SOT position within the prompt.
    sot_probs = torch.softmax(logits[:, sot_index].float(), dim=-1)
    no_speech_prob = sot_probs[:, sp.no_speech]
    last_logits = logits[:, -1].float()

    ts_state = (torch.zeros(B, dtype=torch.bool, device=dev),
                torch.zeros(B, dtype=torch.bool, device=dev),
                torch.full((B,), sp.timestamp_begin, dtype=torch.int64,
                           device=dev))
    finished = torch.zeros(B, dtype=torch.bool, device=dev)
    sum_lp = torch.zeros(B, dtype=torch.float32, device=dev)
    lengths = torch.zeros(B, dtype=torch.int64, device=dev)
    vocab = torch.arange(last_logits.shape[1], device=dev)
    blank_mask = (vocab == blank_token) | (vocab == eot)

    for step in range(max_new):
        lg = torch.where(suppress_mask[None, :], NEG_INF, last_logits)
        if suppress_blank and step == 0:
            lg = torch.where(blank_mask[None, :], NEG_INF, lg)
        if use_timestamps:
            lg = _timestamp_filter(lg, sp_consts, ts_state, step,
                                   max_initial_index)

        logprobs = torch.log_softmax(lg, dim=-1)
        if temperature > 0:
            u = torch.rand(lg.shape, generator=generator, device=dev)
            gumbel = -torch.log(-torch.log(u))
            next_tok = torch.argmax(lg / max(temperature, 1e-6) + gumbel,
                                    dim=-1)
        else:
            next_tok = torch.argmax(lg, dim=-1)
        next_tok = torch.where(finished, eot, next_tok)

        tok_lp = torch.gather(logprobs, -1, next_tok[:, None])[:, 0]
        sum_lp = sum_lp + torch.where(finished, 0.0, tok_lp)
        lengths = lengths + (~finished).long()
        new_state = _update_ts_state(ts_state, next_tok, sp_consts, step)
        ts_state = tuple(torch.where(finished, old, new)
                         for new, old in zip(new_state, ts_state))
        finished = finished | (next_tok == eot)
        tokens[:, prompt_len + step] = next_tok
        if step + 1 == max_new or bool(finished.all()):
            break
        logits, cache = whisper.decode(cfg, params, next_tok[:, None],
                                       prompt_len + step, cache, cross_kv)
        last_logits = logits[:, -1].float()
    return tokens, sum_lp, lengths, no_speech_prob


def _self_cache_dtype(params, cross_kv) -> torch.dtype:
    return (cross_kv.k.dtype if cross_kv.k.dtype != torch.int8
            else params["decoder"]["pos_emb"].dtype)


def detect_language_logits(cfg: WhisperConfig, params, cross_kv
                           ) -> torch.Tensor:
    """One decoder step on [sot] → probabilities over the language tokens.
    Parity: full_lang_id_from_state (src/engine/whisper.rs:287)."""
    sp = WhisperTokenizer(cfg.n_langs).special
    B = cross_kv.k.shape[1]
    dev = cross_kv.k.device
    cache = whisper.init_kv_cache(cfg, B, dtype=_self_cache_dtype(
        params, cross_kv), max_len=8, device=dev)
    prompt = torch.full((B, 1), sp.sot, dtype=torch.int64, device=dev)
    logits, _ = whisper.decode(cfg, params, prompt, 0, cache, cross_kv)
    lg = logits[:, 0].float()
    lang_logits = lg[:, sp.lang_base:sp.lang_base + sp.n_langs]
    return torch.softmax(lang_logits, dim=-1)


def detect_language(cfg: WhisperConfig, params, cross_kv,
                    tok: WhisperTokenizer) -> tuple[list[str], np.ndarray]:
    probs = detect_language_logits(cfg, params, cross_kv).cpu().numpy()
    idx = probs.argmax(axis=-1)
    return [tok.special.languages[i] for i in idx], probs


def decode_greedy(cfg: WhisperConfig, params, cross_kv,
                  tok: WhisperTokenizer, opts: DecodingOptions,
                  prompt_ids: Optional[list[int]] = None,
                  languages: Optional[list[str]] = None,
                  rng: Optional[torch.Generator] = None) -> DecodingResult:
    """Host wrapper: build prompt + masks, run the loop. `rng` draws the
    samples at temperature > 0 (a generator seeded 0 on the cache's device
    when None)."""
    B = int(cross_kv.k.shape[1])
    dev = cross_kv.k.device
    language = opts.language or (languages[0] if languages else "en")
    sot_seq = tok.sot_sequence(language, opts.task,
                               timestamps=not opts.without_timestamps)
    prompt = list(prompt_ids or []) + sot_seq
    sot_index = len(prompt_ids or [])
    prompt_arr = torch.tensor(prompt, dtype=torch.int64,
                              device=dev)[None].repeat(B, 1)
    suppress = torch.from_numpy(build_suppress_mask(tok, cfg, opts)).to(dev)
    max_new = min(opts.max_new_tokens, cfg.n_text_ctx - len(prompt) - 1)
    # Right-size the cache: every decode step reads the whole [.., T, ..]
    # buffer, so T = prompt+max_new (tile-rounded), not n_text_ctx.
    cache_len = min(cfg.n_text_ctx,
                    ((len(prompt) + max_new + 63) // 64) * 64)
    cache = whisper.init_kv_cache(cfg, B, dtype=_self_cache_dtype(
        params, cross_kv), max_len=cache_len, device=dev)
    blank = tok.encode(" ")
    blank_token = blank[0] if blank else 220
    if rng is None and opts.temperature > 0:
        rng = torch.Generator(device=dev).manual_seed(0)
    tokens, sum_lp, lengths, no_speech = greedy_loop(
        cfg, params, cross_kv, cache, prompt_arr, suppress,
        float(opts.temperature), rng,
        prompt_len=len(prompt), max_new=max_new,
        use_timestamps=not opts.without_timestamps,
        suppress_blank=opts.suppress_blank,
        max_initial_index=int(opts.max_initial_timestamp / 0.02),
        blank_token=int(blank_token), sot_index=sot_index)
    lengths = lengths.cpu().numpy()
    avg_lp = sum_lp.cpu().numpy() / np.maximum(lengths, 1)
    return DecodingResult(
        tokens=tokens.cpu().numpy().astype(np.int32),
        prompt_len=len(prompt), avg_logprob=avg_lp,
        no_speech_prob=no_speech.cpu().numpy(),
        language=[language] * B, temperature=opts.temperature)
