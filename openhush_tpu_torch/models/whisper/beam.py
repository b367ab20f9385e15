"""Beam-search decoding: the port of openhush_tpu/models/whisper/beam.py.

The alive/finished formulation of the reference (as in flax/t5x): each step
expands the K alive beams over the vocabulary, keeps the top 2K candidates
(so an all-EOT expansion cannot starve the alive set), routes EOT
candidates into the finished set with length-penalized scores, and makes
each new beam inherit its parent's history. The timestamp and suppression
filters of decoding.py apply per beam row, their state gathered by parent.

Two formulations, as the reference's, chosen by `whisper.beam_grouped_ok`
(looked up at call time):
- grouped (K·H ≤ 128): one cross-KV row per batch row and no cache
  reorder; the beams inherit an ancestry mask instead
  (model.decode_beam_step, on K4's beam mode);
- fallback: the cross-KV tiled K ways and the cache rows gathered by
  parent before a per-row `decode` step.

Differences from the reference, each with its reason:
- The loop runs on the host (the reference is one `lax.while_loop`), with
  its stop condition read after each step.
- `_top_k` is a stable descending sort: `jax.lax.top_k` breaks ties by the
  lower index, and dead beams (alive_lp = finfo(f32).min) tie across whole
  rows, where `torch.topk` promises no order.
- The self-cache is right-sized to prompt_len + max_new rows (64-aligned),
  as decoding.decode_greedy's, where the reference allocates n_text_ctx:
  the grouped step reads all K·T keys of a group, and the rows past the
  last write are never visible (their keys are masked to exact zeros).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from openhush_tpu_torch.models.whisper import decoding, model as whisper
from openhush_tpu_torch.models.whisper.config import WhisperConfig
from openhush_tpu_torch.text.tokenizer import WhisperTokenizer

NEG_INF = decoding.NEG_INF


def _length_score(sum_lp, length, length_penalty: Optional[float]):
    """Whisper: None → average logprob; else GoogleNMT ((5+L)/6)^p."""
    length = length.clamp(min=1)
    if length_penalty is None:
        return sum_lp / length
    return sum_lp / (((5.0 + length) / 6.0) ** length_penalty)


def _gather_beams(x: torch.Tensor, parent: torch.Tensor) -> torch.Tensor:
    """x [B, K, ...] gathered along the beam axis by parent [B, M]."""
    rows = torch.arange(x.shape[0], device=x.device)[:, None]
    return x[rows, parent]


def _top_k(x: torch.Tensor, k: int):
    """The k largest of the last axis in jax.lax.top_k's order: descending,
    ties lowest index first."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def _tile(kv, K: int):
    """A cache or cross-KV [L, B, ...] with each row repeated K times."""
    rep = lambda t: t.repeat_interleave(K, dim=1)
    if isinstance(kv, whisper.QuantKVCache):
        return whisper.QuantKVCache(rep(kv.k), rep(kv.k_scale), rep(kv.v),
                                    rep(kv.v_scale))
    return whisper.KVCache(rep(kv.k), rep(kv.v))


@torch.no_grad()
def beam_search_loop(cfg: WhisperConfig, params, cross_kv,
                     prompt: torch.Tensor, suppress_mask: torch.Tensor, *,
                     beam_size: int, prompt_len: int, max_new: int,
                     use_timestamps: bool, suppress_blank: bool,
                     max_initial_index: int, blank_token: int,
                     sot_index: int = 0,
                     length_penalty: Optional[float] = None):
    """prompt [B, prompt_len] → (tokens [B, prompt_len + max_new], scores
    [B], lengths [B], no_speech [B]) tensors: the best finished sequence of
    each row (the best alive one where none finished), prompt included,
    EOT-padded."""
    sp = WhisperTokenizer(cfg.n_langs).special
    sp_consts = (sp.timestamp_begin, sp.eot)
    eot = sp.eot
    B = prompt.shape[0]
    K = beam_size
    BK = B * K
    L = prompt_len + max_new
    V = cfg.n_vocab_padded
    dev = prompt.device

    # Prefill B rows, then tile to B*K.
    cache0 = whisper.init_kv_cache(
        cfg, B, dtype=decoding._self_cache_dtype(params, cross_kv),
        max_len=min(cfg.n_text_ctx, (L + 63) // 64 * 64), device=dev)
    logits0, cache0 = whisper.decode(cfg, params, prompt, 0, cache0, cross_kv)
    sot_probs = torch.softmax(logits0[:, sot_index].float(), dim=-1)
    no_speech = sot_probs[:, sp.no_speech]
    last_logits = logits0[:, -1].float().repeat_interleave(K, dim=0)
    cache = _tile(cache0, K)
    del cache0
    grouped = whisper.beam_grouped_ok(cfg, K)
    xkv = cross_kv if grouped else _tile(cross_kv, K)
    Tc = cache.k.shape[2]
    anc = (whisper.beam_ancestry(B, K, Tc, prompt_len, dev) if grouped
           else None)

    tokens = torch.full((B, K, L), eot, dtype=torch.int64, device=dev)
    tokens[:, :, :prompt_len] = prompt[:, None]
    # Only beam 0 is alive at the start (the beams are identical).
    alive_lp = torch.tensor([[0.0] + [NEG_INF] * (K - 1)],
                            device=dev).repeat(B, 1)
    alive_len = torch.zeros(B, K, dtype=torch.int64, device=dev)
    fin_scores = torch.full((B, K), NEG_INF, device=dev)
    fin_tokens = torch.full((B, K, L), eot, dtype=torch.int64, device=dev)
    fin_lens = torch.zeros(B, K, dtype=torch.int64, device=dev)
    ts_state = (torch.zeros(BK, dtype=torch.bool, device=dev),
                torch.zeros(BK, dtype=torch.bool, device=dev),
                torch.full((BK,), sp.timestamp_begin, dtype=torch.int64,
                           device=dev))
    ids = torch.arange(V, device=dev)
    blank_mask = (ids == blank_token) | (ids == eot)
    rows = torch.arange(B, device=dev)[:, None]

    step = 0
    # whisper's stop: every finished slot filled, the step budget spent, or
    # no beam alive.
    while step < max_new and bool(
            (fin_scores <= NEG_INF / 2).any()
            & (alive_lp.max() > NEG_INF / 2)):
        lg = torch.where(suppress_mask[None, :], NEG_INF, last_logits)
        if suppress_blank and step == 0:
            lg = torch.where(blank_mask[None, :], NEG_INF, lg)
        if use_timestamps:
            lg = decoding._timestamp_filter(lg, sp_consts, ts_state, step,
                                            max_initial_index)
        logprobs = torch.log_softmax(lg, dim=-1).view(B, K, V)
        cand_lp = alive_lp[:, :, None] + logprobs

        # The top 2K candidates over every beam.
        top_lp, top_idx = _top_k(cand_lp.view(B, K * V), 2 * K)
        parent = top_idx // V
        tok = top_idx % V
        is_eot = tok == eot
        new_len = alive_len.gather(1, parent) + 1

        # The finished set takes the EOT candidates.
        eot_scores = torch.where(
            is_eot, _length_score(top_lp, new_len, length_penalty), NEG_INF)
        all_scores = torch.cat([fin_scores, eot_scores], dim=1)
        all_tokens = torch.cat([fin_tokens, _gather_beams(tokens, parent)],
                               dim=1)
        all_lens = torch.cat([fin_lens, torch.where(is_eot, new_len - 1, 0)],
                             dim=1)
        fin_scores, fin_idx = _top_k(all_scores, K)
        fin_tokens = _gather_beams(all_tokens, fin_idx)
        fin_lens = all_lens.gather(1, fin_idx)

        # The top K non-EOT candidates are the new alive set.
        alive_lp, aidx = _top_k(torch.where(is_eot, NEG_INF, top_lp), K)
        alive_parent = parent.gather(1, aidx)
        alive_tok = tok.gather(1, aidx)
        alive_len = new_len.gather(1, aidx)
        tokens = _gather_beams(tokens, alive_parent)
        tokens[:, :, prompt_len + step] = alive_tok

        flat_parent = (alive_parent + rows * K).view(BK)
        ts_state = decoding._update_ts_state(
            tuple(t[flat_parent] for t in ts_state), alive_tok.view(BK),
            sp_consts, step)

        pos = prompt_len + step
        if grouped:
            # Inherit the parent's ancestry and add the own write at pos:
            # this step's visibility and the next step's ancestry.
            anc = whisper.beam_own(_gather_beams(anc, alive_parent),
                                   torch.full((B,), pos, device=dev))
            logits3, cache = whisper.decode_beam_step(
                cfg, params, alive_tok, torch.full((B,), pos, device=dev),
                cache, anc.view(B, K, K * Tc), xkv)
            last = logits3.view(BK, V)
        else:
            cache = whisper.KVCache(cache.k[:, flat_parent],
                                    cache.v[:, flat_parent])
            logits, cache = whisper.decode(cfg, params,
                                           alive_tok.view(BK, 1), pos, cache,
                                           xkv)
            last = logits[:, -1]
        last_logits = last.float()
        step += 1

    # Where nothing finished, the best alive beam.
    alive_scores = _length_score(alive_lp, alive_len, length_penalty)
    no_fin = fin_scores[:, 0] <= NEG_INF / 2
    best_tokens = torch.where(no_fin[:, None], tokens[:, 0], fin_tokens[:, 0])
    best_scores = torch.where(no_fin, alive_scores[:, 0], fin_scores[:, 0])
    best_lens = torch.where(no_fin, alive_len[:, 0], fin_lens[:, 0])
    return best_tokens, best_scores, best_lens, no_speech


def decode_beam(cfg: WhisperConfig, params, cross_kv,
                tok: WhisperTokenizer, opts: decoding.DecodingOptions,
                prompt_ids: Optional[list[int]] = None,
                languages: Optional[list[str]] = None
                ) -> decoding.DecodingResult:
    """Host wrapper mirroring decoding.decode_greedy: beam_size
    opts.beam_size (5 when None), length_penalty opts.length_penalty."""
    B = int(cross_kv.k.shape[1])
    dev = cross_kv.k.device
    language = opts.language or (languages[0] if languages else "en")
    sot_seq = tok.sot_sequence(language, opts.task,
                               timestamps=not opts.without_timestamps)
    prompt = list(prompt_ids or []) + sot_seq
    sot_index = len(prompt_ids or [])
    prompt_arr = torch.tensor(prompt, dtype=torch.int64,
                              device=dev)[None].repeat(B, 1)
    suppress = torch.from_numpy(decoding.build_suppress_mask(
        tok, cfg, opts)).to(dev)
    max_new = min(opts.max_new_tokens, cfg.n_text_ctx - len(prompt) - 1)
    blank = tok.encode(" ")
    tokens, scores, lengths, no_speech = beam_search_loop(
        cfg, params, cross_kv, prompt_arr, suppress,
        beam_size=opts.beam_size or 5, prompt_len=len(prompt),
        max_new=max_new, use_timestamps=not opts.without_timestamps,
        suppress_blank=opts.suppress_blank,
        max_initial_index=int(opts.max_initial_timestamp / 0.02),
        blank_token=int(blank[0] if blank else 220), sot_index=sot_index,
        length_penalty=opts.length_penalty)
    return decoding.DecodingResult(
        tokens=tokens.cpu().numpy().astype(np.int32),
        prompt_len=len(prompt), avg_logprob=scores.cpu().numpy(),
        no_speech_prob=no_speech.cpu().numpy(), language=[language] * B,
        temperature=0.0)
