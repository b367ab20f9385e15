"""Speculative greedy decoding: a shallow draft decoder proposes, the big
model verifies, and the output is token-identical to plain greedy.

Port of openhush_tpu/models/whisper/speculative.py. Every emitted token is
an argmax of the big model's filtered logits; the draft decides only how
many of them one verify pass yields. The whole whisper filter chain
(suppress masks, the blank rule, the paired-timestamp grammar) runs per
verify position with its state carried along the proposal block, so the
timestamps mode is exact too. A draft that rarely matches (random weights)
costs speed, never output.

The draft shares the big model's encoder (large-v3-turbo's 4-layer decoder
drafts for large-v3), so drafting adds a second cross-KV projection of the
same features, not a second encoder pass.

Differences from the reference, each with its reason:
- The loop is a host `while` over device tensors (the reference's
  `lax.while_loop`): the loop's condition is its one host sync an
  iteration, as `decoding.greedy_loop` syncs once a step.
- The accept chain continues past position i while the big model's token
  i equals the proposal fed at position i + 1 of the block (`props[:, i]`,
  as the reference's `batcher.spec_step` compares). The reference's
  one-shot loop compares it with the proposal one further on
  (`props[:, i + 1]`): its chain breaks where a matching draft would carry
  it, and it could continue from a block whose fed token was not the one
  emitted. Where both chains agree, so do the tokens.
- Caches are written in place (decode's write-first flat step); the stale
  rows a rejected block leaves past a row's fill are overwritten before any
  query can see them, since every later decode starts at that fill.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from openhush_tpu_torch.models.whisper import decoding, model as whisper
from openhush_tpu_torch.models.whisper.config import WhisperConfig
from openhush_tpu_torch.text.tokenizer import WhisperTokenizer

NEG_INF = decoding.NEG_INF


def _filter_chain(lg, suppress_mask, step, ts_state, sp_consts, *,
                  use_timestamps, suppress_blank, blank_mask,
                  max_initial_index):
    """The greedy loop's filter stack on [B, V] fp32 logits; `step` is the
    per-row count of sampled tokens ([B] tensor)."""
    lg = torch.where(suppress_mask[None, :], NEG_INF, lg)
    if suppress_blank:
        lg = torch.where((step == 0)[:, None] & blank_mask[None, :],
                         NEG_INF, lg)
    if use_timestamps:
        lg = decoding._timestamp_filter(lg, sp_consts, ts_state, step,
                                        max_initial_index)
    return lg


def speculative_greedy_loop(cfg: WhisperConfig, params,
                            draft_cfg: WhisperConfig, draft_params,
                            cross_kv, draft_xkv, cache, draft_cache,
                            prompt: torch.Tensor, suppress_mask: torch.Tensor,
                            *, prompt_len: int, max_new: int,
                            use_timestamps: bool, suppress_blank: bool,
                            max_initial_index: int, blank_token: int,
                            sot_index: int = 0, k_spec: int = 5):
    """`decoding.greedy_loop` at temperature 0, with the same outputs:
    (tokens [B, prompt_len + max_new], sum_logprobs [B], lengths [B],
    no_speech_prob [B]), as tensors.

    Invariant between iterations: both caches hold every emitted token but
    the newest (the tip); `n` counts a row's emitted tokens. An iteration:
    the draft rolls k_spec proposals from the tip (S=1 steps at per-row
    fed + i), the big model verifies [tip, p1..p_{K-1}] in one decode at
    per-row fed, the accept scan emits 1..K big-model argmaxes a row, and
    the emitted window is written at each row's offset. Both caches need
    prompt_len + max_new + k_spec rows: no write may fall past them.
    `speculative_greedy_loop.verifies` counts the iterations (verify
    passes) over all calls."""
    sp = WhisperTokenizer(cfg.n_langs).special
    sp_consts = (sp.timestamp_begin, sp.eot)
    eot = sp.eot
    B = prompt.shape[0]
    dev = prompt.device
    K = k_spec
    for c in (cache, draft_cache):
        if c.k.shape[2] < prompt_len + max_new + K:
            raise ValueError(f"a cache of {c.k.shape[2]} rows; speculative "
                             f"decoding writes up to "
                             f"{prompt_len + max_new + K}")
    ids = torch.arange(cfg.n_vocab_padded, device=dev)
    blank_mask = (ids == blank_token) | (ids == eot)

    def filt(lg, step, ts):
        return _filter_chain(lg, suppress_mask, step, ts, sp_consts,
                             use_timestamps=use_timestamps,
                             suppress_blank=suppress_blank,
                             blank_mask=blank_mask,
                             max_initial_index=max_initial_index)

    # Width prompt_len + max_new + K: a row's K-wide window always fits.
    tokens = torch.full((B, prompt_len + max_new + K), eot,
                        dtype=torch.int64, device=dev)
    tokens[:, :prompt_len] = prompt

    # Prefill both models on the prompt.
    logits, _ = whisper.decode(cfg, params, prompt, 0, cache, cross_kv)
    whisper.decode(draft_cfg, draft_params, prompt, 0, draft_cache,
                   draft_xkv)
    sot_probs = torch.softmax(logits[:, sot_index].float(), dim=-1)
    no_speech_prob = sot_probs[:, sp.no_speech]

    # The first token exactly as greedy_loop's step 0.
    zeros = torch.zeros(B, dtype=torch.int64, device=dev)
    ts_state = (torch.zeros(B, dtype=torch.bool, device=dev),
                torch.zeros(B, dtype=torch.bool, device=dev),
                torch.full((B,), sp.timestamp_begin, dtype=torch.int64,
                           device=dev))
    lg0 = filt(logits[:, -1].float(), zeros, ts_state)
    tip = torch.argmax(lg0, dim=-1)
    sum_lp = torch.gather(torch.log_softmax(lg0, -1), -1, tip[:, None])[:, 0]
    ts_state = decoding._update_ts_state(ts_state, tip, sp_consts, zeros)
    tokens[:, prompt_len] = tip
    finished = (tip == eot) | (max_new <= 1)
    n = torch.ones(B, dtype=torch.int64, device=dev)   # emitted, tip included
    b_idx = torch.arange(B, device=dev)[:, None]
    offs = torch.arange(K, device=dev)[None, :]

    while not bool(finished.all()):
        speculative_greedy_loop.verifies += 1
        fed = prompt_len + n - 1          # per-row cache fill (tokens fed)

        # The draft: K proposals from the tip, one S=1 step each.
        cur, dts, props = tip, ts_state, []
        for i in range(K):
            lg, _ = whisper.decode(draft_cfg, draft_params, cur[:, None],
                                   fed + i, draft_cache, draft_xkv)
            cur = torch.argmax(filt(lg[:, -1].float(), n + i, dts), dim=-1)
            dts = decoding._update_ts_state(dts, cur, sp_consts, n + i)
            props.append(cur)
        props = torch.stack(props, dim=1)     # [B, K]: p1..pK

        # The big model verifies [tip, p1..p_{K-1}] in one pass.
        block = torch.cat([tip[:, None], props[:, :K - 1]], dim=1)
        vlogits, _ = whisper.decode(cfg, params, block, fed, cache, cross_kv)
        vlogits = vlogits.float()             # [B, K, V]

        # The accept scan: emit while the fed proposal was the big model's.
        ok = torch.ones(B, dtype=torch.bool, device=dev)
        trues, emits = [], []
        for i in range(K):
            lg = filt(vlogits[:, i], n + i, ts_state)
            true_i = torch.argmax(lg, dim=-1)
            lp_i = torch.gather(torch.log_softmax(lg, -1), -1,
                                true_i[:, None])[:, 0]
            emit = ok & ~finished & (n + i < max_new)
            new_ts = decoding._update_ts_state(ts_state, true_i, sp_consts,
                                               n + i)
            ts_state = tuple(torch.where(emit, a, b)
                             for a, b in zip(new_ts, ts_state))
            tip = torch.where(emit, true_i, tip)
            sum_lp = sum_lp + torch.where(emit, lp_i, 0.0)
            ok = emit & (true_i != eot)
            ok = (ok & (props[:, i] == true_i) if i < K - 1
                  else torch.zeros_like(ok))
            trues.append(true_i)
            emits.append(emit)
        trues = torch.stack(trues, dim=1)     # [B, K]
        emits = torch.stack(emits, dim=1)     # [B, K] bool

        # The emitted window, at each row's offset.
        at = prompt_len + n[:, None] + offs
        tokens[b_idx, at] = torch.where(emits, trues, tokens[b_idx, at])

        finished = finished | (emits & (trues == eot)).any(dim=1)
        n = n + emits.sum(dim=1)
        finished = finished | (n >= max_new)
    return tokens[:, :prompt_len + max_new], sum_lp, n, no_speech_prob


speculative_greedy_loop.verifies = 0     # verify passes, for accounting


def decode_speculative(cfg: WhisperConfig, params, draft_cfg: WhisperConfig,
                       draft_params, cross_kv, draft_xkv,
                       tok: WhisperTokenizer, opts: decoding.DecodingOptions,
                       prompt_ids: Optional[list[int]] = None,
                       languages: Optional[list[str]] = None,
                       k_spec: int = 5) -> decoding.DecodingResult:
    """`decoding.decode_greedy`'s host wrapper for the speculative loop
    (temperature 0): the same option handling, with both caches sized
    prompt + max_new + k_spec rows (64-aligned) and no n_text_ctx clamp, as
    the reference sizes them: the verify pass writes K-token blocks up to
    prompt + max_new + K - 2. The self-cache dtype follows the cross-KV's,
    or the weights' when the cross-KV is int8."""
    B = int(cross_kv.k.shape[1])
    dev = cross_kv.k.device
    language = opts.language or (languages[0] if languages else "en")
    sot_seq = tok.sot_sequence(language, opts.task,
                               timestamps=not opts.without_timestamps)
    prompt = list(prompt_ids or []) + sot_seq
    sot_index = len(prompt_ids or [])
    prompt_arr = torch.tensor(prompt, dtype=torch.int64,
                              device=dev)[None].repeat(B, 1)
    suppress = torch.from_numpy(
        decoding.build_suppress_mask(tok, cfg, opts)).to(dev)
    max_new = min(opts.max_new_tokens, cfg.n_text_ctx - len(prompt) - 1)
    cache_len = ((len(prompt) + max_new + k_spec + 63) // 64) * 64
    cache = whisper.init_kv_cache(
        cfg, B, dtype=decoding._self_cache_dtype(params, cross_kv),
        max_len=cache_len, device=dev)
    draft_cache = whisper.init_kv_cache(
        draft_cfg, B, dtype=decoding._self_cache_dtype(draft_params,
                                                       draft_xkv),
        max_len=cache_len, device=dev)
    blank = tok.encode(" ")
    blank_token = blank[0] if blank else 220
    tokens, sum_lp, lengths, no_speech = speculative_greedy_loop(
        cfg, params, draft_cfg, draft_params, cross_kv, draft_xkv, cache,
        draft_cache, prompt_arr, suppress, prompt_len=len(prompt),
        max_new=max_new, use_timestamps=not opts.without_timestamps,
        suppress_blank=opts.suppress_blank,
        max_initial_index=int(opts.max_initial_timestamp / 0.02),
        blank_token=int(blank_token), sot_index=sot_index, k_spec=k_spec)
    lengths = lengths.cpu().numpy()
    avg_lp = sum_lp.cpu().numpy() / np.maximum(lengths, 1)
    return decoding.DecodingResult(
        tokens=tokens.cpu().numpy().astype(np.int32),
        prompt_len=len(prompt), avg_logprob=avg_lp,
        no_speech_prob=no_speech.cpu().numpy(),
        language=[language] * B, temperature=0.0)
