"""Hard distillation of a speculative draft against the serving teacher.

Counterpart of openhush_tpu/training/distill.py. A turbo-shaped draft
decoder trains on the teacher's own greedy trajectories: cross-entropy
toward the teacher's emitted argmax, which directly optimizes the
speculative accept rate P[draft argmax == teacher argmax along teacher
rollouts]. It needs no network and no real data: the teacher is whatever
parameters are loaded (random-init on the card's smoke run, real
checkpoints otherwise), and the input distribution is whatever the
caller's mel_fn produces.

Faithfulness to the serving pipeline (runtime/server.py's spec path):
- rollouts run the big model on the same int8 cross-KV
  (compute_cross_kv_quant) the server installs: on the card they launch
  K1-K5 (encode, the int8 cross-KV, the prompt prefill and the S=1 steps);
- the caller passes the serving suppress mask and prompt, so the
  filtered-argmax comparison the accept scan performs is the function
  being distilled;
- the draft trains against the teacher's encoder features, the tensors
  EngineServer feeds the draft's cross-KV projections.

Only the draft's decoder subtree is trained (an fp32 master copy;
optax.adamw's arithmetic, train.AdamW, at a constant rate and with no
clip). The teacher-forced pass is model.decode_teacher_forced, the decoder
half that model.forward uses too: `decode` cannot carry a gradient (the
decode kernels have no backward, and its cache writes happen in place).

Differences from the reference, each a repair of a fault in it (the JAX
file stays as it is):
- `time_budget_s=0.0` is a budget of zero, not "no deadline": one rollout
  batch, the held-out batch and one epoch.
- The held-out eval (the init_heldout_* and heldout_* stats) runs the
  draft through `decode` on the int8 cross-KV the server installs; the
  reference evaluates on the fp cross-KV, which overstates the served
  accept-rate proxy. Training stays on the fp cross-KV (rounding has no
  gradient).
- CE and agreement count a row's target positions up to and including
  its first EOT; the reference's rollout runs past EOT and weights those
  positions fully when the caller's suppress mask lets EOT through.
- When only the held-out batch was collected (n_batches 0), training
  falls back to it as the reference's does, and stats["heldout_is_train"]
  says so (the reference reports train agreement as held-out).
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np
import torch

from openhush_tpu_torch.models.whisper import model as whisper
from openhush_tpu_torch.models.whisper import weights
from openhush_tpu_torch.models.whisper.config import WhisperConfig
from openhush_tpu_torch.text.tokenizer import WhisperTokenizer
from openhush_tpu_torch.training.train import AdamW, OptState, leaves

NEG_INF = -1e9


def _round64(n: int) -> int:
    return ((n + 63) // 64) * 64


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _filt_argmax(lg: torch.Tensor, suppress: torch.Tensor) -> torch.Tensor:
    return torch.argmax(torch.where(suppress, NEG_INF, lg.float()), dim=-1)


@torch.no_grad()
def teacher_rollout(cfg: WhisperConfig, params, mel, prompt, suppress, *,
                    prompt_len: int, gen_tokens: int):
    """Encode + greedy rollout: mel [B, n_mels, F] → (features [B, A, D]
    in the parameters' dtype, tokens int64 [B, prompt_len + gen_tokens]).

    The big model decodes over its int8 cross-KV exactly as the serving
    step does; argmaxes are taken over suppress-masked fp32 logits (the
    serving filter chain minus the step-0 blank rule, which touches one
    position in ~128 and is applied identically to draft and verifier at
    serve time, so a mismatch there cannot be created by training)."""
    B = prompt.shape[0]
    dtype = params["encoder"]["conv1_w"].dtype
    feats = whisper.encode(cfg, params, mel.to(dtype))
    xkv = whisper.compute_cross_kv_quant(cfg, params, feats)
    cache = whisper.init_kv_cache(cfg, B, dtype=feats.dtype,
                                  max_len=_round64(prompt_len + gen_tokens),
                                  device=feats.device)
    logits, cache = whisper.decode(cfg, params, prompt, 0, cache, xkv)
    tip = _filt_argmax(logits[:, -1], suppress)
    out = [tip]
    for i in range(1, gen_tokens):
        lg, cache = whisper.decode(cfg, params, tip[:, None],
                                   prompt_len + i - 1, cache, xkv)
        tip = _filt_argmax(lg[:, -1], suppress)
        out.append(tip)
    return feats, torch.cat([prompt, torch.stack(out, dim=1)], dim=1)


def _draft_logits(dcfg: WhisperConfig, dec_params, feats, inputs,
                  int8_cross: bool) -> torch.Tensor:
    """The draft's logits over `inputs` [B, S] from position 0: teacher-
    forced on the fp cross-KV (differentiable), or, for the held-out eval,
    through `decode` over an empty cache on the int8 cross-KV the server
    installs."""
    dparams = {"decoder": dec_params}
    feats = feats.to(dec_params["pos_emb"].dtype)
    if not int8_cross:
        xkv = whisper.compute_cross_kv(dcfg, dparams, feats)
        return whisper.decode_teacher_forced(dcfg, dparams, xkv, inputs)
    B, S = inputs.shape
    xkv = whisper.compute_cross_kv_quant(dcfg, dparams, feats)
    cache = whisper.init_kv_cache(dcfg, B, dtype=feats.dtype,
                                  max_len=_round64(S), device=feats.device)
    logits, _ = whisper.decode(dcfg, dparams, inputs, 0, cache, xkv)
    return logits


def _ce_and_agree(dcfg, dec_params, feats, tokens, suppress, prompt_len,
                  *, eot: int, int8_cross: bool = False):
    """Teacher-forced draft pass over a rollout. Returns (masked CE,
    filtered-argmax agreement) over the generated positions up to and
    including each row's first `eot` target."""
    B, T = tokens.shape
    S = T - 1
    logits = _draft_logits(dcfg, dec_params, feats, tokens[:, :-1],
                           int8_cross).float()
    tgt = tokens[:, 1:]
    # Generated positions only: input position prompt_len-1 predicts the
    # first content token. (Vocab-padded tail ids never appear in tgt —
    # argmaxes above are suppress-masked and the pad ids are suppressed.)
    gen = torch.arange(S, device=tokens.device)[None, :] >= prompt_len - 1
    is_eot = ((tgt == eot) & gen).long()
    mask = (gen & (torch.cumsum(is_eot, dim=1) - is_eot == 0)).float()
    denom = mask.sum()
    lp = torch.log_softmax(logits, dim=-1)
    nll = -lp.gather(-1, tgt[..., None])[..., 0]
    ce = (nll * mask).sum() / denom
    pred = torch.argmax(torch.where(suppress[None, None, :], NEG_INF,
                                    logits), dim=-1)
    agree = ((pred == tgt) * mask).sum() / denom
    return ce, agree


def _distill_step(dcfg: WhisperConfig, opt: AdamW, dec_params,
                  opt_state: OptState, feats, tokens, suppress, *,
                  prompt_len: int, eot: int):
    """One AdamW step on the draft's decoder, in place (the reference
    donates its buffers) → (dec_params, opt_state, ce, agree) of the
    batch before the update."""
    ps = leaves(dec_params)
    for p in ps:
        p.requires_grad_(True)
    with torch.enable_grad():
        ce, agree = _ce_and_agree(dcfg, dec_params, feats, tokens, suppress,
                                  prompt_len, eot=eot)
        grads = torch.autograd.grad(ce, ps, allow_unused=True)
    opt.apply(dec_params, [torch.zeros_like(p) if g is None else g
                           for g, p in zip(grads, ps)], opt_state)
    return dec_params, opt_state, ce.detach(), agree.detach()


@torch.no_grad()
def _eval_step(dcfg: WhisperConfig, dec_params, feats, tokens, suppress, *,
               prompt_len: int, eot: int):
    """CE and agreement on a held-out rollout, through the int8 cross-KV
    the server installs for the draft."""
    return _ce_and_agree(dcfg, dec_params, feats, tokens, suppress,
                         prompt_len, eot=eot, int8_cross=True)


def distill_draft(cfg: WhisperConfig, params, dcfg: WhisperConfig,
                  mel_fn: Callable[[np.random.Generator], np.ndarray],
                  prompt: np.ndarray, suppress: np.ndarray, *,
                  n_batches: int = 16, epochs: int = 6,
                  gen_tokens: int = 48, lr: float = 3e-4,
                  weight_decay: float = 0.01, seed: int = 7,
                  time_budget_s: Optional[float] = None,
                  serve_dtype: torch.dtype = torch.bfloat16,
                  log: Optional[Callable[[str], None]] = None):
    """Distill a draft for (cfg, params) and return (draft_params, stats).
    draft_params is a full init_params-shaped tree in serve_dtype whose
    decoder subtree is the distilled one, drop-in for
    EngineServer(draft=(dcfg, draft_params)); everything runs on the
    teacher's device, and the draft starts from weights.init_params with
    a generator seeded `seed`.

    mel_fn(rng) -> [B, n_mels, F] float mel batch (numpy; the caller owns
    the input distribution). prompt [B, P] int and suppress [V] bool must
    be the serving prompt and suppress mask.

    One rollout batch is held out; stats['heldout_agree'] is the
    per-position filtered-argmax agreement there through the int8
    cross-KV, the direct proxy for the speculative accept rate, which the
    caller then measures end to end through the real server."""
    device = params["decoder"]["tok_emb"].device
    rng = np.random.default_rng(seed)
    prompt = torch.as_tensor(np.asarray(prompt), device=device).long()
    sup = torch.as_tensor(np.asarray(suppress, bool), device=device)
    prompt_len = int(prompt.shape[1])
    eot = WhisperTokenizer(cfg.n_langs).special.eot
    deadline = (time.monotonic() + time_budget_s
                if time_budget_s is not None else None)

    def say(msg):
        if log:
            log(msg)

    # Rollout corpus (teacher is frozen: collect once, train epochs over
    # it), device-resident.
    corpus = []
    for b in range(n_batches + 1):          # +1 held-out
        mel = torch.from_numpy(np.asarray(mel_fn(rng), np.float32)).to(
            device)
        corpus.append(teacher_rollout(cfg, params, mel, prompt, sup,
                                      prompt_len=prompt_len,
                                      gen_tokens=gen_tokens))
        if deadline is not None and time.monotonic() > deadline and b >= 1:
            say(f"distill: rollout budget hit at {b + 1} batches")
            break
    held = corpus.pop()
    heldout_is_train = not corpus
    if heldout_is_train:                     # only the held-out batch
        corpus = [held]

    # fp32 master copy of the DECODER subtree only.
    draft_full = weights.init_params(
        dcfg, torch.Generator(device=device).manual_seed(seed),
        dtype=serve_dtype, device=device)
    dec = _tree_map(lambda a: a.float().clone(), draft_full["decoder"])
    opt = AdamW(float(lr), float(weight_decay))
    opt_state = opt.init(dec)

    ce0, agree0 = _eval_step(dcfg, dec, *held, sup, prompt_len=prompt_len,
                             eot=eot)
    stats = {"init_heldout_agree": round(float(agree0), 4),
             "init_heldout_ce": round(float(ce0), 3),
             "rollout_batches": len(corpus),
             "gen_tokens": gen_tokens,
             "heldout_is_train": heldout_is_train}
    say(f"distill: {len(corpus)} rollout batches x "
        f"{int(corpus[0][1].shape[0])} rows x {gen_tokens} tokens; "
        f"init held-out agree {float(agree0):.3f} ce {float(ce0):.2f}")

    steps = 0
    ce = agree = float("nan")
    for ep in range(epochs):
        for bi in rng.permutation(len(corpus)):
            feats, tokens = corpus[bi]
            dec, opt_state, ce_d, ag_d = _distill_step(
                dcfg, opt, dec, opt_state, feats, tokens, sup,
                prompt_len=prompt_len, eot=eot)
            steps += 1
        ce, agree = float(ce_d), float(ag_d)
        if deadline is not None and time.monotonic() > deadline:
            say(f"distill: train budget hit after epoch {ep + 1}")
            break
    hce, hagree = _eval_step(dcfg, dec, *held, sup, prompt_len=prompt_len,
                             eot=eot)
    stats.update({"steps": steps,
                  "train_ce": round(ce, 3),
                  "train_agree": round(agree, 4),
                  "heldout_ce": round(float(hce), 3),
                  "heldout_agree": round(float(hagree), 4)})
    say(f"distill: {steps} steps; train agree {agree:.3f}; "
        f"held-out agree {float(hagree):.3f} ce {float(hce):.2f}")

    draft_full["decoder"] = _tree_map(
        lambda a: a.detach().to(serve_dtype), dec)
    return draft_full, stats
