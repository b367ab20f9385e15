"""Whisper encoder/decoder in PyTorch: the port of
openhush_tpu/models/whisper/model.py on the main transcription path.

Parameters keep the JAX package's layout (see weights.py): per-layer weights
stacked on a leading [n_layer] axis, linear weights [in, out], conv stems
HIO. Caches keep its flat layout, k/v [L, B, T, H*Dh]. Layer norms, softmax
and logits run in fp32 whatever the parameter dtype (bf16 in production).

Differences from the reference, each with its reason:
- Layers run in a Python loop over per-layer views instead of `lax.scan`.
- The decode step writes the self-attention cache in place (the reference
  returns an updated copy); `decode` still returns the cache. In the flat
  step each layer writes its new keys first and then attends over the
  cache, where the reference attends over the read-only cache plus the new
  keys beside it: the same keys, the same math.
- The decode step's attention (the reference's `_attend_decode_flat*`
  einsums, whose block-diagonal selector is a TPU layout trick) runs on the
  hand-written decode-attention kernel, ops/decode_attention.py.
- Not in this slice: the W8A8 encoder and int8 decoder weights, the int8
  self-cache, and beam groups (`cross_group > 1`).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from openhush_tpu_torch.models.whisper.config import WhisperConfig
from openhush_tpu_torch.ops.decode_attention import (attend_decode,
                                                     attend_decode_pipelined)
from openhush_tpu_torch.ops.flash_attention import flash_attention
from openhush_tpu_torch.ops.quantize import quantize_heads

Params = dict
NEG = torch.finfo(torch.float32).min       # mask fill, as jnp.finfo(f32).min


# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------

def sinusoids(length: int, channels: int) -> np.ndarray:
    """Fixed sinusoidal positions for the encoder (OpenAI layout:
    concat(sin, cos) over channels//2 timescales, base 10000)."""
    assert channels % 2 == 0
    log_timescale_increment = np.log(10000.0) / (channels // 2 - 1)
    inv_timescales = np.exp(-log_timescale_increment * np.arange(channels // 2))
    scaled_time = np.arange(length)[:, None] * inv_timescales[None, :]
    return np.concatenate([np.sin(scaled_time), np.cos(scaled_time)],
                          axis=1).astype(np.float32)


def layer_norm(x, scale, bias, eps=1e-5):
    y = F.layer_norm(x.float(), x.shape[-1:], scale.float(), bias.float(), eps)
    return y.to(x.dtype)


def _split_heads(x, n_head):
    """[B, T, H*Dh] → [B, H, T, Dh] view."""
    b, t, d = x.shape
    return x.view(b, t, n_head, d // n_head).transpose(1, 2)


def _merge_heads(x):
    b, h, t, dh = x.shape
    return x.transpose(1, 2).reshape(b, t, h * dh)


def _gelu(x):
    """Exact erf GELU, or the tanh approximation under OPENHUSH_GELU=tanh
    or the `gelu_tanh.ok` marker in the model directory (the reference's
    rule, model.py:_gelu). Resolved once per process."""
    if _gelu_mode() == "tanh":
        return F.gelu(x, approximate="tanh")
    return F.gelu(x)


_GELU_MODE: Optional[str] = None


def _gelu_mode() -> str:
    global _GELU_MODE
    if _GELU_MODE is None:
        mode = os.environ.get("OPENHUSH_GELU")
        if mode not in ("erf", "tanh"):
            from openhush_tpu_torch.runtime.engine import default_model_dir
            mode = ("tanh" if os.path.exists(os.path.join(
                default_model_dir(), "gelu_tanh.ok")) else "erf")
        _GELU_MODE = mode
    return _GELU_MODE


def _mlp(x, lp):
    h = _gelu(x @ lp["fc1_w"] + lp["fc1_b"])
    return h @ lp["fc2_w"] + lp["fc2_b"]


def _layers(stacked: dict) -> list[dict]:
    """Stacked {name: [L, ...]} → one {name: view} dict per layer."""
    views = {name: w.unbind(0) for name, w in stacked.items()}
    n = len(next(iter(views.values())))
    return [{name: v[i] for name, v in views.items()} for i in range(n)]


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------

def encode(cfg: WhisperConfig, params: Params, mel: torch.Tensor
           ) -> torch.Tensor:
    """mel: [B, n_mels, 3000] → audio features [B, n_audio_ctx, d].

    Conv stem (k=3 s=1, gelu; k=3 s=2, gelu) + sinusoidal positions +
    pre-LN transformer + final LN. Attention runs on the flash kernel."""
    enc = params["encoder"]
    # HIO [3, in, out] → torch's [out, in, 3]; mel is already channels-first.
    x = F.conv1d(mel, enc["conv1_w"].permute(2, 1, 0), padding=1)
    x = _gelu(x + enc["conv1_b"][:, None])
    x = F.conv1d(x, enc["conv2_w"].permute(2, 1, 0), stride=2, padding=1)
    x = _gelu(x + enc["conv2_b"][:, None])
    x = x.transpose(1, 2)                                 # [B, T, d]
    x = x + enc["pos_emb"][None, : x.shape[1]].to(x.dtype)

    n_head = cfg.n_audio_head
    for lp in _layers(enc["layers"]):
        h = layer_norm(x, lp["ln1_scale"], lp["ln1_bias"])
        q = _split_heads(h @ lp["q_w"] + lp["q_b"], n_head)
        k = _split_heads(h @ lp["k_w"], n_head)
        v = _split_heads(h @ lp["v_w"] + lp["v_b"], n_head)
        x = x + _merge_heads(flash_attention(q, k, v)) @ lp["o_w"] + lp["o_b"]
        h = layer_norm(x, lp["ln2_scale"], lp["ln2_bias"])
        x = x + _mlp(h, lp)
    return layer_norm(x, enc["ln_post_scale"], enc["ln_post_bias"])


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class KVCache:
    """Self-attention or cross-attention cache, flat layout k/v [L, B, T, H*Dh]."""
    k: torch.Tensor
    v: torch.Tensor


@dataclasses.dataclass
class QuantKVCache:
    """int8 cross-KV with per-(position, head) scales: values [L, B, T, H*Dh]
    int8, scales [L, B, T, H] fp32. Scales fold into scores and probs, so the
    int8 values are never dequantized in memory."""
    k: torch.Tensor        # int8 [L,B,T,H*Dh]
    k_scale: torch.Tensor  # f32  [L,B,T,H]
    v: torch.Tensor        # int8 [L,B,T,H*Dh]
    v_scale: torch.Tensor  # f32  [L,B,T,H]


def init_kv_cache(cfg: WhisperConfig, batch: int, dtype=torch.float32,
                  max_len: Optional[int] = None, device=None) -> KVCache:
    max_len = max_len or cfg.n_text_ctx
    shape = (cfg.n_text_layer, batch, max_len, cfg.n_text_state)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


def _cross_kv_layers(params: Params, audio_features: torch.Tensor):
    for lp in _layers(params["decoder"]["layers"]):
        yield (audio_features @ lp["xk_w"],
               audio_features @ lp["xv_w"] + lp["xv_b"])


def compute_cross_kv(cfg: WhisperConfig, params: Params,
                     audio_features: torch.Tensor) -> KVCache:
    """Per-layer cross-attention K/V from the encoder output, once per 30 s
    window, flat [L, B, T_audio, H*Dh]."""
    ks, vs = zip(*_cross_kv_layers(params, audio_features))
    return KVCache(torch.stack(ks), torch.stack(vs))


def compute_cross_kv_quant(cfg: WhisperConfig, params: Params,
                           audio_features: torch.Tensor) -> QuantKVCache:
    """int8 variant of compute_cross_kv, quantized a layer at a time on the
    per-head quantize kernel."""
    n_head = cfg.n_text_head
    kq, ks, vq, vs = [], [], [], []
    for k, v in _cross_kv_layers(params, audio_features):
        k8, k_s = quantize_heads(k, n_head)
        v8, v_s = quantize_heads(v, n_head)
        kq.append(k8), ks.append(k_s), vq.append(v8), vs.append(v_s)
    return QuantKVCache(torch.stack(kq), torch.stack(ks), torch.stack(vq),
                        torch.stack(vs))


def _attend_views(q4, k4, v4, mask, *, ks=None, vs=None):
    """Multi-query attention on [B, T, H, D] views of flat KV (the long
    prefill path). q4 [B,S,H,D]; k4/v4 [B,T,H,D] (int8 or float);
    ks/vs [B,T,H]."""
    dh = q4.shape[-1]
    compute = q4.dtype
    scores = torch.einsum("bqhd,bkhd->bhqk", q4.float(),
                          k4.to(compute).float())
    if ks is not None:
        scores = scores * ks.transpose(1, 2)[:, :, None, :]
    scores = scores * (dh ** -0.5)
    if mask is not None:
        scores = torch.where(mask, scores, NEG)
    probs = torch.softmax(scores, dim=-1)
    if vs is not None:
        probs = probs * vs.transpose(1, 2)[:, :, None, :]
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(compute), v4.to(compute))
    B, S = q4.shape[:2]
    return out.reshape(B, S, -1).to(q4.dtype)


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------

def _cross(cross_kv, l):
    if isinstance(cross_kv, QuantKVCache):
        return (cross_kv.k[l], cross_kv.v[l], cross_kv.k_scale[l],
                cross_kv.v_scale[l])
    return cross_kv.k[l], cross_kv.v[l], None, None


def _logits(cfg: WhisperConfig, dec: Params, x: torch.Tensor) -> torch.Tensor:
    x = layer_norm(x, dec["ln_scale"], dec["ln_bias"])
    logits = x.float() @ dec["tok_emb"].float().T
    logits[..., cfg.n_vocab:] = NEG                      # vocab padding
    return logits


def _row_writer(pos: torch.Tensor, S: int, max_len: int):
    """write(buf [B, T, ...], new [B, S, ...]): rows pos_b .. pos_b+S-1 of
    each batch row b take `new`, rows past T are dropped (the reference's
    scatter mode="drop"). A dropped row is sent to row pos_b - 1 with that
    row's own value, so no index is out of range (a device assert on CUDA)
    and no two writes of one call meet on a row with different values."""
    B = pos.shape[0]
    t_idx = pos[:, None] + torch.arange(S, device=pos.device)[None, :]
    keep = t_idx < max_len
    rows = torch.where(keep, t_idx, (pos[:, None] - 1).clamp(min=0))
    b_idx = torch.arange(B, device=pos.device)[:, None]

    def write(buf, new):
        keep_b = keep.view(B, S, *([1] * (new.dim() - 2)))
        buf[b_idx, rows] = torch.where(keep_b, new, buf[b_idx, rows])
    return write


def _decode_flat_ro(cfg: WhisperConfig, params: Params, x: torch.Tensor,
                    pos, cache: KVCache, cross_kv
                    ) -> tuple[torch.Tensor, KVCache]:
    """decode() body for S·H ≤ 128, on the decode-attention kernel.

    Each layer writes its S new keys and values into the cache in place
    first, then attends with query i seeing the keys before pos_row + i + 1
    (the direct load path, K4); the reference reads the cache as read-only
    (keys before pos_row) and the new keys beside it, causal among
    themselves, which is the same set of keys and the same math. The
    cross-attention sees all of cross_kv (the pipelined load path, K5).
    Per-row `pos` ([B] tensor) writes rows past max_len nowhere."""
    _decode_flat_ro.calls += 1
    dec = params["decoder"]
    B, S, _ = x.shape
    n_head = cfg.n_text_head
    max_len = cache.k.shape[2]
    if torch.is_tensor(pos):
        lengths = (pos + 1).to(torch.int32)
        write = _row_writer(pos, S, max_len)
    else:
        lengths = pos + 1
        n_keep = max(0, min(S, max_len - pos))

        def write(buf, new):
            buf[:, pos:pos + n_keep] = new[:, :n_keep]

    for l, lp in enumerate(_layers(dec["layers"])):
        h = layer_norm(x, lp["ln1_scale"], lp["ln1_bias"])
        q = h @ lp["q_w"] + lp["q_b"]                    # [B, S, HD]
        write(cache.k[l], (h @ lp["k_w"]).to(cache.k.dtype))
        write(cache.v[l], (h @ lp["v_w"] + lp["v_b"]).to(cache.v.dtype))
        attn = attend_decode(q, cache.k[l], cache.v[l], lengths, n_head,
                             causal=True)
        x = x + attn @ lp["o_w"] + lp["o_b"]
        h = layer_norm(x, lp["ln2_scale"], lp["ln2_bias"])
        xq = h @ lp["xq_w"] + lp["xq_b"]
        xk, xv, xks, xvs = _cross(cross_kv, l)
        attn = attend_decode_pipelined(xq, xk, xv, None, n_head, ks=xks,
                                       vs=xvs)
        x = x + attn @ lp["xo_w"] + lp["xo_b"]
        h = layer_norm(x, lp["ln3_scale"], lp["ln3_bias"])
        x = x + _mlp(h, lp)
    return _logits(cfg, dec, x), cache


_decode_flat_ro.calls = 0      # flat decoder calls, for launch accounting


def decode(cfg: WhisperConfig, params: Params, tokens: torch.Tensor,
           pos, cache: KVCache, cross_kv, *, cross_group: int = 1,
           ) -> tuple[torch.Tensor, KVCache]:
    """Run the decoder on `tokens` [B, S] starting at position `pos`,
    attending to the self-attention cache and the precomputed cross K/V
    (KVCache or int8 QuantKVCache). Handles prompt prefill (S > 1) and
    single-token steps (S = 1). Writes the S new keys and values into
    `cache` in place.

    `pos` is an int (every row at the same offset: one-shot decode) or an
    integer [B] tensor (continuous batching: every slot at its own offset;
    S·H ≤ 128 only). Cache key j is visible to a row iff j < its pos, plus
    the new keys causally.

    Returns (logits [B, S, n_vocab_padded] fp32, the cache)."""
    if cross_group != 1:
        raise NotImplementedError("beam groups (cross_group > 1) are not "
                                  "ported yet")
    if not isinstance(cache, KVCache):
        raise NotImplementedError("the int8 self-cache is not ported yet")
    dec = params["decoder"]
    B, S = tokens.shape
    n_head = cfg.n_text_head
    max_len = cache.k.shape[2]
    per_row = torch.is_tensor(pos)
    if per_row and pos.shape != (B,):
        raise ValueError(f"per-row pos must be [{B}], got {tuple(pos.shape)}")
    if S > max_len:
        raise ValueError(f"{S} tokens do not fit a cache of {max_len}")

    x = dec["tok_emb"][tokens]
    if per_row:
        pos = pos.long()
        # Clamped like the reference's gather of out-of-range positions.
        pos_ids = (pos[:, None] + torch.arange(S, device=tokens.device)
                   ).clamp(max=cfg.n_text_ctx - 1)
    else:
        pos_ids = torch.arange(pos, pos + S, device=tokens.device)
    x = x + dec["pos_emb"][pos_ids].to(x.dtype)

    if S * n_head <= 128:
        return _decode_flat_ro(cfg, params, x, pos, cache, cross_kv)
    if per_row:
        raise NotImplementedError("per-row positions take the flat path "
                                  "only (S·H <= 128), as in the reference")

    # Long prefill (S·H > 128): write the block into the cache, then attend
    # over the head views with a causal mask.
    key_idx = torch.arange(max_len, device=x.device)[None, :]
    q_idx = torch.arange(S, device=x.device)[:, None]
    self_mask = (key_idx <= pos + q_idx)[None, None]      # [1, 1, S, T]
    dh = cfg.n_text_state // n_head

    for l, lp in enumerate(_layers(dec["layers"])):
        h = layer_norm(x, lp["ln1_scale"], lp["ln1_bias"])
        q = h @ lp["q_w"] + lp["q_b"]                    # [B, S, HD]
        cache.k[l, :, pos:pos + S] = (h @ lp["k_w"]).to(cache.k.dtype)
        cache.v[l, :, pos:pos + S] = (h @ lp["v_w"] + lp["v_b"]
                                      ).to(cache.v.dtype)
        attn = _attend_views(
            q.view(B, S, n_head, dh),
            cache.k[l].view(B, max_len, n_head, dh),
            cache.v[l].view(B, max_len, n_head, dh), self_mask)
        x = x + attn @ lp["o_w"] + lp["o_b"]
        h = layer_norm(x, lp["ln2_scale"], lp["ln2_bias"])
        xq = h @ lp["xq_w"] + lp["xq_b"]                 # [B, S, HD]
        xk, xv, xks, xvs = _cross(cross_kv, l)
        T_a = xk.shape[1]
        attn = _attend_views(
            xq.view(B, S, n_head, dh), xk.view(B, T_a, n_head, dh),
            xv.view(B, T_a, n_head, dh), None, ks=xks, vs=xvs)
        x = x + attn @ lp["xo_w"] + lp["xo_b"]
        h = layer_norm(x, lp["ln3_scale"], lp["ln3_bias"])
        x = x + _mlp(h, lp)
    return _logits(cfg, dec, x), cache


def forward(cfg: WhisperConfig, params: Params, mel: torch.Tensor,
            tokens: torch.Tensor) -> torch.Tensor:
    """Teacher-forced forward (training): mel [B, n_mels, 3000], tokens
    [B, S] → logits [B, S, n_vocab_padded] fp32. Differentiable.

    The reference (model.py:forward) runs `decode` over an empty cache of
    S rows with the fp cross-KV. Here the decoder attends over the block's
    own S keys with a causal mask in plain PyTorch (`_attend_views`), which
    is the function of both of the reference's branches (the flat path for
    S·H <= 128, the long prefill above it: XLA einsums on the TPU too). It
    does not go through `decode`: the decode kernels have no backward, and
    the cache writes in place would break autograd's version checks. The
    encoder's attention runs on the flash kernels, backward included."""
    feats = encode(cfg, params, mel)
    cross_kv = compute_cross_kv(cfg, params, feats)
    dec = params["decoder"]
    B, S = tokens.shape
    n_head = cfg.n_text_head
    dh = cfg.n_text_state // n_head
    T_a = feats.shape[1]
    x = dec["tok_emb"][tokens]
    x = x + dec["pos_emb"][:S].to(x.dtype)
    causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    heads = lambda t, T: t.view(B, T, n_head, dh)
    for l, lp in enumerate(_layers(dec["layers"])):
        h = layer_norm(x, lp["ln1_scale"], lp["ln1_bias"])
        attn = _attend_views(heads(h @ lp["q_w"] + lp["q_b"], S),
                             heads(h @ lp["k_w"], S),
                             heads(h @ lp["v_w"] + lp["v_b"], S), causal)
        x = x + attn @ lp["o_w"] + lp["o_b"]
        h = layer_norm(x, lp["ln2_scale"], lp["ln2_bias"])
        attn = _attend_views(heads(h @ lp["xq_w"] + lp["xq_b"], S),
                             heads(cross_kv.k[l], T_a),
                             heads(cross_kv.v[l], T_a), None)
        x = x + attn @ lp["xo_w"] + lp["xo_b"]
        h = layer_norm(x, lp["ln3_scale"], lp["ln3_bias"])
        x = x + _mlp(h, lp)
    return _logits(cfg, dec, x)
