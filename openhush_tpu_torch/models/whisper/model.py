"""Whisper encoder/decoder in PyTorch: the port of
openhush_tpu/models/whisper/model.py on the main transcription path.

Parameters keep the JAX package's layout (see weights.py): per-layer weights
stacked on a leading [n_layer] axis, linear weights [in, out], conv stems
HIO. Caches keep its flat layout, k/v [L, B, T, H*Dh]. Layer norms, softmax
and logits run in fp32 whatever the parameter dtype (bf16 in production).

Differences from the reference, each with its reason:
- Layers run in a Python loop over per-layer views instead of `lax.scan`.
- The decode step writes the self-attention cache in place (the reference
  returns an updated copy); `decode` still returns the cache.
- The reference's block-diagonal selector, which spreads each head's query
  into its own 128-lane column of one matmul, is a TPU layout trick. Here
  every score and value product is a per-head contraction, which sums the
  same terms.
- On CUDA there is no integer matmul, so the int8 cross-attention products
  run in fp32 on integer values, where they are exact (see `_exact_pv`).
- Not in this slice: the W8A8 encoder and int8 decoder weights, the int8
  self-cache, beam groups (`cross_group > 1`) and per-row positions.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from openhush_tpu_torch.models.whisper.config import WhisperConfig
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


# ---------------------------------------------------------------------------
# Decode-step attention over the flat caches
# ---------------------------------------------------------------------------

# Keys per fp32 partial sum of an int8 prob x int8 value product: each term
# is at most 127*127, and 1024 of them stay below 2**24, so every partial
# sum is an exact integer; partials are added in int32.
_PV_CHUNK = 1024


def _exact_pv(p8: torch.Tensor, v4: torch.Tensor) -> torch.Tensor:
    """sum_t p8[b,t,s,h] * v4[b,t,h,d] → int32 [B, S, H, D], exact; p8 holds
    integer values in fp32, v4 is int8."""
    out = None
    for t0 in range(0, v4.shape[1], _PV_CHUNK):
        part = torch.einsum("btsh,bthd->bshd", p8[:, t0:t0 + _PV_CHUNK],
                            v4[:, t0:t0 + _PV_CHUNK].float()).to(torch.int32)
        out = part if out is None else out + part
    return out


def _quantize_query(q3: torch.Tensor, n_head: int):
    """Per-(row, query, head) int8 query quantization of the decode paths:
    max(·, 1e-10) / 127 with a divide (not _quantize_heads' recipe)."""
    B, S, HD = q3.shape
    qh = q3.float().view(B, S, n_head, HD // n_head)
    qscale = torch.clamp(qh.abs().amax(dim=-1), min=1e-10) / 127.0
    q8 = torch.clamp(torch.round(qh / qscale[..., None]), -127, 127)
    return q8, qscale


def _attend_decode_flat_multi(q3, k_flat, v_flat, n_head, *, ks=None,
                              vs=None):
    """Cross-attention of S queries over a flat cache, every key visible.

    q3: [B, S, H*D]; k_flat/v_flat: [B, T, H*D] (float or int8);
    ks/vs: [B, T, H] scales when the cache is int8. With int8 KV the query
    is quantized per head, the score and value products are integer-exact,
    and the scales fold into scores and probs (probs quantized per (row,
    query, head)). Per query this is the reference's S=1 step
    (_attend_decode_flat) too, so the port has one function for both."""
    B, S, HD = q3.shape
    D = HD // n_head
    T = k_flat.shape[1]
    k4 = k_flat.view(B, T, n_head, D)
    v4 = v_flat.view(B, T, n_head, D)
    quant = k_flat.dtype == torch.int8

    if quant:
        q8, qscale = _quantize_query(q3, n_head)
        scores = torch.einsum("bthd,bshd->btsh", k4.float(), q8)
        scores = (scores * ks[:, :, None, :]
                  * qscale[:, None, :, :] * (D ** -0.5))
    else:
        scores = torch.einsum("bthd,bshd->btsh", k4.float(),
                              q3.float().view(B, S, n_head, D)) * (D ** -0.5)

    probs = torch.softmax(scores, dim=1)                 # over T
    if quant:
        pv = probs * vs[:, :, None, :]                   # [B, T, S, H]
        pscale = torch.clamp(pv.amax(dim=1), min=1e-20) / 127.0   # [B, S, H]
        p8 = torch.clamp(torch.round(pv / pscale[:, None]), -127, 127)
        out = _exact_pv(p8, v4).float() * pscale[..., None]
    else:
        out = torch.einsum("btsh,bthd->bshd",
                           probs.to(v_flat.dtype).float(), v4.float())
    return out.reshape(B, S, HD).to(q3.dtype)


def _attend_decode_flat_ro(q3, k_cache, v_cache, cache_mask, k_new, v_new,
                           n_head):
    """Self-attention of S new queries over a read-only cache plus the S new
    keys riding beside it (float caches).

    q3 [B,S,HD]; k_cache/v_cache [B,T,HD] holding positions < pos;
    cache_mask [B|1,T] (key j visible iff j < pos); k_new/v_new [B,S,HD]
    already in the cache dtype: block key jb is visible to query i iff
    jb <= i. One softmax runs over the T + S keys."""
    B, S, HD = q3.shape
    D = HD // n_head
    T = k_cache.shape[1]
    qf = q3.float().view(B, S, n_head, D)
    sc_c = torch.einsum("bthd,bshd->btsh", k_cache.view(B, T, n_head, D).float(),
                        qf) * (D ** -0.5)
    sc_n = torch.einsum("bjhd,bshd->bjsh", k_new.view(B, S, n_head, D).float(),
                        qf) * (D ** -0.5)
    if cache_mask is not None:
        sc_c = torch.where(cache_mask[:, :, None, None], sc_c, NEG)
    idx = torch.arange(S, device=q3.device)
    blk = idx[:, None] <= idx[None, :]                   # [jb, i]
    sc_n = torch.where(blk[None, :, :, None], sc_n, NEG)
    probs = torch.softmax(torch.cat([sc_c, sc_n], dim=1), dim=1)
    p_c, p_n = probs[:, :T], probs[:, T:]
    out = (torch.einsum("btsh,bthd->bshd", p_c.to(v_cache.dtype).float(),
                        v_cache.view(B, T, n_head, D).float())
           + torch.einsum("bjsh,bjhd->bshd", p_n.to(v_new.dtype).float(),
                          v_new.view(B, S, n_head, D).float()))
    return out.reshape(B, S, HD).to(q3.dtype)


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


def _decode_flat_ro(cfg: WhisperConfig, params: Params, x: torch.Tensor,
                    pos: int, cache: KVCache, cross_kv
                    ) -> tuple[torch.Tensor, KVCache]:
    """decode() body for S·H ≤ 128: each layer attends over the cache as
    read-only and the S new keys beside it, then writes its S new keys and
    values into the cache in place (no later read in this step needs the
    old contents)."""
    dec = params["decoder"]
    B, S, _ = x.shape
    n_head = cfg.n_text_head
    max_len = cache.k.shape[2]
    cache_mask = torch.arange(max_len, device=x.device)[None, :] < pos

    for l, lp in enumerate(_layers(dec["layers"])):
        h = layer_norm(x, lp["ln1_scale"], lp["ln1_bias"])
        q = h @ lp["q_w"] + lp["q_b"]                    # [B, S, HD]
        k_new = (h @ lp["k_w"]).to(cache.k.dtype)
        v_new = (h @ lp["v_w"] + lp["v_b"]).to(cache.v.dtype)
        attn = _attend_decode_flat_ro(q, cache.k[l], cache.v[l], cache_mask,
                                      k_new, v_new, n_head)
        cache.k[l, :, pos:pos + S] = k_new
        cache.v[l, :, pos:pos + S] = v_new
        x = x + attn @ lp["o_w"] + lp["o_b"]
        h = layer_norm(x, lp["ln2_scale"], lp["ln2_bias"])
        xq = h @ lp["xq_w"] + lp["xq_b"]
        xk, xv, xks, xvs = _cross(cross_kv, l)
        attn = _attend_decode_flat_multi(xq, xk, xv, n_head, ks=xks, vs=xvs)
        x = x + attn @ lp["xo_w"] + lp["xo_b"]
        h = layer_norm(x, lp["ln3_scale"], lp["ln3_bias"])
        x = x + _mlp(h, lp)
    return _logits(cfg, dec, x), cache


def decode(cfg: WhisperConfig, params: Params, tokens: torch.Tensor,
           pos: int, cache: KVCache, cross_kv, *, cross_group: int = 1,
           ) -> tuple[torch.Tensor, KVCache]:
    """Run the decoder on `tokens` [B, S] starting at position `pos` (one
    offset for every row), attending to the self-attention cache and the
    precomputed cross K/V (KVCache or int8 QuantKVCache). Handles prompt
    prefill (S > 1) and single-token steps (S = 1). Writes the S new keys
    and values into `cache` in place.

    Returns (logits [B, S, n_vocab_padded] fp32, the cache)."""
    if cross_group != 1:
        raise NotImplementedError("beam groups (cross_group > 1) are not "
                                  "ported yet")
    if not isinstance(cache, KVCache):
        raise NotImplementedError("the int8 self-cache is not ported yet")
    if not isinstance(pos, int):
        raise NotImplementedError("per-row positions are not ported yet")
    dec = params["decoder"]
    B, S = tokens.shape
    n_head = cfg.n_text_head
    max_len = cache.k.shape[2]

    x = dec["tok_emb"][tokens]
    pos_ids = torch.arange(pos, pos + S, device=tokens.device)
    x = x + dec["pos_emb"][pos_ids].to(x.dtype)

    if S * n_head <= 128:
        return _decode_flat_ro(cfg, params, x, pos, cache, cross_kv)

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
