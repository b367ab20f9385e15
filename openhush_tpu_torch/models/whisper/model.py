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
  hand-written decode-attention kernel, ops/decode_attention.py; an int8
  self-cache takes its new keys from the per-head quantize kernel
  (ops/quantize.py, K and V in one launch) before it is written.
- An int8 decoder weight's product (`_mm`) runs on the W8A16 kernel
  (ops/w8a16.py), which reads the levels once as int8 where XLA fuses
  their convert into the dot; where the reference adds a bias right after
  the product (`_mm(x, w) + b`) the kernel's epilogue adds it, rounding
  as the separate add does.
- The W8A8 encoder's int8 weights are stored column-major in each layer
  (the same [in, out] values): `torch._int_mm` (cuBLASLt's int8 GEMM)
  runs several times faster on a column-major second operand on the H100
  (chip_smoke.py phase 4d times both).
- The grouped beam step (`decode_beam_step`) writes each beam's new keys
  first, like the flat step, and attends under one ancestry mask that
  includes each beam's own new key (the reference's cache mask plus its
  identity block over the new keys beside the cache), on K4's beam mode.
- Tensor parallelism is explicit (parallel/sharding.py): parameters from
  `shard_params` hold a rank's columns of q, k, v, fc1 (and xq, xk, xv) and
  rows of o, xo, fc2, and carry their mesh. A layer stack whose q_w holds
  fewer columns than the model's width runs on the rank's heads (their
  count from that width), with `copy_to_model` before each column-parallel
  product and `reduce_from_model` after each row-parallel one, its bias
  added once after the reduce. A bf16 partial product is reduced in fp32
  (rounded once, as the single device's product is). Path decisions (the
  flat step, the grouped beam step) read the global head count; only the
  kernels' launch shapes take the local one. The reference's GSPMD inserts
  these collectives itself. A whole stack (a draft, int8 weights) runs
  with none.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from openhush_tpu_torch.models.whisper.config import WhisperConfig
from openhush_tpu_torch.ops.decode_attention import (ancestry_rows,
                                                     attend_decode,
                                                     attend_decode_beam,
                                                     attend_decode_pipelined,
                                                     div127)
from openhush_tpu_torch.ops.flash_attention import flash_attention
from openhush_tpu_torch.ops.quantize import quantize_heads_kv
from openhush_tpu_torch.ops.w8a16 import mm_w8a16
from openhush_tpu_torch.parallel.sharding import (copy_to_model,
                                                  reduce_from_model)

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


def _mlp(x, lp, tp=None):
    h = _gelu(_mm(copy_to_model(x, tp), lp["fc1_w"], lp["fc1_b"]))
    return _row(h, lp["fc2_w"], tp) + lp["fc2_b"]


# ---------------------------------------------------------------------------
# Tensor parallelism
# ---------------------------------------------------------------------------

def _width(w) -> int:
    """Output columns of a plain or int8 weight."""
    return (w["q"] if isinstance(w, dict) else w).shape[-1]


def _stack_tp(params: Params, layers: dict, width: int, n_head: int):
    """(model group or None, local head count) of a layer stack: a stack
    whose q_w holds all `width` columns is whole and runs with no
    collective; a narrower one was cut by shard_params, and runs on its
    share of the heads over the group its params carry."""
    local = _width(layers["q_w"])
    if local == width:
        return None, n_head
    mesh = getattr(params, "mesh", None)
    if mesh is None:
        raise ValueError(f"a layer stack holds {local} of {width} columns but "
                         f"the parameters carry no mesh: cut them with "
                         f"parallel.sharding.shard_params")
    return mesh.model_group, n_head * local // width


def _row(x, w, tp):
    """A row-parallel product: x @ w, summed over the model group `tp`
    (x holds the rank's input columns, w its rows). A bf16 rank's partial
    sum is reduced in fp32 and rounded once; one that needs a gradient is
    reduced in its own dtype. Without a group, `_mm`."""
    if tp is None:
        return _mm(x, w)
    if x.dtype == torch.float32 or (torch.is_grad_enabled() and (
            x.requires_grad or w.requires_grad)):
        y = x @ w
    elif x.is_cuda:
        y = torch.mm(x.reshape(-1, x.shape[-1]), w, out_dtype=torch.float32
                     ).view(*x.shape[:-1], w.shape[-1])
    else:
        y = x.float() @ w.float()
    return reduce_from_model(y, tp).to(x.dtype)


def _unbind(w) -> list:
    """[L, ...] → L views; an int8 weight {"q": [L, in, out], "s": [L, out]}
    → L dicts {"q": q[l], "s": s[l]}."""
    if isinstance(w, dict):
        return [dict(zip(w, parts))
                for parts in zip(*(t.unbind(0) for t in w.values()))]
    return w.unbind(0)


def _layers(stacked: dict) -> list[dict]:
    """Stacked {name: [L, ...]} → one {name: view} dict per layer."""
    views = {name: _unbind(w) for name, w in stacked.items()}
    n = len(next(iter(views.values())))
    return [{name: v[i] for name, v in views.items()} for i in range(n)]


# ---------------------------------------------------------------------------
# int8 weights (the reference's int8 rungs)
# ---------------------------------------------------------------------------

def _mm(x, w, b=None):
    """x @ w (+ b) for a plain weight, or for an int8 weight {"q": int8
    [in, out], "s": fp32 [out]} per output channel: the product of x and the
    levels with fp32 sums, times the scales in fp32, then cast to x's dtype
    (the reference's dot with preferred_element_type=f32), then + b in x's
    dtype, as the reference's `_mm(x, w) + b`. An int8 weight takes the
    W8A16 kernel (ops/w8a16.py: the levels read once as int8, the bias in
    its epilogue) on a CUDA tensor, its plain version on a CPU one."""
    if isinstance(w, dict):
        return mm_w8a16(x, w, b)
    return x @ w if b is None else x @ w + b


def _quantize_weight(w: torch.Tensor) -> dict:
    """[..., in, out] → {"q": int8, "s": fp32 [..., out]}: the reference's
    recipe, scale = max|w| over `in` / 127 (a divide), floored at 1e-10."""
    w32 = w.float()
    scale = torch.clamp(div127(w32.abs().amax(dim=-2)), min=1e-10)
    q = torch.clamp(torch.round(w32 / scale[..., None, :]), -127, 127)
    return {"q": q.to(torch.int8), "s": scale}


def _quantize_layers(params: Params, part: str, column_major: bool
                     ) -> Params:
    """params with every `*_w` matrix under params[part]["layers"] int8;
    leaves that are already dicts stay as they are, so a second call
    changes nothing."""
    layers = dict(params[part]["layers"])
    for name, w in layers.items():
        if name.endswith("_w") and not isinstance(w, dict):
            qw = _quantize_weight(w)
            if column_major:
                qw["q"] = qw["q"].transpose(-1, -2).contiguous(
                ).transpose(-1, -2)
            layers[name] = qw
    return {**params, part: {**params[part], "layers": layers}}


def quantize_decoder_weights(params: Params) -> Params:
    """Every decoder layer matrix (self, cross and MLP projections, xk_w and
    xv_w included) int8 with per-output-channel scales; the token and
    position tables and the layer norms stay dense. The decoder's `_mm`
    runs them on the W8A16 kernel."""
    return _quantize_layers(params, "decoder", column_major=False)


def quantize_encoder_weights(params: Params) -> Params:
    """Every encoder layer matrix int8, the same recipe, for the W8A8
    encoder (`encode` takes `_block_i8` when q_w is a dict); the conv stem,
    positions and layer norms stay dense. Each layer's levels are stored
    column-major, as `torch._int_mm` takes them fastest on the card."""
    return _quantize_layers(params, "encoder", column_major=True)


def _quantize_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8: x [..., D] → (int8 values, fp32 scales
    [...]), scale = max|x| * float32(1/127) (a reciprocal multiply),
    floored at 1e-10. Plain PyTorch, as the reference keeps it in XLA."""
    x32 = x.float()
    scale = x32.abs().amax(dim=-1) * torch.tensor(1.0 / 127.0,
                                                  dtype=torch.float32)
    safe = torch.clamp(scale, min=1e-10)
    q = torch.clamp(torch.round(x32 / safe[..., None]), -127, 127)
    return q.to(torch.int8), safe


def _mm_i8(x8: torch.Tensor, xs: torch.Tensor, w: dict) -> torch.Tensor:
    """int8 x int8 → int32 product (torch._int_mm) with both scale folds:
    x8 [..., I] with per-row scales xs [...], w {"q": int8 [I, O], "s":
    fp32 [O]} → fp32 [..., O], folded left to right as the reference does.
    On the card _int_mm takes more than 16 rows and I, O multiples of 8:
    other shapes raise."""
    q = w["q"]
    x2 = x8.reshape(-1, x8.shape[-1])
    if x2.is_cuda and not (x2.shape[0] > 16 and x2.shape[1] % 8 == 0
                           and q.shape[1] % 8 == 0):
        raise ValueError(f"_mm_i8: the card's int8 GEMM takes more than 16 "
                         f"rows and inner and output sizes that are multiples "
                         f"of 8, not [{x2.shape[0]}, {x2.shape[1]}] x "
                         f"[{q.shape[0]}, {q.shape[1]}]")
    y = torch._int_mm(x2, q).view(*x8.shape[:-1], q.shape[-1]).float()
    return y * xs[..., None] * w["s"].float()


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

    tp, n_head = _stack_tp(params, enc["layers"], cfg.n_audio_state,
                           cfg.n_audio_head)
    int8 = isinstance(enc["layers"]["q_w"], dict)
    for lp in _layers(enc["layers"]):
        x = _block_i8(x, lp, n_head) if int8 else _block(x, lp, n_head, tp)
    return layer_norm(x, enc["ln_post_scale"], enc["ln_post_bias"])


def _block(x, lp, n_head, tp=None):
    h = copy_to_model(layer_norm(x, lp["ln1_scale"], lp["ln1_bias"]), tp)
    q = _split_heads(h @ lp["q_w"] + lp["q_b"], n_head)
    k = _split_heads(h @ lp["k_w"], n_head)
    v = _split_heads(h @ lp["v_w"] + lp["v_b"], n_head)
    x = x + _row(_merge_heads(flash_attention(q, k, v)), lp["o_w"], tp
                 ) + lp["o_b"]
    h = layer_norm(x, lp["ln2_scale"], lp["ln2_bias"])
    return x + _mlp(h, lp, tp)


def _block_i8(x, lp, n_head):
    """The W8A8 encoder layer: every projection an int8 x int8 product on
    per-row quantized activations, one quantize per distinct input (h feeds
    q, k and v); the residual stream, layer norms, attention (the flash
    kernel) and GELU stay in x's dtype."""
    dt = x.dtype
    h8, hs = _quantize_rows(layer_norm(x, lp["ln1_scale"], lp["ln1_bias"]))
    q = _split_heads((_mm_i8(h8, hs, lp["q_w"]) + lp["q_b"]).to(dt), n_head)
    k = _split_heads(_mm_i8(h8, hs, lp["k_w"]).to(dt), n_head)
    v = _split_heads((_mm_i8(h8, hs, lp["v_w"]) + lp["v_b"]).to(dt), n_head)
    a8, as_ = _quantize_rows(_merge_heads(flash_attention(q, k, v)))
    x = x + (_mm_i8(a8, as_, lp["o_w"]) + lp["o_b"]).to(dt)
    h8, hs = _quantize_rows(layer_norm(x, lp["ln2_scale"], lp["ln2_bias"]))
    g = _gelu((_mm_i8(h8, hs, lp["fc1_w"]) + lp["fc1_b"]).to(dt))
    g8, gs = _quantize_rows(g)
    return x + (_mm_i8(g8, gs, lp["fc2_w"]) + lp["fc2_b"]).to(dt)


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
    """int8 cross-KV, or int8 self-cache, with per-(position, head) scales:
    values [L, B, T, H*Dh] int8, scales [L, B, T, H] fp32. Scales fold into
    scores and probs, so the int8 values are never dequantized in memory."""
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


def init_quant_kv_cache(cfg: WhisperConfig, batch: int,
                        max_len: Optional[int] = None,
                        device=None) -> QuantKVCache:
    """int8 self-attention cache: init_kv_cache's layout with per-(position,
    head) scales, zeroed; decode() quantizes the new keys as it writes
    them."""
    max_len = max_len or cfg.n_text_ctx
    shape = (cfg.n_text_layer, batch, max_len, cfg.n_text_state)
    vals = lambda: torch.zeros(shape, dtype=torch.int8, device=device)
    scales = lambda: torch.zeros(*shape[:3], cfg.n_text_head,
                                 dtype=torch.float32, device=device)
    return QuantKVCache(vals(), scales(), vals(), scales())


def _cross_kv_layers(params: Params, audio_features: torch.Tensor, tp):
    audio_features = copy_to_model(audio_features, tp)
    for lp in _layers(params["decoder"]["layers"]):
        yield (_mm(audio_features, lp["xk_w"]),
               _mm(audio_features, lp["xv_w"], lp["xv_b"]))


def _decoder_tp(cfg: WhisperConfig, params: Params):
    """(model group or None, local head count) of the decoder stack."""
    return _stack_tp(params, params["decoder"]["layers"], cfg.n_text_state,
                     cfg.n_text_head)


def _check_cache_heads(cfg: WhisperConfig, cache, n_head: int) -> None:
    """A self-cache must hold the decoder's heads on this rank: a full-width
    cache (init_kv_cache) beside sharded params is refused here rather than
    at a shape error deep in a layer."""
    width = n_head * (cfg.n_text_state // cfg.n_text_head)
    if cache.k.shape[-1] != width:
        raise ValueError(
            f"the self-cache holds {cache.k.shape[-1]} columns, the decoder "
            f"{n_head} heads ({width}) on this rank: cut a mesh's caches "
            f"with parallel.sharding (cache_spec, shard_slot_state, "
            f"shard_beam_state)")


def compute_cross_kv(cfg: WhisperConfig, params: Params,
                     audio_features: torch.Tensor) -> KVCache:
    """Per-layer cross-attention K/V from the encoder output, once per 30 s
    window, flat [L, B, T_audio, H*Dh] (a rank's heads on a mesh)."""
    tp, _ = _decoder_tp(cfg, params)
    ks, vs = zip(*_cross_kv_layers(params, audio_features, tp))
    return KVCache(torch.stack(ks), torch.stack(vs))


def compute_cross_kv_quant(cfg: WhisperConfig, params: Params,
                           audio_features: torch.Tensor) -> QuantKVCache:
    """int8 variant of compute_cross_kv, a layer at a time (as the
    reference's scan, so the layers' fp intermediates never all exist at
    once): one launch of the per-head quantize kernel writes layer l's K and
    V straight into slice l of the stacked cache."""
    tp, n_head = _decoder_tp(cfg, params)
    L, dh = cfg.n_text_layer, cfg.n_text_state // cfg.n_text_head
    B, T = audio_features.shape[:2]
    dev = audio_features.device
    vals = lambda: torch.empty(L, B, T, n_head * dh, dtype=torch.int8,
                               device=dev)
    scales = lambda: torch.empty(L, B, T, n_head, dtype=torch.float32,
                                 device=dev)
    out = QuantKVCache(vals(), scales(), vals(), scales())
    for l, (k, v) in enumerate(_cross_kv_layers(params, audio_features, tp)):
        quantize_heads_kv(k, v, n_head, (out.k[l], out.k_scale[l], out.v[l],
                                         out.v_scale[l]))
    return out


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
    # Contiguous for the products after it (the W8A16 kernel takes no
    # strided x).
    return out.reshape(B, S, -1).to(q4.dtype).contiguous()


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------

def _kv_at(cache, l):
    """Layer l of a cache → (k, v, k_scale, v_scale); no scales for a float
    cache."""
    if isinstance(cache, QuantKVCache):
        return cache.k[l], cache.v[l], cache.k_scale[l], cache.v_scale[l]
    return cache.k[l], cache.v[l], None, None


def _new_kv(cache, k_new, v_new, n_head: int):
    """A layer's new keys and values [B, S, H*Dh] as the self-cache holds
    them → (k, v, k_scale, v_scale): cast to its dtype, or, in an int8
    cache, quantized per (row, head) by one launch of the quantize kernel
    for K and V (the reference's _quantize_heads recipe)."""
    if not isinstance(cache, QuantKVCache):
        return k_new.to(cache.k.dtype), v_new.to(cache.v.dtype), None, None
    B, S, HD = k_new.shape
    vals = lambda: torch.empty(B, S, HD, dtype=torch.int8,
                               device=k_new.device)
    scales = lambda: torch.empty(B, S, n_head, dtype=torch.float32,
                                 device=k_new.device)
    k8, ks, v8, vs = vals(), scales(), vals(), scales()
    quantize_heads_kv(k_new, v_new, n_head, (k8, ks, v8, vs))
    return k8, v8, ks, vs


def _write_self_kv(cache, l, h, lp, n_head: int, write):
    """Project layer l's new keys and values from h, put them into the
    self-cache with write(buf, new) (with their scales in an int8 cache)
    and return the layer's (k, v, k_scale, v_scale)."""
    bufs = _kv_at(cache, l)
    new = _new_kv(cache, _mm(h, lp["k_w"]), _mm(h, lp["v_w"], lp["v_b"]),
                  n_head)
    for buf, t in zip(bufs, new):
        if t is not None:
            write(buf, t)
    return bufs


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
                    pos, cache: KVCache, cross_kv, cross_group: int = 1
                    ) -> tuple[torch.Tensor, KVCache]:
    """decode() body for S·H ≤ 128, on the decode-attention kernel.

    Each layer writes its S new keys and values into the cache in place
    first, then attends with query i seeing the keys before pos_row + i + 1
    (the direct load path, K4); the reference reads the cache as read-only
    (keys before pos_row) and the new keys beside it, causal among
    themselves, which is the same set of keys and the same math. An int8
    self-cache (QuantKVCache) gets the new keys' levels and scales from the
    quantize kernel (K3) and K4 runs its int8 mode, whose prob scale spans
    the cache and the block together, as the reference's does. The
    cross-attention sees all of cross_kv (the pipelined load path, K5);
    with cross_group > 1 every `cross_group` consecutive rows share one
    cross-KV row and fold into its query dimension. Per-row `pos` ([B]
    tensor) writes rows past max_len nowhere."""
    _decode_flat_ro.calls += 1
    _decode_flat_ro.layers += cfg.n_text_layer
    return _flat_layers(cfg, params, x, pos, cache, cross_kv, cross_group)


# Flat decoder calls, and the decoder layers they ran (a draft model's calls
# run fewer than the big model's), for launch accounting.
_decode_flat_ro.calls = 0
_decode_flat_ro.layers = 0


def _flat_layers(cfg: WhisperConfig, params: Params, x: torch.Tensor, pos,
                 cache, cross_kv, cross_group: int, beam=None):
    """The layers of the flat step (_decode_flat_ro) and of the grouped
    beam step (decode_beam_step, `beam` = (rows int8 [G, K, T], lengths
    int32 [G]): the self-attention on K4's beam mode over each group's K
    cache rows, through the source-row table)."""
    dec = params["decoder"]
    B, S, _ = x.shape
    tp, n_head = _decoder_tp(cfg, params)
    _check_cache_heads(cfg, cache, n_head)
    max_len = cache.k.shape[2]
    if torch.is_tensor(pos):
        lengths = (pos + 1).to(torch.int32)
        write = _row_writer(pos, S, max_len)
    else:
        lengths = pos + 1
        n_keep = max(0, min(S, max_len - pos))

        def write(buf, new):
            buf[:, pos:pos + n_keep] = new[:, :n_keep]

    # A group's rows as one row of keys (free views of the row-contiguous
    # cache), and the group's queries folded into the cross-attention's.
    group = lambda t: None if t is None else t.view(B // cross_group, -1,
                                                    t.shape[-1])
    for l, lp in enumerate(_layers(dec["layers"])):
        h = copy_to_model(layer_norm(x, lp["ln1_scale"], lp["ln1_bias"]), tp)
        q = _mm(h, lp["q_w"], lp["q_b"])                 # [B, S, HD]
        k, v, ks, vs = _write_self_kv(cache, l, h, lp, n_head, write)
        if beam is None:
            attn = attend_decode(q, k, v, lengths, n_head, ks=ks, vs=vs,
                                 causal=True)
        else:
            attn = attend_decode_beam(group(q), group(k), group(v), *beam,
                                      n_head, ks=group(ks),
                                      vs=group(vs)).view(B, S, -1)
        x = x + _row(attn, lp["o_w"], tp) + lp["o_b"]
        h = copy_to_model(layer_norm(x, lp["ln2_scale"], lp["ln2_bias"]), tp)
        xq = _mm(h, lp["xq_w"], lp["xq_b"])
        xk, xv, xks, xvs = _kv_at(cross_kv, l)
        attn = attend_decode_pipelined(group(xq), xk, xv, None, n_head,
                                       ks=xks, vs=xvs).view(B, S, -1)
        x = x + _row(attn, lp["xo_w"], tp) + lp["xo_b"]
        h = layer_norm(x, lp["ln3_scale"], lp["ln3_bias"])
        x = x + _mlp(h, lp, tp)
    return _logits(cfg, dec, x), cache


# ---------------------------------------------------------------------------
# Beam groups
# ---------------------------------------------------------------------------

LANE = 128


def beam_grouped_ok(cfg: WhisperConfig, beam_size: int) -> bool:
    """True when a K-beam group's K·H score rows fit one 128-lane tile (the
    reference's gate, model.py:beam_grouped_ok): then the one-shot beam
    loop and the beam batcher take the grouped step (decode_beam_step),
    else the K-tiled cross-KV and a parent gather of the cache. A function,
    looked up at call time, so tests can force the fallback."""
    return beam_size * cfg.n_text_head <= LANE


def beam_ancestry(G: int, K: int, T: int, prompt_len: int,
                  device=None) -> torch.Tensor:
    """The ancestry of G freshly prefilled groups, bool [G, K, K, T]: beam
    i reads its own row's prompt positions (the K rows hold the same
    prompt)."""
    eye = torch.eye(K, dtype=torch.bool, device=device)
    t = torch.arange(T, device=device)
    return (eye[:, :, None] & (t < prompt_len)).expand(G, K, K, T).clone()


def beam_own(anc: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """anc [G, K, K, T] with beam i's own bit set at position pos[g] of its
    own row: the key decode_beam_step writes there. A pos at or past T sets
    nothing (that write is dropped too)."""
    G, K, _, T = anc.shape
    eye = torch.eye(K, dtype=torch.bool, device=anc.device)
    at = torch.arange(T, device=anc.device) == pos.view(G, 1, 1, 1)
    return anc | (eye[None, :, :, None] & at)


def decode_beam_step(cfg: WhisperConfig, params: Params,
                     tokens: torch.Tensor, pos: torch.Tensor, cache,
                     anc_mask: torch.Tensor, cross_kv
                     ) -> tuple[torch.Tensor, object]:
    """One beam-search decode step for G groups of K beams, with no cache
    reorder and no cross-KV tiling (the reference's decode_beam_step).

    tokens [G, K] (each beam's next token), pos [G] integer tensor (a
    group's beams advance together), cache [L, G*K, T, H*D] (rows
    group-major, never permuted; KVCache, or QuantKVCache with [L, G*K, T,
    H] scales), cross_kv [L, G, A, ...] (one copy a group, fp or int8).

    Beam (g, i)'s new key and value are written at row g*K + i, position
    pos[g] (in int8 levels and scales by one K3 launch a layer in an int8
    self-cache), and then the beams attend on K4's beam mode under
    anc_mask [G, K, K*T]: query i sees flat key j = row*T + t iff it is
    set. The mask becomes a source-row table once a step, before the
    layers (ops.decode_attention.ancestry_rows: the one row a beam reads at
    each position), and K4 reads positions t < min(pos[g] + 1, T) through
    it in every layer. The caller passes the ancestry with each beam's own
    bit at pos[g] already set (beam_own), which is also the next step's
    ancestry: bits only at positions up to pos[g]. That
    is the reference's key set (its mask over the cache plus the identity
    block over the new keys beside it) while pos[g] < T. A write at T is
    dropped, as the reference's mode="drop" drops it, and then the beam does
    not see its new key where the reference's does: only a frozen group in
    the beam batcher gets there (prompt_len + max_new == T), and the
    batcher discards its outputs. The cross-attention runs on K5 with the
    group's K queries against its one cross-KV row.

    Returns (logits [G, K, n_vocab_padded] fp32, the cache). Requires
    K·H ≤ 128."""
    decode_beam_step.calls += 1
    dec = params["decoder"]
    G, K = tokens.shape
    if K * cfg.n_text_head > LANE:
        raise ValueError(f"K·H = {K * cfg.n_text_head} > {LANE}: the grouped "
                         f"beam step needs one lane tile")
    pos = pos.long()
    # Clamped like the reference's gather of an out-of-range position.
    x = dec["tok_emb"][tokens] + dec["pos_emb"][
        pos.clamp(max=cfg.n_text_ctx - 1)][:, None].to(dec["tok_emb"].dtype)
    beam = (ancestry_rows(anc_mask),
            (pos + 1).clamp(max=cache.k.shape[2]).to(torch.int32))
    logits, cache = _flat_layers(cfg, params, x.view(G * K, 1, -1),
                                 pos.repeat_interleave(K), cache, cross_kv,
                                 K, beam)
    return logits.view(G, K, -1), cache


decode_beam_step.calls = 0     # grouped beam steps, for launch accounting


def decode(cfg: WhisperConfig, params: Params, tokens: torch.Tensor,
           pos, cache: KVCache, cross_kv, *, cross_group: int = 1,
           ) -> tuple[torch.Tensor, KVCache]:
    """Run the decoder on `tokens` [B, S] starting at position `pos`,
    attending to the self-attention cache (KVCache, or the int8
    QuantKVCache of init_quant_kv_cache) and the precomputed cross K/V
    (KVCache or int8 QuantKVCache). Handles prompt prefill (S > 1) and
    single-token steps (S = 1). Writes the S new keys and values (int8:
    their levels and scales) into `cache` in place.

    `pos` is an int (every row at the same offset: one-shot decode) or an
    integer [B] tensor (continuous batching: every slot at its own offset).
    Cache key j is visible to a row iff j < its pos, plus the new keys
    causally.

    cross_group > 1 (beam search): every group of `cross_group`
    consecutive rows shares one cross-KV row (cross_kv batch B /
    cross_group), read once a group. Requires cross_group · S · H ≤ 128.

    Returns (logits [B, S, n_vocab_padded] fp32, the cache)."""
    dec = params["decoder"]
    B, S = tokens.shape
    n_head = cfg.n_text_head
    if cross_group > 1:
        if B % cross_group:
            raise ValueError(f"batch {B} not divisible by cross_group "
                             f"{cross_group}")
        if cross_group * S * n_head > LANE:
            raise ValueError(
                f"cross_group·S·H = {cross_group * S * n_head} > {LANE}: "
                f"grouped cross-attention needs one lane tile (tile the "
                f"cross-KV per row instead for this beam size)")
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
        return _decode_flat_ro(cfg, params, x, pos, cache, cross_kv,
                               cross_group)

    # Long prefill (S·H > 128): write the block into the cache, then attend
    # over the head views with a causal mask, per row. The reference's
    # dynamic_update_slice clamps each row's start to max_len - S; the mask
    # keeps the unclamped pos.
    row_pos = pos if per_row else torch.full((B,), pos, device=x.device)
    q_idx = torch.arange(S, device=x.device)
    self_mask = (torch.arange(max_len, device=x.device)
                 <= (row_pos[:, None] + q_idx)[..., None])[:, None]
    rows = row_pos.clamp(max=max_len - S)[:, None] + q_idx     # [B, S]
    batch = torch.arange(B, device=x.device)[:, None]
    dh = cfg.n_text_state // n_head
    tp, n_head = _decoder_tp(cfg, params)        # the rank's heads from here
    _check_cache_heads(cfg, cache, n_head)

    def write(buf, new):
        buf[batch, rows] = new

    for l, lp in enumerate(_layers(dec["layers"])):
        h = copy_to_model(layer_norm(x, lp["ln1_scale"], lp["ln1_bias"]), tp)
        q = _mm(h, lp["q_w"], lp["q_b"])                 # [B, S, HD]
        k, v, ks, vs = _write_self_kv(cache, l, h, lp, n_head, write)
        attn = _attend_views(
            q.view(B, S, n_head, dh), k.view(B, max_len, n_head, dh),
            v.view(B, max_len, n_head, dh), self_mask, ks=ks, vs=vs)
        x = x + _row(attn, lp["o_w"], tp) + lp["o_b"]
        h = copy_to_model(layer_norm(x, lp["ln2_scale"], lp["ln2_bias"]), tp)
        xq = _mm(h, lp["xq_w"], lp["xq_b"])               # [B, S, HD]
        xk, xv, xks, xvs = _kv_at(cross_kv, l)
        T_a = xk.shape[1]
        attn = _attend_views(
            xq.view(B, S, n_head, dh), xk.view(B, T_a, n_head, dh),
            xv.view(B, T_a, n_head, dh), None, ks=xks, vs=xvs)
        x = x + _row(attn, lp["xo_w"], tp) + lp["xo_b"]
        h = layer_norm(x, lp["ln3_scale"], lp["ln3_bias"])
        x = x + _mlp(h, lp, tp)
    return _logits(cfg, dec, x), cache


def decode_teacher_forced(cfg: WhisperConfig, params: Params, cross_kv,
                          tokens: torch.Tensor) -> torch.Tensor:
    """The decoder over a whole token block from position 0, each token
    seeing the ones before it: tokens [B, S] and the fp cross K/V
    (KVCache) → logits [B, S, n_vocab_padded] fp32. Differentiable: the
    function of the reference's `decode` over an empty cache of S rows (its
    flat path for S·H <= 128, the long prefill above it), in plain PyTorch
    (`_attend_views`) with no cache and no decode kernel. `forward` and
    training/distill.py share it."""
    dec = params["decoder"]
    B, S = tokens.shape
    dh = cfg.n_text_state // cfg.n_text_head
    tp, n_head = _decoder_tp(cfg, params)
    T_a = cross_kv.k.shape[2]
    x = dec["tok_emb"][tokens]
    x = x + dec["pos_emb"][:S].to(x.dtype)
    causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    heads = lambda t, T: t.view(B, T, n_head, dh)
    for l, lp in enumerate(_layers(dec["layers"])):
        h = copy_to_model(layer_norm(x, lp["ln1_scale"], lp["ln1_bias"]), tp)
        attn = _attend_views(heads(h @ lp["q_w"] + lp["q_b"], S),
                             heads(h @ lp["k_w"], S),
                             heads(h @ lp["v_w"] + lp["v_b"], S), causal)
        x = x + _row(attn, lp["o_w"], tp) + lp["o_b"]
        h = copy_to_model(layer_norm(x, lp["ln2_scale"], lp["ln2_bias"]), tp)
        attn = _attend_views(heads(h @ lp["xq_w"] + lp["xq_b"], S),
                             heads(cross_kv.k[l], T_a),
                             heads(cross_kv.v[l], T_a), None)
        x = x + _row(attn, lp["xo_w"], tp) + lp["xo_b"]
        h = layer_norm(x, lp["ln3_scale"], lp["ln3_bias"])
        x = x + _mlp(h, lp, tp)
    return _logits(cfg, dec, x)


def forward(cfg: WhisperConfig, params: Params, mel: torch.Tensor,
            tokens: torch.Tensor) -> torch.Tensor:
    """Teacher-forced forward (training): mel [B, n_mels, 3000], tokens
    [B, S] → logits [B, S, n_vocab_padded] fp32. Differentiable.

    The reference (model.py:forward) runs `decode` over an empty cache of
    S rows with the fp cross-KV. Here the decoder half is
    `decode_teacher_forced`: the block's own S keys under a causal mask in
    plain PyTorch, which is the function of both of the reference's
    branches (XLA einsums on the TPU too). It does not go through `decode`:
    the decode kernels have no backward, and the cache writes in place
    would break autograd's version checks. The encoder's attention runs on
    the flash kernels, backward included."""
    feats = encode(cfg, params, mel)
    return decode_teacher_forced(cfg, params,
                                 compute_cross_kv(cfg, params, feats), tokens)
