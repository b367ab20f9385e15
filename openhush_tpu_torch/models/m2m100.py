"""M2M-100 many-to-many translation as a PyTorch seq2seq.

Counterpart of openhush_tpu/models/m2m100.py. The reference runs M2M-100
through ONNX Runtime with a greedy decode loop to 256 tokens and a
`__xx__`→id language-token table (src/translation/m2m100.rs:460-717, lang
table :351-458). Here the model is a dict of tensors in the JAX package's
layout (per-layer weights stacked on a leading [L] axis, linear weights
[in, out]), converted from HF M2M100ForConditionalGeneration checkpoints,
with a fixed-shape KV cache written in place.

Architecture facts targeted (verified against transformers' torch impl):
pre-LN blocks with final layer norms on both stacks, ReLU MLPs, fairseq
sinusoidal positions ([sin|cos] halves, offset 2, padding_idx 1 zeroed,
position ids = cumsum(non-pad) + padding_idx), sqrt(d) embedding scale,
biased q/k/v/out projections, tied unembedding in fp32.

Attention is the reference's `whisper._attend` in plain PyTorch (fp32
scores and softmax, a mask fill of finfo(float32).min, not -inf): the JAX
package runs it as XLA einsums, no Pallas kernel, so no hand-written kernel
and no library attention (SDPA) stands in for it here. The greedy loop is
a host loop that stops once every row has emitted EOS, as the reference's
`while_loop` does (one host sync a step).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from openhush_tpu_torch.device import resolve_device
from openhush_tpu_torch.models.whisper.model import (KVCache, _layers,
                                                     _merge_heads,
                                                     _split_heads,
                                                     layer_norm)
from openhush_tpu_torch.models.whisper.weights import from_numpy_params

PAD = 1
EOS = 2
MAX_NEW_TOKENS = 256   # parity: greedy loop cap (m2m100.rs:634-703)
NEG = torch.finfo(torch.float32).min

# The 100 language codes (FLORES-101 order as used by M2M-100's tokenizer;
# token id = vocab_base + index, `__xx__` form). Parity: lang table
# m2m100.rs:351-458.
LANG_CODES = (
    "af am ar ast az ba be bg bn br bs ca ceb cs cy da de el en es et fa "
    "ff fi fr fy ga gd gl gu ha he hi hr ht hu hy id ig ilo is it ja jv "
    "ka kk km kn ko lb lg ln lo lt lv mg mk ml mn mr ms my ne nl no ns "
    "oc or pa pl ps pt ro ru sd si sk sl so sq sr ss su sv sw ta th tl tn "
    "tr uk ur uz vi wo xh yi yo zh zu").split()


@dataclasses.dataclass(frozen=True)
class M2MConfig:
    name: str = "418M"
    vocab_size: int = 128112
    d_model: int = 1024
    n_heads: int = 16
    n_enc_layers: int = 12
    n_dec_layers: int = 12
    ffn_dim: int = 4096
    max_positions: int = 1024
    lang_token_base: int = 128004   # id of "__af__" (first lang token)

    @property
    def vocab_padded(self) -> int:
        return ((self.vocab_size + 127) // 128) * 128


CONFIGS = {
    "418M": M2MConfig(),
    "1.2B": M2MConfig(name="1.2B", n_enc_layers=24, n_dec_layers=24,
                      ffn_dim=8192),
    "test": M2MConfig(name="test", vocab_size=1000, d_model=64, n_heads=2,
                      n_enc_layers=2, n_dec_layers=2, ffn_dim=128,
                      lang_token_base=900),
}


def lang_token_id(cfg: M2MConfig, code: str) -> int:
    try:
        return cfg.lang_token_base + LANG_CODES.index(code)
    except ValueError:
        raise ValueError(f"unknown M2M-100 language {code!r}") from None


def sinusoidal_positions(n: int, dim: int) -> np.ndarray:
    """fairseq layout: [sin | cos] halves, padding_idx row zeroed."""
    half = dim // 2
    freq = np.exp(np.arange(half) * -(np.log(10000.0) / (half - 1)))
    ang = np.arange(n)[:, None] * freq[None, :]
    emb = np.concatenate([np.sin(ang), np.cos(ang)], axis=1)
    if dim % 2 == 1:
        emb = np.concatenate([emb, np.zeros((n, 1))], axis=1)
    emb[PAD, :] = 0.0
    return emb.astype(np.float32)


def _position_ids(tokens: torch.Tensor, past: int = 0) -> torch.Tensor:
    """cumsum(non-pad)*mask + PAD (+past) — pads stay at PAD position."""
    mask = (tokens != PAD).long()
    return (torch.cumsum(mask, dim=1) + past) * mask + PAD


def init_params(cfg: M2MConfig, generator: torch.Generator,
                dtype: torch.dtype = torch.float32, device=None) -> dict:
    """Random-init parameters in the reference layout: linear weights
    N(0, 1/fan_in), biases zero, layer norms identity, the vocabulary's
    padding rows and PAD's row of the embedding zero. The draws come from
    `generator` (on `device`) and differ from JAX's PRNG."""
    device = resolve_device(device)

    def g(*shape):
        w = torch.randn(shape, generator=generator, device=device)
        return (w * shape[-2] ** -0.5).to(dtype)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    def attn(L, d, x=""):
        return {f"{x}{n}_{k}": (g(L, d, d) if k == "w" else zeros(L, d))
                for n in "qkvo" for k in "wb"}

    def ln(L, d, n):
        return {f"{n}_scale": torch.ones(L, d, dtype=dtype, device=device),
                f"{n}_bias": zeros(L, d)}

    def mlp(L, d, f):
        return {"fc1_w": g(L, d, f), "fc1_b": zeros(L, f),
                "fc2_w": g(L, f, d), "fc2_b": zeros(L, d)}

    d, f = cfg.d_model, cfg.ffn_dim
    Le, Ld = cfg.n_enc_layers, cfg.n_dec_layers
    tok = g(cfg.vocab_padded, d)
    tok[cfg.vocab_size:] = 0
    tok[PAD] = 0
    stack_ln = {"ln_scale": torch.ones(d, dtype=dtype, device=device),
                "ln_bias": zeros(d)}
    return {
        "tok_emb": tok,
        "pos_emb": torch.from_numpy(sinusoidal_positions(
            cfg.max_positions + 2, d)).to(device=device, dtype=dtype),
        "encoder": {
            "layers": {**attn(Le, d), **ln(Le, d, "ln1"), **mlp(Le, d, f),
                       **ln(Le, d, "ln2")},
            **stack_ln,
        },
        "decoder": {
            "layers": {**attn(Ld, d), **ln(Ld, d, "ln1"), **attn(Ld, d, "x"),
                       **ln(Ld, d, "ln2"), **mlp(Ld, d, f),
                       **ln(Ld, d, "ln3")},
            **{k: v.clone() for k, v in stack_ln.items()},
        },
    }


def _attend(q, k, v, mask=None):
    """q,k,v: [B,H,T,Dh]. Scores and softmax in fp32, masked keys filled
    with finfo(float32).min. Returns [B,H,Tq,Dh] in q's dtype."""
    dh = q.shape[-1]
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) \
        * dh ** -0.5
    if mask is not None:
        scores = torch.where(mask, scores, NEG)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v)


def _proj(x, lp, name):
    return x @ lp[f"{name}_w"] + lp[f"{name}_b"]


def encode(cfg: M2MConfig, params: dict, tokens: torch.Tensor
           ) -> torch.Tensor:
    """tokens [B, S] → features [B, S, d] (pads attend-masked)."""
    tokens = tokens.long()
    x = params["tok_emb"][tokens] * cfg.d_model ** 0.5
    x = x + params["pos_emb"][_position_ids(tokens)].to(x.dtype)
    pad_mask = (tokens != PAD)[:, None, None, :]    # [B,1,1,S]
    n_head = cfg.n_heads
    for lp in _layers(params["encoder"]["layers"]):
        h = layer_norm(x, lp["ln1_scale"], lp["ln1_bias"])
        q, k, v = (_split_heads(_proj(h, lp, n), n_head) for n in "qkv")
        x = x + _proj(_merge_heads(_attend(q, k, v, pad_mask)), lp, "o")
        h = layer_norm(x, lp["ln2_scale"], lp["ln2_bias"])
        h = torch.relu(_proj(h, lp, "fc1"))
        x = x + _proj(h, lp, "fc2")
    return layer_norm(x, params["encoder"]["ln_scale"],
                      params["encoder"]["ln_bias"])


def compute_cross_kv(cfg: M2MConfig, params: dict,
                     features: torch.Tensor) -> KVCache:
    """Per-layer cross-attention K/V, [L, B, H, S, Dh]."""
    n_head = cfg.n_heads
    ks, vs = zip(*((_split_heads(_proj(features, lp, "xk"), n_head),
                    _split_heads(_proj(features, lp, "xv"), n_head))
                   for lp in _layers(params["decoder"]["layers"])))
    return KVCache(torch.stack(ks), torch.stack(vs))


def init_kv_cache(cfg: M2MConfig, batch: int, max_len: int = MAX_NEW_TOKENS,
                  dtype=torch.float32, device=None) -> KVCache:
    shape = (cfg.n_dec_layers, batch, cfg.n_heads, max_len,
             cfg.d_model // cfg.n_heads)
    device = resolve_device(device)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


def decode(cfg: M2MConfig, params: dict, tokens: torch.Tensor, pos: int,
           cache: KVCache, cross_kv: KVCache, src_tokens: torch.Tensor
           ) -> tuple[torch.Tensor, KVCache]:
    """tokens [B, S] at offset `pos` → (logits [B, S, Vp] fp32, cache). The
    S new keys and values are written into `cache` in place (the reference
    returns an updated copy)."""
    dec = params["decoder"]
    B, S = tokens.shape
    n_head = cfg.n_heads
    max_len = cache.k.shape[3]
    if pos + S > max_len:
        raise ValueError(f"positions {pos}..{pos + S - 1} past a cache of "
                         f"{max_len}")
    dev = tokens.device

    x = params["tok_emb"][tokens.long()] * cfg.d_model ** 0.5
    # Decoder positions: offset past non-pad counting (decode stream has no
    # pads, so positions = pos + 1 + arange + PAD).
    pos_ids = pos + 1 + torch.arange(S, device=dev) + PAD
    x = x + params["pos_emb"][pos_ids].to(x.dtype)

    key_idx = torch.arange(max_len, device=dev)[None, :]
    q_idx = torch.arange(S, device=dev)[:, None]
    self_mask = (key_idx <= pos + q_idx)[None, None]
    src_mask = (src_tokens != PAD)[:, None, None, :]

    for l, lp in enumerate(_layers(dec["layers"])):
        h = layer_norm(x, lp["ln1_scale"], lp["ln1_bias"])
        q = _split_heads(_proj(h, lp, "q"), n_head)
        cache.k[l, :, :, pos:pos + S] = _split_heads(_proj(h, lp, "k"),
                                                     n_head)
        cache.v[l, :, :, pos:pos + S] = _split_heads(_proj(h, lp, "v"),
                                                     n_head)
        x = x + _proj(_merge_heads(_attend(q, cache.k[l], cache.v[l],
                                           self_mask)), lp, "o")
        h = layer_norm(x, lp["ln2_scale"], lp["ln2_bias"])
        xq = _split_heads(_proj(h, lp, "xq"), n_head)
        x = x + _proj(_merge_heads(_attend(xq, cross_kv.k[l], cross_kv.v[l],
                                           src_mask)), lp, "xo")
        h = layer_norm(x, lp["ln3_scale"], lp["ln3_bias"])
        h = torch.relu(_proj(h, lp, "fc1"))
        x = x + _proj(h, lp, "fc2")
    x = layer_norm(x, dec["ln_scale"], dec["ln_bias"])
    logits = x.float() @ params["tok_emb"].float().T
    logits[..., cfg.vocab_size:] = NEG                  # vocab padding
    return logits, cache


@torch.no_grad()
def greedy_translate(cfg: M2MConfig, params: dict, src_tokens: torch.Tensor,
                     target_lang_token, *,
                     max_new: int = MAX_NEW_TOKENS) -> torch.Tensor:
    """Greedy decode: prompt [eos, lang] → tokens [B, max_new] until every
    row has emitted EOS (then EOS, and PAD past the last step); parity:
    greedy loop, m2m100.rs:634-703."""
    B = src_tokens.shape[0]
    dev = src_tokens.device
    feats = encode(cfg, params, src_tokens)
    xkv = compute_cross_kv(cfg, params, feats)
    cache = init_kv_cache(cfg, B, max_len=max_new + 2, dtype=feats.dtype,
                          device=dev)
    prompt = torch.stack([torch.full((B,), EOS, device=dev),
                          torch.full((B,), int(target_lang_token),
                                     device=dev)], dim=1)
    logits, cache = decode(cfg, params, prompt, 0, cache, xkv, src_tokens)
    out = torch.full((B, max_new), PAD, dtype=torch.long, device=dev)
    last = logits[:, -1]
    finished = torch.zeros(B, dtype=torch.bool, device=dev)
    step = 0
    while step < max_new and not bool(finished.all()):
        nxt = torch.argmax(last, dim=-1)
        nxt = torch.where(finished, EOS, nxt)
        out[:, step] = nxt
        finished |= nxt == EOS
        logits, cache = decode(cfg, params, nxt[:, None], 2 + step, cache,
                               xkv, src_tokens)
        last = logits[:, -1]
        step += 1
    return out


# ---------------------------------------------------------------------------
# HF checkpoint conversion
# ---------------------------------------------------------------------------

def from_hf_state_dict(sd: dict, cfg: M2MConfig, device=None) -> dict:
    """HF M2M100ForConditionalGeneration state dict (torch tensors or
    arrays) → our fp32 parameters on `device`, in the JAX package's
    layout."""
    if any(k.startswith("model.") for k in sd):
        sd = {k[len("model."):]: v for k, v in sd.items()
              if k.startswith("model.")}

    def _np(t):
        if torch.is_tensor(t):
            t = t.detach().cpu().float().numpy()
        return np.asarray(t, np.float32)

    def stack(L, tpl, tr=True):
        return np.stack([(_np(sd[tpl.format(i)]).T if tr
                          else _np(sd[tpl.format(i)])) for i in range(L)])

    def attn_block(pre, L, x=""):
        hf = {"q": "q_proj", "k": "k_proj", "v": "v_proj", "o": "out_proj"}
        out = {}
        for ours, theirs in hf.items():
            out[f"{x}{ours}_w"] = stack(L, f"{pre}.{theirs}.weight")
            out[f"{x}{ours}_b"] = stack(L, f"{pre}.{theirs}.bias", tr=False)
        return out

    def lns(pre, L, name):
        return {f"{name}_scale": stack(L, f"{pre}.weight", tr=False),
                f"{name}_bias": stack(L, f"{pre}.bias", tr=False)}

    def mlps(pre, L):
        return {"fc1_w": stack(L, f"{pre}.fc1.weight"),
                "fc1_b": stack(L, f"{pre}.fc1.bias", tr=False),
                "fc2_w": stack(L, f"{pre}.fc2.weight"),
                "fc2_b": stack(L, f"{pre}.fc2.bias", tr=False)}

    Le, Ld = cfg.n_enc_layers, cfg.n_dec_layers
    tok = _np(sd["shared.weight"] if "shared.weight" in sd
              else sd["encoder.embed_tokens.weight"])
    if tok.shape[0] < cfg.vocab_padded:
        tok = np.concatenate([tok, np.zeros(
            (cfg.vocab_padded - tok.shape[0], tok.shape[1]), tok.dtype)])
    tree = {
        "tok_emb": tok,
        "pos_emb": sinusoidal_positions(cfg.max_positions + 2, cfg.d_model),
        "encoder": {
            "layers": {
                **attn_block("encoder.layers.{}.self_attn", Le),
                **lns("encoder.layers.{}.self_attn_layer_norm", Le, "ln1"),
                **mlps("encoder.layers.{}", Le),
                **lns("encoder.layers.{}.final_layer_norm", Le, "ln2"),
            },
            "ln_scale": _np(sd["encoder.layer_norm.weight"]),
            "ln_bias": _np(sd["encoder.layer_norm.bias"]),
        },
        "decoder": {
            "layers": {
                **attn_block("decoder.layers.{}.self_attn", Ld),
                **lns("decoder.layers.{}.self_attn_layer_norm", Ld, "ln1"),
                **attn_block("decoder.layers.{}.encoder_attn", Ld, x="x"),
                **lns("decoder.layers.{}.encoder_attn_layer_norm", Ld,
                      "ln2"),
                **mlps("decoder.layers.{}", Ld),
                **lns("decoder.layers.{}.final_layer_norm", Ld, "ln3"),
            },
            "ln_scale": _np(sd["decoder.layer_norm.weight"]),
            "ln_bias": _np(sd["decoder.layer_norm.bias"]),
        },
    }
    return from_numpy_params(tree, device=device)


class M2M100Translator:
    """Engine used by postproc.translation when backend='m2m100'; needs a
    converted checkpoint + tokenizer files (m2m100.npz + tokenizer dir in
    the models directory). Runs on `device` (CUDA unless the caller asks
    for the CPU)."""

    def __init__(self, config, device=None):
        from openhush_tpu_torch.models.whisper.weights import load_npz
        from openhush_tpu_torch.runtime.engine import default_model_dir
        path = os.path.join(default_model_dir(), "m2m100.npz")
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"M2M-100 checkpoint not found: {path}\nConvert with: "
                f"python -m openhush_tpu.cli model convert-m2m100 "
                f"--hf-path /path/to/m2m100_418M")
        self.cfg = CONFIGS["418M"]
        self.device = resolve_device(device)
        self.params = from_numpy_params(load_npz(path), device=self.device)
        self.target = config.target_language
        tok_dir = os.path.join(default_model_dir(), "m2m100_tokenizer")
        from tokenizers import Tokenizer  # type: ignore
        self.tokenizer = Tokenizer.from_file(
            os.path.join(tok_dir, "tokenizer.json"))

    def translate(self, text: str, target: Optional[str] = None) -> str:
        ids = self.tokenizer.encode(text).ids[:self.cfg.max_positions - 2]
        src = torch.tensor([ids + [EOS]], device=self.device)
        lang = lang_token_id(self.cfg, target or self.target)
        out = greedy_translate(self.cfg, self.params, src, lang)[0]
        content = [int(t) for t in out.tolist() if t not in (PAD, EOS)]
        return self.tokenizer.decode(content)
