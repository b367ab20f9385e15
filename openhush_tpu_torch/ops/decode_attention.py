"""Single-query decode attention on the hand-written CUDA kernel
(csrc/decode_attention.cu): kernels K4 and K5 of the port.

Counterparts of openhush_tpu/ops/decode_attention.py:decode_cross_attend
(K4, direct loads) and openhush_tpu/ops/decode_attention_dma.py:
decode_cross_attend_dma (K5, its pipelined load path). Both compute the
same function: `attend_decode` launches K4, one CTA per query streaming
the keys; `attend_decode_pipelined` launches K5, a cluster of 8 CTAs per
query (and per pair of heads, for int8 K/V and an even head count), each
holding a slice of the keys, with the softmax combined across the
cluster. The two are not equal bit for bit (K5 sums the softmax's
denominator in another order, which can move an int8 prob level at an
exact .5 tie), but each is within the plain version's tolerance, and K5
gives the same bits on every launch. With S > 1 queries a row and causal
off, `attend_decode_pipelined` takes K5's multi-query mode,
`attend_decode_multi`: one cluster per row (and pair of heads) for all S
queries, reading the row's keys once (the JAX model's
_attend_decode_flat_multi reads the cache once for its S queries), each
query's output and probs the bits of a K5 launch of that query alone.
The decode step (models/whisper/model.py:_decode_flat_ro) runs the
self-attention on K4 and the cross-attention on K5; the grouped beam
step's K beams and a verify block's S queries take the multi-query mode.
`attend_decode_beam` is K4's beam mode: the
grouped beam step's self-attention (model.py:decode_beam_step), where
each of a group's K beams reads, at each position, the one cache row of
the group that its ancestry selects there: a source-row table that
`ancestry_rows` builds from the ancestry mask once a step.

Three functions, each with its plain PyTorch version here:
- `attend_decode_plain` is the production arithmetic of the JAX decode step
  (model.py:_attend_decode_flat, _attend_decode_flat_multi and
  _attend_decode_flat_ro), per query, with per-row key lengths;
- `attend_decode_beam_plain` is the same arithmetic over each beam's
  visible keys, addressed through the source-row table (the JAX model's
  _attend_decode_flat_beam under the ancestry mask the table came from);
- `decode_cross_attend_plain` is the TPU kernel's own function: q comes
  pre-scaled, no scales are applied, int8 values are taken as numbers.
CPU tensors take the plain versions; CUDA tensors launch the kernel or
raise.
"""

from __future__ import annotations

import torch

from openhush_tpu_torch.ops import _build

HEAD_DIM = 64            # the only head size the kernel takes (every Whisper)
MAX_SMEM = 200 * 1024    # K4's dynamic shared memory, at most
STAGES = 4               # K4's ring: at least one 2 KB pass per stage
MAX_SMEM_SPLIT = 200 * 1024   # K5's, at most
CLUSTER = 8              # K5's CTAs per query (per row, multi), each a slice
S_MAX = 6                # K5's multi-query mode: queries a block
WARPS = 4                # K5's CTA: 128 threads
TAB_MAX = 512            # K4's beam mode: positions of a table row, at most
NEG = torch.finfo(torch.float32).min    # mask fill, as jnp.finfo(f32).min
_QO = {torch.float32: 0, torch.bfloat16: 1}
_KV_FLOAT = {torch.bfloat16: 2, torch.float32: 3}

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


def div127(x: torch.Tensor) -> torch.Tensor:
    """x / 127 as an IEEE divide on every device. On a CUDA tensor,
    `x / 127.0` multiplies by a rounded 1/127 instead (PyTorch's rewrite
    for a host scalar divisor), which moves a scale by one ulp and an int8
    level at a .5 tie: the reference's recipes divide."""
    return x / torch.full((), 127.0, dtype=x.dtype, device=x.device)


def _quantize_query(q3: torch.Tensor, n_head: int):
    """Per-(row, query, head) int8 query quantization of the decode paths:
    max(·, 1e-10) / 127 with a divide (not quantize_heads' recipe)."""
    B, S, HD = q3.shape
    qh = q3.float().view(B, S, n_head, HD // n_head)
    qscale = div127(torch.clamp(qh.abs().amax(dim=-1), min=1e-10))
    q8 = torch.clamp(torch.round(qh / qscale[..., None]), -127, 127)
    return q8, qscale


def _visible(lengths, B: int, S: int, T: int, causal: bool, device):
    """[B|1, T, S, 1] bool: key t is visible to query s of row b iff
    t < lengths[b] + (s if causal else 0). None when every key is."""
    if lengths is None:
        return None
    n = torch.as_tensor(lengths, device=device).reshape(-1, 1)     # [B|1, 1]
    if causal:
        n = n + torch.arange(S, device=device)[None, :]            # [B|1, S]
    t = torch.arange(T, device=device)[None, :, None]
    return (t < n[:, None, :])[..., None]


def attend_decode_plain(q3: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        lengths, n_head: int, *, ks=None, vs=None,
                        causal: bool = False, return_probs: bool = False):
    """S queries per row over a flat cache: q3 [B, S, H*D]; k, v [B, T, H*D]
    (int8 with scales ks, vs [B, T, H], or float); lengths: None (every key
    visible), an int, or an int [B] tensor; query s sees keys
    t < lengths[b] + (s if causal else 0). Returns [B, S, H*D] in q3's dtype.

    int8: the query is quantized per (row, query, head), the score and value
    products are integer-exact, the scales fold into scores and probs, and
    probs are quantized per (row, query, head) with the joint scale
    max_t(p·vs) / 127. Float: probs are cast to the value dtype before the
    value product. return_probs: also return the probs the value product
    takes, [B, S, H, T] fp32 (int8 levels in the int8 mode), for checks."""
    mask = _visible(lengths, *q3.shape[:2], k.shape[1], causal, q3.device)
    return _attend_plain(q3, k, v, mask, n_head, ks, vs, return_probs)


def ancestry_rows(anc: torch.Tensor) -> torch.Tensor:
    """The source-row table of an ancestry: anc bool [G, K, K, T] (or
    [G, K, K*T]), beam i of group g reads position t of the group's cache
    row r iff anc[g, i, r, t] → rows int8 [G, K, T], that r, or -1 where
    no row is set. model.beam_ancestry, beam_own and beam._gather_beams
    set at most one row for each (group, beam, position); this is not
    checked here (a check on the card would cost a sync a step)."""
    G, K = anc.shape[:2]
    anc = anc.view(G, K, K, -1)
    r = torch.arange(K, dtype=torch.int8, device=anc.device).view(1, 1, K, 1)
    return torch.where(anc, r, -1).amax(dim=2)


def attend_decode_beam_plain(q3: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, rows: torch.Tensor,
                             lengths: torch.Tensor, n_head: int, *,
                             ks=None, vs=None, return_probs: bool = False):
    """The grouped beam step's self-attention: q3 [G, K, H*D], one query a
    beam; k, v [G, K*T, H*D], the group's K cache rows of T positions as
    one row of keys (int8 with scales ks, vs [G, K*T, H], or float); rows
    int8 [G, K, T] (ancestry_rows) and lengths int [G]: key t < lengths[g]
    of beam i is position t of the group's cache row rows[g, i, t] (flat
    key rows*T + t), none where that is -1. Each beam's keys are gathered
    by position, then take attend_decode_plain's arithmetic with the
    reference's finfo(f32).min fill on the hidden ones: the function of
    _attend_decode_flat_beam under the mask `rows` came from, whose cache
    mask and identity block over the new keys are one mask here (the
    caller writes each beam's new key into the cache first and sets its
    own bit, model.decode_beam_step). return_probs: the probs by position,
    [G, K, H, T]."""
    G, K, HD = q3.shape
    T = rows.shape[-1]
    t = torch.arange(T, device=rows.device)
    seen = (rows >= 0) & (t < torch.as_tensor(lengths).view(G, 1, 1))
    src = rows.long().clamp(min=0) * T + t                     # [G, K, T]
    at = lambda x: None if x is None else x[
        torch.arange(G, device=x.device)[:, None, None], src].view(
            G * K, T, -1)
    out = _attend_plain(q3.reshape(G * K, 1, HD), at(k), at(v),
                        seen.view(G * K, T, 1, 1), n_head, at(ks), at(vs),
                        return_probs)
    if return_probs:
        return out[0].view(G, K, HD), out[1].view(G, K, n_head, T)
    return out.view(G, K, HD)


def _attend_plain(q3, k, v, mask, n_head: int, ks, vs, return_probs: bool):
    """attend_decode_plain's arithmetic under `mask` ([B|1, T, S, 1] bool:
    key t visible to query s of row b; None: every key)."""
    B, S, HD = q3.shape
    D = HD // n_head
    T = k.shape[1]
    k4 = k.view(B, T, n_head, D)
    v4 = v.view(B, T, n_head, D)
    quant = k.dtype == torch.int8
    if quant:
        q8, qscale = _quantize_query(q3, n_head)
        scores = torch.einsum("bthd,bshd->btsh", k4.float(), q8)
        scores = (scores * ks[:, :, None, :]
                  * qscale[:, None, :, :] * (D ** -0.5))
    else:
        scores = torch.einsum("bthd,bshd->btsh", k4.float(),
                              q3.float().view(B, S, n_head, D)) * (D ** -0.5)
    if mask is not None:
        scores = torch.where(mask, scores, NEG)
    probs = torch.softmax(scores, dim=1)                 # over T
    if quant:
        pv = probs * vs[:, :, None, :]                   # [B, T, S, H]
        pscale = div127(torch.clamp(pv.amax(dim=1), min=1e-20))  # [B, S, H]
        p = torch.clamp(torch.round(pv / pscale[:, None]), -127, 127)
        out = _exact_pv(p, v4).float() * pscale[..., None]
    else:
        p = probs.to(v.dtype).float()
        out = torch.einsum("btsh,bthd->bshd", p, v4.float())
    out = out.reshape(B, S, HD).to(q3.dtype)
    return (out, p.permute(0, 2, 3, 1)) if return_probs else out


def decode_cross_attend_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, n_heads: int,
                              t_actual: int | None = None) -> torch.Tensor:
    """The TPU kernel's function: q [B, H*D] (scales and 1/sqrt(D) folded in
    by the caller), k, v [B, T, H*D] int8 or bf16 taken as plain numbers,
    keys t < t_actual → [B, H*D] bf16. Operands are rounded to bf16 and the
    probs are rounded to bf16 before the value product, as the kernel's MXU
    dots take them."""
    B, HD = q.shape
    T = k.shape[1]
    D = HD // n_heads
    qf = q.to(torch.bfloat16).float().view(B, n_heads, D)
    kf = k.to(torch.bfloat16).float().view(B, T, n_heads, D)
    vf = v.to(torch.bfloat16).float().view(B, T, n_heads, D)
    scores = torch.einsum("bthd,bhd->bth", kf, qf)
    if t_actual is not None and t_actual < T:
        scores[:, t_actual:] = NEG
    probs = torch.softmax(scores, dim=1).to(torch.bfloat16).float()
    return torch.einsum("bth,bthd->bhd", probs, vf).reshape(B, HD).to(
        torch.bfloat16)


def _split_smem(T: int, esize: int, G: int, S: int, multi: bool,
                quant: bool) -> int:
    """K5's dynamic shared memory (csrc/decode_attention.cu, SplitSmem) for
    G heads a cluster and elements of esize bytes: a slice's rows (two
    slices when the multi-query mode walks more than S_MAX queries), a
    block's value sums by warp (the multi-query int8 mode: by quad of rows,
    over slices padded to whole quads, with its levels packed as bytes)
    and every rank's (two buffers when walking), its scores, and ks and
    vs."""
    per = -(-T // CLUSTER)
    nq = min(S, S_MAX) if multi else 1
    bufs = 2 if multi and S > S_MAX else 1
    packed = multi and quant
    rows = -(-per // 4) * 4 if packed else per
    # A query's value sums: 4 a thread (packed), else a warp's a column.
    sums = 4 * 32 * WARPS if packed else WARPS * G * HEAD_DIM
    return (bufs * rows * HEAD_DIM * esize * G
            + (sums + bufs * CLUSTER * G * HEAD_DIM) * nq * 4
            + nq * per * G * 4 + 2 * per * G * 4
            + (nq * G * rows if packed else 0))


def _launch(q3, k, v, lengths, n_head, ks, vs, causal, sm_scale, kv_kind,
            pipelined: int, name: str, return_probs: bool = False,
            rows=None):
    """Check the operands and launch the kernel; returns [B, S, H*D] in
    q3's dtype (and the probs, as attend_decode_plain). `pipelined`: 0 K4,
    1 K5 (a cluster per query), 2 K5's multi-query mode (a cluster per
    row; causal off). `rows` (K4 only, the beam mode): int8 [B, S, T], row
    b a group of S beams over k, v [B, S*T, H*D] and `lengths` an int32
    [B] tensor, as attend_decode_beam_plain takes them."""
    B, S, HD = q3.shape
    keys = k.shape[1]
    T = keys if rows is None else rows.shape[-1]
    if HD != n_head * HEAD_DIM:
        raise ValueError(f"{name}: width {HD} with {n_head} heads; the "
                         f"kernel takes head_dim {HEAD_DIM}")
    if q3.dtype not in _QO or k.shape != (B, keys, HD) or v.shape != k.shape \
            or v.dtype != k.dtype:
        raise ValueError(f"{name}: q {q3.dtype} {tuple(q3.shape)}, k/v "
                         f"{k.dtype} {tuple(k.shape)}/{tuple(v.shape)}")
    if pipelined == 2 and causal:
        raise ValueError(f"{name}: K5's multi-query mode takes no causal "
                         f"offset")
    if pipelined:      # one head a cluster, the least
        fits = _split_smem(T, k.element_size(), 1, S, pipelined == 2,
                           kv_kind == 0) <= MAX_SMEM_SPLIT
    else:              # every key's score (and ks, vs; the table's row), one
        tail = T * 4 * (3 if kv_kind == 0 else 1)      # ring of passes
        if rows is not None:
            tail += -(-T // 16) * 16
        fits = tail + STAGES * 2048 <= MAX_SMEM
    if not fits:
        raise ValueError(f"{name}: T={T} keys do not fit the kernel's "
                         f"shared memory")
    tensors = [q3, k, v]
    if kv_kind == 0:
        if ks is None or vs is None or ks.shape != (B, keys, n_head) \
                or vs.shape != ks.shape or ks.dtype != torch.float32 \
                or vs.dtype != torch.float32:
            raise ValueError(f"{name}: int8 K/V need fp32 scales "
                             f"[{B}, {keys}, {n_head}]")
        tensors += [ks, vs]
    len_ptr, len_default = None, T
    if isinstance(lengths, int):
        len_default = lengths
    elif lengths is not None:
        if lengths.dtype != torch.int32 or lengths.shape != (B,):
            raise ValueError(f"{name}: lengths must be int32 [{B}]")
        tensors.append(lengths)
        len_ptr = lengths.data_ptr()
    if rows is not None:
        if pipelined or kv_kind == 1 or causal or len_ptr is None \
                or rows.dtype != torch.int8 or rows.shape != (B, S, T) \
                or keys != S * T or T > TAB_MAX:
            raise ValueError(
                f"{name}: the beam mode takes rows int8 [{B}, {S}, T] with "
                f"T <= {TAB_MAX} positions over {S}*T keys and int32 "
                f"lengths [{B}], on the direct path; got rows {rows.dtype} "
                f"{tuple(rows.shape)} over {keys} keys")
        tensors.append(rows)
    for t in tensors:
        if t.device != q3.device or not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous on "
                             f"{q3.device}")
    for t in (k, v):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: K/V must be 16-byte aligned")
    out = torch.empty_like(q3)
    probs = (torch.empty(B, S, n_head, T, dtype=torch.float32,
                         device=q3.device) if return_probs else None)
    err = _build.library().oh_decode_attention(
        q3.data_ptr(), k.data_ptr(), v.data_ptr(),
        ks.data_ptr() if kv_kind == 0 else None,
        vs.data_ptr() if kv_kind == 0 else None,
        len_ptr, len_default, int(causal),
        rows.data_ptr() if rows is not None else None, out.data_ptr(),
        probs.data_ptr() if return_probs else None, B, S, n_head, T,
        sm_scale, kv_kind, _QO[q3.dtype], int(pipelined),
        torch.cuda.current_stream(q3.device).cuda_stream)
    _build.check(err, "oh_decode_attention")
    return (out, probs) if return_probs else out


def _no_gradient(name, *tensors):
    """The decode kernels have no backward: raise rather than let autograd
    see an output with no grad_fn and drop the gradient without a word."""
    if torch.is_grad_enabled() and any(
            torch.is_tensor(t) and t.requires_grad for t in tensors):
        raise RuntimeError(f"{name} has no backward; call it under "
                           f"torch.no_grad() (decoding needs no gradient)")


def _attend(q3, k, v, lengths, n_head, ks, vs, causal, pipelined: int, name,
            return_probs, rows=None):
    if q3.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q3.device}")
    if k.dtype == torch.int8:
        kv_kind = 0
    elif k.dtype in _KV_FLOAT:
        kv_kind = _KV_FLOAT[k.dtype]
    else:
        raise ValueError(f"{name}: K/V dtype {k.dtype}")
    return _launch(q3, k, v, lengths, n_head, ks, vs, causal,
                   (q3.shape[-1] // n_head) ** -0.5, kv_kind, pipelined, name,
                   return_probs, rows)


def attend_decode(q3: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  lengths, n_head: int, *, ks=None, vs=None,
                  causal: bool = False, return_probs: bool = False):
    """Same function as `attend_decode_plain`. CPU tensors take the plain
    version; CUDA tensors launch the kernel's direct load path (K4). A
    `lengths` tensor must be int32; every query must see at least one key.
    Raises if an input needs a gradient: neither path has a backward."""
    _no_gradient("attend_decode", q3, k, v, ks, vs)
    if q3.device.type == "cpu":
        return attend_decode_plain(q3, k, v, lengths, n_head, ks=ks, vs=vs,
                                   causal=causal, return_probs=return_probs)
    out = _attend(q3, k, v, lengths, n_head, ks, vs, causal, 0,
                  "attend_decode", return_probs)
    attend_decode.launches += 1
    return out


def attend_decode_pipelined(q3: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, lengths, n_head: int, *,
                            ks=None, vs=None, causal: bool = False,
                            return_probs: bool = False):
    """Same function as `attend_decode`, on K5: a cluster of 8 CTAs per
    query, each loading a slice of the keys at once; with S > 1 queries a
    row and causal off (a beam group's folded queries, a verify block, a
    prefill's cross-attention), `attend_decode_multi`: a cluster per row
    for all S, which reads the row's keys once. Within the plain version's
    tolerance, and the same bits on every launch."""
    _no_gradient("attend_decode_pipelined", q3, k, v, ks, vs)
    if q3.device.type == "cpu":
        return attend_decode_plain(q3, k, v, lengths, n_head, ks=ks, vs=vs,
                                   causal=causal, return_probs=return_probs)
    S, T = q3.shape[1], k.shape[1]
    if S > 1 and not causal and _split_smem(
            T, k.element_size(), 1, S, True,
            k.dtype == torch.int8 and ks is not None) <= MAX_SMEM_SPLIT:
        out = attend_decode_multi(q3, k, v, lengths, n_head, ks=ks, vs=vs,
                                  return_probs=return_probs)
    else:
        out = _attend(q3, k, v, lengths, n_head, ks, vs, causal, 1,
                      "attend_decode_pipelined", return_probs)
    attend_decode_pipelined.launches += 1
    return out


def attend_decode_multi(q3: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        lengths, n_head: int, *, ks=None, vs=None,
                        return_probs: bool = False):
    """K5's multi-query mode: the function of `attend_decode_plain` with
    causal off (every query of a row sees the row's keys), on one cluster
    of 8 CTAs per (pair of heads, row) that loads the row's keys once for
    all its S queries (in blocks of S_MAX). Each query's output and probs
    equal, bit for bit, those of a K5 launch of that query alone. CPU
    tensors take the plain version."""
    _no_gradient("attend_decode_multi", q3, k, v, ks, vs)
    if q3.device.type == "cpu":
        return attend_decode_plain(q3, k, v, lengths, n_head, ks=ks, vs=vs,
                                   return_probs=return_probs)
    out = _attend(q3, k, v, lengths, n_head, ks, vs, False, 2,
                  "attend_decode_multi", return_probs)
    attend_decode_multi.launches += 1
    return out


def attend_decode_beam(q3: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       rows: torch.Tensor, lengths: torch.Tensor,
                       n_head: int, *, ks=None, vs=None,
                       return_probs: bool = False):
    """Same function as `attend_decode_beam_plain`. CPU tensors take the
    plain version; CUDA tensors launch K4's beam mode (one CTA per (head,
    beam, group) on the direct path, reading only the rows the table
    names at positions t < lengths[g]). rows must be int8 [G, K, T] and
    lengths int32 [G]. Every query must see at least one key: the kernel
    writes zeros where none is visible, the plain version a uniform
    average."""
    _no_gradient("attend_decode_beam", q3, k, v, ks, vs)
    if q3.device.type == "cpu":
        return attend_decode_beam_plain(q3, k, v, rows, lengths, n_head,
                                        ks=ks, vs=vs,
                                        return_probs=return_probs)
    out = _attend(q3, k, v, lengths, n_head, ks, vs, False, 0,
                  "attend_decode_beam", return_probs, rows=rows)
    attend_decode_beam.launches += 1
    return out


def decode_cross_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        n_heads: int, t_actual: int | None = None, *,
                        pipelined: bool = False) -> torch.Tensor:
    """Same function as `decode_cross_attend_plain`: the kernel in float
    mode with sm_scale 1, every row's length t_actual, no scales. CPU
    tensors take the plain version."""
    if q.device.type == "cpu":
        return decode_cross_attend_plain(q, k, v, n_heads, t_actual)
    if q.device.type != "cuda":
        raise ValueError(f"decode_cross_attend: unsupported device "
                         f"{q.device}")
    if k.dtype not in (torch.int8, torch.bfloat16):
        raise ValueError(f"decode_cross_attend: K/V dtype {k.dtype}; the "
                         f"TPU kernel's function takes int8 or bf16")
    kv_kind = 1 if k.dtype == torch.int8 else 2
    B, HD = q.shape
    T = k.shape[1]
    out = _launch(q.to(torch.bfloat16).reshape(B, 1, HD), k, v,
                  t_actual if t_actual is not None else T, n_heads, None,
                  None, False, 1.0, kv_kind, int(pipelined),
                  "decode_cross_attend")
    decode_cross_attend.launches += 1
    return out.reshape(B, HD)


attend_decode.launches = 0
attend_decode_beam.launches = 0
attend_decode_pipelined.launches = 0
attend_decode_multi.launches = 0
decode_cross_attend.launches = 0
