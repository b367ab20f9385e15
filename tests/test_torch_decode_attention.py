"""Port decode attention (openhush_tpu_torch.ops.decode_attention) against the
JAX package on the same inputs, made from a seed with numpy.

- `decode_cross_attend_plain` against the TPU kernel
  `openhush_tpu.ops.decode_attention.decode_cross_attend` in interpret mode,
  bf16 and int8 inputs, with t_actual below T. Tolerance 2e-2, as the
  reference's own test holds that kernel to a dense version (abs for bf16,
  relative to the output's peak for int8 values of magnitude ~100): both
  round probs and operands to bf16, the TPU kernel with online rescaling.
- `attend_decode_plain` against the production XLA paths of the JAX decode
  step, `_attend_decode_flat` (S=1), `_attend_decode_flat_multi` (S=3) and
  `_attend_decode_flat_ro` (the read-only cache plus the new keys, against
  the port's write-first-then-attend form), int8 with scales, bf16 and
  fp32, with per-row key lengths. Tolerance: fp32 atol 2e-6 (outputs of
  magnitude ~3; fp32 sums in another order); bf16 rtol 2^-7 (one ulp of the
  output) with atol 2e-3 (a prob whose fp32 value differs in the last place
  may round to the neighbouring bf16 value, which moves an output by one
  bf16 ulp of that prob, at most 2^-9, times |v|, a few units here). int8
  atol 1e-5: the integer products are exact on both sides and the fp32
  scale folds run in the same order, so the only difference is the
  softmax's sum order, which can move a prob's int8 level by one at a .5
  tie; no such tie occurs on these inputs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openhush_tpu.models.whisper import model as jax_model
from openhush_tpu.ops.decode_attention import decode_cross_attend as jax_dca
from openhush_tpu_torch.ops import decode_attention as da

H, D = 4, 64
HD = H * D


def _bf16_round(x):
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


@pytest.mark.parametrize("kind", ["bf16", "int8"])
@pytest.mark.parametrize("t_actual", [1024, 700])
def test_decode_cross_attend_plain_matches_tpu_kernel(kind, t_actual):
    B, T = 2, 1024                      # two T blocks of 512 in the kernel
    rng = np.random.default_rng(0)
    q = (rng.standard_normal((B, HD)) * 0.5).astype(np.float32)
    if kind == "int8":
        k = rng.integers(-100, 100, (B, T, HD)).astype(np.int8)
        v = rng.integers(-100, 100, (B, T, HD)).astype(np.int8)
        jk, jv = jnp.asarray(k), jnp.asarray(v)
        tk, tv = torch.from_numpy(k), torch.from_numpy(v)
    else:
        k = _bf16_round((rng.standard_normal((B, T, HD)) * 0.5
                         ).astype(np.float32))
        v = _bf16_round((rng.standard_normal((B, T, HD)) * 0.5
                         ).astype(np.float32))
        jk, jv = jnp.asarray(k, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16)
        tk = torch.from_numpy(k).to(torch.bfloat16)
        tv = torch.from_numpy(v).to(torch.bfloat16)
    ref = np.asarray(jax_dca(jnp.asarray(q), jk, jv, n_heads=H,
                             t_actual=t_actual, interpret=True),
                     np.float32)
    ours = da.decode_cross_attend_plain(torch.from_numpy(q), tk, tv, H,
                                        t_actual)
    assert ours.dtype == torch.bfloat16 and ours.shape == (B, HD)
    err = np.abs(ours.float().numpy() - ref).max()
    if kind == "int8":
        err /= np.abs(ref).max()
    assert err < 2e-2
    # The CPU wrapper is the plain version.
    assert torch.equal(da.decode_cross_attend(torch.from_numpy(q), tk, tv, H,
                                              t_actual), ours)


def _inputs(B, S, T, quant, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, HD)).astype(np.float32)
    if quant == "int8":
        k = rng.integers(-127, 128, (B, T, HD)).astype(np.int8)
        v = rng.integers(-127, 128, (B, T, HD)).astype(np.int8)
        ks = rng.uniform(0.005, 0.03, (B, T, H)).astype(np.float32)
        vs = rng.uniform(0.005, 0.03, (B, T, H)).astype(np.float32)
        return q, k, v, ks, vs
    k = rng.standard_normal((B, T, HD)).astype(np.float32)
    v = rng.standard_normal((B, T, HD)).astype(np.float32)
    return q, k, v, None, None


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


LENGTHS = np.array([96, 40, 1], np.int32)       # per-row visible keys


@pytest.mark.parametrize("kind", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("S", [1, 3])
def test_attend_decode_plain_matches_jax_flat(kind, S):
    """S=1 against `_attend_decode_flat`, S=3 against
    `_attend_decode_flat_multi`, every row with its own key count."""
    B, T = 3, 96
    q, k, v, ks, vs = _inputs(B, S, T, kind, seed=S)
    if kind == "bf16":
        j = lambda a: jnp.asarray(a, jnp.bfloat16)
        t = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    else:
        j, t = _j, _t
    mask = np.arange(T)[None, :] < LENGTHS[:, None]                 # [B, T]
    if S == 1:
        ref = jax_model._attend_decode_flat(
            j(q[:, 0]), j(k), j(v), jnp.asarray(mask), H, ks=_j(ks),
            vs=_j(vs))[:, None]
    else:
        mask4 = np.broadcast_to(mask[:, None, None, :], (B, 1, S, T))
        ref = jax_model._attend_decode_flat_multi(
            j(q), j(k), j(v), jnp.asarray(mask4), H, ks=_j(ks), vs=_j(vs))
    lengths = torch.from_numpy(LENGTHS)
    ours = da.attend_decode_plain(t(q), t(k), t(v), lengths, H, ks=_t(ks),
                                  vs=_t(vs))
    tol = {"fp32": dict(atol=2e-6), "int8": dict(atol=1e-5),
           "bf16": dict(rtol=2 ** -7, atol=2e-3)}[kind]
    np.testing.assert_allclose(ours.float().numpy(),
                               np.asarray(ref, np.float32), **tol)
    for fn in (da.attend_decode, da.attend_decode_pipelined):
        assert torch.equal(fn(t(q), t(k), t(v), lengths, H, ks=_t(ks),
                              vs=_t(vs)), ours)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_write_first_matches_jax_read_only_block(dtype):
    """The port's self-attention writes the S new keys at pos_row.. first
    and attends with query i seeing pos_row + i + 1 keys (causal); the
    reference attends over the read-only cache (keys < pos_row) plus the
    new block beside it, causal inside it."""
    B, S, T = 3, 3, 64
    pos = np.array([10, 0, 60], np.int64)
    rng = np.random.default_rng(7)
    cast = lambda a: torch.from_numpy(a).to(dtype).float().numpy()
    q = cast(rng.standard_normal((B, S, HD)).astype(np.float32))
    cache_k = cast(rng.standard_normal((B, T, HD)).astype(np.float32))
    cache_v = cast(rng.standard_normal((B, T, HD)).astype(np.float32))
    k_new = cast(rng.standard_normal((B, S, HD)).astype(np.float32))
    v_new = cast(rng.standard_normal((B, S, HD)).astype(np.float32))
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    cache_mask = np.arange(T)[None, :] < pos[:, None]
    ref = jax_model._attend_decode_flat_ro(
        jnp.asarray(q, jdt), jnp.asarray(cache_k, jdt),
        jnp.asarray(cache_v, jdt), jnp.asarray(cache_mask),
        jnp.asarray(k_new, jdt), jnp.asarray(v_new, jdt), H)
    k_w, v_w = cache_k.copy(), cache_v.copy()
    for b in range(B):
        k_w[b, pos[b]:pos[b] + S] = k_new[b]
        v_w[b, pos[b]:pos[b] + S] = v_new[b]
    conv = lambda a: torch.from_numpy(a).to(dtype)
    ours = da.attend_decode_plain(conv(q), conv(k_w), conv(v_w),
                                  torch.from_numpy(pos + 1), H, causal=True)
    assert ours.dtype == dtype
    tol = 2e-6 if dtype == torch.float32 else 1e-2   # one bf16 ulp at ~1
    np.testing.assert_allclose(ours.float().numpy(),
                               np.asarray(ref, np.float32), atol=tol)


def test_int_lengths_and_none_match_tensor_lengths():
    q, k, v, ks, vs = _inputs(2, 2, 32, "int8", seed=3)
    full = da.attend_decode_plain(_t(q), _t(k), _t(v), None, H, ks=_t(ks),
                                  vs=_t(vs))
    as_int = da.attend_decode_plain(_t(q), _t(k), _t(v), 32, H, ks=_t(ks),
                                    vs=_t(vs))
    as_row = da.attend_decode_plain(_t(q), _t(k), _t(v),
                                    torch.tensor([32, 32]), H, ks=_t(ks),
                                    vs=_t(vs))
    assert torch.equal(full, as_int) and torch.equal(full, as_row)
    causal = da.attend_decode_plain(_t(q), _t(k), _t(v), 5, H, ks=_t(ks),
                                    vs=_t(vs), causal=True)
    short = da.attend_decode_plain(_t(q[:, 1:]), _t(k), _t(v), 6, H,
                                   ks=_t(ks), vs=_t(vs))
    assert torch.equal(causal[:, 1:], short)
    # The probs the value sum takes: int8 levels, zero past each query's keys.
    _, p = da.attend_decode_plain(_t(q), _t(k), _t(v), 5, H, ks=_t(ks),
                                  vs=_t(vs), causal=True, return_probs=True)
    assert p.shape == (2, 2, H, 32) and bool((p == p.round()).all())
    assert p.abs().max() == 127 and p[:, 0, :, 5:].abs().sum() == 0
    assert p[:, 1, :, 6:].abs().sum() == 0


FLT_MAX = torch.finfo(torch.float32).max


def _model_scores(q3, k, ks):
    """The kernels' scores [B, T, S, H]: ((dot * ks) * qscale) * sm_scale
    with the int32 dot of the int8 levels, else (K . q) * sm_scale."""
    B, S, _ = q3.shape
    k4 = k.view(B, k.shape[1], H, D)
    if k.dtype == torch.int8:
        q8, qscale = da._quantize_query(q3, H)
        return (torch.einsum("bthd,bshd->btsh", k4.float(), q8)
                * ks[:, :, None, :] * qscale[:, None] * D ** -0.5)
    return torch.einsum("bthd,bshd->btsh", k4.float(),
                        q3.float().view(B, S, H, D)) * D ** -0.5


def _k5_model(q3, k, v, lengths, C, ks=None, vs=None):
    """K5's arithmetic (csrc/decode_attention.cu, the cluster split) in
    PyTorch: rank r of a cluster of C takes keys [r*per, (r+1)*per) of the
    row's n visible keys, per = ceil(n / C), possibly none; the ranks'
    maxima, sums of exp(s - m) and (int8) maxima of p*vs combine in rank
    order; each slice's value sum is int32 (int8) or fp32, and the slices'
    sums add in rank order. Returns (out, probs [B, S, H, T] as
    attend_decode_plain's, m, l, pscale)."""
    B, S, HD = q3.shape
    T = k.shape[1]
    v4 = v.view(B, T, H, D)
    scores = _model_scores(q3, k, ks)
    n = lengths.clamp(max=T).long()
    per = (n + C - 1) // C
    t = torch.arange(T)[None, :]
    # [B, T, 1, 1] masks: rank r's slice of each row, and the visible keys.
    ranks = [((t >= r * per[:, None]) & (t < torch.minimum((r + 1) * per, n)
                                         [:, None]))[:, :, None, None]
             for r in range(C)]
    visible = (t < n[:, None])[:, :, None, None]
    m = torch.full(scores[:, 0].shape, -FLT_MAX)
    for sl in ranks:
        m = torch.maximum(m, torch.where(sl, scores, -FLT_MAX).amax(dim=1))
    e = torch.where(visible, torch.exp(scores - m[:, None]), 0.0)
    l = torch.zeros_like(m)
    for sl in ranks:
        l = l + torch.where(sl, e, 0.0).sum(dim=1)
    if k.dtype == torch.int8:
        pv = (e / l[:, None]) * vs[:, :, None, :]
        pmax = torch.zeros_like(m)
        for sl in ranks:
            pmax = torch.maximum(pmax, torch.where(sl, pv, 0.0).amax(dim=1))
        pscale = torch.clamp(pmax, min=1e-20) / 127.0
        p = torch.clamp(torch.round(pv / pscale[:, None]), -127, 127)
        total = sum(da._exact_pv(torch.where(sl, p, 0.0), v4) for sl in ranks)
        out = total.float() * pscale[..., None]
    else:
        pscale = None
        p = (e / l[:, None]).to(v.dtype).float()
        out = torch.zeros(B, S, H, D)
        for sl in ranks:
            out = out + torch.einsum("btsh,bthd->bshd",
                                     torch.where(sl, p, 0.0), v4.float())
    return (out.reshape(B, S, HD).to(q3.dtype), p.permute(0, 2, 3, 1), m, l,
            pscale, scores, visible)


@pytest.mark.parametrize("C", [1, 2, 8])
@pytest.mark.parametrize("T", [7, 1500])
@pytest.mark.parametrize("S", [1, 3])
@pytest.mark.parametrize("kind", ["int8", "bf16"])
def test_k5_cluster_split_model(kind, S, T, C):
    """K5's split of each row's keys over a cluster of C ranks, modelled in
    PyTorch, against `attend_decode_plain` and the JAX decode step's
    `_attend_decode_flat` (S=1) / `_attend_decode_flat_multi` (S=3), with
    per-row lengths that include n = 1 and n < C. Tolerances: m equal bit
    for bit (a max is exact in any order); pscale equal bit for bit to the
    whole row's max_t(p*vs) / 127 given the model's l (the split of that
    max is exact), and within 1e-5 relative of the plain version's (l
    summed in another order over up to 1500 terms, and torch.softmax
    multiplies by 1/l: 1.2e-6 seen here); int8 prob levels within 1 on <= 1e-3 of visible keys
    (a level moves only at an exact .5 tie); outputs within 1e-2."""
    B = 3
    q, k, v, ks, vs = _inputs(B, S, T, "int8" if kind == "int8" else "fp32",
                              seed=10 * S + T % 10)
    if kind == "bf16":
        j = lambda a: jnp.asarray(a, jnp.bfloat16)
        t = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    else:
        j, t = _j, _t
    lens = np.array([T, (T + 1) // 2 if T > 7 else 3, 1], np.int32)
    lengths = torch.from_numpy(lens)
    args = (t(q), t(k), t(v), lengths, H)
    out, p, m, l, pscale, scores, visible = _k5_model(
        *args[:4], C, ks=_t(ks), vs=_t(vs))
    plain, p_plain = da.attend_decode_plain(*args, ks=_t(ks), vs=_t(vs),
                                            return_probs=True)

    assert torch.equal(m, torch.where(visible, scores, -FLT_MAX).amax(dim=1))
    if kind == "int8":
        pv = torch.where(visible, (torch.exp(scores - m[:, None])
                                   / l[:, None]) * _t(vs)[:, :, None, :], 0.0)
        assert torch.equal(pscale, torch.clamp(pv.amax(dim=1), min=1e-20)
                           / 127.0)
        probs = torch.softmax(torch.where(visible, scores, da.NEG), dim=1)
        ref_pscale = torch.clamp((probs * _t(vs)[:, :, None, :]).amax(dim=1),
                                 min=1e-20) / 127.0
        np.testing.assert_allclose(pscale.numpy(), ref_pscale.numpy(),
                                   rtol=1e-5)
        dp = (p - p_plain).abs()
        assert dp.max() <= 1
        assert dp.ne(0).sum().item() <= 1e-3 * H * S * int(lengths.sum())

    mask = np.arange(T)[None, :] < lens[:, None]
    if S == 1:
        ref = jax_model._attend_decode_flat(
            j(q[:, 0]), j(k), j(v), jnp.asarray(mask), H, ks=_j(ks),
            vs=_j(vs))[:, None]
    else:
        ref = jax_model._attend_decode_flat_multi(
            j(q), j(k), j(v), jnp.asarray(np.broadcast_to(
                mask[:, None, None, :], (B, 1, S, T))), H, ks=_j(ks),
            vs=_j(vs))
    assert out.dtype == plain.dtype
    for other in (plain.float().numpy(), np.asarray(ref, np.float32)):
        np.testing.assert_allclose(out.float().numpy(), other, atol=1e-2)


WARPS, LANES = 4, 32        # K4's CTA: 128 threads


def _butterfly(x):
    """Lane 0's value after `v += shfl_xor(v, off)` for off = n/2, ..., 1
    over the n entries of x's first dimension."""
    off = x.shape[0] // 2
    while off:
        x = x + x[torch.arange(x.shape[0]) ^ off]
        off //= 2
    return x[0]


def _k4_model(q3, k, v, lengths, causal, ks=None, vs=None):
    """K4's arithmetic (csrc/decode_attention.cu, decode_attention_kernel)
    in PyTorch, with its order of sums. A pass holds RPP rows (128 threads,
    16 bytes each: CHUNKS threads per row); warp w owns rows whose index
    mod RPP lies in [w*RW, (w+1)*RW). For the softmax, lane i of a warp
    takes its rows j = i, i+32, ... (row (j // RW)*RPP + w*RW + j % RW),
    adds its exps in that order, and the lanes are joined by a butterfly of
    shuffles, the warps in warp order; the max and (int8) max(p*vs) are
    exact in any order. The value sum: each thread adds p*v over its rows
    in pass order, the warp's RW rows join by a butterfly, the warps in
    order (int32 in the int8 mode: exact). Returns (out, probs)."""
    B, S, HD = q3.shape
    T = k.shape[1]
    v4 = v.view(B, T, H, D).float()
    chunks = D // (16 // k.element_size())
    rw, rpp = LANES // chunks, WARPS * LANES // chunks
    scores = _model_scores(q3, k, ks)                       # [B, T, S, H]
    quant = k.dtype == torch.int8
    out = torch.zeros(B, S, H, D)
    probs = torch.zeros(B, S, H, T)
    for b in range(B):
        for s in range(S):
            n = min(int(lengths[b]) + (s if causal else 0), T)
            kp = -(-n // rpp)
            sc = scores[b, :n, s]                           # [n, H]
            m = sc.amax(dim=0)
            e = torch.exp(sc - m)
            warp_rows = [[t for j in range(kp * rw)
                          if (t := (j // rw) * rpp + w * rw + j % rw) < n]
                         for w in range(WARPS)]
            l = torch.zeros(H)
            for rows in warp_rows:
                lanes = torch.zeros(LANES, H)
                for i, t in enumerate(rows):     # lane j % 32 of entry j
                    lanes[i % LANES] += e[t]
                l = l + _butterfly(lanes)
            if quant:
                pv = (e / l) * vs[b, :n]
                pscale = torch.clamp(pv.amax(dim=0), min=1e-20) / 127.0
                p = torch.clamp(torch.round(pv / pscale), -127, 127)
                acc = torch.einsum("th,thd->hd", p.double(),
                                   v4[b, :n].double())      # exact integers
                out[b, s] = (acc.float() * pscale[:, None])
            else:
                p = (e / l).to(v.dtype).float()
                part = torch.zeros(rpp, H, D)
                for t in range(n):               # each thread, pass order
                    part[t % rpp] += p[t, :, None] * v4[b, t]
                for w in range(WARPS):
                    out[b, s] += _butterfly(part[w * rw:(w + 1) * rw])
            probs[b, s, :, :n] = p.T
    return out.reshape(B, S, HD).to(q3.dtype), probs


@pytest.mark.parametrize("kind", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("S", [1, 3])
def test_k4_warp_reduction_model(kind, S):
    """K4's order of sums (each warp over its own rows, the warps joined
    once per quantity), modelled in PyTorch, against `attend_decode_plain`
    and the JAX decode step's `_attend_decode_flat` (S=1) /
    `_attend_decode_flat_multi` (S=3, causal: query s sees len_b + s keys),
    with per-row lengths. The file's tolerances: fp32 atol 2e-6, bf16 rtol
    2^-7 with atol 2e-3, int8 atol 1e-5; int8 prob levels equal (no .5 tie
    on these inputs)."""
    B, T = 3, 96
    causal = S > 1
    q, k, v, ks, vs = _inputs(B, S, T, kind, seed=20 + S)
    if kind == "bf16":
        j = lambda a: jnp.asarray(a, jnp.bfloat16)
        t = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    else:
        j, t = _j, _t
    lens = np.array([T - 2, 40, 1], np.int32)
    lengths = torch.from_numpy(lens)
    args = (t(q), t(k), t(v), lengths, H)
    out, p = _k4_model(*args[:4], causal, ks=_t(ks), vs=_t(vs))
    plain, p_plain = da.attend_decode_plain(*args, ks=_t(ks), vs=_t(vs),
                                            causal=causal, return_probs=True)
    n = lens[:, None] + (np.arange(S)[None, :] if causal else 0)   # [B, S]
    mask4 = np.arange(T)[None, None, :] < n[:, :, None]            # [B, S, T]
    if S == 1:
        ref = jax_model._attend_decode_flat(
            j(q[:, 0]), j(k), j(v), jnp.asarray(mask4[:, 0]), H, ks=_j(ks),
            vs=_j(vs))[:, None]
    else:
        ref = jax_model._attend_decode_flat_multi(
            j(q), j(k), j(v), jnp.asarray(mask4[:, None]), H, ks=_j(ks),
            vs=_j(vs))
    tol = {"fp32": dict(atol=2e-6), "int8": dict(atol=1e-5),
           "bf16": dict(rtol=2 ** -7, atol=2e-3)}[kind]
    assert out.dtype == plain.dtype
    if kind == "int8":
        assert torch.equal(p, p_plain)
    for other in (plain.float().numpy(), np.asarray(ref, np.float32)):
        np.testing.assert_allclose(out.float().numpy(), other, **tol)


def test_wrappers_never_fall_back_off_the_cpu():
    """On a device other than the CPU the wrappers launch the kernel or
    raise; the 'meta' device stands in for one here."""
    q = torch.empty(2, 1, HD, device="meta")
    k = torch.empty(2, 8, HD, device="meta")
    for fn in (da.attend_decode, da.attend_decode_pipelined):
        with pytest.raises(ValueError, match="unsupported device"):
            fn(q, k, k, None, H)
    with pytest.raises(ValueError, match="unsupported device"):
        da.decode_cross_attend(q[:, 0], k, k, H)
