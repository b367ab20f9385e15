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


def _inputs(B, S, T, quant, seed, n_head=H):
    rng = np.random.default_rng(seed)
    hd = n_head * D
    q = rng.standard_normal((B, S, hd)).astype(np.float32)
    if quant == "int8":
        k = rng.integers(-127, 128, (B, T, hd)).astype(np.int8)
        v = rng.integers(-127, 128, (B, T, hd)).astype(np.int8)
        ks = rng.uniform(0.005, 0.03, (B, T, n_head)).astype(np.float32)
        vs = rng.uniform(0.005, 0.03, (B, T, n_head)).astype(np.float32)
        return q, k, v, ks, vs
    k = rng.standard_normal((B, T, hd)).astype(np.float32)
    v = rng.standard_normal((B, T, hd)).astype(np.float32)
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


def _model_scores(q3, k, ks, n_head=H):
    """The kernels' scores [B, T, S, H]: ((dot * ks) * qscale) * sm_scale
    with the int32 dot of the int8 levels, else (K . q) * sm_scale."""
    B, S, _ = q3.shape
    k4 = k.view(B, k.shape[1], n_head, D)
    if k.dtype == torch.int8:
        q8, qscale = da._quantize_query(q3, n_head)
        return (torch.einsum("bthd,bshd->btsh", k4.float(), q8)
                * ks[:, :, None, :] * qscale[:, None] * D ** -0.5)
    return torch.einsum("bthd,bshd->btsh", k4.float(),
                        q3.float().view(B, S, n_head, D)) * D ** -0.5


THREADS = 128               # K5's CTA
WARPS, LANES = 4, 32        # K4's and K5's CTA: 128 threads


def _exp32(x):
    """fp32 exp that does not depend on where x lies in its tensor (ATen's
    vector and scalar exp can differ in the last place)."""
    return torch.exp(x.double()).float()


def _piece_dots(q3, k, n_head):
    """K5's float scores [B, T, S, H] in its order: each 16-byte piece of
    a key row (vals values) summed in order with fmaf (the bf16 products
    are exact in fp32), then the row's pieces by a butterfly of shuffles
    (xor chunks/2, ..., 1), times sm_scale."""
    B, S, _ = q3.shape
    T = k.shape[1]
    vals = 16 // k.element_size()
    chunks = D // vals
    prod = (k.float().view(B, T, 1, n_head, chunks, vals)
            * q3.float().view(B, 1, S, n_head, chunks, vals))
    acc = torch.zeros(prod.shape[:-1])
    for j in range(vals):
        acc = acc + prod[..., j]
    return _butterfly(acc.movedim(-1, 0)) * D ** -0.5


def _block_sum(x, G):
    """K5's sum of one rank's entries x [cnt, ..., H] (row-major over
    (row, head in the cluster's G)): thread i adds entries i, i + 128, ...
    in order (the others' lanes hold 0 for that head), a butterfly of
    shuffles within each warp, then the warps in order (block_reduce)."""
    cnt, rest = x.shape[0], x.shape[1:]
    rpt = THREADS // G                       # rows a thread's stride
    k = -(-cnt // rpt)
    xp = torch.zeros((k * rpt,) + rest)
    xp[:cnt] = x
    acc = torch.zeros((rpt,) + rest)
    for kk in range(k):
        acc = acc + xp[kk * rpt:(kk + 1) * rpt]
    th = torch.arange(THREADS).view((THREADS,) + (1,) * len(rest))
    lanes = torch.where(th % G == torch.arange(rest[-1]) % G,   # head th % G
                        acc[th.flatten() // G], 0.0)
    total = None
    for w in range(WARPS):
        part = _butterfly(lanes[w * LANES:(w + 1) * LANES])
        total = part if total is None else total + part
    return total


def _rows_sum(x, rpp, rw):
    """K5's float value sum over one rank's rows x [cnt, ...]: thread row
    r0 < rpp adds rows r0, r0 + rpp, ... in order (fmaf: the products are
    exact), the rw rows of a warp join by shuffles at ascending offsets,
    then the warps in order from 0."""
    cnt, rest = x.shape[0], x.shape[1:]
    k = -(-cnt // rpp)
    xp = torch.zeros((k * rpp,) + rest)
    xp[:cnt] = x
    acc = torch.zeros((rpp,) + rest)
    for kk in range(k):
        acc = acc + xp[kk * rpp:(kk + 1) * rpp]
    total = torch.zeros(rest)
    for w in range(rpp // rw):
        lanes = acc[w * rw:(w + 1) * rw]
        off = 1
        while off < rw:
            lanes = lanes + lanes[torch.arange(rw) ^ off]
            off *= 2
        total = total + lanes[0]
    return total


def _k5_model(q3, k, v, lengths, C, ks=None, vs=None, n_head=H, multi=False):
    """K5's arithmetic (csrc/decode_attention.cu, the cluster split) in
    PyTorch, in the kernel's order: rank r of a cluster of C takes keys
    [r*per, (r+1)*per) of the row's n visible keys, per = ceil(n / C),
    possibly none; a cluster takes G heads (two for int8 and an even head
    count); each rank's max, sum of exp(s - m) (_block_sum's order) and
    (int8) max of p*vs combine in rank order; each slice's value sum is
    int32 (int8: exact) or fp32 (_rows_sum's order), and the slices' sums
    add in rank order. multi=False: a cluster per query (each query its
    own launch); multi=True: the multi-query mode, one split of each row's
    keys for all its S queries, taken in blocks of da.S_MAX, each block's
    (query, head) values exchanged together. Returns (out, probs [B, S, H,
    T] as attend_decode_plain's, m, l, pscale, scores, visible)."""
    B, S, HD = q3.shape
    T = k.shape[1]
    quant = k.dtype == torch.int8
    G = 2 if quant and n_head % 2 == 0 else 1
    v4 = v.view(B, T, n_head, D)
    scores = (_model_scores(q3, k, ks, n_head) if quant
              else _piece_dots(q3, k, n_head))
    n = lengths.clamp(max=T).long()
    t = torch.arange(T)[None, :]
    visible = (t < n[:, None])[:, :, None, None]
    m = torch.full((B, S, n_head), -FLT_MAX)
    l = torch.zeros(B, S, n_head)
    pscale = torch.ones(B, S, n_head) if quant else None
    p = torch.zeros(B, T, S, n_head)
    out = torch.zeros(B, S, n_head, D)
    vals = 16 // k.element_size()
    rpp = THREADS // (G * (D // vals))         # rows a pass
    blocks = ([range(s0, min(s0 + da.S_MAX, S)) for s0 in range(0, S, da.S_MAX)]
              if multi else [range(s, s + 1) for s in range(S)])
    for b in range(B):
        nb = int(n[b])
        per = -(-nb // C)
        for qs in blocks:                        # a cluster's queries at once
            sl = slice(qs.start, qs.stop)
            # Each rank's slice of the row's keys: the same for every query.
            slices = [slice(min(r * per, nb), min((r + 1) * per, nb))
                      for r in range(C)]
            sc = scores[b, :, sl]                # [T, s, H]
            mb = torch.full(sc.shape[1:], -FLT_MAX)
            for rs in slices:
                if rs.stop > rs.start:
                    mb = torch.maximum(mb, sc[rs].amax(dim=0))
            e = torch.zeros_like(sc)
            e[:nb] = _exp32(sc[:nb] - mb)
            lb = torch.zeros(sc.shape[1:])
            for rs in slices:
                lb = lb + _block_sum(e[rs], G)
            if quant:
                pv = (e / lb) * vs[b, :, None, :]
                pm = torch.zeros(sc.shape[1:])
                for rs in slices:
                    if rs.stop > rs.start:
                        pm = torch.maximum(pm, pv[rs].amax(dim=0))
                ps = da.div127(torch.clamp(pm, min=1e-20))
                pb = torch.clamp(torch.round(pv / ps), -127, 127)
                pb[nb:] = 0
                total = torch.zeros(pb.shape[1:] + (D,), dtype=torch.int32)
                for rs in slices:            # (an empty slice adds 0)
                    if rs.stop > rs.start:
                        total = total + da._exact_pv(pb[None, rs],
                                                     v4[b:b + 1, rs])[0]
                ob = total.float() * ps[..., None]
                pscale[b, sl] = ps
            else:
                pb = (e / lb).to(v.dtype).float()
                pb[nb:] = 0
                rw = LANES // (G * (D // vals))  # rows a warp
                ob = torch.zeros(sc.shape[1:] + (D,))
                for rs in slices:
                    prod = pb[rs][..., None] * v4[b, rs, None].float()
                    ob = ob + _rows_sum(prod, rpp, rw)
            m[b, sl], l[b, sl], p[b, :, sl], out[b, sl] = mb, lb, pb, ob
    return (out.reshape(B, S, HD).to(q3.dtype), p.permute(0, 2, 3, 1), m, l,
            pscale, scores, visible)


@pytest.mark.parametrize("C", [1, 2, 8])
@pytest.mark.parametrize("T", [7, 1500])
@pytest.mark.parametrize("S", [1, 3, 5, 6, pytest.param((5, 20), id="5h20")])
@pytest.mark.parametrize("kind", ["int8", "bf16"])
def test_k5_cluster_split_model(kind, S, T, C):
    """K5's split of each row's keys over a cluster of C ranks, modelled in
    PyTorch in the kernel's order, against `attend_decode_plain` and the
    JAX decode step's `_attend_decode_flat` (S=1) /
    `_attend_decode_flat_multi` (S > 1), with per-row lengths that include
    n = 1 and n < C; then the multi-query mode's model (one split of a
    row's keys for its S queries, blocks of S_MAX) against a launch of
    each query alone. H=4 heads, and 20 at S=5 ("5h20"). Tolerances: m
    equal bit for bit (a max is exact in any order); pscale equal bit for
    bit to the whole row's max_t(p*vs) / 127 given the model's l (the
    split of that max is exact), and within 1e-5 relative of the plain
    version's (l summed in another order over up to 1500 terms, and
    torch.softmax multiplies by 1/l: 1.2e-6 seen here); int8 prob levels
    within 1 on <= 1e-3 of visible keys (a level moves only at an exact .5
    tie); outputs within 1e-2. The multi-query mode: every query's output,
    probs, m, l and pscale equal the single query's bit for bit."""
    S, n_head = (S, H) if isinstance(S, int) else S
    B = 3
    q, k, v, ks, vs = _inputs(B, S, T, "int8" if kind == "int8" else "fp32",
                              seed=10 * S + T % 10, n_head=n_head)
    if kind == "bf16":
        j = lambda a: jnp.asarray(a, jnp.bfloat16)
        t = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    else:
        j, t = _j, _t
    lens = np.array([T, (T + 1) // 2 if T > 7 else 3, 1], np.int32)
    lengths = torch.from_numpy(lens)
    args = (t(q), t(k), t(v), lengths, n_head)
    kw = dict(ks=_t(ks), vs=_t(vs), n_head=n_head)
    out, p, m, l, pscale, scores, visible = _k5_model(*args[:4], C, **kw)
    plain, p_plain = da.attend_decode_plain(*args, ks=_t(ks), vs=_t(vs),
                                            return_probs=True)

    assert torch.equal(m, torch.where(visible, scores, -FLT_MAX).amax(dim=1))
    if kind == "int8":
        pv = torch.where(visible, (_exp32(scores - m[:, None])
                                   / l[:, None]) * _t(vs)[:, :, None, :], 0.0)
        assert torch.equal(pscale, da.div127(torch.clamp(pv.amax(dim=1),
                                                         min=1e-20)))
        probs = torch.softmax(torch.where(visible, scores, da.NEG), dim=1)
        ref_pscale = torch.clamp((probs * _t(vs)[:, :, None, :]).amax(dim=1),
                                 min=1e-20) / 127.0
        np.testing.assert_allclose(pscale.numpy(), ref_pscale.numpy(),
                                   rtol=1e-5)
        dp = (p - p_plain).abs()
        assert dp.max() <= 1
        assert dp.ne(0).sum().item() <= 1e-3 * n_head * S * int(lengths.sum())

    mask = np.arange(T)[None, :] < lens[:, None]
    if S == 1:
        ref = jax_model._attend_decode_flat(
            j(q[:, 0]), j(k), j(v), jnp.asarray(mask), n_head, ks=_j(ks),
            vs=_j(vs))[:, None]
    else:
        ref = jax_model._attend_decode_flat_multi(
            j(q), j(k), j(v), jnp.asarray(np.broadcast_to(
                mask[:, None, None, :], (B, 1, S, T))), n_head, ks=_j(ks),
            vs=_j(vs))
    assert out.dtype == plain.dtype
    for other in (plain.float().numpy(), np.asarray(ref, np.float32)):
        np.testing.assert_allclose(out.float().numpy(), other, atol=1e-2)

    # The multi-query mode: each query as a launch of it alone.
    multi = _k5_model(*args[:4], C, multi=True, **kw)
    for s in range(S):
        alone = _k5_model(args[0][:, s:s + 1], *args[1:4], C, **kw)
        assert torch.equal(multi[0][:, s], alone[0][:, 0])       # outputs
        assert torch.equal(multi[1][:, s], alone[1][:, 0])       # probs
        for i in (2, 3) + ((4,) if kind == "int8" else ()):      # m, l, pscale
            assert torch.equal(multi[i][:, s], alone[i][:, 0])


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


class _OnCard(torch.Tensor):
    """A CPU tensor that reports a CUDA device, so that a wrapper takes its
    launch path (into a stand-in library)."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def test_multi_query_launch_reaches_the_entry(monkeypatch):
    """What `attend_decode_pipelined` hands the kernel's C entry, on a
    stand-in library, for a beam step's cross-attention: G groups of K
    beams folded into a row's queries over the group's int8 cross-KV. The
    multi-query mode (pipelined 2) gets B = G, S = K, T, the lengths and
    no causal offset, and counts a launch on both wrappers; a causal block
    and a single query stay on a cluster per query (pipelined 1)."""
    import types
    from openhush_tpu_torch.ops import _build
    got = []

    def entry(*args):
        got.append(args)
        return 0

    monkeypatch.setattr(_build, "library", lambda: types.SimpleNamespace(
        oh_decode_attention=entry))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))
    G, K, T = 2, 5, 1500
    card = lambda x: x.as_subclass(_OnCard)
    q = card(torch.zeros(G * K, 1, HD, dtype=torch.bfloat16)).view(G, K, HD)
    k = card(torch.zeros(G, T, HD, dtype=torch.int8))
    ks = card(torch.ones(G, T, H))
    lengths = card(torch.full((G,), 700, dtype=torch.int32))
    multi0 = da.attend_decode_multi.launches
    pipe0 = da.attend_decode_pipelined.launches
    da.attend_decode_pipelined(q, k, k, None, H, ks=ks, vs=ks)
    da.attend_decode_pipelined(q, k, k, lengths, H, ks=ks, vs=ks)
    da.attend_decode_pipelined(q, k, k, lengths, H, ks=ks, vs=ks, causal=True)
    da.attend_decode_pipelined(q[:, :1].contiguous(), k, k, None, H, ks=ks,
                               vs=ks)
    assert da.attend_decode_multi.launches == multi0 + 2
    assert da.attend_decode_pipelined.launches == pipe0 + 4
    whole, lens, causal, single = got
    for args in (whole, lens):
        assert args[11:15] == (G, K, H, T)             # B, S, H, T
        assert args[7] == 0 and args[8] is None        # no causal offset, no table
        assert args[18] == 2                           # the multi-query mode
    assert whole[5] is None and whole[6] == T          # every key visible
    assert lens[5] == lengths.data_ptr()
    assert causal[7] == 1 and causal[18] == 1 and causal[11:13] == (G, K)
    assert single[11:13] == (G, 1) and single[18] == 1
