"""The int8 decoder weights' product (openhush_tpu_torch.ops.w8a16) against
the JAX package's `_mm` on a dict weight from its own
quantize_decoder_weights, on the same numpy inputs from a seed, single and
grouped (products of one x in one launch), and its gradient against
jax.grad; the wrappers' refusals and their launches into a stand-in
library (a card output's gradient included); the model's launches a
decoder call and a cross-KV; the tolerance helper that chip_smoke.py
holds the kernel to.

Tolerances: bf16 x within one bf16 ulp of the reference's value (both sum
the exact products in fp32, in other orders, and round once to bf16; an
ulp covers a neighbouring rounding); fp32 x within 1e-5 of sum_i |x_i *
q_i| * s (the fp32 sums' order). With a bias, the reference is JAX's
`_mm(x, w) + b` in x's dtype, as the model's call sites read."""

import functools
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openhush_tpu.models.whisper import model as jax_model
from openhush_tpu_torch.models.whisper import model
from openhush_tpu_torch.ops import _build
from openhush_tpu_torch.ops import w8a16

WIDTHS = [(i, o) for i in (64, 80, 384) for o in (64, 80, 384)]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: small products, and the test workers share the
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _weight(I, O):
    """JAX's int8 weight of a random [I, O] matrix (numpy q, s) and a bias."""
    rng = np.random.default_rng(1000 * I + O)
    w = (0.05 * rng.standard_normal((I, O))).astype(np.float32)
    wq = jax_model.quantize_decoder_weights(
        {"decoder": {"layers": {"q_w": jnp.asarray(w)}}}
    )["decoder"]["layers"]["q_w"]
    bias = (0.5 * rng.standard_normal(O)).astype(np.float32)
    return np.array(wq["q"]), np.array(wq["s"]), bias


def _ulp_bf16(v):
    _, e = np.frexp(np.maximum(np.abs(v), np.finfo(np.float32).tiny))
    return np.ldexp(1.0, e - 8)


@pytest.mark.parametrize("I,O", WIDTHS)
@pytest.mark.parametrize("M", [1, 5, 8, 20, 33])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_plain_matches_jax_mm(dtype, M, I, O):
    q, s, b = _weight(I, O)
    rng = np.random.default_rng(M)
    x = rng.standard_normal((M, I)).astype(np.float32)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    tx = torch.from_numpy(x).to(tdt)
    jx = jnp.asarray(x, jdt)
    jw = {"q": jnp.asarray(q), "s": jnp.asarray(s)}
    tw = {"q": torch.from_numpy(q), "s": torch.from_numpy(s)}
    tb = torch.from_numpy(b).to(tdt)
    mag = np.abs(tx.float().numpy()) @ np.abs(q.astype(np.float32)) * s
    for bias in (False, True):
        ref = jax_model._mm(jx, jw)
        if bias:
            ref = ref + jnp.asarray(b, jdt)
        ref = np.asarray(ref.astype(jnp.float32))
        ours = w8a16.mm_w8a16_plain(tx, tw, tb if bias else None)
        assert ours.dtype == tdt and ours.shape == (M, O)
        got = ours.float().numpy()
        err = np.abs(got - ref)
        tol = _ulp_bf16(ref) if dtype == "bfloat16" else 1e-5 * mag
        assert (err <= tol).all(), (bias, float(err.max()))
        # The wrapper takes the plain version for CPU tensors.
        assert torch.equal(w8a16.mm_w8a16(tx, tw, tb if bias else None),
                           ours)


def test_model_mm_folds_the_bias_as_the_reference_adds_it():
    """`model._mm(x, w, b)` on an int8 weight is `_mm(x, w) + b` in x's
    dtype: the product rounded to bf16, then the bias added and rounded
    again; a plain weight gives x @ w + b."""
    q, s, b = _weight(64, 80)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 3, 64)).astype(np.float32)).to(torch.bfloat16)
    w = {"q": torch.from_numpy(q), "s": torch.from_numpy(s)}
    tb = torch.from_numpy(b).to(torch.bfloat16)
    assert torch.equal(model._mm(x, w, tb), model._mm(x, w) + tb)
    assert model._mm(x, w).shape == (2, 3, 80)
    dense = torch.from_numpy(q.astype(np.float32)).to(torch.bfloat16)
    assert torch.equal(model._mm(x, dense, tb), x @ dense + tb)


@pytest.mark.parametrize("I,O", [(72, 64), (64, 40), (8, 64)])
def test_refuses_widths_not_multiples_of_16(I, O):
    x = torch.zeros(2, I, dtype=torch.bfloat16)
    w = {"q": torch.zeros(I, O, dtype=torch.int8),
         "s": torch.ones(O)}
    with pytest.raises(ValueError, match=rf"\[2, {I}\].*\[{I}, {O}\]"):
        w8a16.mm_w8a16(x, w)


def test_refuses_a_non_contiguous_x():
    x = torch.zeros(64, 8, dtype=torch.bfloat16).t()
    w = {"q": torch.zeros(64, 16, dtype=torch.int8), "s": torch.ones(16)}
    with pytest.raises(ValueError, match=r"x \[8, 64\].*not contiguous"):
        w8a16.mm_w8a16(x, w)


def test_refuses_operands_the_kernel_does_not_take():
    x = torch.zeros(2, 64, dtype=torch.bfloat16)
    q = torch.zeros(64, 16, dtype=torch.int8)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        w8a16.mm_w8a16(x.half(), {"q": q, "s": torch.ones(16)})
    with pytest.raises(ValueError, match="contiguous int8"):
        w8a16.mm_w8a16(x, {"q": q.float(), "s": torch.ones(16)})
    with pytest.raises(ValueError, match="contiguous int8"):
        w8a16.mm_w8a16(x, {"q": torch.zeros(16, 64, dtype=torch.int8).t(),
                           "s": torch.ones(16)})
    with pytest.raises(ValueError, match="scales"):
        w8a16.mm_w8a16(x, {"q": q, "s": torch.ones(16).half()})
    with pytest.raises(ValueError, match="bias"):
        w8a16.mm_w8a16(x, {"q": q, "s": torch.ones(16)}, torch.ones(16))
    with pytest.raises(ValueError, match="unsupported device"):
        w8a16.mm_w8a16(x.to("meta"), {"q": q.to("meta"),
                                      "s": torch.ones(16, device="meta")})


class _OnCard(torch.Tensor):
    """A CPU tensor that reports a CUDA device, so that the wrapper takes
    its launch path."""

    @property
    def device(self):
        return torch.device("cuda", 0)

    @property
    def is_cuda(self):
        return True


def _card_operands(M=5, I=64, O=32, dtype=torch.bfloat16):
    card = lambda t: t.as_subclass(_OnCard)
    return (card(torch.zeros(M, I, dtype=dtype)),
            {"q": card(torch.zeros(I, O, dtype=torch.int8)),
             "s": card(torch.ones(O))},
            card(torch.zeros(O, dtype=dtype)))


def test_a_card_tensor_with_no_kernel_raises(monkeypatch):
    """No quiet switch to the plain version: where the kernel cannot be
    built, a CUDA tensor's product raises, and nothing is counted."""
    def no_toolkit():
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA "
                           "toolkit")

    monkeypatch.setattr(_build, "library", no_toolkit)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda device: 0, raising=False)
    x, w, b = _card_operands()
    before = w8a16.mm_w8a16.launches
    with pytest.raises(RuntimeError, match="nvcc not found"):
        w8a16.mm_w8a16(x, w, b)
    assert w8a16.mm_w8a16.launches == before


@pytest.mark.parametrize("dtype,code", [(torch.bfloat16, 1),
                                        (torch.float32, 0)])
def test_launch_reaches_the_entry(monkeypatch, dtype, code):
    """What the wrapper hands the kernel's C entry on a stand-in library,
    for one product: x, then the levels, the scales, the bias (or none),
    the output and O, two null member slots, the member count 1, M = the
    rows of x's leading dimensions, I, the dtype and the stream; one
    launch counted a call, and a failed launch raises."""
    got = []

    def entry(*args):
        got.append(args)
        return 0

    monkeypatch.setattr(_build, "library", lambda: types.SimpleNamespace(
        oh_w8a16_group=entry))
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda device: 7, raising=False)
    x, w, b = _card_operands(dtype=dtype)
    before = w8a16.mm_w8a16.launches
    y = w8a16.mm_w8a16(x.view(1, 5, 64), w, b)
    w8a16.mm_w8a16(x, w)
    assert w8a16.mm_w8a16.launches == before + 2
    assert y.shape == (1, 5, 32) and y.dtype == dtype
    with_bias, without = got
    assert with_bias[:3] == (x.data_ptr(), w["q"].data_ptr(),
                             w["s"].data_ptr())
    assert with_bias[3] == b.data_ptr() and without[3] is None
    assert with_bias[4:6] == (y.data_ptr(), 32)
    assert with_bias[6:16] == (None, None, None, None, 0) * 2
    assert with_bias[16:] == (1, 5, 64, code, 7)

    monkeypatch.setattr(_build, "library", lambda: types.SimpleNamespace(
        oh_w8a16_group=lambda *args: 1))
    with pytest.raises(RuntimeError, match="oh_w8a16_group: CUDA error 1"):
        w8a16.mm_w8a16(x, w)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("bias", [False, True])
def test_tolerance_helper(dtype, bias):
    """The helper passes the plain version's output and one within half an
    ulp plus the sum-error bound of the fp32 reference, and fails one an
    ulp of the output's dtype beyond that."""
    q, s, b = _weight(384, 80)
    x = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (8, 384)).astype(np.float32)).to(dtype)
    w = {"q": torch.from_numpy(q), "s": torch.from_numpy(s)}
    tb = torch.from_numpy(b).to(dtype) if bias else None
    y = w8a16.mm_w8a16_plain(x, w, tb)
    ok, ratio = w8a16.within_tolerance(y, x, w, tb)
    assert ok and ratio <= 1.0
    ref, tol = w8a16.tolerance(x, w, tb)
    # The output's values nearest the tolerance's edge on its inner side.
    edge = (ref + tol).to(dtype)
    edge = torch.where((edge.float() - ref).abs() <= tol, edge,
                       (ref + tol - w8a16._ulp(ref + tol, dtype)).to(dtype))
    assert w8a16.within_tolerance(edge, x, w, tb)[0]
    ulp = w8a16._ulp((ref + tol).abs(), dtype)
    beyond = (ref + tol + ulp).to(dtype)
    bad = y.clone()
    bad[3, 7] = beyond[3, 7]
    ok, ratio = w8a16.within_tolerance(bad, x, w, tb)
    assert not ok and ratio > 1.0


# ---------------------------------------------------------------------------
# The grouped entry: products of one x in one launch
# ---------------------------------------------------------------------------

GROUP_OS = (64, 80, 384)          # the members' widths (q-, k-, v-like)
GROUP_BIAS = (True, False, True)  # q and v carry a bias, k none


def _members(I):
    """A group of three int8 weights of width I (JAX's levels) with the
    q/k/v pattern of biases: [(q, s, bias or None)] as numpy."""
    out = []
    for O, has_bias in zip(GROUP_OS, GROUP_BIAS):
        q, s, b = _weight(I, O)
        out.append((q, s, b if has_bias else None))
    return out


@pytest.mark.parametrize("I", (64, 80, 384))
@pytest.mark.parametrize("M", [1, 5, 8, 20, 33])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_group_plain_matches_jax_mm(dtype, M, I):
    """Each member of `mm_w8a16_group` (the plain version on the CPU)
    against JAX's `_mm(x, w)` (+ b in x's dtype) at the tolerances of
    test_plain_matches_jax_mm, and equal to its own single product."""
    rng = np.random.default_rng(100 + M)
    x = rng.standard_normal((M, I)).astype(np.float32)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    tx = torch.from_numpy(x).to(tdt)
    jx = jnp.asarray(x, jdt)
    members = _members(I)
    tmembers = [({"q": torch.from_numpy(q), "s": torch.from_numpy(s)},
                 None if b is None else torch.from_numpy(b).to(tdt))
                for q, s, b in members]
    ys = w8a16.mm_w8a16_group(tx, tmembers)
    assert len(ys) == 3
    plain = w8a16.mm_w8a16_group_plain(tx, tmembers)
    for (q, s, b), (tw, tb), y, yp in zip(members, tmembers, ys, plain):
        ref = jax_model._mm(jx, {"q": jnp.asarray(q), "s": jnp.asarray(s)})
        if b is not None:
            ref = ref + jnp.asarray(b, jdt)
        ref = np.asarray(ref.astype(jnp.float32))
        assert y.dtype == tdt and y.shape == (M, q.shape[1])
        assert y.is_contiguous()
        mag = np.abs(tx.float().numpy()) @ np.abs(q.astype(np.float32)) * s
        err = np.abs(y.float().numpy() - ref)
        tol = _ulp_bf16(ref) if dtype == "bfloat16" else 1e-5 * mag
        assert (err <= tol).all(), (b is not None, float(err.max()))
        assert torch.equal(y, yp)
        assert torch.equal(y, w8a16.mm_w8a16_plain(tx, tw, tb))


def test_group_refuses_what_the_kernel_does_not_take():
    """The grouped entry raises the single entry's errors for any member,
    and refuses members of another input width, a strided x, a wrong
    dtype, a mixed device and groups of no or more than three members."""
    x = torch.zeros(2, 64, dtype=torch.bfloat16)
    w = lambda I, O: {"q": torch.zeros(I, O, dtype=torch.int8),
                      "s": torch.ones(O)}
    with pytest.raises(ValueError, match=r"x \[2, 64\] x levels \[80, 16\]"):
        w8a16.mm_w8a16_group(x, [(w(64, 16), None), (w(80, 16), None)])
    with pytest.raises(ValueError, match="not contiguous"):
        w8a16.mm_w8a16_group(torch.zeros(64, 8, dtype=torch.bfloat16).t(),
                             [(w(64, 16), None), (w(64, 32), None)])
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        w8a16.mm_w8a16_group(x.half(), [(w(64, 16), None)] * 2)
    with pytest.raises(ValueError, match="the bias must be contiguous"):
        w8a16.mm_w8a16_group(x, [(w(64, 16), None),
                                 (w(64, 16), torch.ones(16))])
    card = lambda t: t.as_subclass(_OnCard)
    on_card = {"q": card(torch.zeros(64, 16, dtype=torch.int8)),
               "s": card(torch.ones(16))}
    with pytest.raises(ValueError, match="x on cpu, the levels on cuda:0"):
        w8a16.mm_w8a16_group(x, [(w(64, 16), None), (on_card, None)])
    with pytest.raises(ValueError, match="x on cpu, the bias on cuda:0"):
        w8a16.mm_w8a16_group(x, [(w(64, 16), card(torch.zeros(
            16, dtype=torch.bfloat16)))])
    with pytest.raises(ValueError, match="1 to 3 members"):
        w8a16.mm_w8a16_group(x, [])
    with pytest.raises(ValueError, match="1 to 3 members"):
        w8a16.mm_w8a16_group(x, [(w(64, 16), None)] * 4)


def _stand_in(monkeypatch, **entries):
    """A stand-in kernel library with these entry points, and a stream
    handle of 7."""
    monkeypatch.setattr(_build, "library",
                        lambda: types.SimpleNamespace(**entries))
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda device: 7, raising=False)


@pytest.mark.parametrize("n", [2, 3])
def test_group_launch_hands_every_member_to_one_entry(monkeypatch, n):
    """One call of the grouped entry on a stand-in library: the C entry gets
    x, then each member's levels, scales, bias (or none), output and
    width, null slots past the members, the count, M, I, the dtype and the
    stream; one launch is counted and each output is its own contiguous
    [..., O] tensor."""
    got = []

    def entry(*args):
        got.append(args)
        return 0

    _stand_in(monkeypatch, oh_w8a16_group=entry)
    card = lambda t: t.as_subclass(_OnCard)
    x = card(torch.zeros(2, 3, 64, dtype=torch.bfloat16))
    members = [({"q": card(torch.zeros(64, O, dtype=torch.int8)),
                 "s": card(torch.ones(O))},
                card(torch.zeros(O, dtype=torch.bfloat16)) if b else None)
               for O, b in list(zip(GROUP_OS, GROUP_BIAS))[:n]]
    before = w8a16.mm_w8a16.launches
    ys = w8a16.mm_w8a16_group(x, members)
    assert w8a16.mm_w8a16.launches == before + 1
    (args,) = got
    assert args[0] == x.data_ptr()
    for k in range(3):
        slot = args[1 + 5 * k:6 + 5 * k]
        if k < n:
            (w, b), y = members[k], ys[k]
            assert y.shape == (2, 3, w["q"].shape[1]) and y.is_contiguous()
            assert slot == (w["q"].data_ptr(), w["s"].data_ptr(),
                            None if b is None else b.data_ptr(),
                            y.data_ptr(), w["q"].shape[1])
        else:
            assert slot == (None, None, None, None, 0)
    assert args[16:] == (n, 6, 64, 1, 7)

    _stand_in(monkeypatch, oh_w8a16_group=lambda *args: 2)
    with pytest.raises(RuntimeError, match="oh_w8a16_group: CUDA error 2"):
        w8a16.mm_w8a16_group(x, members)


# ---------------------------------------------------------------------------
# The model's launches: q/k/v in one, xk/xv in one
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _int8_test_model():
    from openhush_tpu_torch.models.whisper import weights
    from openhush_tpu_torch.models.whisper.config import get_config
    cfg = get_config("test")
    params = weights.init_params(cfg, torch.Generator().manual_seed(0),
                                 device="cpu")
    return cfg, model.quantize_decoder_weights(params)


def _count_launches(monkeypatch):
    """Counts the model's calls of the kernel's two entries; on the card
    each call is one launch (test_launch_reaches_the_entry and
    test_group_launch_hands_every_member_to_one_entry). CPU tensors take
    the plain versions underneath."""
    calls = {"single": 0, "group": 0}

    def counted(name, fn):
        def run(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)
        return run

    monkeypatch.setattr(model, "mm_w8a16", counted("single", w8a16.mm_w8a16))
    monkeypatch.setattr(model, "mm_w8a16_group",
                        counted("group", w8a16.mm_w8a16_group))
    return calls


@pytest.mark.parametrize("quant", [False, True])
def test_cross_kv_takes_one_launch_a_layer(monkeypatch, quant):
    """compute_cross_kv (and its int8 variant) on int8 decoder weights:
    xk and xv of a layer in one grouped launch, 1 a layer."""
    cfg, params = _int8_test_model()
    calls = _count_launches(monkeypatch)
    feats = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (1, cfg.n_audio_ctx, cfg.n_audio_state)).astype(np.float32))
    with torch.no_grad():
        fn = model.compute_cross_kv_quant if quant else model.compute_cross_kv
        fn(cfg, params, feats)
    assert calls == {"single": 0, "group": cfg.n_text_layer}


@pytest.mark.parametrize("S", [1, 3, 80])
def test_decoder_call_takes_six_launches_a_layer(monkeypatch, S):
    """A decoder call on int8 decoder weights, flat (S·H <= 128: S = 1, 3)
    or a long prefill (S = 80): q/k/v in one grouped launch and o, xq, xo,
    fc1, fc2 one each, 6 a layer."""
    cfg, params = _int8_test_model()
    feats = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (1, cfg.n_audio_ctx, cfg.n_audio_state)).astype(np.float32))
    with torch.no_grad():
        cross = model.compute_cross_kv(cfg, params, feats)
        calls = _count_launches(monkeypatch)
        tokens = torch.arange(S)[None] + 50258
        model.decode(cfg, params, tokens, 0, model.init_kv_cache(
            cfg, 1, max_len=96), cross)
    L = cfg.n_text_layer
    assert calls == {"single": 5 * L, "group": L}


def test_dense_weights_take_no_kernel(monkeypatch):
    """Dense weights keep their plain products: no W8A16 entry is called."""
    from openhush_tpu_torch.models.whisper import weights
    cfg, _ = _int8_test_model()
    params = weights.init_params(cfg, torch.Generator().manual_seed(0),
                                 device="cpu")
    calls = _count_launches(monkeypatch)
    feats = torch.zeros(1, cfg.n_audio_ctx, cfg.n_audio_state)
    with torch.no_grad():
        cross = model.compute_cross_kv(cfg, params, feats)
        model.decode(cfg, params, torch.tensor([[50258]]), 0,
                     model.init_kv_cache(cfg, 1, max_len=64), cross)
    assert calls == {"single": 0, "group": 0}


# ---------------------------------------------------------------------------
# Gradients (F7): the card's output keeps its gradient
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("M", [1, 20])
def test_cpu_gradient_matches_jax_grad(dtype, M):
    """The gradient of sum(y * g) in x and in the bias, y = mm_w8a16(x, w,
    b) on the CPU, against jax.grad of the reference's `_mm(x, w) + b`.
    Tolerances: dx as the forward's (both sum g * s * q in fp32 in some
    order and round once): within one bf16 ulp in bf16, 1e-5 of sum_o |g
    s q| in fp32; dbias, a sum of M cotangents in x's dtype, within M
    half-ulps of sum |dy| in bf16 (JAX may round each partial sum) and
    1e-6 of it in fp32."""
    import jax
    I, O = 80, 64
    q, s, b = _weight(I, O)
    rng = np.random.default_rng(7 + M)
    x = rng.standard_normal((M, I)).astype(np.float32)
    g = rng.standard_normal((M, O)).astype(np.float32)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    jw = {"q": jnp.asarray(q), "s": jnp.asarray(s)}

    def loss(jx, jb):
        y = jax_model._mm(jx, jw) + jb
        return jnp.sum(y.astype(jnp.float32) * jnp.asarray(g))

    jdx, jdb = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x, jdt),
                                              jnp.asarray(b, jdt))
    tx = torch.from_numpy(x).to(tdt).requires_grad_()
    tb = torch.from_numpy(b).to(tdt).requires_grad_()
    y = w8a16.mm_w8a16(tx, {"q": torch.from_numpy(q),
                            "s": torch.from_numpy(s)}, tb)
    (y.float() * torch.from_numpy(g)).sum().backward()
    assert tx.grad.dtype == tdt and tb.grad.dtype == tdt
    ref = np.asarray(jdx.astype(jnp.float32))
    err = np.abs(tx.grad.float().numpy() - ref)
    mag = np.abs(g) @ (np.abs(q.astype(np.float32)) * s).T
    tol = _ulp_bf16(ref) if dtype == "bfloat16" else 1e-5 * mag
    assert (err <= tol).all(), err.max()
    eps = float(torch.finfo(tdt).eps)
    dy = np.abs(g.astype(np.float32)).sum(0)
    tol = (M * eps / 2 if dtype == "bfloat16" else 1e-6) * dy
    err = np.abs(tb.grad.float().numpy() - np.asarray(jdb.astype(jnp.float32)))
    assert (err <= tol).all(), err.max()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_card_output_keeps_the_plain_gradient(monkeypatch, dtype):
    """On a stand-in library, a CUDA-path output with grad enabled keeps a
    grad_fn, and its backward gives the plain version's gradient in x and
    in the bias, bit for bit (the same operations on the CPU)."""
    _stand_in(monkeypatch, oh_w8a16_group=lambda *args: 0)
    q, s, b = _weight(80, 64)
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.standard_normal((3, 80)).astype(np.float32)
                         ).to(dtype)
    g = torch.from_numpy(rng.standard_normal((3, 64)).astype(np.float32))
    w = {"q": torch.from_numpy(q), "s": torch.from_numpy(s)}
    bias = torch.from_numpy(b).to(dtype)

    px, pb = x.clone().requires_grad_(), bias.clone().requires_grad_()
    (w8a16.mm_w8a16_plain(px, w, pb).float() * g).sum().backward()

    card = lambda t: t.as_subclass(_OnCard)
    cx = card(x.clone()).requires_grad_()
    cb = card(bias.clone()).requires_grad_()
    before = w8a16.mm_w8a16.launches
    y = w8a16.mm_w8a16(cx, {"q": card(w["q"]), "s": card(w["s"])}, cb)
    assert w8a16.mm_w8a16.launches == before + 1
    assert y.grad_fn is not None
    (y.float() * g).sum().backward()
    assert torch.equal(cx.grad.as_subclass(torch.Tensor), px.grad)
    assert torch.equal(cb.grad.as_subclass(torch.Tensor), pb.grad)


def test_inference_launches_without_a_function(monkeypatch):
    """Under torch.no_grad(), and with grad enabled but nothing needing a
    gradient, the card's path launches directly: no autograd Function on
    the inference loop, and an output without grad_fn."""
    _stand_in(monkeypatch, oh_w8a16_group=lambda *args: 0)

    def no_function(*args):
        raise AssertionError("autograd Function on the inference path")

    monkeypatch.setattr(w8a16._W8A16, "apply", no_function)
    x, w, b = _card_operands()
    with torch.no_grad():
        y = w8a16.mm_w8a16(x.requires_grad_(), w, b)
        ys = w8a16.mm_w8a16_group(x, [(w, b), (w, None)])
    assert y.grad_fn is None and all(t.grad_fn is None for t in ys)
    x.requires_grad_(False)
    assert w8a16.mm_w8a16(x, w, b).grad_fn is None
