"""The W8A8 encoder layer's kernels (openhush_tpu_torch.ops.w8a8: the
per-row quantize, fused with its layer norm, and the int8 product with its
epilogue) against the JAX package on the same numpy inputs from a seed
("test" config): `quantize_rows` against `_quantize_rows` (after JAX's
`layer_norm` with `ln`), `mm_w8a8` with a bias, GELU (erf and tanh) and a
residual against `_mm_i8` and the expressions of the reference's
`block_i8`, the group against its single calls, `_block_i8` against one
step of `block_i8`, the W8A8 `encode` against JAX's; the wrappers'
refusals and their launches into a stand-in library; the model's launches
an encoder layer.

Tolerances (as tests/test_torch_int8.py states them): levels within one on
at most 1e-3 of the elements and scales rtol 1e-6 (the reference's /127 may
compile to a reciprocal multiply, one ulp off); products atol 1e-5 on the
same int8 inputs (fp32 out; one bf16 ulp with a bf16 output, whose
rounding may fall on either side of a neighbouring fp32 value); W8A8
features median 1e-4 and max 5e-2 (level flips at .5 ties, see
test_torch_int8.test_encode_w8a8_matches_jax)."""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openhush_tpu.models.whisper import model as jax_model
from openhush_tpu.models.whisper.config import CONFIGS
from openhush_tpu_torch.models.whisper import model, weights
from openhush_tpu_torch.models.whisper.config import get_config
from openhush_tpu_torch.ops import _build, w8a8

CFG = CONFIGS["test"]
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: small products and an encoder over 1500 rows,
    and the test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _pinned(monkeypatch):
    monkeypatch.setattr(jax_model, "_GELU_MODE", "erf")
    monkeypatch.setattr(model, "_GELU_MODE", "erf")


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _both(a: np.ndarray, dtype):
    """The same values as a torch tensor and a JAX array of `dtype`."""
    t = torch.from_numpy(a).to(dtype)
    return t, jnp.asarray(_np(t)).astype(JDT[dtype])


def assert_levels(ours, ref):
    d = np.abs(np.asarray(ours, np.int32) - np.asarray(ref, np.int32))
    assert d.max() <= 1 and (d > 0).mean() <= 1e-3, (d.max(), (d > 0).mean())


def _rows(shape, seed):
    """Activations of varied row scales, as a layer's rows."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape) * np.exp(rng.standard_normal(
        (*shape[:-1], 1)))
    return x.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_weight(I, O):
    """JAX's int8 weight of a random [I, O] matrix (numpy q, s) from its own
    quantize_encoder_weights, and a bias."""
    rng = np.random.default_rng(10 * I + O)
    w = (0.05 * rng.standard_normal((I, O))).astype(np.float32)
    wq = jax_model.quantize_encoder_weights(
        {"encoder": {"layers": {"q_w": jnp.asarray(w)}}}
    )["encoder"]["layers"]["q_w"]
    return np.array(wq["q"]), np.array(wq["s"]), (
        0.5 * rng.standard_normal(O)).astype(np.float32)


def _weights(I, O, column_major=True):
    """(the port's int8 weight, JAX's, the bias as numpy)."""
    q, s, b = _jax_weight(I, O)
    tq = torch.from_numpy(q)
    if column_major:
        tq = tq.t().contiguous().t()
    return ({"q": tq, "s": torch.from_numpy(s)},
            {"q": jnp.asarray(q), "s": jnp.asarray(s)}, b)


# ---------------------------------------------------------------------------
# The plain versions against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [64, 256, 1280])
def test_quantize_rows_matches_jax(dtype, D):
    """quantize_rows against the reference's _quantize_rows: levels within
    one, scales rtol 1e-6; a zero row takes the 1e-10 floor."""
    x = _rows((3, 17, D), D)
    x[1, 4] = 0
    t, j = _both(x, dtype)
    q, s = w8a8.quantize_rows(t)
    jq, js = jax_model._quantize_rows(j)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert q.shape == t.shape and s.shape == t.shape[:-1]
    assert_levels(q.numpy(), jq)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-6)
    assert s[1, 4].item() == np.float32(1e-10)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [64, 1280])
def test_quantize_rows_with_layer_norm_matches_jax(dtype, D):
    """quantize_rows(x, ln=(scale, bias)) against JAX's layer_norm then
    _quantize_rows, and against model.layer_norm then _quantize_rows (the
    same bits: what the fused kernel replaces)."""
    rng = np.random.default_rng(D + 1)
    x = (3 * _rows((2, 33, D), D + 2) + 1).astype(np.float32)
    g = (1 + 0.1 * rng.standard_normal(D)).astype(np.float32)
    b = (0.1 * rng.standard_normal(D)).astype(np.float32)
    (t, j), (tg, jg), (tb, jb) = (_both(a, dtype) for a in (x, g, b))
    q, s = w8a8.quantize_rows(t, ln=(tg, tb))
    jq, js = jax_model._quantize_rows(jax_model.layer_norm(j, jg, jb))
    assert_levels(q.numpy(), jq)
    rtol = 1e-6 if dtype == torch.float32 else 2.0 ** -7
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=rtol)
    q2, s2 = model._quantize_rows(model.layer_norm(t, tg, tb))
    assert torch.equal(q, q2) and torch.equal(s, s2)


def _jax_epilogue(y, jb, gelu, jres, dt):
    """The reference's block_i8 around an `_mm_i8` output y: + bias in
    fp32, cast to dt, GELU, + residual in dt. The GELU of a bf16 y is taken
    in fp32 and rounded once, as PyTorch's is: XLA on the CPU rounds each
    of its steps to bf16 (up to ~4 ulps from the once-rounded value)."""
    if jb is not None:
        y = y + jb
    y = y.astype(JDT[dt])
    if gelu is not None:
        y = jax.nn.gelu(y.astype(jnp.float32), approximate=gelu == "tanh"
                        ).astype(JDT[dt])
    return y if jres is None else jres + y


@pytest.mark.parametrize("case", ["fp32 out, bias", "bias",
                                  "bias, erf GELU", "bias, tanh GELU",
                                  "bias, residual", "no bias"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("I,O", [(64, 64), (64, 256), (256, 64)])
def test_mm_w8a8_matches_jax(case, dtype, I, O):
    """mm_w8a8 with its epilogue options against JAX's _mm_i8 and the
    block_i8 expressions on the same int8 inputs (JAX's quantized rows and
    weight): fp32 atol 1e-5; a bf16 output within one bf16 ulp of JAX's,
    or 1e-5 where that is more (GELU's tail below x = -4, where PyTorch's
    0.5 x (1 + erf) and JAX's erfc form part by up to ~5e-6)."""
    x = _rows((2, 37, I), I + O)
    j8, js = jax_model._quantize_rows(jnp.asarray(x))
    x8, xs = torch.from_numpy(np.array(j8)), torch.from_numpy(np.array(js))
    w, jw, b = _weights(I, O)
    out = torch.float32 if case == "fp32 out, bias" else dtype
    bias = None if case == "no bias" else b
    gelu = {"bias, erf GELU": "erf", "bias, tanh GELU": "tanh"}.get(case)
    res = (_rows((2, 37, O), O) if case == "bias, residual" else None)
    tb, jb = (None, None) if bias is None else _both(bias, dtype)
    tres, jres = (None, None) if res is None else _both(res, out)
    y = w8a8.mm_w8a8(x8, xs, w, bias=tb, gelu=gelu, residual=tres,
                     out_dtype=out)
    ref = np.asarray(_jax_epilogue(jax_model._mm_i8(j8, js, jw), jb, gelu,
                                   jres, out), np.float32)
    assert y.dtype == out and y.shape == (2, 37, O)
    if out == torch.float32:
        np.testing.assert_allclose(y.numpy(), ref, atol=1e-5)
    else:
        _, e = np.frexp(np.maximum(np.abs(ref), np.finfo(np.float32).tiny))
        assert (np.abs(_np(y) - ref)
                <= np.maximum(np.ldexp(1.0, e - 8), 1e-5)).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mm_w8a8_takes_row_major_levels_on_the_cpu(dtype):
    """The CPU's plain version takes JAX's row-major levels too (the
    reference's _mm_i8 takes any layout): the same bits as column-major."""
    x8, xs = w8a8.quantize_rows(torch.from_numpy(_rows((40, 64), 5)))
    (wc, _, b), (wr, _, _) = _weights(64, 128), _weights(64, 128, False)
    tb = torch.from_numpy(b).to(dtype)
    assert torch.equal(w8a8.mm_w8a8(x8, xs, wc, tb, out_dtype=dtype),
                       w8a8.mm_w8a8(x8, xs, wr, tb, out_dtype=dtype))


@pytest.mark.parametrize("n", [1, 2, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_group_is_its_single_calls(n, dtype):
    """mm_w8a8_group gives each member its single call's bits (q and v
    biased, k not), each its own contiguous output."""
    x8, xs = w8a8.quantize_rows(torch.from_numpy(_rows((2, 19, 64), 7)))
    members = []
    for k, O in enumerate((64, 128, 64)[:n]):
        w, _, b = _weights(64, O)
        members.append((w, None if k == 1 else
                        torch.from_numpy(b).to(dtype)))
    ys = w8a8.mm_w8a8_group(x8, xs, members, out_dtype=dtype)
    assert len(ys) == n
    for (w, b), y in zip(members, ys):
        assert y.is_contiguous() and y.dtype == dtype
        assert torch.equal(y, w8a8.mm_w8a8(x8, xs, w, b, out_dtype=dtype))


def _jax_block_i8(x, lp, n_head):
    """One step of the reference's block_i8 (a function local to its
    encode), written out from its module's pieces line for line."""
    dt = x.dtype
    h = jax_model.layer_norm(x, lp["ln1_scale"], lp["ln1_bias"])
    h8, hs = jax_model._quantize_rows(h)
    q = jax_model._split_heads((jax_model._mm_i8(h8, hs, lp["q_w"])
                                + lp["q_b"]).astype(dt), n_head)
    k = jax_model._split_heads(jax_model._mm_i8(h8, hs, lp["k_w"]
                                                ).astype(dt), n_head)
    v = jax_model._split_heads((jax_model._mm_i8(h8, hs, lp["v_w"])
                                + lp["v_b"]).astype(dt), n_head)
    a = jax_model._merge_heads(jax_model._attend_full(q, k, v))
    a8, as_ = jax_model._quantize_rows(a)
    x = x + (jax_model._mm_i8(a8, as_, lp["o_w"]) + lp["o_b"]).astype(dt)
    h = jax_model.layer_norm(x, lp["ln2_scale"], lp["ln2_bias"])
    h8, hs = jax_model._quantize_rows(h)
    g = jax_model._gelu((jax_model._mm_i8(h8, hs, lp["fc1_w"])
                         + lp["fc1_b"]).astype(dt))
    g8, gs = jax_model._quantize_rows(g)
    return x + (jax_model._mm_i8(g8, gs, lp["fc2_w"]) + lp["fc2_b"]
                ).astype(dt)


@functools.lru_cache(maxsize=None)
def _int8_pair():
    """(JAX params with W8A8 encoder weights, the port's copy), fp32, with
    random biases and layer norms (init's are 0 and 1)."""
    jparams = jax_model.init_params(CFG, jax.random.PRNGKey(2),
                                    dtype=jnp.float32)
    rng = np.random.default_rng(11)
    layers = dict(jparams["encoder"]["layers"])
    for name, leaf in layers.items():
        if name.endswith("_b") or name.endswith("_bias"):
            layers[name] = jnp.asarray(0.1 * rng.standard_normal(
                leaf.shape).astype(np.float32))
        elif name.endswith("_scale"):
            layers[name] = jnp.asarray(1 + 0.1 * rng.standard_normal(
                leaf.shape).astype(np.float32))
    jparams = {**jparams, "encoder": {**jparams["encoder"],
                                      "layers": layers}}
    jq = jax_model.quantize_encoder_weights(jparams)
    return jq, weights.from_numpy_params(jax.tree.map(np.asarray, jq),
                                         torch.float32, "cpu")


def _features_close(ours, ref):
    err = np.abs(ours - ref)
    assert np.median(err) <= 1e-4 and err.max() <= 5e-2, (
        np.median(err), err.max())


def test_block_i8_matches_one_step_of_jax():
    """_block_i8 (its fused calls: the layer norms inside the quantizes,
    q/k/v in one group, the bias, GELU and residual in the epilogues)
    against one step of the reference's block_i8 on the same int8 layer
    and input: within the W8A8 features' bounds."""
    jq, pq = _int8_pair()
    jlp = jax.tree.map(lambda a: a[0], jq["encoder"]["layers"])
    lp = model._layers(pq["encoder"]["layers"])[0]
    x = 2 * _rows((1, CFG.n_audio_ctx, CFG.n_audio_state), 12)
    ref = np.asarray(jax.jit(_jax_block_i8, static_argnums=2)(
        jnp.asarray(x), jlp, CFG.n_audio_head))
    with torch.no_grad():
        ours = model._block_i8(torch.from_numpy(x), lp, CFG.n_audio_head)
    assert ours.shape == x.shape
    _features_close(ours.numpy(), ref)


@pytest.mark.parametrize("gelu", ["erf", "tanh"])
def test_encode_w8a8_matches_jax(monkeypatch, gelu):
    """The W8A8 encode (every layer on the fused entries) against JAX's on
    the same int8 weights and log-mel, in both GELU modes."""
    monkeypatch.setattr(jax_model, "_GELU_MODE", gelu)
    monkeypatch.setattr(model, "_GELU_MODE", gelu)
    jq, pq = _int8_pair()
    mel = np.random.default_rng(13).standard_normal(
        (1, CFG.n_mels, 2 * CFG.n_audio_ctx)).astype(np.float32)
    # A fresh function to trace: jit's cache would keep the other mode's.
    ref = np.asarray(jax.jit(lambda p, m: jax_model.encode(CFG, p, m))(
        jq, jnp.asarray(mel)))
    with torch.no_grad():
        ours = model.encode(CFG, pq, torch.from_numpy(mel))
    _features_close(ours.numpy(), ref)


# ---------------------------------------------------------------------------
# Refusals (every device)
# ---------------------------------------------------------------------------

def test_quantize_refuses_what_the_kernel_does_not_take():
    x = torch.zeros(4, 64)
    ln = (torch.ones(64), torch.zeros(64))
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        w8a8.quantize_rows(x.half())
    with pytest.raises(ValueError, match="not contiguous"):
        w8a8.quantize_rows(torch.zeros(64, 4).t())
    for D in (60, 6152):
        with pytest.raises(ValueError, match="multiple of 8"):
            w8a8.quantize_rows(torch.zeros(2, D))
    with pytest.raises(ValueError, match="layer norm"):
        w8a8.quantize_rows(x, ln=(torch.ones(64), torch.zeros(64).double()))
    with pytest.raises(ValueError, match="layer norm"):
        w8a8.quantize_rows(x, ln=(torch.ones(32), torch.zeros(32)))
    with pytest.raises(ValueError, match="unsupported device"):
        w8a8.quantize_rows(x.to("meta"), ln=tuple(t.to("meta") for t in ln))


def _mm_operands(M=5, I=64, O=32):
    x8 = torch.zeros(M, I, dtype=torch.int8)
    w = {"q": torch.zeros(O, I, dtype=torch.int8).t(), "s": torch.ones(O)}
    return x8, torch.ones(M), w


def test_mm_refuses_what_the_kernel_does_not_take():
    x8, xs, w = _mm_operands()
    with pytest.raises(ValueError, match="contiguous int8"):
        w8a8.mm_w8a8(x8.float(), xs, w)
    with pytest.raises(ValueError, match="contiguous int8"):
        w8a8.mm_w8a8(torch.zeros(64, 5, dtype=torch.int8).t(), xs, w)
    with pytest.raises(ValueError, match="multiple of 32"):
        w8a8.mm_w8a8(torch.zeros(5, 48, dtype=torch.int8), xs,
                      {"q": torch.zeros(48, 32, dtype=torch.int8),
                       "s": torch.ones(32)})
    with pytest.raises(ValueError, match="row scales"):
        w8a8.mm_w8a8(x8, xs.double(), w)
    with pytest.raises(ValueError, match="multiple of 16"):
        w8a8.mm_w8a8(x8, xs, {"q": torch.zeros(64, 40, dtype=torch.int8),
                              "s": torch.ones(40)})
    with pytest.raises(ValueError, match="neither row- nor column-major"):
        w8a8.mm_w8a8(x8, xs, {"q": torch.zeros(64, 64, dtype=torch.int8
                                               )[:, ::2],
                              "s": torch.ones(32)})
    with pytest.raises(ValueError, match="scales"):
        w8a8.mm_w8a8(x8, xs, {"q": w["q"], "s": torch.ones(32).half()})
    with pytest.raises(ValueError, match="bias"):
        w8a8.mm_w8a8(x8, xs, w, torch.ones(32).half())
    with pytest.raises(ValueError, match="residual"):
        w8a8.mm_w8a8(x8, xs, w, residual=torch.zeros(5, 32),
                     out_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="out_dtype"):
        w8a8.mm_w8a8(x8, xs, w, out_dtype=torch.float16)
    with pytest.raises(ValueError, match="gelu"):
        w8a8.mm_w8a8(x8, xs, w, gelu="exact")
    with pytest.raises(ValueError, match="unsupported device"):
        w8a8.mm_w8a8(x8.to("meta"), xs.to("meta"),
                      {k: v.to("meta") for k, v in w.items()})


def test_group_refuses_what_the_kernel_does_not_take():
    x8, xs, w = _mm_operands()
    with pytest.raises(ValueError, match="1 to 3 members"):
        w8a8.mm_w8a8_group(x8, xs, [])
    with pytest.raises(ValueError, match="1 to 3 members"):
        w8a8.mm_w8a8_group(x8, xs, [(w, None)] * 4)
    with pytest.raises(ValueError, match="share a dtype"):
        w8a8.mm_w8a8_group(x8, xs, [(w, torch.ones(32)),
                                    (w, torch.ones(32).bfloat16())])


# ---------------------------------------------------------------------------
# Launches, on a stand-in library
# ---------------------------------------------------------------------------

class _OnCard(torch.Tensor):
    """A CPU tensor that reports a CUDA device, so that the wrapper takes
    its launch path."""

    @property
    def device(self):
        return torch.device("cuda", 0)

    @property
    def is_cuda(self):
        return True


def _card(t):
    return t.as_subclass(_OnCard)


def _stand_in(monkeypatch, **entries):
    """A stand-in kernel library with these entry points, and a stream
    handle of 7."""
    monkeypatch.setattr(_build, "library",
                        lambda: types.SimpleNamespace(**entries))
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda device: 7, raising=False)


def test_a_card_tensor_with_no_kernel_raises(monkeypatch):
    """No quiet switch to the plain versions: where the kernels cannot be
    built, a CUDA tensor raises, and nothing is counted."""
    def no_toolkit():
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA "
                           "toolkit")

    monkeypatch.setattr(_build, "library", no_toolkit)
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda device: 0, raising=False)
    x8, xs, w = (_card(t) if torch.is_tensor(t) else
                 {k: _card(v) for k, v in t.items()} for t in _mm_operands())
    before = (w8a8.quantize_rows.launches, w8a8.mm_w8a8.launches)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        w8a8.quantize_rows(_card(torch.zeros(5, 64)))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        w8a8.mm_w8a8(x8, xs, w)
    assert (w8a8.quantize_rows.launches, w8a8.mm_w8a8.launches) == before


@pytest.mark.parametrize("ln", [False, True])
@pytest.mark.parametrize("dtype,code", [(torch.bfloat16, 1),
                                        (torch.float32, 0)])
def test_quantize_launch_reaches_the_entry(monkeypatch, ln, dtype, code):
    """What quantize_rows hands the kernel's C entry: x, the layer norm's
    scale and bias (or nulls), the levels, the scales, the rows, D, x's and
    the layer norm's dtypes, eps and the stream; one launch counted, and a
    failed launch raises."""
    got = []
    _stand_in(monkeypatch, oh_w8a8_quantize=lambda *a: got.append(a) or 0)
    x = _card(torch.zeros(2, 3, 64, dtype=dtype))
    lnp = (_card(torch.ones(64, dtype=torch.bfloat16)),
           _card(torch.zeros(64, dtype=torch.bfloat16))) if ln else None
    before = w8a8.quantize_rows.launches
    q, s = w8a8.quantize_rows(x, ln=lnp)
    assert w8a8.quantize_rows.launches == before + 1
    assert q.shape == (2, 3, 64) and q.dtype == torch.int8
    assert s.shape == (2, 3) and s.dtype == torch.float32
    (args,) = got
    assert args[0] == x.data_ptr()
    assert args[1:3] == ((lnp[0].data_ptr(), lnp[1].data_ptr()) if ln
                         else (None, None))
    assert args[3:5] == (q.data_ptr(), s.data_ptr())
    assert args[5:9] == (6, 64, code, 1 if ln else 0)
    assert args[9] == pytest.approx(1e-5) and args[10] == 7
    _stand_in(monkeypatch, oh_w8a8_quantize=lambda *a: 3)
    with pytest.raises(RuntimeError, match="oh_w8a8_quantize: CUDA error 3"):
        w8a8.quantize_rows(x)


@pytest.mark.parametrize("n", [1, 3])
def test_mm_launch_reaches_the_entry(monkeypatch, n):
    """What the product hands its C entry: x8, its scales, then each
    member's levels, scales, bias, residual (or nulls), output and width,
    null slots past the members, the count, M, I, the output's and the
    biases' dtypes, the GELU mode and the stream; one launch counted a
    call, a single call's options (bf16 bias, tanh GELU, a residual)
    included; a failed launch raises."""
    got = []
    _stand_in(monkeypatch, oh_w8a8_mm=lambda *a: got.append(a) or 0)
    x8 = _card(torch.zeros(2, 3, 64, dtype=torch.int8))
    xs = _card(torch.ones(2, 3))
    ws = [{"q": _card(torch.zeros(O, 64, dtype=torch.int8).t()),
           "s": _card(torch.ones(O))} for O in (32, 48, 32)[:n]]
    bs = [_card(torch.zeros(w["s"].shape[0], dtype=torch.bfloat16))
          for w in ws]
    before = w8a8.mm_w8a8.launches
    if n == 1:
        res = _card(torch.zeros(2, 3, 32, dtype=torch.bfloat16))
        ys = (w8a8.mm_w8a8(x8, xs, ws[0], bs[0], gelu="tanh", residual=res,
                           out_dtype=torch.bfloat16),)
        opts = (1, 1, 2)
    else:
        members = [(w, None if k == 1 else b)
                   for k, (w, b) in enumerate(zip(ws, bs))]
        ys = w8a8.mm_w8a8_group(x8, xs, members, out_dtype=torch.bfloat16)
        opts = (1, 1, 0)
    assert w8a8.mm_w8a8.launches == before + 1
    (args,) = got
    assert args[:2] == (x8.data_ptr(), xs.data_ptr())
    for k in range(3):
        slot = args[2 + 6 * k:8 + 6 * k]
        if k < n:
            y = ys[k]
            O = ws[k]["s"].shape[0]
            assert y.shape == (2, 3, O) and y.dtype == torch.bfloat16
            bias = None if (n > 1 and k == 1) else bs[k].data_ptr()
            assert slot == (ws[k]["q"].data_ptr(), ws[k]["s"].data_ptr(),
                            bias, res.data_ptr() if n == 1 else None,
                            y.data_ptr(), O)
        else:
            assert slot == (None, None, None, None, None, 0)
    assert args[20:] == (n, 6, 64, *opts, 7)
    _stand_in(monkeypatch, oh_w8a8_mm=lambda *a: 2)
    with pytest.raises(RuntimeError, match="oh_w8a8_mm: CUDA error 2"):
        w8a8.mm_w8a8(x8, xs, ws[0])


def test_the_card_refuses_row_major_levels(monkeypatch):
    """int8 wgmma takes its B operand K-major only: on the card the levels
    must be column-major (as quantize_encoder_weights stores them);
    nothing is launched for row-major ones."""
    _stand_in(monkeypatch, oh_w8a8_mm=lambda *a: pytest.fail("launched"))
    x8 = _card(torch.zeros(5, 64, dtype=torch.int8))
    w = {"q": _card(torch.zeros(64, 32, dtype=torch.int8)),
         "s": _card(torch.ones(32))}
    with pytest.raises(ValueError, match="column-major on the card"):
        w8a8.mm_w8a8(x8, _card(torch.ones(5)), w)


def test_the_card_refuses_a_residual_that_needs_a_gradient(monkeypatch):
    """The kernel has no backward: on the card a bias or residual that needs
    a gradient is refused (nothing launched), where the plain version
    carries it; under no_grad it launches."""
    _stand_in(monkeypatch, oh_w8a8_mm=lambda *a: 0)
    x8 = _card(torch.zeros(5, 64, dtype=torch.int8))
    xs = _card(torch.ones(5))
    w = {"q": _card(torch.zeros(32, 64, dtype=torch.int8).t()),
         "s": _card(torch.ones(32))}
    res = _card(torch.zeros(5, 32, requires_grad=True))
    before = w8a8.mm_w8a8.launches
    with pytest.raises(ValueError, match="no backward"):
        w8a8.mm_w8a8(x8, xs, w, residual=res)
    with pytest.raises(ValueError, match="no backward"):
        w8a8.mm_w8a8_group(x8, xs, [(w, res[0])])
    assert w8a8.mm_w8a8.launches == before
    with torch.no_grad():
        w8a8.mm_w8a8(x8, xs, w, residual=res)
    assert w8a8.mm_w8a8.launches == before + 1
    x8c, xsc, wc = _mm_operands()
    resc = torch.zeros(5, 32, requires_grad=True)
    w8a8.mm_w8a8(x8c, xsc, wc, residual=resc).sum().backward()
    assert torch.equal(resc.grad, torch.ones(5, 32))


def test_encoder_weights_are_column_major():
    """quantize_encoder_weights stores each layer's levels column-major:
    the layout the card's kernel takes, per layer view included."""
    params = weights.init_params(get_config("test"), torch.Generator(
    ).manual_seed(0), device="cpu")
    q = model.quantize_encoder_weights(params)["encoder"]["layers"]
    for name in ("q_w", "k_w", "v_w", "o_w", "fc1_w", "fc2_w"):
        for lw in model._unbind(q[name]):
            I = lw["q"].shape[0]
            assert lw["q"].stride() == (1, I), name


def test_encoder_layer_takes_four_and_four_launches(monkeypatch):
    """An encode on W8A8 weights calls the fused entries, each one launch
    on the card: per layer 4 quantizes (2 with a layer norm) and 4
    products (q/k/v as one group; o and fc2 with a residual, fc1 with the
    GELU); dense weights call none."""
    cfg = get_config("test")
    params = weights.init_params(cfg, torch.Generator().manual_seed(0),
                                 device="cpu")
    calls = {"quantize": 0, "ln": 0, "mm": 0, "group": 0, "residual": 0,
             "gelu": 0}

    def quantize(x, ln=None):
        calls["quantize"] += 1
        calls["ln"] += ln is not None
        return w8a8.quantize_rows(x, ln)

    def mm(x8, xs, w, bias=None, gelu=None, residual=None,
           out_dtype=torch.float32):
        calls["mm"] += 1
        calls["residual"] += residual is not None
        calls["gelu"] += gelu is not None
        return w8a8.mm_w8a8(x8, xs, w, bias, gelu, residual, out_dtype)

    def group(*args, **kw):
        calls["group"] += 1
        return w8a8.mm_w8a8_group(*args, **kw)

    monkeypatch.setattr(model, "quantize_rows", quantize)
    monkeypatch.setattr(model, "mm_w8a8", mm)
    monkeypatch.setattr(model, "mm_w8a8_group", group)
    mel = torch.zeros(1, cfg.n_mels, 2 * cfg.n_audio_ctx)
    with torch.no_grad():
        model.encode(cfg, params, mel)
        assert set(calls.values()) == {0}
        model.encode(cfg, model.quantize_encoder_weights(params), mel)
    L = cfg.n_audio_layer
    assert calls == {"quantize": 4 * L, "ln": 2 * L, "mm": 3 * L,
                     "group": L, "residual": 2 * L, "gelu": L}
