"""The int8 decoder weights' product (openhush_tpu_torch.ops.w8a16) against
the JAX package's `_mm` on a dict weight from its own
quantize_decoder_weights, on the same numpy inputs from a seed; the
wrapper's refusals and its launch into a stand-in library; the tolerance
helper that chip_smoke.py holds the kernel to.

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
    """What the wrapper hands the kernel's C entry on a stand-in library:
    x, the levels, the scales, the bias (or none), the output, M = the rows
    of x's leading dimensions, I, O and the dtype; one launch counted a
    call, and a failed launch raises."""
    got = []

    def entry(*args):
        got.append(args)
        return 0

    monkeypatch.setattr(_build, "library", lambda: types.SimpleNamespace(
        oh_w8a16=entry))
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
    assert with_bias[4] == y.data_ptr()
    assert with_bias[5:] == (5, 64, 32, code, 7)

    monkeypatch.setattr(_build, "library", lambda: types.SimpleNamespace(
        oh_w8a16=lambda *args: 1))
    with pytest.raises(RuntimeError, match="oh_w8a16: CUDA error 1"):
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
