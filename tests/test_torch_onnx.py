"""Port ONNX executor (openhush_tpu_torch.models.onnx2torch, over the port's
copy of utils/onnx_io.py) against the JAX package's
openhush_tpu/models/onnx2jax.py, and the ONNX paths of the aux models
(vad.OnnxSileroVad through create_engine, WakeWordDetector.from_onnx)
against theirs.

Every graph is written by the test with the port's writer and read by both
executors from the same file; the port runs on CPU tensors, JAX on numpy.
Tolerances: outputs within atol 1e-5 (fp32 convolutions unfolded into
matmuls against XLA's at Precision.HIGHEST, sums in another order); Silero
probabilities over ten chained chunks and wake-word scores within 1e-5;
the writer's bytes equal the reference's."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from openhush_tpu.models import vad as jvad
from openhush_tpu.models import wakeword as jww
from openhush_tpu.models.onnx2jax import OnnxJaxModel
from openhush_tpu.models.onnx2jax import UnsupportedOnnxOp as JUnsupported
from openhush_tpu.utils import onnx_io as jonnx_io
from openhush_tpu_torch.models import vad, wakeword
from openhush_tpu_torch.models.onnx2torch import (OnnxTorchModel,
                                                  UnsupportedOnnxOp)
from openhush_tpu_torch.utils import onnx_io
from openhush_tpu_torch.utils.onnx_io import (OnnxGraph, OnnxModel, OnnxNode,
                                              OnnxValueInfo)

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (the graphs with the aux models' signatures)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads for this file's torch work: the suite runs six
    workers on one machine, and eight threads each oversubscribe it."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)

ATOL = 1e-5


def make_model(nodes, initializers, inputs, outputs):
    graph = OnnxGraph(nodes=nodes, initializers=initializers,
                      inputs=[OnnxValueInfo(n, 1, s) for n, s in inputs],
                      outputs=[OnnxValueInfo(n, 1, s) for n, s in outputs])
    return OnnxModel(graph)


def both(model: OnnxModel, tmp_path, *inputs):
    """Write the model, run it through both executors on the same inputs;
    each output as a list of numpy arrays (port, JAX)."""
    p = str(tmp_path / "m.onnx")
    onnx_io.save(model, p)
    ours = OnnxTorchModel.load(p, device="cpu")(
        *[torch.from_numpy(x) if isinstance(x, np.ndarray) and x.ndim
          else x for x in inputs])
    ref = OnnxJaxModel.load(p)(*inputs)
    ours = ours if isinstance(ours, tuple) else (ours,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    assert len(ours) == len(ref)
    for a in ours:
        assert torch.is_tensor(a) and a.device.type == "cpu"
    return [a.numpy() for a in ours], [np.asarray(r) for r in ref]


def assert_same(model, tmp_path, *inputs, atol=ATOL):
    ours, ref = both(model, tmp_path, *inputs)
    for a, r in zip(ours, ref):
        assert a.shape == r.shape
        np.testing.assert_allclose(a, r, rtol=0, atol=atol)
    return ours


def rand(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


# ---------------------------------------------------------------------------
# Wire format
# ---------------------------------------------------------------------------

def _zoo(io, rng):
    """A model with every attribute kind and several tensor dtypes, built
    with the data classes of `io` (either package's onnx_io)."""
    then_g = io.OnnxGraph(nodes=[io.OnnxNode("Identity", ["x"], ["out"])],
                          initializers={"k": rand(rng, 2)}, inputs=[],
                          outputs=[io.OnnxValueInfo("out")])
    nodes = [
        io.OnnxNode("Gemm", ["x", "w"], ["y"], name="gemm0",
                    attrs={"transB": 1, "alpha": 0.5, "perm": [1, 0],
                           "scales": [1.5, 2.0], "mode": "linear",
                           "value": np.arange(4, dtype=np.int64)}),
        io.OnnxNode("If", ["c"], ["z"], attrs={"then_branch": then_g,
                                               "else_branch": then_g}),
    ]
    inits = {"w": rand(rng, 4, 3), "i": np.asarray([2, 0, -1], np.int64),
             "h": np.asarray([1.5, -2.25], np.float16),
             "b": np.asarray([True, False]), "c": np.asarray(True),
             "u": np.asarray([7, 255], np.uint8)}
    return io.OnnxModel(io.OnnxGraph(
        nodes=nodes, initializers=inits,
        inputs=[io.OnnxValueInfo("x", 1, (2, "n"))],
        outputs=[io.OnnxValueInfo("y", 1, (2, 4))]))


def test_writer_bytes_equal_the_reference():
    blob = onnx_io.dumps(_zoo(onnx_io, np.random.default_rng(0)))
    assert blob == jonnx_io.dumps(_zoo(jonnx_io, np.random.default_rng(0)))
    back, ref = onnx_io.loads(blob), jonnx_io.loads(blob)
    assert onnx_io.dumps(back) == blob
    for k, v in back.graph.initializers.items():
        r = ref.graph.initializers[k]
        assert v.dtype == r.dtype
        np.testing.assert_array_equal(v, r)
    attrs, ref_attrs = back.graph.nodes[0].attrs, ref.graph.nodes[0].attrs
    assert sorted(attrs) == sorted(ref_attrs)
    for k in attrs:
        np.testing.assert_array_equal(attrs[k], ref_attrs[k])
    branch = back.graph.nodes[1].attrs["then_branch"]
    np.testing.assert_array_equal(branch.initializers["k"], ref.graph.nodes[
        1].attrs["then_branch"].initializers["k"])
    assert back.graph.inputs[0].shape == (2, "n") == ref.graph.inputs[0].shape


def test_fp16_int32_data_bit_patterns():
    """fp16 stored in int32_data carries uint16 bit patterns: the port's
    reader reinterprets them, as the reference's does."""
    vals = np.asarray([1.5, -2.25, 0.0, 3.0e-5], np.float16)
    payload = b"".join(onnx_io._varint(int(b)) for b in vals.view(np.uint16))
    blob = (onnx_io._tag(1, 0) + onnx_io._varint(4)
            + onnx_io._tag(2, 0) + onnx_io._varint(10)
            + onnx_io._len_field(5, payload) + onnx_io._str_field(8, "w"))
    t = onnx_io._parse_tensor(memoryview(blob))
    ref = jonnx_io._parse_tensor(memoryview(blob))
    assert t.array.dtype == ref.array.dtype == np.float16
    np.testing.assert_array_equal(t.array, vals)
    np.testing.assert_array_equal(t.array, ref.array)


# ---------------------------------------------------------------------------
# Conv / pool / norm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stride,pad,dil,groups", [
    (1, 0, 1, 1), (2, 1, 1, 1), (1, 2, 2, 1), (1, 1, 1, 2),
])
def test_conv1d(tmp_path, stride, pad, dil, groups):
    rng = np.random.default_rng(1)
    x = rand(rng, 2, 4, 37)
    w, b = rand(rng, 6, 4 // groups, 5), rand(rng, 6)
    node = OnnxNode("Conv", ["x", "w", "b"], ["y"], attrs={
        "strides": [stride], "pads": [pad, pad], "dilations": [dil],
        "group": groups, "kernel_shape": [5]})
    assert_same(make_model([node], {"w": w, "b": b}, [("x", x.shape)],
                           [("y", ())]), tmp_path, x)


@pytest.mark.parametrize("auto_pad,stride", [("SAME_UPPER", 1),
                                             ("SAME_LOWER", 2),
                                             ("VALID", 2)])
def test_conv2d_auto_pad(tmp_path, auto_pad, stride):
    rng = np.random.default_rng(2)
    x, w = rand(rng, 1, 3, 16, 15), rand(rng, 8, 3, 3, 3)
    node = OnnxNode("Conv", ["x", "w"], ["y"], attrs={
        "auto_pad": auto_pad, "kernel_shape": [3, 3],
        "strides": [stride, stride]})
    out = assert_same(make_model([node], {"w": w}, [("x", x.shape)],
                                 [("y", ())]), tmp_path, x)
    if auto_pad == "SAME_UPPER":
        ref = torch.nn.functional.conv2d(torch.from_numpy(x),
                                         torch.from_numpy(w), padding=1)
        np.testing.assert_allclose(out[0], ref.numpy(), atol=ATOL)


def test_conv_transpose(tmp_path):
    rng = np.random.default_rng(3)
    x, w, b = rand(rng, 2, 4, 9), rand(rng, 4, 3, 4), rand(rng, 3)
    node = OnnxNode("ConvTranspose", ["x", "w", "b"], ["y"], attrs={
        "strides": [2], "pads": [1, 1], "kernel_shape": [4]})
    out = assert_same(make_model([node], {"w": w, "b": b}, [("x", x.shape)],
                                 [("y", ())]), tmp_path, x)
    ref = torch.nn.functional.conv_transpose1d(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
        stride=2, padding=1)
    np.testing.assert_allclose(out[0], ref.numpy(), atol=ATOL)


@pytest.mark.parametrize("op,attrs", [
    ("MaxPool", {"kernel_shape": [3], "strides": [2], "pads": [1, 1]}),
    ("AveragePool", {"kernel_shape": [3], "strides": [2], "pads": [1, 1]}),
    ("AveragePool", {"kernel_shape": [3], "strides": [2], "pads": [1, 1],
                     "count_include_pad": 1}),
    ("MaxPool", {"kernel_shape": [2, 3], "strides": [2, 1],
                 "dilations": [1, 2]}),
    ("GlobalAveragePool", {}), ("GlobalMaxPool", {}),
])
def test_pools(tmp_path, op, attrs):
    rng = np.random.default_rng(4)
    x = rand(rng, 2, 3, 11, 21) if "dilations" in attrs else (
        rand(rng, 2, 3, 21))
    node = OnnxNode(op, ["x"], ["y"], attrs=attrs)
    assert_same(make_model([node], {}, [("x", x.shape)], [("y", ())]),
                tmp_path, x)


def test_norms(tmp_path):
    rng = np.random.default_rng(5)
    x = rand(rng, 2, 5, 9)
    s, b, m = rand(rng, 5), rand(rng, 5), rand(rng, 5)
    v = (rng.random(5) + 0.5).astype(np.float32)
    g, h = rand(rng, 9), rand(rng, 9)
    nodes = [
        OnnxNode("BatchNormalization", ["x", "s", "b", "m", "v"], ["y0"],
                 attrs={"epsilon": 1e-5}),
        OnnxNode("InstanceNormalization", ["x", "s", "b"], ["y1"]),
        OnnxNode("LayerNormalization", ["x", "g", "h"], ["y2"],
                 attrs={"axis": -1}),
    ]
    assert_same(make_model(nodes, {"s": s, "b": b, "m": m, "v": v, "g": g,
                                   "h": h}, [("x", x.shape)],
                           [("y0", ()), ("y1", ()), ("y2", ())]),
                tmp_path, x)


# ---------------------------------------------------------------------------
# Recurrent ops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("direction", ["forward", "bidirectional",
                                       "reverse"])
def test_lstm(tmp_path, direction):
    T, B, I, H = 7, 2, 5, 4
    D = 2 if direction == "bidirectional" else 1
    rng = np.random.default_rng(6)
    x = rand(rng, T, B, I)
    inits = {"W": rand(rng, D, 4 * H, I), "R": rand(rng, D, 4 * H, H),
             "B": rand(rng, D, 8 * H), "h0": rand(rng, D, B, H),
             "c0": rand(rng, D, B, H)}
    node = OnnxNode("LSTM", ["x", "W", "R", "B", "", "h0", "c0"],
                    ["Y", "Yh", "Yc"],
                    attrs={"direction": direction, "hidden_size": H})
    assert_same(make_model([node], inits, [("x", x.shape)],
                           [("Y", ()), ("Yh", ()), ("Yc", ())]),
                tmp_path, x)


@pytest.mark.parametrize("lbr", [1, 0])
def test_gru(tmp_path, lbr):
    T, B, I, H = 6, 3, 4, 5
    rng = np.random.default_rng(7)
    x = rand(rng, T, B, I)
    inits = {"W": rand(rng, 1, 3 * H, I), "R": rand(rng, 1, 3 * H, H),
             "B": rand(rng, 1, 6 * H)}
    node = OnnxNode("GRU", ["x", "W", "R", "B"], ["Y", "Yh"],
                    attrs={"hidden_size": H, "linear_before_reset": lbr})
    ours = assert_same(make_model([node], inits, [("x", x.shape)],
                                  [("Y", ()), ("Yh", ())]), tmp_path, x)
    if lbr:      # torch's GRU is ONNX's linear_before_reset=1 (rzn → zrn)
        gru = torch.nn.GRU(I, H)
        z, r, n = np.split(inits["W"][0], 3)
        rz, rr, rn = np.split(inits["R"][0], 3)
        bw, br = np.split(inits["B"][0], 2)
        with torch.no_grad():
            gru.weight_ih_l0.copy_(torch.from_numpy(np.concatenate([r, z, n])))
            gru.weight_hh_l0.copy_(torch.from_numpy(
                np.concatenate([rr, rz, rn])))
            bz, bri, bn = np.split(bw, 3)
            hz, hr, hn = np.split(br, 3)
            gru.bias_ih_l0.copy_(torch.from_numpy(np.concatenate([bri, bz,
                                                                  bn])))
            gru.bias_hh_l0.copy_(torch.from_numpy(np.concatenate([hr, hz,
                                                                  hn])))
            ref_y, _ = gru(torch.from_numpy(x))
        np.testing.assert_allclose(ours[0][:, 0], ref_y.numpy(), atol=ATOL)


# ---------------------------------------------------------------------------
# Shape math, slicing, reductions, control flow, elementwise, errors
# ---------------------------------------------------------------------------

def test_shape_chain_folds_static(tmp_path):
    nodes = [
        OnnxNode("Shape", ["x"], ["shp"]),
        OnnxNode("Gather", ["shp", "zero"], ["n"], attrs={"axis": 0}),
        OnnxNode("Unsqueeze", ["n"], ["n1"], attrs={"axes": [0]}),
        OnnxNode("Concat", ["n1", "minus1"], ["target"],
                 attrs={"axis": 0}),
        OnnxNode("Reshape", ["x", "target"], ["y"]),
        OnnxNode("Softmax", ["y"], ["z"], attrs={"axis": -1}),
    ]
    inits = {"zero": np.asarray(0, np.int64),
             "minus1": np.asarray([-1], np.int64)}
    x = rand(np.random.default_rng(8), 2, 3, 4)
    out = assert_same(make_model(nodes, inits, [("x", (2, 3, 4))],
                                 [("z", ())]), tmp_path, x)
    assert out[0].shape == (2, 12)


@pytest.mark.parametrize("steps,pads,mode", [
    (2, [0, 1, 0, 1], "constant"), (-1, [1, 2, 0, 1], "reflect"),
    (1, [2, 0, 1, 1], "edge")])
def test_slice_pad_reduce(tmp_path, steps, pads, mode):
    nodes = [
        OnnxNode("Slice", ["x", "starts", "ends", "axes", "steps"], ["s"]),
        OnnxNode("Pad", ["s", "pads"], ["p"], attrs={"mode": mode}),
        OnnxNode("ReduceMean", ["p"], ["y"], attrs={"axes": [1],
                                                    "keepdims": 0}),
        OnnxNode("ReduceSum", ["p", "ax0"], ["y1"]),
        OnnxNode("ReduceMax", ["p"], ["y2"], attrs={"keepdims": 0}),
        OnnxNode("ReduceProd", ["p"], ["y3"], attrs={"axes": [0, 1]}),
        OnnxNode("ReduceL2", ["p"], ["y4"], attrs={"axes": [0]}),
        OnnxNode("ArgMax", ["p"], ["y5"], attrs={"axis": 1}),
    ]
    start, end = (1, 2 ** 62) if steps > 0 else (-2, -2 ** 62)
    inits = {"starts": np.asarray([start], np.int64),
             "ends": np.asarray([end], np.int64),
             "axes": np.asarray([0], np.int64),
             "steps": np.asarray([steps], np.int64),
             "pads": np.asarray(pads, np.int64),
             "ax0": np.asarray([0], np.int64)}
    x = rand(np.random.default_rng(9), 6, 3)
    ours = assert_same(make_model(nodes, inits, [("x", (6, 3))],
                                  [(n, ()) for n in
                                   ("y", "y1", "y2", "y3", "y4", "y5")]),
                       tmp_path, x)
    sl = x[1::steps] if steps > 0 else x[-2::-1]
    expect = np.pad(sl, ((pads[0], pads[2]), (pads[1], pads[3])),
                    mode=mode).mean(1)
    np.testing.assert_allclose(ours[0], expect, atol=1e-6)


def test_if_static_condition(tmp_path):
    then_g = OnnxGraph(
        nodes=[OnnxNode("Mul", ["x", "two"], ["out"])],
        initializers={"two": np.asarray(2.0, np.float32)},
        inputs=[], outputs=[OnnxValueInfo("out")])
    else_g = OnnxGraph(
        nodes=[OnnxNode("Neg", ["x"], ["out"])],
        initializers={}, inputs=[], outputs=[OnnxValueInfo("out")])
    x = np.asarray([1.0, 2.0, 3.0], np.float32)
    for cond, expect in ((True, 2 * x), (False, -x)):
        nodes = [OnnxNode("If", ["cond"], ["y"], attrs={
            "then_branch": then_g, "else_branch": else_g})]
        out = assert_same(make_model(nodes, {"cond": np.asarray(cond)},
                                     [("x", (3,))], [("y", (3,))]),
                          tmp_path, x)
        np.testing.assert_allclose(out[0], expect)


def test_if_on_a_traced_condition_fails_loudly(tmp_path):
    g = OnnxGraph(nodes=[OnnxNode("Identity", ["x"], ["out"])],
                  initializers={}, inputs=[], outputs=[OnnxValueInfo("out")])
    nodes = [OnnxNode("Greater", ["x", "zero"], ["c"]),
             OnnxNode("If", ["c"], ["y"], name="iff",
                      attrs={"then_branch": g, "else_branch": g})]
    model = make_model(nodes, {"zero": np.asarray(0.0, np.float32)},
                       [("x", ())], [("y", ())])
    p = str(tmp_path / "m.onnx")
    onnx_io.save(model, p)
    with pytest.raises(UnsupportedOnnxOp, match="traced condition"):
        OnnxTorchModel.load(p, device="cpu")(torch.ones(()))


ELEMENTWISE = ["Add", "Sub", "Mul", "Div", "Min", "Max", "Pow", "Equal",
               "Greater", "Less", "GreaterOrEqual", "LessOrEqual"]
UNARY = ["Sqrt", "Exp", "Log", "Neg", "Abs", "Floor", "Ceil", "Round",
         "Reciprocal", "Erf", "Relu", "Sigmoid", "Tanh", "Softplus",
         "Identity", "Dropout", "LogSoftmax", "Elu", "HardSigmoid",
         "LeakyRelu"]


def test_elementwise_and_unary(tmp_path):
    rng = np.random.default_rng(10)
    x = (rng.random((3, 4)) * 2 + 0.1).astype(np.float32)
    nodes = [OnnxNode(op, ["x", "k"], [f"b{i}"])
             for i, op in enumerate(ELEMENTWISE)]
    nodes += [OnnxNode(op, ["x"], [f"u{i}"])
              for i, op in enumerate(UNARY)]
    nodes += [OnnxNode("Where", ["b7", "x", "k"], ["w"]),
              OnnxNode("Not", ["b7"], ["nb"]),
              OnnxNode("And", ["b7", "b9"], ["ab"]),
              OnnxNode("Or", ["nb", "b9"], ["ob"]),
              OnnxNode("Clip", ["x", "lo", "hi"], ["cl"]),
              OnnxNode("PRelu", ["u2", "slope"], ["pr"]),
              OnnxNode("Cast", ["b8"], ["cf"], attrs={"to": 1}),
              OnnxNode("MatMul", ["x", "m"], ["mm"]),
              OnnxNode("Gemm", ["x", "m", "k1"], ["gm"],
                       attrs={"alpha": 0.5, "beta": 2.0})]
    outs = ([f"b{i}" for i in range(len(ELEMENTWISE))]
            + [f"u{i}" for i in range(len(UNARY))]
            + ["w", "nb", "ab", "ob", "cl", "pr", "cf", "mm", "gm"])
    inits = {"k": (rng.random(4) + 0.5).astype(np.float32),
             "lo": np.asarray(0.5, np.float32),
             "hi": np.asarray(1.5, np.float32),
             "slope": rand(rng, 4), "m": rand(rng, 4, 5),
             "k1": rand(rng, 5)}
    assert_same(make_model(nodes, inits, [("x", x.shape)],
                           [(n, ()) for n in outs]), tmp_path, x)


def test_shape_ops(tmp_path):
    nodes = [
        OnnxNode("Transpose", ["x"], ["t"], attrs={"perm": [2, 0, 1]}),
        OnnxNode("Flatten", ["t"], ["f"], attrs={"axis": 2}),
        OnnxNode("Unsqueeze", ["f", "ax"], ["u"]),
        OnnxNode("Squeeze", ["u", "ax"], ["s"]),
        OnnxNode("Expand", ["one", "shape"], ["e"]),
        OnnxNode("Tile", ["s", "reps"], ["ti"]),
        OnnxNode("Split", ["x"], ["p0", "p1"], attrs={"axis": 2,
                                                      "split": [1, 3]}),
        OnnxNode("Gather", ["x", "idx"], ["g"], attrs={"axis": 1}),
        OnnxNode("Size", ["x"], ["n"]),
        OnnxNode("Range", ["zero", "n", "three"], ["r"]),
        OnnxNode("ConstantOfShape", ["shape"], ["c"],
                 attrs={"value": np.asarray([2.5], np.float32)}),
        OnnxNode("Constant", [], ["k"], attrs={"value_ints": [1, 2]}),
        OnnxNode("Add", ["e", "c"], ["ec"]),
        OnnxNode("Concat", ["s", "s"], ["cc"], attrs={"axis": 0}),
    ]
    inits = {"ax": np.asarray([-1], np.int64),
             "one": np.asarray([[1.0], [2.0]], np.float32),
             "shape": np.asarray([2, 3], np.int64),
             "reps": np.asarray([2, 1], np.int64),
             "idx": np.asarray([[2, -1], [0, 1]], np.int64),
             "zero": np.asarray(0, np.int64),
             "three": np.asarray(3, np.int64)}
    x = rand(np.random.default_rng(11), 2, 3, 4)
    assert_same(make_model(nodes, inits, [("x", x.shape)],
                           [(n, ()) for n in ("t", "f", "s", "ti", "p0",
                                              "p1", "g", "r", "ec", "cc",
                                              "k")]), tmp_path, x)


@pytest.mark.parametrize("mode,sizes", [("nearest", [1, 2, 7, 5]),
                                        ("linear", [1, 2, 9, 3]),
                                        ("cubic", [1, 2, 4, 12])])
def test_resize(tmp_path, mode, sizes):
    node = OnnxNode("Resize", ["x", "", "", "sizes"], ["y"],
                    attrs={"mode": mode})
    x = rand(np.random.default_rng(12), 1, 2, 5, 6)
    assert_same(make_model([node], {"sizes": np.asarray(sizes, np.int64)},
                           [("x", x.shape)], [("y", ())]), tmp_path, x)


def test_unsupported_op_fails_loudly(tmp_path):
    node = OnnxNode("StringNormalizer", ["x"], ["y"], name="weird")
    model = make_model([node], {}, [("x", (2,))], [("y", (2,))])
    p = str(tmp_path / "m.onnx")
    onnx_io.save(model, p)
    with pytest.raises(UnsupportedOnnxOp, match="StringNormalizer"):
        OnnxTorchModel.load(p, device="cpu")(torch.zeros(2))
    with pytest.raises(JUnsupported, match="StringNormalizer"):
        OnnxJaxModel.load(p)(np.zeros(2, np.float32))


def test_fp16_and_int_initializers(tmp_path):
    """fp16 and int32 initializers flow through Cast and Add as in JAX."""
    nodes = [OnnxNode("Cast", ["h"], ["hf"], attrs={"to": 1}),
             OnnxNode("Add", ["x", "hf"], ["y"]),
             OnnxNode("Cast", ["i"], ["i32"], attrs={"to": 1}),
             OnnxNode("Mul", ["y", "i32"], ["z"])]
    inits = {"h": np.asarray([1.5, -2.25, 3.0e-5], np.float16),
             "i": np.asarray([2, -3, 4], np.int32)}
    x = rand(np.random.default_rng(13), 3)
    assert_same(make_model(nodes, inits, [("x", (3,))], [("z", ())]),
                tmp_path, x)


def test_initializers_upload_once(tmp_path):
    w = rand(np.random.default_rng(14), 4, 3)
    node = OnnxNode("MatMul", ["x", "w"], ["y"])
    p = str(tmp_path / "m.onnx")
    onnx_io.save(make_model([node], {"w": w}, [("x", (2, 4))],
                            [("y", ())]), p)
    m = OnnxTorchModel.load(p, device="cpu")
    x = torch.ones(2, 4)
    m(x)
    [(arr, t)] = [v for v in m._uploads.values() if v is not None]
    m(x)
    assert [v for v in m._uploads.values() if v is not None][0][1] is t
    assert m.save(str(tmp_path / "again.onnx")) is None
    assert (tmp_path / "again.onnx").read_bytes() == Path(p).read_bytes()


# ---------------------------------------------------------------------------
# The aux models' ONNX paths
# ---------------------------------------------------------------------------

class _Cfg:
    def __init__(self, engine, model_path, threshold=0.5):
        self.engine, self.model_path, self.threshold = (engine, model_path,
                                                        threshold)


def test_silero_onnx_through_create_engine_matches_jax(tmp_path):
    path = str(tmp_path / "silero_vad.onnx")
    onnx_io.save(chip_smoke.silero_v5_graph(np.random.default_rng(15)), path)
    ours = vad.create_engine(_Cfg("silero", path), device="cpu")
    ref = jvad.create_engine(_Cfg("silero", path))
    assert isinstance(ours, vad.OnnxSileroVad)
    assert isinstance(ref, jvad.OnnxSileroVad)
    rng = np.random.default_rng(16)
    probs = []
    for i in range(10):
        chunk = (rng.standard_normal(vad.CHUNK_SIZE)
                 * (0.3 if i % 3 else 0.01)).astype(np.float32)
        a, b = ours.process(chunk), ref.process(chunk)
        assert a.probability == pytest.approx(b.probability, abs=ATOL)
        assert a.is_speech == b.is_speech
        probs.append(a.probability)
    assert ours._state.shape == (2, 1, 128)
    np.testing.assert_allclose(ours._state.numpy(), np.asarray(ref._state),
                               atol=ATOL)
    assert len(set(probs)) > 1                   # the state is threaded
    ours.reset()
    assert not ours._state.any()


def test_create_engine_falls_back_on_a_missing_onnx(tmp_path):
    path = tmp_path / "silero_vad.onnx"
    ours = vad.create_engine(_Cfg("silero", str(path)), device="cpu")
    assert isinstance(ours, vad.VadEngine) and ours.kind == "energy"
    assert isinstance(jvad.create_engine(_Cfg("silero", str(path))),
                      jvad.VadEngine)


def test_wakeword_from_onnx_matches_jax(tmp_path):
    emb, cls_m = chip_smoke.wakeword_graphs(np.random.default_rng(17))
    ep, cp = str(tmp_path / "emb.onnx"), str(tmp_path / "cls.onnx")
    onnx_io.save(emb, ep)
    onnx_io.save(cls_m, cp)
    ours = wakeword.WakeWordDetector.from_onnx(ep, cp, device="cpu")
    ref = jww.WakeWordDetector.from_onnx(ep, cp)
    rng = np.random.default_rng(18)
    t = np.arange(wakeword.CHUNK_SAMPLES) / 16000
    scores = []
    for i in range(26):
        chunk = (0.3 * np.sin(2 * np.pi * (300 + 40 * i) * t) * (i % 4 < 2)
                 + 0.05 * rng.standard_normal(t.size)).astype(np.float32)
        a, b = ours.process(chunk), ref.process(chunk)
        assert (a is None) == (b is None)
        if a is not None:
            assert a == pytest.approx(b, abs=ATOL)
            scores.append(a)
    assert len(scores) == 26 - 24 and all(0 < s < 1 for s in scores)
    # Each stage alone, on one mel window and one embedding history.
    mel = torch.from_numpy(rand(rng, 76, 32))
    np.testing.assert_allclose(ours._emb_fn(mel).numpy(),
                               np.asarray(ref._emb_fn(mel.numpy())),
                               atol=ATOL)
    embs = torch.from_numpy(rand(rng, 16, 96))
    assert float(ours._cls_fn(embs)) == pytest.approx(
        float(ref._cls_fn(embs.numpy())), abs=ATOL)
