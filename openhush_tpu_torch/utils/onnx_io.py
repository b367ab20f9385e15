"""Pure-Python ONNX file reader/writer (protobuf wire format, no deps).

A copy of openhush_tpu/utils/onnx_io.py (the port imports nothing of the
JAX package); the two write the same bytes.

The reference executes every auxiliary model (Silero VAD, openWakeWord,
M2M-100, pyannote) through the ONNX Runtime C++ library (`ort`,
the reference's Cargo.toml:40; sessions at src/input/wake_word.rs:121-146,
src/translation/m2m100.rs:519-539). The rebuild replaces that runtime
with its own executor (models/onnx2torch.py here), but the *checkpoints*
for those models are published as .onnx files, so we need to read them.
This module implements just enough of the protobuf wire format to decode
(and, for tests, encode) the ONNX ModelProto subset used by those models:
graph topology, node attributes, and initializer tensors.

Field numbers follow onnx.proto3 (onnx/onnx.proto in the ONNX repo):
  ModelProto:   ir_version=1, producer_name=2, graph=7, opset_import=8
  GraphProto:   node=1, name=2, initializer=5, input=11, output=12
  NodeProto:    input=1, output=2, name=3, op_type=4, attribute=5, domain=7
  AttributeProto: name=1, f=2, i=3, s=4, t=5, g=6, floats=7, ints=8,
                  strings=9, type=20
  TensorProto:  dims=1, data_type=2, float_data=4, int32_data=5,
                string_data=6, int64_data=7, name=8, raw_data=9,
                double_data=10
  ValueInfoProto: name=1, type=2;  TypeProto: tensor_type=1;
  TypeProto.Tensor: elem_type=1, shape=2;  TensorShapeProto: dim=1;
  Dimension: dim_value=1, dim_param=2
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Any, Iterator, Optional

import numpy as np

# TensorProto.DataType values
_DTYPES = {
    1: np.float32, 2: np.uint8, 3: np.int8, 4: np.uint16, 5: np.int16,
    6: np.int32, 7: np.int64, 9: np.bool_, 10: np.float16, 11: np.float64,
    12: np.uint32, 13: np.uint64,
}
_DTYPE_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}

WIRE_VARINT, WIRE_I64, WIRE_LEN, WIRE_I32 = 0, 1, 2, 5


# ---------------------------------------------------------------------------
# Wire-level primitives
# ---------------------------------------------------------------------------

def _read_varint(buf: memoryview, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 70:
            raise ValueError("varint too long (corrupt protobuf)")


def _iter_fields(buf: memoryview) -> Iterator[tuple[int, int, Any]]:
    """Yield (field_number, wire_type, value). LEN values are memoryviews."""
    pos = 0
    end = len(buf)
    while pos < end:
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == WIRE_VARINT:
            val, pos = _read_varint(buf, pos)
        elif wire == WIRE_LEN:
            n, pos = _read_varint(buf, pos)
            val = buf[pos:pos + n]
            pos += n
        elif wire == WIRE_I64:
            val = struct.unpack_from("<q", buf, pos)[0]
            pos += 8
        elif wire == WIRE_I32:
            val = struct.unpack_from("<i", buf, pos)[0]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


def _signed(v: int) -> int:
    """Protobuf int64 varints are two's-complement; fold back to signed."""
    return v - (1 << 64) if v >= (1 << 63) else v


def _packed_varints(mv: memoryview) -> list[int]:
    out = []
    pos = 0
    while pos < len(mv):
        v, pos = _read_varint(mv, pos)
        out.append(_signed(v))
    return out


# ---------------------------------------------------------------------------
# Decoded model structures
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class OnnxTensor:
    name: str
    array: np.ndarray


@dataclasses.dataclass
class OnnxAttr:
    name: str
    value: Any          # float | int | bytes | np.ndarray | list | OnnxGraph


@dataclasses.dataclass
class OnnxNode:
    op_type: str
    inputs: list[str]
    outputs: list[str]
    name: str = ""
    attrs: dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class OnnxValueInfo:
    name: str
    elem_type: int = 1
    shape: tuple = ()        # ints for static dims, str for symbolic


@dataclasses.dataclass
class OnnxGraph:
    nodes: list[OnnxNode]
    initializers: dict[str, np.ndarray]
    inputs: list[OnnxValueInfo]
    outputs: list[OnnxValueInfo]
    name: str = ""


@dataclasses.dataclass
class OnnxModel:
    graph: OnnxGraph
    ir_version: int = 8
    opset: int = 17
    producer: str = ""


def _parse_tensor(mv: memoryview) -> OnnxTensor:
    dims: list[int] = []
    data_type = 1
    name = ""
    raw: Optional[bytes] = None
    floats: list[float] = []
    ints32: list[int] = []
    ints64: list[int] = []
    doubles: list[float] = []
    for field, wire, val in _iter_fields(mv):
        if field == 1:
            if wire == WIRE_LEN:
                dims.extend(_packed_varints(val))
            else:
                dims.append(_signed(val))
        elif field == 2:
            data_type = val
        elif field == 4:
            if wire == WIRE_LEN:
                floats.extend(np.frombuffer(val, "<f4").tolist())
            else:  # non-packed I32
                floats.append(struct.unpack("<f", struct.pack("<i", val))[0])
        elif field == 5:
            if wire == WIRE_LEN:
                ints32.extend(_packed_varints(val))
            else:
                ints32.append(_signed(val))
        elif field == 7:
            if wire == WIRE_LEN:
                ints64.extend(_packed_varints(val))
            else:
                ints64.append(_signed(val))
        elif field == 8:
            name = bytes(val).decode("utf-8")
        elif field == 9:
            raw = bytes(val)
        elif field == 10:
            if wire == WIRE_LEN:
                doubles.extend(np.frombuffer(val, "<f8").tolist())
            else:
                doubles.append(struct.unpack("<d", struct.pack("<q", val))[0])
    dtype = _DTYPES.get(data_type)
    if dtype is None:
        raise ValueError(f"tensor '{name}': unsupported data_type {data_type}")
    shape = tuple(dims)
    if raw is not None:
        arr = np.frombuffer(raw, dtype=np.dtype(dtype).newbyteorder("<"))
        arr = arr.astype(dtype).reshape(shape)
    elif floats:
        arr = np.asarray(floats, np.float32).reshape(shape)
    elif doubles:
        arr = np.asarray(doubles, np.float64).reshape(shape)
    elif ints64:
        arr = np.asarray(ints64, np.int64).reshape(shape)
    elif ints32:
        if data_type == 10:  # float16 stored as uint16 bit patterns in
            # int32_data (ONNX spec): reinterpret, don't convert
            arr = (np.asarray(ints32, np.int32).astype(np.uint16)
                   .view(np.float16).reshape(shape))
        else:
            arr = np.asarray(ints32, dtype).reshape(shape)
    else:
        arr = np.zeros(shape, dtype)
    return OnnxTensor(name, arr)


def _parse_attr(mv: memoryview) -> OnnxAttr:
    name = ""
    atype = 0
    f = i = s = t = g = None
    floats: list[float] = []
    ints: list[int] = []
    strings: list[bytes] = []
    for field, wire, val in _iter_fields(mv):
        if field == 1:
            name = bytes(val).decode("utf-8")
        elif field == 2:
            f = struct.unpack("<f", struct.pack("<i", val))[0]
        elif field == 3:
            i = _signed(val)
        elif field == 4:
            s = bytes(val)
        elif field == 5:
            t = _parse_tensor(val).array
        elif field == 6:
            g = _parse_graph(val)
        elif field == 7:
            if wire == WIRE_LEN:
                floats.extend(np.frombuffer(val, "<f4").tolist())
            else:
                floats.append(struct.unpack("<f", struct.pack("<i", val))[0])
        elif field == 8:
            if wire == WIRE_LEN:
                ints.extend(_packed_varints(val))
            else:
                ints.append(_signed(val))
        elif field == 9:
            strings.append(bytes(val))
        elif field == 20:
            atype = val
    # AttributeProto.AttributeType: FLOAT=1 INT=2 STRING=3 TENSOR=4 GRAPH=5
    # FLOATS=6 INTS=7 STRINGS=8
    if atype == 1 or (atype == 0 and f is not None):
        return OnnxAttr(name, f)
    if atype == 2 or (atype == 0 and i is not None):
        return OnnxAttr(name, i)
    if atype == 3 or (atype == 0 and s is not None):
        return OnnxAttr(name, s)
    if atype == 4 or (atype == 0 and t is not None):
        return OnnxAttr(name, t)
    if atype == 5 or (atype == 0 and g is not None):
        return OnnxAttr(name, g)
    if atype == 6 or floats:
        return OnnxAttr(name, list(floats))
    if atype == 7 or ints:
        return OnnxAttr(name, list(ints))
    if atype == 8 or strings:
        return OnnxAttr(name, strings)
    return OnnxAttr(name, None)


def _parse_node(mv: memoryview) -> OnnxNode:
    node = OnnxNode("", [], [])
    for field, _wire, val in _iter_fields(mv):
        if field == 1:
            node.inputs.append(bytes(val).decode("utf-8"))
        elif field == 2:
            node.outputs.append(bytes(val).decode("utf-8"))
        elif field == 3:
            node.name = bytes(val).decode("utf-8")
        elif field == 4:
            node.op_type = bytes(val).decode("utf-8")
        elif field == 5:
            attr = _parse_attr(val)
            node.attrs[attr.name] = attr.value
    return node


def _parse_value_info(mv: memoryview) -> OnnxValueInfo:
    vi = OnnxValueInfo("")
    for field, _wire, val in _iter_fields(mv):
        if field == 1:
            vi.name = bytes(val).decode("utf-8")
        elif field == 2:  # TypeProto
            for f2, _w2, v2 in _iter_fields(val):
                if f2 != 1:      # tensor_type
                    continue
                for f3, _w3, v3 in _iter_fields(v2):
                    if f3 == 1:
                        vi.elem_type = v3
                    elif f3 == 2:  # TensorShapeProto
                        dims: list = []
                        for f4, _w4, v4 in _iter_fields(v3):
                            if f4 != 1:
                                continue
                            dim_val: Any = None
                            for f5, _w5, v5 in _iter_fields(v4):
                                if f5 == 1:
                                    dim_val = _signed(v5)
                                elif f5 == 2 and dim_val is None:
                                    dim_val = bytes(v5).decode("utf-8")
                            dims.append(dim_val)
                        vi.shape = tuple(dims)
    return vi


def _parse_graph(mv: memoryview) -> OnnxGraph:
    graph = OnnxGraph([], {}, [], [])
    for field, _wire, val in _iter_fields(mv):
        if field == 1:
            graph.nodes.append(_parse_node(val))
        elif field == 2:
            graph.name = bytes(val).decode("utf-8")
        elif field == 5:
            t = _parse_tensor(val)
            graph.initializers[t.name] = t.array
        elif field == 11:
            graph.inputs.append(_parse_value_info(val))
        elif field == 12:
            graph.outputs.append(_parse_value_info(val))
    return graph


def load(path: str) -> OnnxModel:
    """Parse an .onnx file into an OnnxModel."""
    with open(path, "rb") as fh:
        data = fh.read()
    return loads(data)


def loads(data: bytes) -> OnnxModel:
    model = OnnxModel(OnnxGraph([], {}, [], []))
    for field, wire, val in _iter_fields(memoryview(data)):
        if field == 1:
            model.ir_version = val
        elif field == 2:
            model.producer = bytes(val).decode("utf-8", "replace")
        elif field == 7:
            model.graph = _parse_graph(val)
        elif field == 8 and wire == WIRE_LEN:
            for f2, _w2, v2 in _iter_fields(val):
                if f2 == 2:
                    model.opset = v2
    return model


# ---------------------------------------------------------------------------
# Writer (tests build synthetic checkpoints; converters round-trip them)
# ---------------------------------------------------------------------------

def _varint(v: int) -> bytes:
    if v < 0:
        v += 1 << 64
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _len_field(field: int, payload: bytes) -> bytes:
    return _tag(field, WIRE_LEN) + _varint(len(payload)) + payload


def _str_field(field: int, s: str) -> bytes:
    return _len_field(field, s.encode("utf-8"))


def _enc_tensor(name: str, arr: np.ndarray) -> bytes:
    # NOT ascontiguousarray: that promotes 0-d arrays to 1-d, which would
    # change Gather/Unsqueeze semantics for scalar initializers.
    arr = np.asarray(arr, order="C")
    code = _DTYPE_CODES.get(arr.dtype)
    if code is None:
        raise ValueError(f"unsupported dtype {arr.dtype}")
    out = bytearray()
    dims = b"".join(_varint(d) for d in arr.shape)
    if dims:
        out += _len_field(1, dims)
    out += _tag(2, WIRE_VARINT) + _varint(code)
    out += _str_field(8, name)
    out += _len_field(9, arr.astype(arr.dtype.newbyteorder("<")).tobytes())
    return bytes(out)


def _enc_attr(name: str, value: Any) -> bytes:
    out = bytearray(_str_field(1, name))
    if isinstance(value, OnnxGraph):
        out += _len_field(6, _enc_graph(value))
        out += _tag(20, WIRE_VARINT) + _varint(5)
    elif isinstance(value, np.ndarray):
        out += _len_field(5, _enc_tensor("", value))
        out += _tag(20, WIRE_VARINT) + _varint(4)
    elif isinstance(value, float):
        out += _tag(2, WIRE_I32) + struct.pack("<f", value)
        out += _tag(20, WIRE_VARINT) + _varint(1)
    elif isinstance(value, bool):
        out += _tag(3, WIRE_VARINT) + _varint(int(value))
        out += _tag(20, WIRE_VARINT) + _varint(2)
    elif isinstance(value, int):
        out += _tag(3, WIRE_VARINT) + _varint(value)
        out += _tag(20, WIRE_VARINT) + _varint(2)
    elif isinstance(value, bytes):
        out += _len_field(4, value)
        out += _tag(20, WIRE_VARINT) + _varint(3)
    elif isinstance(value, str):
        out += _len_field(4, value.encode("utf-8"))
        out += _tag(20, WIRE_VARINT) + _varint(3)
    elif isinstance(value, (list, tuple)):
        if all(isinstance(v, float) for v in value) and value:
            payload = b"".join(struct.pack("<f", v) for v in value)
            out += _len_field(7, payload)
            out += _tag(20, WIRE_VARINT) + _varint(6)
        elif all(isinstance(v, (bytes, str)) for v in value) and value:
            for v in value:
                vb = v.encode("utf-8") if isinstance(v, str) else v
                out += _len_field(9, vb)
            out += _tag(20, WIRE_VARINT) + _varint(8)
        else:
            payload = b"".join(_varint(int(v)) for v in value)
            out += _len_field(8, payload)
            out += _tag(20, WIRE_VARINT) + _varint(7)
    else:
        raise ValueError(f"attr {name}: unsupported value {value!r}")
    return bytes(out)


def _enc_node(node: OnnxNode) -> bytes:
    out = bytearray()
    for s in node.inputs:
        out += _str_field(1, s)
    for s in node.outputs:
        out += _str_field(2, s)
    if node.name:
        out += _str_field(3, node.name)
    out += _str_field(4, node.op_type)
    for k, v in node.attrs.items():
        out += _len_field(5, _enc_attr(k, v))
    return bytes(out)


def _enc_value_info(vi: OnnxValueInfo) -> bytes:
    dims = bytearray()
    for d in vi.shape:
        if isinstance(d, str):
            dim = _str_field(2, d)
        else:
            dim = _tag(1, WIRE_VARINT) + _varint(int(d))
        dims += _len_field(1, dim)
    shape_payload = bytes(dims)
    tensor_type = (_tag(1, WIRE_VARINT) + _varint(vi.elem_type)
                   + _len_field(2, shape_payload))
    type_proto = _len_field(1, tensor_type)
    return _str_field(1, vi.name) + _len_field(2, type_proto)


def _enc_graph(graph: OnnxGraph) -> bytes:
    out = bytearray()
    for node in graph.nodes:
        out += _len_field(1, _enc_node(node))
    out += _str_field(2, graph.name or "graph")
    for name, arr in graph.initializers.items():
        out += _len_field(5, _enc_tensor(name, arr))
    for vi in graph.inputs:
        out += _len_field(11, _enc_value_info(vi))
    for vi in graph.outputs:
        out += _len_field(12, _enc_value_info(vi))
    return bytes(out)


def dumps(model: OnnxModel) -> bytes:
    out = bytearray()
    out += _tag(1, WIRE_VARINT) + _varint(model.ir_version)
    if model.producer:
        out += _str_field(2, model.producer)
    out += _len_field(7, _enc_graph(model.graph))
    opset = _tag(2, WIRE_VARINT) + _varint(model.opset)
    out += _len_field(8, opset)
    return bytes(out)


def save(model: OnnxModel, path: str) -> None:
    with open(path, "wb") as fh:
        fh.write(dumps(model))
