"""Minimal ONNX reader/writer: protobuf wire format, no onnx dependency.

The port's own copy of ``livecc_tpu/tools/onnx_lite.py`` (pure numpy; the
port imports nothing of the JAX package). The reference's face detector
runs insightface's ``buffalo_sc`` SCRFD through onnxruntime
(data/production/distributed_lighter_asd/face_detector.py:9-21). Neither
``onnx`` nor ``onnxruntime`` exists on the port's machines, so this module
speaks the protobuf WIRE FORMAT directly for the small ONNX subset a
detector graph needs: ModelProto / GraphProto / NodeProto / AttributeProto /
TensorProto. Field numbers follow the public onnx.proto3 schema; unknown
fields are skipped (forward-compatible, exactly like protobuf).

``load_model(path)`` -> Model with nodes + initializers (numpy arrays);
``save_model(path, model)`` writes a file real onnx/onnxruntime can read,
byte for byte what the JAX package's writer gives for the same ``Model``
(``tests/test_torch_asd.py``). ``tools/onnx_torch.py`` executes a Model.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Any, Iterator

import numpy as np

# TensorProto.DataType — the subset detector graphs use
DT_FLOAT, DT_UINT8, DT_INT8, DT_INT32, DT_INT64, DT_BOOL, DT_DOUBLE = 1, 2, 3, 6, 7, 9, 11
_DTYPES = {
    DT_FLOAT: np.float32, DT_UINT8: np.uint8, DT_INT8: np.int8,
    DT_INT32: np.int32, DT_INT64: np.int64, DT_BOOL: np.bool_,
    DT_DOUBLE: np.float64,
}
_DT_OF = {np.dtype(v): k for k, v in _DTYPES.items()}

# AttributeProto.AttributeType
AT_FLOAT, AT_INT, AT_STRING, AT_TENSOR, AT_FLOATS, AT_INTS, AT_STRINGS = 1, 2, 3, 4, 6, 7, 8


# ---------------------------------------------------------------------------
# wire-format primitives
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


def _write_varint(out: bytearray, value: int) -> None:
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _fields(data: bytes | memoryview) -> Iterator[tuple[int, int, Any]]:
    """Yields (field_number, wire_type, value) over one message."""
    buf = memoryview(data)
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        field, wt = key >> 3, key & 7
        if wt == 0:                       # varint
            val, pos = _read_varint(buf, pos)
        elif wt == 1:                     # 64-bit
            val = buf[pos:pos + 8]
            pos += 8
        elif wt == 2:                     # length-delimited
            ln, pos = _read_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wt == 5:                     # 32-bit
            val = buf[pos:pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wt}")
        yield field, wt, val


def _emit(out: bytearray, field: int, wt: int, payload) -> None:
    _write_varint(out, (field << 3) | wt)
    if wt == 0:
        _write_varint(out, payload)
    elif wt == 2:
        _write_varint(out, len(payload))
        out.extend(payload)
    else:
        out.extend(payload)


def _packed_i64(view) -> list[int]:
    vals = []
    pos = 0
    buf = memoryview(view)
    while pos < len(buf):
        v, pos = _read_varint(buf, pos)
        vals.append(v - (1 << 64) if v >= (1 << 63) else v)
    return vals


def _signed(v: int) -> int:
    return v - (1 << 64) if v >= (1 << 63) else v


# ---------------------------------------------------------------------------
# message types (the subset we model)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Attribute:
    name: str
    type: int
    f: float = 0.0
    i: int = 0
    s: bytes = b""
    floats: tuple = ()
    ints: tuple = ()
    t: np.ndarray | None = None

    @property
    def value(self):
        return {AT_FLOAT: self.f, AT_INT: self.i, AT_STRING: self.s.decode(),
                AT_FLOATS: tuple(self.floats), AT_INTS: tuple(self.ints),
                AT_TENSOR: self.t}[self.type]


@dataclasses.dataclass
class Node:
    op_type: str
    inputs: list[str]
    outputs: list[str]
    name: str = ""
    attrs: dict[str, Attribute] = dataclasses.field(default_factory=dict)

    def attr(self, name: str, default=None):
        a = self.attrs.get(name)
        return default if a is None else a.value


@dataclasses.dataclass
class Model:
    nodes: list[Node]
    initializers: dict[str, np.ndarray]
    inputs: list[str]                     # graph inputs EXCLUDING initializers
    outputs: list[str]
    name: str = ""


# ---------------------------------------------------------------------------
# decoding
# ---------------------------------------------------------------------------

def _decode_tensor(data) -> tuple[str, np.ndarray]:
    dims: list[int] = []
    dtype = DT_FLOAT
    name = ""
    raw = None
    float_data: list[float] = []
    i64_data: list[int] = []
    i32_data: list[int] = []
    for field, wt, val in _fields(data):
        if field == 1:
            if wt == 0:
                dims.append(_signed(val))
            else:
                dims.extend(_packed_i64(val))
        elif field == 2:
            dtype = val
        elif field == 4:
            if wt == 2:                   # packed floats
                float_data.extend(np.frombuffer(bytes(val), np.float32).tolist())
            else:
                float_data.append(struct.unpack("<f", bytes(val))[0])
        elif field == 5:
            if wt == 2:
                pos = 0
                buf = memoryview(val)
                while pos < len(buf):
                    v, pos = _read_varint(buf, pos)
                    i32_data.append(_signed(v))
            else:
                i32_data.append(_signed(val))
        elif field == 7:
            if wt == 2:
                i64_data.extend(_packed_i64(val))
            else:
                i64_data.append(_signed(val))
        elif field == 8:
            name = bytes(val).decode()
        elif field == 9:
            raw = bytes(val)
    np_dtype = _DTYPES.get(dtype)
    if np_dtype is None:
        raise ValueError(f"tensor {name!r}: unsupported data_type {dtype}")
    if raw is not None:
        arr = np.frombuffer(raw, np_dtype).reshape(dims)
    elif float_data:
        arr = np.asarray(float_data, np_dtype).reshape(dims)
    elif i64_data:
        arr = np.asarray(i64_data, np_dtype).reshape(dims)
    elif i32_data:
        arr = np.asarray(i32_data, np_dtype).reshape(dims)
    else:
        arr = np.zeros(dims, np_dtype)
    return name, arr


def _decode_attribute(data) -> Attribute:
    kw: dict[str, Any] = dict(name="", type=0)
    floats: list[float] = []
    ints: list[int] = []
    for field, wt, val in _fields(data):
        if field == 1:
            kw["name"] = bytes(val).decode()
        elif field == 2:
            kw["f"] = struct.unpack("<f", bytes(val))[0]
        elif field == 3:
            kw["i"] = _signed(val)
        elif field == 4:
            kw["s"] = bytes(val)
        elif field == 5:
            kw["t"] = _decode_tensor(val)[1]
        elif field == 7:
            if wt == 2:
                floats.extend(np.frombuffer(bytes(val), np.float32).tolist())
            else:
                floats.append(struct.unpack("<f", bytes(val))[0])
        elif field == 8:
            if wt == 2:
                ints.extend(_packed_i64(val))
            else:
                ints.append(_signed(val))
        elif field == 20:
            kw["type"] = val
    kw["floats"] = tuple(floats)
    kw["ints"] = tuple(ints)
    a = Attribute(**kw)
    if not a.type:                        # writers may omit type; infer
        if a.t is not None:
            a.type = AT_TENSOR
        elif floats:
            a.type = AT_FLOATS
        elif ints:
            a.type = AT_INTS
        elif a.s:
            a.type = AT_STRING
    return a


def _decode_node(data) -> Node:
    node = Node(op_type="", inputs=[], outputs=[])
    for field, wt, val in _fields(data):
        if field == 1:
            node.inputs.append(bytes(val).decode())
        elif field == 2:
            node.outputs.append(bytes(val).decode())
        elif field == 3:
            node.name = bytes(val).decode()
        elif field == 4:
            node.op_type = bytes(val).decode()
        elif field == 5:
            a = _decode_attribute(val)
            node.attrs[a.name] = a
    return node


def _decode_value_info_name(data) -> str:
    for field, wt, val in _fields(data):
        if field == 1:
            return bytes(val).decode()
    return ""


def _decode_graph(data) -> Model:
    nodes: list[Node] = []
    initializers: dict[str, np.ndarray] = {}
    inputs: list[str] = []
    outputs: list[str] = []
    name = ""
    for field, wt, val in _fields(data):
        if field == 1:
            nodes.append(_decode_node(val))
        elif field == 2:
            name = bytes(val).decode()
        elif field == 5:
            n, arr = _decode_tensor(val)
            initializers[n] = arr
        elif field == 11:
            inputs.append(_decode_value_info_name(val))
        elif field == 12:
            outputs.append(_decode_value_info_name(val))
    inputs = [i for i in inputs if i not in initializers]
    return Model(nodes=nodes, initializers=initializers, inputs=inputs,
                 outputs=outputs, name=name)


def load_model(path: str) -> Model:
    with open(path, "rb") as f:
        data = f.read()
    graph = None
    for field, wt, val in _fields(data):
        if field == 7:                    # ModelProto.graph
            graph = _decode_graph(val)
    if graph is None:
        raise ValueError(f"{path}: no graph in model")
    return graph


# ---------------------------------------------------------------------------
# encoding (tests synthesize graphs; output is valid ONNX)
# ---------------------------------------------------------------------------

def _encode_tensor(name: str, arr: np.ndarray) -> bytes:
    out = bytearray()
    for d in arr.shape:
        _emit(out, 1, 0, d)
    _emit(out, 2, 0, _DT_OF[arr.dtype])
    _emit(out, 8, 2, name.encode())
    _emit(out, 9, 2, np.ascontiguousarray(arr).tobytes())
    return bytes(out)


def _encode_attribute(a: Attribute) -> bytes:
    out = bytearray()
    _emit(out, 1, 2, a.name.encode())
    if a.type == AT_FLOAT:
        _emit(out, 2, 5, struct.pack("<f", a.f))
    elif a.type == AT_INT:
        _emit(out, 3, 0, a.i & ((1 << 64) - 1))
    elif a.type == AT_STRING:
        _emit(out, 4, 2, a.s)
    elif a.type == AT_TENSOR:
        _emit(out, 5, 2, _encode_tensor("", a.t))
    elif a.type == AT_FLOATS:
        for f in a.floats:
            _emit(out, 7, 5, struct.pack("<f", f))
    elif a.type == AT_INTS:
        for i in a.ints:
            _emit(out, 8, 0, i & ((1 << 64) - 1))
    _emit(out, 20, 0, a.type)
    return bytes(out)


def _encode_node(node: Node) -> bytes:
    out = bytearray()
    for i in node.inputs:
        _emit(out, 1, 2, i.encode())
    for o in node.outputs:
        _emit(out, 2, 2, o.encode())
    if node.name:
        _emit(out, 3, 2, node.name.encode())
    _emit(out, 4, 2, node.op_type.encode())
    for a in node.attrs.values():
        _emit(out, 5, 2, _encode_attribute(a))
    return bytes(out)


def _encode_value_info(name: str) -> bytes:
    out = bytearray()
    _emit(out, 1, 2, name.encode())
    return bytes(out)


def save_model(path: str, model: Model) -> None:
    g = bytearray()
    for node in model.nodes:
        _emit(g, 1, 2, _encode_node(node))
    _emit(g, 2, 2, (model.name or "graph").encode())
    for n, arr in model.initializers.items():
        _emit(g, 5, 2, _encode_tensor(n, arr))
    for i in model.inputs:
        _emit(g, 11, 2, _encode_value_info(i))
    for o in model.outputs:
        _emit(g, 12, 2, _encode_value_info(o))
    m = bytearray()
    _emit(m, 1, 0, 7)                    # ir_version
    _emit(m, 7, 2, bytes(g))             # graph
    # opset_import: domain "" version 11
    ops = bytearray()
    _emit(ops, 1, 2, b"")
    _emit(ops, 2, 0, 11)
    _emit(m, 8, 2, bytes(ops))
    with open(path, "wb") as f:
        f.write(bytes(m))


def attr_i(name: str, value: int) -> Attribute:
    return Attribute(name=name, type=AT_INT, i=value)


def attr_f(name: str, value: float) -> Attribute:
    return Attribute(name=name, type=AT_FLOAT, f=value)


def attr_s(name: str, value: str) -> Attribute:
    return Attribute(name=name, type=AT_STRING, s=value.encode())


def attr_ints(name: str, values) -> Attribute:
    return Attribute(name=name, type=AT_INTS, ints=tuple(values))


def attr_floats(name: str, values) -> Attribute:
    return Attribute(name=name, type=AT_FLOATS, floats=tuple(values))
