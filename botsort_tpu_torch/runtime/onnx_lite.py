"""Dependency-free reader and writer for the ONNX subset the importer needs
(port of tools/onnx_lite.py).

The reference ships its weights as ONNX graphs. ONNX is plain protobuf,
and the importer (runtime/import_onnx.py) needs only the graph's nodes and
its initializer tensors, so this module decodes the protobuf wire format
itself. The JAX package's importer tries the ``onnx`` package first; the
port uses only this reader, since neither the card machine nor the
development machine has ``onnx``. Fields read:

  ModelProto.graph (field 7) -> GraphProto
  GraphProto.node (1, repeated NodeProto), .name (2), .initializer (5,
  repeated TensorProto)
  NodeProto.input (1), .output (2), .name (3), .op_type (4),
  .attribute (5, repeated AttributeProto)
  AttributeProto.name (1), .f (2), .i (3), .floats (7), .ints (8)
  TensorProto.dims (1), .data_type (2), .float_data (4), .int32_data (5),
  .int64_data (7), .name (8), .raw_data (9), .double_data (10)

The writer emits the same subset, byte for byte what tools/onnx_lite.py
writes: it builds test fixtures and the smoke test's release-layout files
(real wire bytes). It joins the parts once, so a file of hundreds of
megabytes costs one copy.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

# TensorProto.DataType values (onnx.proto enum).
DT_FLOAT = 1
DT_UINT8 = 2
DT_INT8 = 3
DT_INT32 = 6
DT_INT64 = 7
DT_BOOL = 9
DT_FLOAT16 = 10
DT_DOUBLE = 11

_DTYPES = {
    DT_FLOAT: np.dtype(np.float32),
    DT_UINT8: np.dtype(np.uint8),
    DT_INT8: np.dtype(np.int8),
    DT_INT32: np.dtype(np.int32),
    DT_INT64: np.dtype(np.int64),
    DT_BOOL: np.dtype(np.bool_),
    DT_FLOAT16: np.dtype(np.float16),
    DT_DOUBLE: np.dtype(np.float64),
}
_DATA_TYPES = {v: k for k, v in _DTYPES.items()}


# ---------------------------------------------------------------- decode

def _read_varint(buf: memoryview, pos: int):
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
            raise ValueError("malformed varint")


def _iter_fields(buf: memoryview):
    """Yield (field_number, wire_type, value) over one message's bytes.

    wire 0 -> varint int; wire 1 -> 8 raw bytes; wire 2 -> memoryview;
    wire 5 -> 4 raw bytes.
    """
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        fnum, wtype = key >> 3, key & 7
        if wtype == 0:
            val, pos = _read_varint(buf, pos)
        elif wtype == 1:
            val = bytes(buf[pos:pos + 8])
            pos += 8
        elif wtype == 2:
            ln, pos = _read_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wtype == 5:
            val = bytes(buf[pos:pos + 4])
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wtype}")
        yield fnum, wtype, val


def _packed_varints(val, wtype) -> List[int]:
    """A repeated int field: either one varint or a packed blob."""
    if wtype == 0:
        return [val]
    out = []
    pos = 0
    while pos < len(val):
        v, pos = _read_varint(val, pos)
        out.append(v)
    return out


def _zigzag64(v: int) -> int:
    """int64 fields arrive as two's-complement varints."""
    return v - (1 << 64) if v >= (1 << 63) else v


@dataclass
class LiteAttribute:
    name: str = ""
    i: int = 0
    f: float = 0.0
    ints: List[int] = field(default_factory=list)
    floats: List[float] = field(default_factory=list)


@dataclass
class LiteNode:
    op_type: str = ""
    name: str = ""
    input: List[str] = field(default_factory=list)
    output: List[str] = field(default_factory=list)
    attributes: Dict[str, LiteAttribute] = field(default_factory=dict)

    def attr_i(self, name: str, default: int = 0) -> int:
        a = self.attributes.get(name)
        return a.i if a is not None else default


@dataclass
class LiteTensor:
    name: str = ""
    dims: List[int] = field(default_factory=list)
    array: Optional[np.ndarray] = None


@dataclass
class LiteGraph:
    node: List[LiteNode] = field(default_factory=list)
    initializer: List[LiteTensor] = field(default_factory=list)
    name: str = ""


@dataclass
class LiteModel:
    graph: LiteGraph = field(default_factory=LiteGraph)


def _parse_attribute(buf: memoryview) -> LiteAttribute:
    a = LiteAttribute()
    for fnum, wtype, val in _iter_fields(buf):
        if fnum == 1:
            a.name = bytes(val).decode()
        elif fnum == 2:
            a.f = struct.unpack("<f", val)[0]
        elif fnum == 3:
            a.i = _zigzag64(val)
        elif fnum == 7:
            if wtype == 5:
                a.floats.append(struct.unpack("<f", val)[0])
            else:
                a.floats.extend(
                    struct.unpack(f"<{len(val) // 4}f", bytes(val)))
        elif fnum == 8:
            a.ints.extend(_zigzag64(v) for v in _packed_varints(val, wtype))
    return a


def _parse_node(buf: memoryview) -> LiteNode:
    n = LiteNode()
    for fnum, wtype, val in _iter_fields(buf):
        if fnum == 1:
            n.input.append(bytes(val).decode())
        elif fnum == 2:
            n.output.append(bytes(val).decode())
        elif fnum == 3:
            n.name = bytes(val).decode()
        elif fnum == 4:
            n.op_type = bytes(val).decode()
        elif fnum == 5:
            a = _parse_attribute(val)
            n.attributes[a.name] = a
    return n


def _parse_tensor(buf: memoryview) -> LiteTensor:
    t = LiteTensor()
    data_type = DT_FLOAT
    raw = None
    float_data: List[float] = []
    int64_data: List[int] = []
    int32_data: List[int] = []
    double_data: List[float] = []
    for fnum, wtype, val in _iter_fields(buf):
        if fnum == 1:
            t.dims.extend(_packed_varints(val, wtype))
        elif fnum == 2:
            data_type = val
        elif fnum == 4:
            if wtype == 5:
                float_data.append(struct.unpack("<f", val)[0])
            else:
                float_data.extend(
                    struct.unpack(f"<{len(val) // 4}f", bytes(val)))
        elif fnum == 5:
            int32_data.extend(_packed_varints(val, wtype))
        elif fnum == 7:
            int64_data.extend(
                _zigzag64(v) for v in _packed_varints(val, wtype))
        elif fnum == 8:
            t.name = bytes(val).decode()
        elif fnum == 9:
            raw = bytes(val)
        elif fnum == 10:
            if wtype == 1:
                double_data.append(struct.unpack("<d", val)[0])
            else:
                double_data.extend(
                    struct.unpack(f"<{len(val) // 8}d", bytes(val)))
    dtype = _DTYPES.get(data_type)
    if dtype is None:
        raise ValueError(f"unsupported tensor data_type {data_type} "
                         f"for initializer {t.name!r}")
    shape = tuple(t.dims)
    if raw is not None:
        t.array = np.frombuffer(raw, dtype=dtype).reshape(shape)
    elif float_data:
        t.array = np.asarray(float_data, dtype=dtype).reshape(shape)
    elif int64_data:
        t.array = np.asarray(int64_data, dtype=dtype).reshape(shape)
    elif int32_data:
        t.array = np.asarray(int32_data, dtype=dtype).reshape(shape)
    elif double_data:
        t.array = np.asarray(double_data, dtype=dtype).reshape(shape)
    else:
        t.array = np.zeros(shape, dtype=dtype)
    return t


def _parse_graph(buf: memoryview) -> LiteGraph:
    g = LiteGraph()
    for fnum, wtype, val in _iter_fields(buf):
        if fnum == 1:
            g.node.append(_parse_node(val))
        elif fnum == 2:
            g.name = bytes(val).decode()
        elif fnum == 5:
            g.initializer.append(_parse_tensor(val))
    return g


def parse(data: bytes) -> LiteModel:
    m = LiteModel()
    for fnum, wtype, val in _iter_fields(memoryview(data)):
        if fnum == 7:
            m.graph = _parse_graph(val)
    return m


def load(path: str) -> LiteModel:
    with open(path, "rb") as f:
        return parse(f.read())


# ---------------------------------------------------------------- encode

def _varint(v: int) -> bytes:
    out = bytearray()
    if v < 0:
        v += 1 << 64
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(fnum: int, wtype: int) -> bytes:
    return _varint((fnum << 3) | wtype)


def _len_field(fnum: int, payload: bytes) -> bytes:
    return b"".join((_tag(fnum, 2), _varint(len(payload)), payload))


def encode_tensor(name: str, array: np.ndarray) -> bytes:
    array = np.asarray(array)
    parts = [_tag(1, 0) + _varint(d) for d in array.shape]
    parts.append(_tag(2, 0) + _varint(_DATA_TYPES[array.dtype]))
    parts.append(_len_field(8, name.encode()))
    parts.append(_len_field(9, array.tobytes()))
    return b"".join(parts)


def encode_attribute_i(name: str, value: int) -> bytes:
    payload = _len_field(1, name.encode())
    payload += _tag(3, 0) + _varint(value)
    payload += _tag(20, 0) + _varint(2)  # AttributeProto.type = INT
    return payload


def encode_node(op_type: str, inputs, outputs, name: str = "",
                int_attrs: Optional[Dict[str, int]] = None) -> bytes:
    parts = [_len_field(1, i.encode()) for i in inputs]
    parts += [_len_field(2, o.encode()) for o in outputs]
    if name:
        parts.append(_len_field(3, name.encode()))
    parts.append(_len_field(4, op_type.encode()))
    parts += [_len_field(5, encode_attribute_i(k, v))
              for k, v in (int_attrs or {}).items()]
    return b"".join(parts)


def encode_model(nodes: List[bytes], initializers: List[bytes],
                 graph_name: str = "g") -> bytes:
    graph = [_len_field(1, n) for n in nodes]
    graph.append(_len_field(2, graph_name.encode()))
    graph += [_len_field(5, t) for t in initializers]
    ir_version = _tag(1, 0) + _varint(8)
    return ir_version + _len_field(7, b"".join(graph))
