"""Dependency-free ONNX initializer access (hand-rolled protobuf subset).

The port's own copy of the JAX package's ``io/onnx_lite.py`` (pure numpy).
A 3D-Speaker ERes2NetV2 / CAM++ export keeps the torch parameter names on
its graph's **initializers**; the port only needs those, not the op graph,
since it runs the architecture itself.  The ``onnx`` package is not in
every image, so this module implements just enough of the protobuf wire
format to read and write ``ModelProto.graph.initializer``:

    ModelProto:  field 7  = graph (GraphProto)
    GraphProto:  field 5  = initializer (repeated TensorProto)
    TensorProto: field 1  = dims (repeated int64)
                 field 2  = data_type (1=float32, 6=int32, 7=int64,
                            10=float16, 11=double)
                 field 4  = float_data (packed floats, alt. to raw_data)
                 field 8  = name (string)
                 field 9  = raw_data (little-endian bytes)

Both the packed-``float_data`` and ``raw_data`` encodings are read; the
writer emits ``raw_data`` (what ``torch.onnx.export`` produces) and builds
checkpoints in that format without the onnx package.
"""
from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

_DTYPES = {
    1: np.float32,
    2: np.uint8,
    3: np.int8,
    6: np.int32,
    7: np.int64,
    9: np.bool_,
    10: np.float16,
    11: np.float64,
}
_DTYPE_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


# --------------------------------------------------------------------------
# protobuf wire primitives
# --------------------------------------------------------------------------

def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
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


def _write_varint(value: int) -> bytes:
    out = bytearray()
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _skip_field(buf: bytes, pos: int, wire: int) -> int:
    if wire == 0:
        _, pos = _read_varint(buf, pos)
    elif wire == 1:
        pos += 8
    elif wire == 2:
        n, pos = _read_varint(buf, pos)
        pos += n
    elif wire == 5:
        pos += 4
    else:
        raise ValueError(f"unsupported wire type {wire}")
    return pos


def _iter_fields(buf: bytes):
    """Yield (field_number, wire_type, value_or_span) over a message body.

    wire 0 → int value; wire 2 → bytes; wire 1/5 → raw fixed bytes.
    """
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            val, pos = _read_varint(buf, pos)
            yield field, wire, val
        elif wire == 2:
            ln, pos = _read_varint(buf, pos)
            yield field, wire, buf[pos : pos + ln]
            pos += ln
        elif wire == 5:
            yield field, wire, buf[pos : pos + 4]
            pos += 4
        elif wire == 1:
            yield field, wire, buf[pos : pos + 8]
            pos += 8
        else:
            raise ValueError(f"unsupported wire type {wire}")


def _field(field: int, wire: int) -> bytes:
    return _write_varint((field << 3) | wire)


def _len_delim(field: int, payload: bytes) -> bytes:
    return _field(field, 2) + _write_varint(len(payload)) + payload


# --------------------------------------------------------------------------
# TensorProto
# --------------------------------------------------------------------------

def _parse_tensor(buf: bytes) -> tuple[str, np.ndarray]:
    dims: list[int] = []
    dtype_code = 1
    name = ""
    raw: bytes | None = None
    float_data: list[float] = []
    int_data: list[int] = []
    for field, wire, val in _iter_fields(buf):
        if field == 1:  # dims: varint or packed
            if wire == 0:
                dims.append(val)
            else:
                p = 0
                while p < len(val):
                    d, p = _read_varint(val, p)
                    dims.append(d)
        elif field == 2 and wire == 0:
            dtype_code = val
        elif field == 4:  # float_data
            if wire == 5:
                float_data.append(struct.unpack("<f", val)[0])
            else:
                float_data.extend(
                    struct.unpack(f"<{len(val) // 4}f", val))
        elif field in (5, 7):  # int32_data / int64_data
            if wire == 0:
                int_data.append(val)
            else:
                p = 0
                while p < len(val):
                    d, p = _read_varint(val, p)
                    int_data.append(d)
        elif field == 8 and wire == 2:
            name = val.decode("utf-8")
        elif field == 9 and wire == 2:
            raw = bytes(val)
    dt = _DTYPES.get(dtype_code, np.float32)
    if raw is not None:
        arr = np.frombuffer(raw, dtype=np.dtype(dt).newbyteorder("<"))
    elif float_data:
        arr = np.asarray(float_data, dtype=np.float32)
    elif int_data:
        arr = np.asarray(int_data, dtype=dt)
    else:
        arr = np.zeros(0, dtype=dt)
    return name, arr.reshape(dims)  # dims=[] → scalar (ONNX semantics)


def _emit_tensor(name: str, arr: np.ndarray) -> bytes:
    shape = np.asarray(arr).shape  # before ascontiguousarray (it 1-d-ifies 0-d)
    arr = np.ascontiguousarray(arr)
    code = _DTYPE_CODES.get(arr.dtype)
    if code is None:
        arr = arr.astype(np.float32)
        code = 1
    body = b"".join(_field(1, 0) + _write_varint(int(d)) for d in shape)
    body += _field(2, 0) + _write_varint(code)
    body += _len_delim(8, name.encode("utf-8"))
    body += _len_delim(9, arr.astype(arr.dtype.newbyteorder("<")).tobytes())
    return body


# --------------------------------------------------------------------------
# public API
# --------------------------------------------------------------------------

def read_initializers(path: str | Path) -> dict[str, np.ndarray]:
    """Named initializer arrays of an ONNX model file (no onnx package)."""
    buf = Path(path).read_bytes()
    out: dict[str, np.ndarray] = {}
    for field, wire, val in _iter_fields(buf):
        if field == 7 and wire == 2:  # ModelProto.graph
            for gfield, gwire, gval in _iter_fields(val):
                if gfield == 5 and gwire == 2:  # GraphProto.initializer
                    name, arr = _parse_tensor(gval)
                    out[name] = arr
    return out


def write_initializers(
    path: str | Path,
    tensors: dict[str, np.ndarray],
    graph_name: str = "graph",
) -> None:
    """Write a minimal valid ONNX ModelProto holding only initializers.

    Enough for any initializer-reading consumer (this module, or the real
    ``onnx``/onnxruntime packages) — used to build test fixtures in the
    reference's artifact format.
    """
    graph = _len_delim(2, graph_name.encode("utf-8"))
    graph += b"".join(
        _len_delim(5, _emit_tensor(k, np.asarray(v)))
        for k, v in tensors.items()
    )
    opset = _field(2, 0) + _write_varint(17)  # OperatorSetId{version:17}
    model = (
        _field(1, 0) + _write_varint(8)  # ir_version = 8
        + _len_delim(7, graph)
        + _len_delim(8, opset)
    )
    Path(path).write_bytes(model)
